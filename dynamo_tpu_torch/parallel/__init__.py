"""Cross-worker transfer of KV blocks (``kv_transfer``); the tensor and
expert mesh over ``torch.distributed`` (``mesh``), its multi-host bootstrap
through the control plane (``multihost``) and the mesh dryrun
(``dryrun``).  The reference's pipeline stages and ring-attention sequence
parallelism are a later slice of the port."""
