"""Cross-worker transfer of KV blocks (``kv_transfer``).  The reference's
meshes, pipeline stages and multi-host setup (``mesh``, ``pipeline``,
``multihost``) are a later slice of the port."""
