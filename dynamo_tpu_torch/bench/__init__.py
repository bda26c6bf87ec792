"""The port's benchmark toolkit (copies of dynamo_tpu/bench/): trace
synthesis, concurrency sweeps, SLA profiling, and the headline serving
benchmark (``python -m dynamo_tpu_torch.bench.headline``, the counterpart of
the repository's bench.py) with the summary of its device traces."""
