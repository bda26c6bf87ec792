"""The port's operator tools, as modules of the package (the repository's
``scripts/*.py`` counterparts): ``dyn_top``, ``check_metrics``,
``chaos_smoke``, ``migration_bench``, the decode profiler
``profile_decode``, ``spec_vs_fused`` and ``dynlint``, each run with
``python -m dynamo_tpu_torch.scripts.<name>``."""
