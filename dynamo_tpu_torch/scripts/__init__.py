"""The port's operator tools, as modules of the package (the repository's
``scripts/*.py`` counterparts): ``dyn_top``, ``check_metrics``,
``chaos_smoke`` and ``migration_bench``, each run with ``python -m
dynamo_tpu_torch.scripts.<name>``."""
