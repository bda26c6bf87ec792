"""The planner's profiled-performance model (a copy of
dynamo_tpu/planner/perf_interpolation.py).  The rest of the reference's
planner (load predictors, the SLA planner, connectors, defragmentation)
comes with the fleet planes above the engine."""

from dynamo_tpu_torch.planner.perf_interpolation import PerfProfile, ProfilePoint

__all__ = ["PerfProfile", "ProfilePoint"]
