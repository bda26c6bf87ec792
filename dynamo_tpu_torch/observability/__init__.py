"""The engine's accounting (counterpart of dynamo_tpu/observability/):
``perf`` (the analytical FLOPs/bytes cost model and the rolling MFU /
bandwidth-utilization / goodput tracker) and ``step_metrics`` (the latest
step's snapshot and step counters).  The flight recorder, spans and SLO
tracking come with the HTTP service's slice."""

from dynamo_tpu_torch.observability.perf import ModelCost, UtilizationTracker, model_cost
from dynamo_tpu_torch.observability.step_metrics import StepSnapshot, StepTelemetry

__all__ = ["ModelCost", "StepSnapshot", "StepTelemetry", "UtilizationTracker", "model_cost"]
