"""The port's observability (counterpart of dynamo_tpu/observability/):
``perf`` (the analytical FLOPs/bytes cost model and the rolling MFU /
bandwidth-utilization / goodput tracker), ``step_metrics`` (the latest
step's snapshot and step counters), ``trace`` (the propagated request
context), ``recorder`` (the process-wide span recorder), ``flight`` (the
bounded perf flight recorder the runtime's and the engine's seams write
to), and ``slo`` (burn-rate SLO tracking over the frontend's TTFT / ITL /
error stream, the ``dyn_slo_*`` families and the frontend's ``/slo``)."""

from dynamo_tpu_torch.observability.flight import (
    FlightRecorder,
    flight_dir,
    latest_dump,
    load_dump,
)
from dynamo_tpu_torch.observability.perf import ModelCost, UtilizationTracker, model_cost
from dynamo_tpu_torch.observability.recorder import (
    Span,
    SpanRecorder,
    get_recorder,
    set_recorder,
)
from dynamo_tpu_torch.observability.slo import SloConfig, SloObjective, SloTracker
from dynamo_tpu_torch.observability.step_metrics import StepSnapshot, StepTelemetry
from dynamo_tpu_torch.observability.trace import TraceContext, new_span_id, new_trace_id

__all__ = [
    "FlightRecorder",
    "ModelCost",
    "SloConfig",
    "SloObjective",
    "SloTracker",
    "Span",
    "SpanRecorder",
    "StepSnapshot",
    "StepTelemetry",
    "TraceContext",
    "UtilizationTracker",
    "flight_dir",
    "get_recorder",
    "latest_dump",
    "load_dump",
    "model_cost",
    "new_span_id",
    "new_trace_id",
    "set_recorder",
]
