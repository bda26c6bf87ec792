"""Autoscaling planner.

Observes load + SLA metrics, predicts the next interval, computes required
prefill/decode replica counts from profiled performance, and scales through
a connector (reference: components/planner — load-based planner_core.py and
SLA planner_sla.py, predictors utils/load_predictor.py, interpolation
utils/perf_interpolation.py, connectors local/kubernetes).  A copy of
dynamo_tpu/planner; the Kubernetes connector drives the port's ``deploy/``
plane.

SLO-native autopilot: WorkloadSample carries frontend burn rates and
per-pool occupancy (sample_from_endpoints / burn_rates_from_slo), plan()
escalates the burning pool and rebalances prefill↔decode at the chip
budget, and state.PlannerStatePublisher mirrors every executed decision to
the metrics service's dyn_planner_* gauges.
"""

from dynamo_tpu_torch.planner.defrag import DefragConfig, Defragmenter
from dynamo_tpu_torch.planner.load_predictor import (
    ConstantPredictor,
    EwmaPredictor,
    LinearTrendPredictor,
    make_predictor,
    replay_trace,
)
from dynamo_tpu_torch.planner.perf_interpolation import PerfProfile, ProfilePoint
from dynamo_tpu_torch.planner.planner import (
    Planner,
    PlannerConfig,
    PlannerDecision,
    WorkloadSample,
    burn_rates_from_slo,
    sample_from_endpoints,
)
from dynamo_tpu_torch.planner.state import (
    PLANNER_STATE_EVENT,
    PlannerStateEvent,
    PlannerStatePublisher,
)

__all__ = [
    "ConstantPredictor",
    "DefragConfig",
    "Defragmenter",
    "EwmaPredictor",
    "LinearTrendPredictor",
    "make_predictor",
    "replay_trace",
    "PerfProfile",
    "ProfilePoint",
    "Planner",
    "PlannerConfig",
    "PlannerDecision",
    "WorkloadSample",
    "burn_rates_from_slo",
    "sample_from_endpoints",
    "PLANNER_STATE_EVENT",
    "PlannerStateEvent",
    "PlannerStatePublisher",
]
