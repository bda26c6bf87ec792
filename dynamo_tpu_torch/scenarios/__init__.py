"""Scenario soak engine: adversarial production traffic against a live
routed fleet, with the SLO-native planner autopilot steering mid-soak.

- ``spec``: declarative JSON scenario format (phases × traffic shapes ×
  chaos fault schedules × SLO burn assertions)
- ``traffic``: shape → deterministic arrival/session plans
- ``fleet``: SoakFleet — live scalable mocker (or TorchLlmEngine) pools +
  metrics/frontend surface
- ``runner``: ScenarioRunner — drive, sample, steer, assert, produce the
  SCENARIO_SOAK_CUDA.json artifact

Run the shipped soak: ``python -m dynamo_tpu_torch.scenarios.soak``.
"""

from dynamo_tpu_torch.scenarios.spec import (
    AutopilotSpec,
    FaultEvent,
    FleetSpec,
    Phase,
    PhaseAssertions,
    ScenarioSpec,
    SloSpec,
    TrafficShape,
    builtin_spec_path,
)

__all__ = [
    "AutopilotSpec",
    "FaultEvent",
    "FleetSpec",
    "Phase",
    "PhaseAssertions",
    "ScenarioSpec",
    "SloSpec",
    "TrafficShape",
    "builtin_spec_path",
]
