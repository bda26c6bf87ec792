"""Planner decision state on the event bus.

The planner is a control loop; the metrics service is the observability
plane.  They meet here: after every executed decision the planner publishes
a ``PlannerStateEvent`` on the component's ``planner_state`` event subject,
and the metrics service mirrors the latest event into the
``dyn_planner_{target_replicas,observed_capacity_tok_s,burn_rate_input}``
gauges so `dyn_top` and Prometheus can see WHAT the autopilot decided and
WHY (burn input, per-pool capacity estimates) without scraping the planner
process itself.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass

PLANNER_STATE_EVENT = "planner_state"


@dataclass
class PlannerStateEvent:
    target_prefill: int = 0
    target_decode: int = 0
    # observed per-replica capacity estimates (EWMA at saturation)
    observed_prefill_tok_s: float = 0.0
    observed_decode_tok_s: float = 0.0
    # the worst per-objective burn rate the planner consumed for this decision
    burn_rate_input: float = 0.0
    reason: str = ""
    ts: float = 0.0

    def to_json(self) -> bytes:
        return json.dumps(asdict(self)).encode()

    @classmethod
    def from_json(cls, raw: bytes | str) -> "PlannerStateEvent":
        data = json.loads(raw)
        known = {f for f in cls.__dataclass_fields__}  # noqa: C416
        return cls(**{k: v for k, v in data.items() if k in known})


def event_from_planner(planner, decision, ts: float = 0.0) -> PlannerStateEvent:
    """Snapshot a planner + its latest decision into an event."""
    return PlannerStateEvent(
        target_prefill=decision.num_prefill,
        target_decode=decision.num_decode,
        observed_prefill_tok_s=planner.observed_prefill_capacity,
        observed_decode_tok_s=planner.observed_decode_capacity,
        burn_rate_input=planner.worst_burn_input,
        reason=decision.reason,
        ts=ts,
    )


class PlannerStatePublisher:
    """Publishes planner decisions on ``component.event_subject("planner_state")``.

    Attach to a Planner via ``planner.state_publisher = PlannerStatePublisher(comp)``;
    ``Planner.step`` calls :meth:`publish_decision` after each executed scale.
    """

    def __init__(self, component, clock=None):
        self._component = component
        self._clock = clock
        self.published: list[PlannerStateEvent] = []

    @property
    def subject(self) -> str:
        return self._component.event_subject(PLANNER_STATE_EVENT)

    async def publish(self, event: PlannerStateEvent) -> None:
        self.published.append(event)
        bus = self._component.runtime.plane.bus
        await bus.publish(self.subject, event.to_json())

    async def publish_decision(self, planner, decision) -> None:
        ts = self._clock() if self._clock is not None else 0.0
        await self.publish(event_from_planner(planner, decision, ts=ts))
