"""Traffic shapes → concrete arrival plans.

Given a Phase's TrafficShape and a seed, produce the deterministic list of
request arrivals (phase-relative simulated seconds) and, for session
swarms, the closed-loop multi-turn sessions.  Open-loop kinds draw Poisson
arrivals against a (possibly time-varying) rate function; the swarm reuses
bench.data_generator's session synthesizer so the soak's multi-turn traffic
is the same shape the routing benchmarks replay.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field, replace

from dynamo_tpu_torch.bench.data_generator import SessionConfig, generate_sessions
from dynamo_tpu_torch.scenarios.spec import Phase, TrafficShape

VOCAB = 8_000  # small enough for fast mocker hashing, big enough to not collide


@dataclass
class Arrival:
    at_s: float                  # phase-relative simulated seconds
    isl: int
    osl: int
    kind: str = "plain"          # plain | long | guided


@dataclass
class PhasePlan:
    arrivals: list = field(default_factory=list)   # [Arrival] open-loop
    sessions: list = field(default_factory=list)   # [Session] closed-loop

    @property
    def expected_requests(self) -> int:
        return len(self.arrivals) + sum(len(s.turns) for s in self.sessions)


def _rate_at(shape: TrafficShape, t: float) -> float:
    """Instantaneous arrival rate (req / sim-s) at phase time ``t``."""
    if shape.kind == "burst":
        in_burst = (
            shape.burst_duration_s > 0
            and shape.burst_start_s <= t < shape.burst_start_s + shape.burst_duration_s
        )
        return shape.burst_rate if in_burst else shape.rate
    if shape.kind == "diurnal":
        peak = shape.peak_rate or shape.rate
        period = shape.period_s or 1.0
        # sinusoid between rate (trough) and peak_rate (crest) — a whole
        # diurnal cycle compressed into period_s simulated seconds
        mid = (shape.rate + peak) / 2.0
        amp = (peak - shape.rate) / 2.0
        return max(mid + amp * math.sin(2 * math.pi * t / period), 0.0)
    return shape.rate


def _poisson_arrivals(shape: TrafficShape, duration_s: float,
                      rng: random.Random) -> list[float]:
    """Thinning sampler for an inhomogeneous Poisson process: draw at the
    envelope rate, keep each point with prob rate(t)/envelope."""
    envelope = max(
        shape.rate, shape.burst_rate, shape.peak_rate, 1e-9
    )
    out: list[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(envelope)
        if t >= duration_s:
            return out
        if rng.random() * envelope <= _rate_at(shape, t):
            out.append(t)


def plan_phase(phase: Phase, seed: int) -> PhasePlan:
    """Deterministic arrival plan for one phase."""
    shape = phase.traffic
    rng = random.Random((seed, phase.name).__repr__())

    if shape.kind == "session_swarm":
        sessions = generate_sessions(SessionConfig(
            num_sessions=shape.num_sessions,
            turns_per_session=shape.turns_per_session,
            session_rate=shape.session_rate,
            system_tokens=shape.system_tokens,
            user_tokens_per_turn=shape.isl,
            turn_gap_mean_s=shape.turn_gap_s,
            osl=shape.osl,
            vocab_size=VOCAB,
            seed=rng.randrange(1 << 30),
        ))
        # clamp session starts into the phase window so the swarm actually
        # lands inside the phase it describes
        sessions = [
            replace(s, start_s=min(s.start_s, max(phase.duration_s - 1e-3, 0.0)))
            for s in sessions
        ]
        return PhasePlan(sessions=sessions)

    if shape.requests > 0:
        # closed count (chaos_smoke phases): evenly spaced at 1/rate
        gap = 1.0 / max(shape.rate, 1e-9)
        times = [i * gap for i in range(shape.requests)]
    else:
        times = _poisson_arrivals(shape, phase.duration_s, rng)

    arrivals: list[Arrival] = []
    for t in times:
        isl, osl, kind = shape.isl, shape.osl, "plain"
        if shape.kind == "long_context" and rng.random() < shape.long_fraction:
            isl = shape.isl_long or shape.isl * 8
            kind = "long"
        elif shape.kind == "guided_mix" and rng.random() < shape.guided_fraction:
            osl = shape.osl_guided or shape.osl * 2
            kind = "guided"
        arrivals.append(Arrival(at_s=t, isl=isl, osl=osl, kind=kind))
    return PhasePlan(arrivals=arrivals)


def prompt_tokens(n: int, rng: random.Random) -> list[int]:
    return [rng.randrange(10, VOCAB) for _ in range(n)]
