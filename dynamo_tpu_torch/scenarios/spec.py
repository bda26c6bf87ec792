"""Declarative scenario specs for adversarial fleet soaks.

A scenario is a JSON document: fleet shape + SLO definition + autopilot
knobs + an ordered list of PHASES.  Each phase names a traffic shape
(constant, diurnal burst, multi-turn session swarm, long-context
stragglers, guided/speculative mixes), an optional chaos schedule (fault
events that arm the ``DYN_FAULTS`` registry mid-phase), and the assertions
that must hold when the phase drains: per-objective SLO burn-rate ceilings,
an MFU/goodput floor, and a completion floor.

All times and rates in a spec are SIMULATED seconds — the runner compresses
them by ``speedup`` exactly like the mocker's cost model, so one spec means
the same workload at any compression.

The same format feeds both ends of the chaos story: the tier-1 chaos gate
(``python -m dynamo_tpu_torch.scripts.chaos_smoke`` loads its canned phases from
``specs/chaos_smoke.json``) and the full scenario soak
(``specs/default_soak.json`` → SCENARIO_SOAK_CUDA.json artifact).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path

TRAFFIC_KINDS = (
    "constant", "burst", "diurnal", "session_swarm", "long_context",
    "guided_mix",
)
# the engines a fleet's workers run (the reference's "jax" is the JAX
# package's engine, which the port does not run)
FLEET_ENGINES = ("mocker", "torch")


@dataclass
class TrafficShape:
    """One phase's arrival process (simulated seconds / req per sim-s)."""

    kind: str = "constant"
    rate: float = 2.0              # req/s (base rate for burst/diurnal)
    isl: int = 96                  # prompt tokens/request
    osl: int = 24                  # generated tokens/request
    # burst: a rate spike inside the phase
    burst_rate: float = 0.0
    burst_start_s: float = 0.0
    burst_duration_s: float = 0.0
    # diurnal: sinusoid between rate and peak_rate with this period
    peak_rate: float = 0.0
    period_s: float = 0.0
    # session_swarm: multi-turn chat sessions (bench.data_generator); the
    # swarm is CLOSED-loop per session — turn n+1 waits for turn n
    num_sessions: int = 0
    turns_per_session: int = 3
    session_rate: float = 2.0      # Poisson session starts / sim-s
    system_tokens: int = 64
    turn_gap_s: float = 1.0
    # long_context: fraction of arrivals that are stragglers with isl_long
    long_fraction: float = 0.0
    isl_long: int = 0
    # guided_mix: fraction of requests tagged guided/speculative — they pay
    # a longer decode (osl_guided) like constrained decoding does
    guided_fraction: float = 0.0
    osl_guided: int = 0
    # closed request count (chaos_smoke phases): exactly this many
    # arrivals, spaced by 1/rate — 0 means open-loop rate × duration
    requests: int = 0

    def validate(self) -> None:
        if self.kind not in TRAFFIC_KINDS:
            raise ValueError(
                f"unknown traffic kind {self.kind!r} (want one of {TRAFFIC_KINDS})"
            )
        if self.kind == "session_swarm" and self.num_sessions <= 0:
            raise ValueError("session_swarm traffic needs num_sessions > 0")
        if self.kind == "long_context" and not (0 < self.long_fraction <= 1):
            raise ValueError("long_context traffic needs 0 < long_fraction <= 1")


@dataclass
class FaultEvent:
    """Arm a ``DYN_FAULTS`` schedule at a phase-relative simulated time.

    ``schedule`` uses the registry grammar (robustness/faults.py):
    ``point:trigger[:opt=val...]`` joined by ``;`` — e.g.
    ``worker.generate:nth=3`` or ``cp.recv:once``."""

    at_s: float = 0.0
    schedule: str = ""

    def validate(self) -> None:
        from dynamo_tpu_torch.robustness.faults import parse_faults

        if not self.schedule:
            raise ValueError("fault event needs a schedule")
        parse_faults(self.schedule)  # raises on bad grammar


@dataclass
class WorkerKillEvent:
    """Take one live worker out of a pool at a phase-relative simulated time.

    ``mode="kill"`` is abrupt: the worker's lease is revoked and its handler
    tasks are cancelled with no grace, so in-flight streams break mid-stream
    and the dispatcher's generation journal must resume them on a peer.
    ``mode="drain"`` runs the graceful drain state machine instead (the
    operator/scale-down path)."""

    at_s: float = 0.0
    pool: str = "decode"
    mode: str = "kill"

    def validate(self) -> None:
        if self.mode not in ("kill", "drain"):
            raise ValueError(
                f"worker kill mode must be kill|drain, got {self.mode!r}"
            )


@dataclass
class MigrationEvent:
    """Migrate up to ``count`` live decode sessions at a phase-relative
    simulated time — the runner walks the dispatcher's migration registry
    and asks the coordinator to move each one to its cheapest-hop healthy
    destination (runtime/migration.py).  ``reason`` other than "manual"
    also authorizes DCN-hop destinations, mirroring ``dynctl migrate``."""

    at_s: float = 0.0
    count: int = 1
    reason: str = "manual"

    def validate(self) -> None:
        if self.count <= 0:
            raise ValueError("migration event needs count > 0")


@dataclass
class PhaseAssertions:
    """What must hold when the phase drains.  Burn-rate ceilings are
    evaluated on PHASE-LOCAL counts ((bad/total)/budget over exactly the
    phase's observations), so one phase's damage cannot fail its neighbor.
    Zero/empty disables a check."""

    max_burn_rate: dict = field(default_factory=dict)  # objective → ceiling
    min_goodput_tok_s: float = 0.0   # mean fleet goodput over phase ticks
    min_mfu: float = 0.0             # mean fleet MFU over phase ticks
    min_completed: int = 0
    # topology-aware routing (fleet.slices): floor on the fraction of this
    # phase's KV-router selections that landed on a worker in the NEAR
    # slice (the prefill pool's slice) — the multi-slice soak's proof that
    # discovered link classes steer decode selection
    min_near_slice_fraction: float = 0.0
    # live migration: floor on sessions COMMITTED to a new worker during
    # this phase (migration events, drain integration, or planner defrag)
    min_migrations_committed: int = 0
    # ceiling on client-visible failed requests; -1 disables the check
    # (0 demands the migration soak's hard "zero failed requests")
    max_failed: int = -1


@dataclass
class Phase:
    name: str = "phase"
    duration_s: float = 10.0         # simulated seconds
    traffic: TrafficShape = field(default_factory=TrafficShape)
    faults: list = field(default_factory=list)        # [FaultEvent]
    worker_kills: list = field(default_factory=list)  # [WorkerKillEvent]
    migrations: list = field(default_factory=list)    # [MigrationEvent]
    assertions: PhaseAssertions = field(default_factory=PhaseAssertions)

    def validate(self) -> None:
        if self.duration_s <= 0:
            raise ValueError(f"phase {self.name!r}: duration_s must be > 0")
        self.traffic.validate()
        for ev in self.faults:
            ev.validate()
        for ev in self.worker_kills:
            ev.validate()
        for ev in self.migrations:
            ev.validate()


@dataclass
class SloSpec:
    """Maps onto observability/slo.SloConfig — thresholds in SIMULATED
    seconds (the runner feeds the tracker a simulated clock)."""

    ttft_s: float = 0.5
    ttft_target: float = 0.9
    itl_s: float = 0.1
    itl_target: float = 0.9
    error_target: float = 0.99
    windows_s: list = field(default_factory=lambda: [5.0, 20.0])
    shed_burn: float = 0.0


@dataclass
class FleetSpec:
    """The fleet under test: named pools served on one endpoint."""

    pools: dict = field(default_factory=lambda: {"prefill": 1, "decode": 1})
    policy: str = "kv"               # "kv" (KV-affine) or "random"
    block_size: int = 16
    num_blocks: int = 512
    max_batch_size: int = 8
    metrics_period_s: float = 0.25   # simulated seconds
    mocker: dict = field(default_factory=dict)   # MockerConfig overrides
    # "mocker" (cost-model sim — how scenarios usually run) or "torch": REAL
    # TorchLlmEngine workers stepping the actual model/scheduler/allocator
    # hot path.  torch mode requires the scenario's speedup to be 1.0 — real
    # engines serve in real time, so compressed arrivals would soak the
    # queue, not the system (same rule as bench.routed_fleet.FleetConfig).
    engine: str = "mocker"
    # torch mode: engine context window; size it to the workload's longest
    # prompt+generation (bucket ladder tops out here)
    max_model_len: int = 512
    # emulated multi-slice placement: pool → list of slice labels assigned
    # round-robin to that pool's workers (published as TopologyCards, so the
    # fleet's KV router discovers the link classes).  Empty = single slice
    # (the topology plane sees an all-local map and changes nothing).
    slices: dict = field(default_factory=dict)
    # mocker-side per-pair latency: hop class → extra simulated seconds each
    # prefill pays on a worker behind that link (the KV-transfer bill a far
    # slice really pays; see MockerConfig.transfer_delay_s)
    link_delay_s: dict = field(default_factory=dict)

    def validate(self) -> None:
        if self.policy not in ("kv", "random"):
            raise ValueError(f"fleet policy must be kv|random, got {self.policy!r}")
        if self.engine not in FLEET_ENGINES:
            raise ValueError(
                f"fleet engine must be mocker|torch, got {self.engine!r}"
            )
        if not self.pools or any(n < 0 for n in self.pools.values()):
            raise ValueError("fleet pools must map name → replicas >= 0")
        if any(not labels for labels in self.slices.values()):
            raise ValueError("fleet slices must map pool → non-empty label list")
        bad = set(self.link_delay_s) - {"local", "ici", "dcn"}
        if bad:
            raise ValueError(f"link_delay_s keys must be hop classes, got {sorted(bad)}")


@dataclass
class AutopilotSpec:
    """Planner knobs for the soak (simulated seconds); ``profile`` is the
    optimistic bootstrap PerfProfile — deliberately generous, so any
    mid-soak scale-up is attributable to burn/SLA evidence, not to the
    demand math alone."""

    enabled: bool = True
    interval_s: float = 2.0
    min_prefill: int = 1
    max_prefill: int = 4
    min_decode: int = 1
    max_decode: int = 4
    max_total_chips: int = 8
    burn_upscale: float = 1.0
    burn_hold: float = 0.25
    cooldown_s: float = 6.0
    rebalance: bool = True
    rebalance_occupancy: float = 0.5
    saturation_occupancy: float = 0.8
    scale_down_headroom: float = 1.3
    # bootstrap profile (per-replica): high throughput + low latency means
    # "the current fleet should be fine" until reality disagrees
    profile: dict = field(default_factory=lambda: {
        "prefill_tok_s": 50_000.0, "decode_tok_s": 5_000.0,
        "ttft_s": 0.02, "itl_s": 0.01,
    })
    # acceptance: the soak summary fails unless at least one executed
    # decision was burn/SLA-driven (reason beyond plain "load")
    expect_decision: bool = False
    # planner-driven defragmentation (planner/defrag.py): stepped on the
    # autopilot interval against per-worker KV occupancy, it migrates live
    # sessions off hot workers through the dispatcher's migration
    # coordinator (bounded rate, cooldown, never cross-slice)
    defrag: bool = False
    defrag_spread: float = 0.25
    defrag_min_occupancy: float = 0.5
    defrag_max_per_step: int = 1
    defrag_cooldown_s: float = 8.0


@dataclass
class ScenarioSpec:
    name: str = "scenario"
    seed: int = 0
    speedup: float = 8.0             # sim-time compression (mocker-style)
    tick_s: float = 1.0              # sampling cadence, simulated seconds
    drain_s: float = 10.0            # post-phase drain budget, simulated
    retry_max: int = 2               # runner-side pre-first-token retries
    # check every completed request's streamed tokens against the mocker's
    # deterministic chain — the migration soak's "byte-identical output vs
    # an unmigrated greedy reference" proof (any corruption fails the phase)
    verify_outputs: bool = False
    slo: SloSpec = field(default_factory=SloSpec)
    fleet: FleetSpec = field(default_factory=FleetSpec)
    autopilot: AutopilotSpec = field(default_factory=AutopilotSpec)
    phases: list = field(default_factory=list)        # [Phase]

    def validate(self) -> "ScenarioSpec":
        if not self.phases:
            raise ValueError("scenario needs at least one phase")
        if self.speedup <= 0 or self.tick_s <= 0:
            raise ValueError("speedup and tick_s must be > 0")
        self.fleet.validate()
        if self.fleet.engine == "torch" and self.speedup != 1.0:
            raise ValueError(
                "fleet.engine='torch' requires speedup=1.0: real engines serve "
                "in real time, so compressed arrivals measure queue depth "
                "instead of the system under test"
            )
        names = [p.name for p in self.phases]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate phase names: {names}")
        for p in self.phases:
            p.validate()
        return self

    # -- JSON ---------------------------------------------------------------
    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "ScenarioSpec":
        def _build(dc, payload, casts=None):
            known = dc.__dataclass_fields__
            kwargs = {k: v for k, v in (payload or {}).items() if k in known}
            unknown = set(payload or {}) - set(known)
            if unknown:
                raise ValueError(
                    f"{dc.__name__}: unknown spec keys {sorted(unknown)}"
                )
            for key, fn in (casts or {}).items():
                if key in kwargs:
                    kwargs[key] = fn(kwargs[key])
            return dc(**kwargs)

        phases = [
            _build(
                Phase, p,
                casts={
                    "traffic": lambda t: _build(TrafficShape, t),
                    "faults": lambda fs: [_build(FaultEvent, f) for f in fs],
                    "worker_kills": lambda ks: [
                        _build(WorkerKillEvent, k) for k in ks
                    ],
                    "migrations": lambda ms: [
                        _build(MigrationEvent, m) for m in ms
                    ],
                    "assertions": lambda a: _build(PhaseAssertions, a),
                },
            )
            for p in data.get("phases", [])
        ]
        spec = _build(
            ScenarioSpec, data,
            casts={
                "slo": lambda s: _build(SloSpec, s),
                "fleet": lambda f: _build(FleetSpec, f),
                "autopilot": lambda a: _build(AutopilotSpec, a),
                "phases": lambda _: phases,
            },
        )
        return spec.validate()

    @classmethod
    def load(cls, path: str | Path) -> "ScenarioSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str | Path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
            f.write("\n")


def builtin_spec_path(name: str) -> Path:
    """Path of a spec shipped with the package (``specs/<name>.json``)."""
    return Path(__file__).parent / "specs" / f"{name}.json"
