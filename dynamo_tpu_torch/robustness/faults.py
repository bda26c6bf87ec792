"""Deterministic fault injection at the runtime's seams.

A process-global registry of named *fault points* checked inline on the
paths that matter for self-healing — control-plane RPC send/recv, data-plane
connect-back and mid-stream writes, KV transfer, engine step, prefill
dequeue.  Unarmed, a check is a dict lookup on an empty dict; armed, a
triggered check raises the configured exception with an ``injected fault``
marker in the message so chaos runs are diagnosable from logs alone.

Arming (``DYN_FAULTS`` env var or :meth:`FaultRegistry.arm`):

    DYN_FAULTS="cp.recv:once;worker.generate:nth=2;dp.send:prob=0.05:seed=7"

Grammar: ``;``-separated entries of ``point:trigger[:opt=val...]``.

Triggers (all deterministic — chaos tests are ordinary pytest):

- ``once``    — fire on the first check of the point, then disarm
- ``nth=N``   — fire on exactly the Nth check (1-based), then disarm
- ``every=N`` — fire on every Nth check
- ``prob=P``  — fire with probability P per check, from a seeded RNG
                (``seed=S`` option, default 0) so a given schedule replays
                identically

Options: ``exc=Name`` picks the raised type from :data:`EXCEPTIONS`
(default ``ConnectionError``); ``times=K`` caps total fires for
``every``/``prob`` triggers.
"""

from __future__ import annotations

import os
import random
import threading

from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils import knobs

logger = get_logger("robustness.faults")

# The canonical fault-point names (call sites reference these constants so
# a typo is an import error, not a silently-never-firing fault).
CP_SEND = "cp.send"                  # control-plane RPC about to be written
CP_RECV = "cp.recv"                  # control-plane frame just received
DP_CONNECT = "dp.connect"            # worker data-plane connect-back dial
DP_SEND = "dp.send"                  # worker mid-stream response write
WORKER_GENERATE = "worker.generate"  # ingress handing a request to its engine
ENGINE_STEP = "engine.step"          # engine device-loop iteration
PREFILL_DEQUEUE = "prefill.dequeue"  # disagg prefill worker queue pop
KV_TRANSFER = "kv.transfer"          # disagg KV block shipment
MIGRATE_HANDOFF = "migrate.handoff"  # migration snapshot/KV-stream/pre-admit
MIGRATE_FLIP = "migrate.flip"        # migration stream flip about to commit

EXCEPTIONS: dict[str, type[BaseException]] = {
    "ConnectionError": ConnectionError,
    "ConnectionResetError": ConnectionResetError,
    "TimeoutError": TimeoutError,
    "OSError": OSError,
    "RuntimeError": RuntimeError,
}


class FaultSpec:
    """One armed fault point: trigger state + exception to raise."""

    def __init__(self, point: str, trigger: str, opts: dict[str, str]):
        self.point = point
        self.trigger = trigger
        self.exc_type = EXCEPTIONS[opts.get("exc", "ConnectionError")]
        self.checks = 0
        self.fires = 0
        self.max_fires = int(opts["times"]) if "times" in opts else None
        self.nth = 0
        self.every = 0
        self.prob = 0.0
        self._rng: random.Random | None = None
        if trigger == "once":
            self.nth = 1
        elif trigger.startswith("nth="):
            self.nth = int(trigger[4:])
            if self.nth < 1:
                raise ValueError(f"nth must be >= 1 in fault {point!r}")
        elif trigger.startswith("every="):
            self.every = int(trigger[6:])
            if self.every < 1:
                raise ValueError(f"every must be >= 1 in fault {point!r}")
        elif trigger.startswith("prob="):
            self.prob = float(trigger[5:])
            self._rng = random.Random(int(opts.get("seed", "0")))
        else:
            raise ValueError(f"unknown fault trigger {trigger!r} for {point!r}")

    @property
    def spent(self) -> bool:
        """True once this spec can never fire again (prune it)."""
        if self.nth:
            return self.fires > 0 or self.checks >= self.nth
        return self.max_fires is not None and self.fires >= self.max_fires

    def should_fire(self) -> bool:
        self.checks += 1
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.nth:
            return self.checks == self.nth and self.fires == 0
        if self.every:
            return self.checks % self.every == 0
        assert self._rng is not None
        return self._rng.random() < self.prob


def parse_faults(schedule: str) -> list[FaultSpec]:
    """Parse a ``DYN_FAULTS`` schedule string into specs."""
    specs = []
    for raw in schedule.replace(",", ";").split(";"):
        entry = raw.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"bad fault entry {entry!r} (want point:trigger[:opt=val...])"
            )
        point, trigger = parts[0], parts[1]
        opts: dict[str, str] = {}
        for opt in parts[2:]:
            key, _, value = opt.partition("=")
            if not value:
                raise ValueError(f"bad fault option {opt!r} in {entry!r}")
            opts[key] = value
        specs.append(FaultSpec(point, trigger, opts))
    return specs


class FaultRegistry:
    """Thread-safe registry; the engine device thread checks it too."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._specs: dict[str, list[FaultSpec]] = {}
        self.fired: dict[str, int] = {}

    @property
    def armed(self) -> bool:
        return bool(self._specs)

    def arm(self, schedule: str) -> None:
        """Arm (additively) every entry of a schedule string."""
        for spec in parse_faults(schedule):
            with self._lock:
                self._specs.setdefault(spec.point, []).append(spec)

    def arm_from_env(self) -> None:
        schedule = knobs.get("DYN_FAULTS")
        if schedule:
            self.arm(schedule)

    def reset(self) -> None:
        with self._lock:
            self._specs.clear()
            self.fired.clear()

    def check(self, point: str, **attrs) -> None:
        """Raise iff an armed spec for ``point`` triggers.  The no-fault
        path is one dict lookup — cheap enough for per-frame call sites."""
        specs = self._specs.get(point)
        if not specs:
            return
        with self._lock:
            fire: FaultSpec | None = None
            for spec in specs:
                if spec.should_fire():
                    fire = spec
                    break
            if fire is not None:
                fire.fires += 1
                self.fired[point] = self.fired.get(point, 0) + 1
            # prune spent specs so disarmed points return to the fast path
            live = [s for s in specs if not s.spent]
            if live:
                self._specs[point] = live
            else:
                self._specs.pop(point, None)
            if fire is None:
                return
        counters.incr("dyn_faults_injected_total")
        detail = "".join(f" {k}={v}" for k, v in attrs.items())
        logger.warning("injected fault at %s (#%d)%s", point, self.fired[point], detail)
        try:
            # flight recorder: injected faults are exactly the discrete
            # events a post-mortem wants time-aligned with step telemetry.
            # Lazy import (faults sits below observability in the graph).
            from dynamo_tpu_torch.observability import flight

            for rec in flight.recorders():
                rec.record_event("fault", point=point, fire=self.fired[point])
        except Exception:  # noqa: BLE001 — never mask the injected fault
            pass
        raise fire.exc_type(f"injected fault at {point} (#{self.fired[point]})")


# Process-global registry, armed from DYN_FAULTS at import (tests arm/reset
# it directly).
FAULTS = FaultRegistry()
FAULTS.arm_from_env()


def get_faults() -> FaultRegistry:
    return FAULTS
