"""Perf flight recorder: an always-on, bounded ring of per-step telemetry.

Every engine keeps a :class:`FlightRecorder` — a byte-budgeted ring buffer of
per-step telemetry (token counts, batch occupancy, KV usage, MFU/goodput),
SLO burn-rate samples, and discrete events (preemptions, drains, migrations,
injected faults, unified-batch fallbacks) stamped with monotonic timestamps.
The ring costs one dict append per step while everything is healthy; when
something goes wrong the last N seconds of engine behavior are already in
memory and get dumped to JSONL:

- on demand       — ``dynctl flight dump`` (the ingress ``flight_dump`` ctl op)
- on burn breach  — worst-window SLO burn rate above ``DYN_FLIGHT_BURN``
- on worker crash — a ``spawn_logged`` task died with a real exception
- on drain        — the ingress drain state machine started

Dump files are JSONL: one header object (schema version, source, reason,
record count) followed by one record per line, written under
``DYN_FLIGHT_DIR`` (default ``$DYN_CACHE_DIR/flight``).  The planner's load
predictors re-fit from these dumps (``load_predictor.replay_trace``) so
capacity can pre-position ahead of recorded diurnal crests, and
``dyn_top --flight`` tails the newest one.

``DYN_FLIGHT=0`` is bookkeeping-free: the recorder stores nothing, every
``record_*`` call early-returns before touching the ring, and hot paths are
expected to guard with ``if recorder.enabled:`` so not even the kwargs dict
is built.

Summary counters are exposed as ``dyn_flight_*`` on both metric surfaces:
:func:`render` appends a text exposition to the frontend ``/metrics`` body
(like the resilience counters) and the engine merges :meth:`stats` keys into
its ``stats()`` dict, which the metrics service mirrors as worker-labeled
gauges.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import weakref
from collections import deque
from pathlib import Path
from typing import Any, Callable

from dynamo_tpu_torch.utils import knobs
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("observability.flight")

FLIGHT_SCHEMA_VERSION = 1

# discrete-event taxonomy (docs/observability.md); record_event accepts any
# of these (and tolerates new ones — the dump format is self-describing)
EVENT_KINDS = (
    "preemption",          # scheduler victimized a running sequence
    "drain",               # ingress drain state machine started
    "migration",           # live session migration started/committed/aborted
    "fault",               # chaos fault injected (DYN_FAULTS)
    "unified_fallback",    # unified-batch step fell back to split phases
    "step_error",          # engine step raised
    "crash",               # a spawn_logged task died with a real exception
    "burn_breach",         # worst-window SLO burn crossed DYN_FLIGHT_BURN
)

# min seconds between AUTOMATIC dumps for the same reason — a burn storm or
# crash loop must not turn the flight recorder into a disk-filling hazard
DUMP_COOLDOWN_S = 30.0

_REGISTRY: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()
_registry_lock = threading.Lock()


def flight_enabled() -> bool:
    """The master gate (``DYN_FLIGHT``)."""
    return bool(knobs.get(knobs.K_FLIGHT))


def flight_dir() -> Path:
    """Directory dumps land in (``DYN_FLIGHT_DIR`` > ``DYN_CACHE_DIR/flight``)."""
    explicit = knobs.get(knobs.K_FLIGHT_DIR)
    if explicit:
        return Path(explicit).expanduser()
    cache = knobs.get(knobs.K_CACHE_DIR)
    base = Path(cache).expanduser() if cache else Path.home() / ".cache" / "dynamo_tpu_torch"
    return base / "flight"


def latest_dump(directory: str | os.PathLike | None = None) -> Path | None:
    """Newest flight dump in ``directory`` (default :func:`flight_dir`)."""
    root = Path(directory) if directory is not None else flight_dir()
    try:
        dumps = sorted(root.glob("flight-*.jsonl"), key=lambda p: p.stat().st_mtime)
    except OSError:
        return None
    return dumps[-1] if dumps else None


def load_dump(path: str | os.PathLike) -> tuple[dict, list[dict]]:
    """(header, records) of one JSONL flight dump."""
    header: dict = {}
    records: list[dict] = []
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if i == 0 and "schema_version" in obj:
                header = obj
            else:
                records.append(obj)
    return header, records


class FlightRecorder:
    """Byte-budgeted ring of telemetry records with JSONL dump-on-trigger.

    Thread-safe: the engine's device thread appends steps while asyncio-side
    triggers (ctl ops, crash callbacks) read and dump.
    """

    def __init__(
        self,
        *,
        source: str = "engine",
        capacity_bytes: int | None = None,
        enabled: bool | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.source = source
        self.enabled = flight_enabled() if enabled is None else bool(enabled)
        if capacity_bytes is None:
            capacity_bytes = int(knobs.get(knobs.K_FLIGHT_BUFFER_BYTES))
        self.capacity_bytes = max(int(capacity_bytes), 0)
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque[tuple[int, dict]] = deque()  # (encoded size, record)
        self.buffer_bytes = 0
        self.records_total = 0
        self.dropped_total = 0
        self.dumps_total = 0
        self.last_dump_reason = ""
        self.last_dump_path: str | None = None
        self._last_auto_dump: dict[str, float] = {}  # reason -> monotonic t
        if self.enabled:
            with _registry_lock:
                _REGISTRY.add(self)

    # -- recording -----------------------------------------------------------

    def _append(self, record: dict) -> None:
        size = len(json.dumps(record, separators=(",", ":"), default=str))
        with self._lock:
            if size > self.capacity_bytes:
                # a single record bigger than the whole budget can never fit
                self.dropped_total += 1
                return
            while self._ring and self.buffer_bytes + size > self.capacity_bytes:
                evicted_size, _ = self._ring.popleft()
                self.buffer_bytes -= evicted_size
                self.dropped_total += 1
            self._ring.append((size, record))
            self.buffer_bytes += size
            self.records_total += 1

    def record_step(self, **fields: Any) -> None:
        """One engine step.  Hot path — callers guard with ``if rec.enabled:``
        so the kwargs dict is never built when the recorder is off."""
        if not self.enabled:
            return
        self._append({"kind": "step", "t": self._clock(), **fields})

    def record_burn(self, objective: str, burn_rate: float, window_s: float) -> None:
        if not self.enabled:
            return
        self._append({
            "kind": "burn", "t": self._clock(),
            "objective": objective, "burn_rate": burn_rate, "window_s": window_s,
        })

    def record_event(self, event: str, **fields: Any) -> None:
        if not self.enabled:
            return
        self._append({"kind": "event", "t": self._clock(), "event": event, **fields})

    # -- introspection -------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def records(self) -> list[dict]:
        with self._lock:
            return [rec for _, rec in self._ring]

    def occupancy(self) -> float:
        """Ring fullness (bytes used / budget) — the dyn_top FLIGHT column."""
        if not self.capacity_bytes:
            return 0.0
        with self._lock:
            return self.buffer_bytes / self.capacity_bytes

    def stats(self) -> dict:
        """``flight_*`` keys merged into engine ``stats()`` (metrics service
        mirrors them as ``dyn_flight_*`` worker gauges)."""
        with self._lock:
            return {
                "flight_records_total": self.records_total,
                "flight_dropped_total": self.dropped_total,
                "flight_dumps_total": self.dumps_total,
                "flight_buffer_bytes": self.buffer_bytes,
                "flight_last_dump_reason": self.last_dump_reason,
            }

    # -- dumping -------------------------------------------------------------

    def dump(self, reason: str, path: str | os.PathLike | None = None) -> Path | None:
        """Write the ring to a JSONL file; returns the path (None when the
        recorder is disabled).  The ring is NOT cleared — a later, worse
        trigger still sees the full window."""
        if not self.enabled:
            return None
        with self._lock:
            records = [rec for _, rec in self._ring]
            self.dumps_total += 1
            seq = self.dumps_total
            self.last_dump_reason = reason
        if path is None:
            safe_reason = re.sub(r"[^a-z0-9_]+", "-", reason.lower()).strip("-") or "manual"
            directory = flight_dir()
            path = directory / (
                f"flight-{self.source}-{os.getpid()}-{seq:03d}-{safe_reason}.jsonl"
            )
        path = Path(path)
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                header = {
                    "schema_version": FLIGHT_SCHEMA_VERSION,
                    "source": self.source,
                    "reason": reason,
                    "records": len(records),
                    "dumped_at": time.time(),
                }
                f.write(json.dumps(header, separators=(",", ":")) + "\n")
                for rec in records:
                    f.write(json.dumps(rec, separators=(",", ":"), default=str) + "\n")
        except OSError as exc:
            logger.warning("flight dump to %s failed: %s", path, exc)
            return None
        self.last_dump_path = str(path)
        logger.info("flight recorder dumped %d records to %s (reason=%s)",
                    len(records), path, reason)
        return path

    def maybe_dump(self, reason: str) -> Path | None:
        """Automatic-trigger dump, rate-limited per reason (burn storms and
        crash loops must not fill the disk)."""
        if not self.enabled:
            return None
        now = time.monotonic()
        last = self._last_auto_dump.get(reason, 0.0)
        if now - last < DUMP_COOLDOWN_S:
            return None
        self._last_auto_dump[reason] = now
        return self.dump(reason)


# -- process-wide helpers (crash/burn hooks, aggregate exposition) -----------


def recorders() -> tuple[FlightRecorder, ...]:
    with _registry_lock:
        return tuple(_REGISTRY)


def dump_all(reason: str, *, force: bool = True) -> list[Path]:
    """Dump every live recorder in the process; returns the paths written."""
    paths = []
    for rec in recorders():
        path = rec.dump(reason) if force else rec.maybe_dump(reason)
        if path is not None:
            paths.append(path)
    return paths


def dump_all_on_drain(**fields: Any) -> list[Path]:
    """Drain hook (ingress state machine): record the drain event on every
    live recorder and dump the pre-drain window (rate-limited)."""
    if not flight_enabled():
        return []
    paths = []
    for rec in recorders():
        rec.record_event("drain", **fields)
        path = rec.maybe_dump("drain")
        if path is not None:
            paths.append(path)
    return paths


def on_task_crash(name: str, exc: BaseException) -> None:
    """Crash hook called from the ``spawn_logged`` done-callback: record the
    crash on every live recorder and dump them (rate-limited)."""
    if not flight_enabled():
        return
    for rec in recorders():
        rec.record_event("crash", task=name, error=f"{type(exc).__name__}: {exc}")
        rec.maybe_dump("crash")


_BURN_CHECK_PERIOD_S = 1.0
_last_burn_check = 0.0
_burn_lock = threading.Lock()


def check_burn(slo_tracker, now: float | None = None) -> bool:
    """Burn-breach trigger, called per finished request from the frontend:
    when the worst-window burn rate crosses ``DYN_FLIGHT_BURN``, record a
    burn sample on every recorder and auto-dump.  Rate-limited to one check
    per second (``worst_burn_rate`` memoizes on the same cadence)."""
    threshold = float(knobs.get(knobs.K_FLIGHT_BURN))
    if threshold <= 0 or not flight_enabled():
        return False
    global _last_burn_check
    wall = time.monotonic()
    with _burn_lock:
        if wall - _last_burn_check < _BURN_CHECK_PERIOD_S:
            return False
        _last_burn_check = wall
    worst = slo_tracker.worst_burn_rate(now)
    if worst <= threshold:
        return False
    for rec in recorders():
        rec.record_burn("worst", worst, 0.0)
        rec.maybe_dump("burn_breach")
    return True


def render() -> bytes:
    """Prometheus text exposition of the aggregate ``dyn_flight_*`` families,
    appended to the frontend ``/metrics`` body (like the resilience
    counters).  Families are always declared — zeros when no recorder is
    live — so dashboards and check_metrics see a stable surface."""
    totals = {"records": 0, "dropped": 0, "dumps": 0, "buffer": 0}
    for rec in recorders():
        s = rec.stats()
        totals["records"] += s["flight_records_total"]
        totals["dropped"] += s["flight_dropped_total"]
        totals["dumps"] += s["flight_dumps_total"]
        totals["buffer"] += s["flight_buffer_bytes"]
    lines = [
        "# HELP dyn_flight_records_total Flight-recorder records captured",
        "# TYPE dyn_flight_records_total counter",
        f"dyn_flight_records_total {totals['records']}",
        "# HELP dyn_flight_dropped_total Flight-recorder records evicted over the byte budget",
        "# TYPE dyn_flight_dropped_total counter",
        f"dyn_flight_dropped_total {totals['dropped']}",
        "# HELP dyn_flight_dumps_total Flight-recorder JSONL dumps written",
        "# TYPE dyn_flight_dumps_total counter",
        f"dyn_flight_dumps_total {totals['dumps']}",
        "# HELP dyn_flight_buffer_bytes Flight-recorder ring occupancy in bytes",
        "# TYPE dyn_flight_buffer_bytes gauge",
        f"dyn_flight_buffer_bytes {totals['buffer']}",
        "",
    ]
    return "\n".join(lines).encode()
