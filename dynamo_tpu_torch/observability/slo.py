"""SLO layer over the frontend's latency/error stream: burn-rate tracking.

An SLO here is "at least ``target`` of observations are good", where good
means TTFT/ITL under a threshold or a request finishing without server
error.  The tracker keeps per-second good/bad buckets and computes the
Google-SRE **burn rate** over multiple windows:

    burn_rate = observed_bad_fraction / error_budget      (budget = 1 - target)

Burn rate 1.0 = exactly consuming the budget; 14.4 over 5 minutes is the
classic "page now" threshold.  Multi-window (default 5m + 1h) separates a
transient blip from a sustained burn.

Configuration (all optional — defaults give a working SLO plane out of the
box so ``dyn_slo_*`` families are always present):

- ``DYN_SLO_TTFT_S`` (default 2.0) / ``DYN_SLO_TTFT_TARGET`` (default 0.99)
- ``DYN_SLO_ITL_S`` (default 0.2) / ``DYN_SLO_ITL_TARGET`` (default 0.99)
- ``DYN_SLO_ERROR_TARGET`` (default 0.999) — request success-rate objective
- ``DYN_SLO_WINDOWS`` (default ``300,3600``) — comma-separated seconds
- ``DYN_SLO_SHED_BURN`` (default 0 = off) — burn-rate threshold above which
  frontend admission control (dynamo_tpu/robustness/admission.py) sheds
  instead of queueing

The HTTP frontend feeds it from the metric guards (llm/http/metrics.py),
renders :meth:`SloTracker.render` onto ``/metrics``, and serves
:meth:`SloTracker.status` as JSON on ``/slo``.
"""

from __future__ import annotations

import os
import threading
import time
from dynamo_tpu_torch.utils import knobs
from dataclasses import dataclass, field

DEFAULT_WINDOWS_S = (300.0, 3600.0)
# per-second buckets are pruned past the longest window; cap the worst case
_MAX_SPAN_S = 2 * 3600


@dataclass(frozen=True)
class SloObjective:
    name: str                       # "ttft" | "itl" | "error_rate" | custom
    target: float                   # good fraction, e.g. 0.99
    threshold_s: float | None = None  # latency objectives: good iff <= this

    @property
    def error_budget(self) -> float:
        return max(1.0 - self.target, 1e-9)


@dataclass
class SloConfig:
    objectives: tuple[SloObjective, ...] = ()
    windows_s: tuple[float, ...] = DEFAULT_WINDOWS_S
    shed_burn_threshold: float = 0.0

    @classmethod
    def from_env(cls) -> "SloConfig":
        objectives = (
            SloObjective("ttft", knobs.get("DYN_SLO_TTFT_TARGET"),
                         threshold_s=knobs.get("DYN_SLO_TTFT_S")),
            SloObjective("itl", knobs.get("DYN_SLO_ITL_TARGET"),
                         threshold_s=knobs.get("DYN_SLO_ITL_S")),
            SloObjective("error_rate", knobs.get("DYN_SLO_ERROR_TARGET")),
        )
        raw = knobs.get("DYN_SLO_WINDOWS")
        windows: list[float] = []
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                w = float(part)
            except ValueError:
                continue
            if w > 0:
                windows.append(min(w, _MAX_SPAN_S))
        return cls(
            objectives=objectives,
            windows_s=tuple(windows) or DEFAULT_WINDOWS_S,
            shed_burn_threshold=knobs.get("DYN_SLO_SHED_BURN"),
        )


@dataclass
class _Counts:
    good: int = 0
    bad: int = 0


class SloTracker:
    """Per-second good/bad buckets per objective + burn-rate math.

    Thread-safe (a lock around the bucket maps): observations come from the
    frontend event loop, reads from /metrics scrapes and the admission
    gate."""

    def __init__(self, config: SloConfig | None = None):
        self.config = config or SloConfig.from_env()
        self._by_objective = {o.name: o for o in self.config.objectives}
        self._buckets: dict[str, dict[int, _Counts]] = {
            o.name: {} for o in self.config.objectives
        }
        self._totals: dict[str, _Counts] = {
            o.name: _Counts() for o in self.config.objectives
        }
        longest = max(self.config.windows_s, default=300.0)
        self._span_s = min(max(longest, 1.0), _MAX_SPAN_S)
        self._lock = threading.Lock()
        # worst_burn_rate() memo for the admission hot path (see below)
        self._worst_cache: tuple[float, float] = (-1e18, 0.0)

    # -- feeding -----------------------------------------------------------
    def observe_latency(self, objective: str, seconds: float,
                        now: float | None = None) -> None:
        obj = self._by_objective.get(objective)
        if obj is None or obj.threshold_s is None:
            return
        self._observe(objective, seconds <= obj.threshold_s, now)

    def observe_outcome(self, objective: str, good: bool,
                        now: float | None = None) -> None:
        if objective in self._by_objective:
            self._observe(objective, good, now)

    def _observe(self, objective: str, good: bool, now: float | None) -> None:
        t = int(time.time() if now is None else now)
        with self._lock:
            buckets = self._buckets[objective]
            counts = buckets.setdefault(t, _Counts())
            totals = self._totals[objective]
            if good:
                counts.good += 1
                totals.good += 1
            else:
                counts.bad += 1
                totals.bad += 1
            # prune: drop seconds no window can see anymore
            horizon = t - int(self._span_s) - 1
            if len(buckets) > self._span_s + 2:
                for sec in [s for s in buckets if s < horizon]:
                    del buckets[sec]

    # -- querying ----------------------------------------------------------
    def _window_counts(self, objective: str, window_s: float,
                       now: float | None = None) -> _Counts:
        t = time.time() if now is None else now
        horizon = int(t - window_s)
        out = _Counts()
        with self._lock:
            for sec, counts in self._buckets.get(objective, {}).items():
                if sec > horizon:
                    out.good += counts.good
                    out.bad += counts.bad
        return out

    def burn_rate(self, objective: str, window_s: float,
                  now: float | None = None) -> float:
        """bad_fraction / error_budget over the window (0.0 when no traffic:
        an idle service is not burning budget)."""
        obj = self._by_objective.get(objective)
        if obj is None:
            return 0.0
        counts = self._window_counts(objective, window_s, now)
        total = counts.good + counts.bad
        if not total:
            return 0.0
        return (counts.bad / total) / obj.error_budget

    def worst_burn_rate(self, now: float | None = None) -> float:
        """Max burn rate across every objective over the SHORTEST window —
        the admission-control signal: sheds should react to the fast window,
        not wait out the hour.

        Computing it scans every per-second bucket, and the admission gate
        consults it per saturated request — exactly when the frontend is
        busiest — so wall-clock calls (``now=None``) are memoized for 1s.
        An explicit ``now`` bypasses the cache (tests, /slo snapshots)."""
        if not self.config.objectives or not self.config.windows_s:
            return 0.0
        use_cache = now is None
        if use_cache:
            now = time.time()
            cached_at, cached = self._worst_cache
            if now - cached_at < 1.0:
                return cached
        window = min(self.config.windows_s)
        worst = max(
            self.burn_rate(o.name, window, now) for o in self.config.objectives
        )
        if use_cache:
            self._worst_cache = (now, worst)
        return worst

    def status(self, now: float | None = None) -> dict:
        """The ``/slo`` endpoint payload."""
        t = time.time() if now is None else now
        objectives = {}
        for o in self.config.objectives:
            windows = {}
            for w in self.config.windows_s:
                counts = self._window_counts(o.name, w, t)
                total = counts.good + counts.bad
                windows[str(int(w))] = {
                    "good": counts.good,
                    "bad": counts.bad,
                    "bad_fraction": (counts.bad / total) if total else 0.0,
                    "burn_rate": self.burn_rate(o.name, w, t),
                }
            with self._lock:
                totals = self._totals[o.name]
                good_total, bad_total = totals.good, totals.bad
            objectives[o.name] = {
                "target": o.target,
                "threshold_s": o.threshold_s,
                "error_budget": o.error_budget,
                "good_total": good_total,
                "bad_total": bad_total,
                "windows": windows,
                # per-objective worst window: the planner's burn-rate input
                # (planner.burn_rates_from_slo) — which objective burns
                # decides WHICH pool the autopilot grows
                "worst_burn_rate": max(
                    (w["burn_rate"] for w in windows.values()), default=0.0
                ),
            }
        return {
            "objectives": objectives,
            "windows_s": list(self.config.windows_s),
            "worst_burn_rate": self.worst_burn_rate(t),
            "shed_burn_threshold": self.config.shed_burn_threshold,
        }

    # -- exposition --------------------------------------------------------
    def render(self, now: float | None = None) -> bytes:
        """Prometheus text exposition of the ``dyn_slo_*`` families (appended
        to the frontend's /metrics body, like the resilience counters)."""
        lines = [
            "# HELP dyn_slo_burn_rate_ratio SLO burn rate (bad fraction / error budget) per objective and window",
            "# TYPE dyn_slo_burn_rate_ratio gauge",
        ]
        for o in self.config.objectives:
            for w in self.config.windows_s:
                lines.append(
                    f'dyn_slo_burn_rate_ratio{{objective="{o.name}",window="{int(w)}"}} '
                    f"{self.burn_rate(o.name, w, now):.6g}"
                )
        lines += [
            "# HELP dyn_slo_good_total Observations meeting the SLO objective",
            "# TYPE dyn_slo_good_total counter",
        ]
        with self._lock:
            totals = {name: (c.good, c.bad) for name, c in self._totals.items()}
        for o in self.config.objectives:
            lines.append(f'dyn_slo_good_total{{objective="{o.name}"}} {totals[o.name][0]}')
        lines += [
            "# HELP dyn_slo_bad_total Observations violating the SLO objective",
            "# TYPE dyn_slo_bad_total counter",
        ]
        for o in self.config.objectives:
            lines.append(f'dyn_slo_bad_total{{objective="{o.name}"}} {totals[o.name][1]}')
        lines += [
            "# HELP dyn_slo_threshold_seconds Latency threshold of the SLO objective",
            "# TYPE dyn_slo_threshold_seconds gauge",
        ]
        for o in self.config.objectives:
            if o.threshold_s is not None:
                lines.append(
                    f'dyn_slo_threshold_seconds{{objective="{o.name}"}} {o.threshold_s:g}'
                )
        return ("\n".join(lines) + "\n").encode()
