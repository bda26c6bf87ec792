"""Planner-driven fleet defragmentation via live session migration (a
copy of dynamo_tpu/planner/defrag.py).

Long decode sessions pin KV blocks to whichever worker admitted them; over
hours a fleet develops hot workers (occupancy near the ceiling, every new
admission a near-miss) next to cold ones.  Scaling can't fix that — the
capacity exists, it's just in the wrong place.  The :class:`Defragmenter`
fixes placement instead: each planner interval it looks at per-worker KV
occupancy, and when the hottest worker with live sessions sits more than
``occupancy_spread`` above the coldest eligible peer, it migrates sessions
off the hot worker through the dispatcher's
:class:`~dynamo_tpu_torch.runtime.migration.MigrationCoordinator` — the zero-loss
mid-decode handoff, so defrag is invisible to clients.

Deliberately conservative, in the planner's own idiom (cooldowns, bounded
steps):

- bounded rate: at most ``max_per_step`` migrations per step, and after any
  committed move the loop holds off for ``cooldown_s`` so the occupancy
  signal can settle before it re-judges the fleet;
- never cross-slice: destinations a DCN hop away are filtered out — only a
  drain (a doomed worker) justifies paying the cross-slice bill, and the
  drain path prices that itself;
- prefix-local targets: among eligible destinations the cheapest discovered
  hop wins first (local, then ICI), coldest occupancy second — the moved
  session lands where its continuation re-prefill is cheapest;
- an idle fleet is left alone: the hot worker must itself be above
  ``min_occupancy`` before shuffling sessions buys anything.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from dynamo_tpu_torch.runtime.migration import _HOP_COST
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("planner.defrag")


@dataclass
class DefragConfig:
    enabled: bool = False
    # trigger: hottest-vs-coldest KV occupancy gap (fractions of the cache)
    occupancy_spread: float = 0.25
    # the hot worker must itself be at least this full — moving sessions
    # around a cold fleet is churn, not defragmentation
    min_occupancy: float = 0.5
    max_per_step: int = 1
    cooldown_s: float = 8.0


class Defragmenter:
    """One defrag loop per dispatcher; stepped on the planner's cadence."""

    def __init__(self, coordinator, config: DefragConfig | None = None,
                 clock=time.monotonic):
        self.coordinator = coordinator
        self.config = config or DefragConfig()
        self._clock = clock
        self._cooldown_until = float("-inf")
        self.moves: list[dict] = []      # committed migrations, for the logs

    @staticmethod
    def spread(occupancy: dict[int, float]) -> float:
        if len(occupancy) < 2:
            return 0.0
        vals = occupancy.values()
        return max(vals) - min(vals)

    def _pick(self, occupancy: dict[int, float]) -> tuple[int | None, int | None]:
        """(hot worker to empty, destination) or (None, None).  The hot
        worker must hold live sessions (an occupancy spike with nothing to
        move is the admission controller's problem, not defrag's)."""
        coord = self.coordinator
        sessions = coord.sessions()
        loaded = {h for h in sessions.values() if h in occupancy}
        if not loaded:
            return None, None
        hot = max(loaded, key=lambda w: occupancy[w])
        if occupancy[hot] < self.config.min_occupancy:
            return None, None
        healthy = set(coord.router.healthy_ids({hot}))
        eligible = []
        for w, occ in occupancy.items():
            if w == hot or w not in healthy:
                continue
            if occupancy[hot] - occ < self.config.occupancy_spread:
                continue
            hop = coord.hop(hot, w)
            if hop == "dcn":
                continue     # never cross-slice for a mere rebalance
            eligible.append((w, _HOP_COST.get(hop, 2), occ))
        if not eligible:
            return hot, None
        # cheapest hop first (prefix-local re-prefill), coldest second
        eligible.sort(key=lambda e: (e[1], e[2], e[0]))
        return hot, eligible[0][0]

    async def step(self, occupancy: dict[int, float],
                   now: float | None = None) -> list[dict]:
        """One defrag pass over a per-worker occupancy snapshot (fractions,
        e.g. the aggregated ``gpu_cache_usage_perc``).  Returns the migration
        results it drove (possibly aborted ones — the coordinator's safety
        story means an abort costs nothing)."""
        cfg = self.config
        if not cfg.enabled or self.coordinator is None:
            return []
        now = self._clock() if now is None else now
        if now < self._cooldown_until:
            return []
        hot, dst = self._pick(occupancy)
        if hot is None or dst is None:
            return []
        coord = self.coordinator
        results: list[dict] = []
        for rid in sorted(coord.sessions_on(hot))[: max(cfg.max_per_step, 1)]:
            res = await coord.migrate(rid, dst, reason="defrag")
            results.append(res)
            if res.get("ok"):
                self.moves.append({
                    "t": round(now, 3), "request": rid,
                    "src": res["src"], "dst": res["dst"],
                    "hop": res.get("hop") or "",
                })
        if any(r.get("ok") for r in results):
            self._cooldown_until = now + cfg.cooldown_s
            logger.info(
                "defrag: moved %d session(s) off %x (occupancy %.2f)",
                sum(1 for r in results if r.get("ok")), hot, occupancy[hot],
            )
        return results
