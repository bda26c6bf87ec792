"""PrefetchPager: the engine-side prefetch job queue + accounting.

A priority-ordered queue of hinted prefixes, drained by the engine's
device loop between steps (bounded blocks per iteration, so prefetch can
never stall serving).  Jobs older than ``ttl_s`` are cancelled as stale —
a hint whose request never materialized must not keep paging.

Accounting answers "did prefetch buy anything":

- **hit**: a prefetched block was matched by a real sequence before
  leaving HBM — its recorded page-in cost is credited to
  ``hidden_seconds`` (latency removed from that request's critical path).
- **miss**: a prefetched block was evicted from HBM (or its sequence
  freed it unconsumed) before any hit — wasted page-in work.
- **stale**: a job expired before the pager ran it.

Thread model: ``submit`` is called from the asyncio thread (bus listener)
and the device thread (queue self-hints); everything else runs on the
device thread.  The allocator calls ``on_block_hit``/``on_block_evicted``
under its own lock, so this class keeps its own small lock and never
calls back out.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field

from dynamo_tpu_torch.prefetch.hints import SOURCE_PRIORITY
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("prefetch.pager")

# per-hash cost memory: bounded — oldest entries beyond this are treated
# as already-judged (they count as misses when forgotten unconsumed)
MAX_TRACKED_BLOCKS = 65536

# link-class pricing for tier page-ins (topology plane): a page-in whose
# backing tier sits behind a slower hop gets a smaller per-step budget —
# the device loop must not stall serving while blocks crawl over DCN.
# Fractions of the configured blocks_per_step; "" / "local" = full budget.
LINK_BUDGET_FRACTION = {
    "": 1.0,
    "local": 1.0,
    "ici": 0.5,
    "dcn": 0.25,
}


@dataclass(order=True)
class _Job:
    priority: int
    seq: int
    hashes: list[int] = field(compare=False)
    enqueued: float = field(compare=False, default=0.0)


class PrefetchPager:
    def __init__(
        self,
        *,
        ttl_s: float = 30.0,
        blocks_per_step: int = 64,
        idle_boost: int = 4,
        clock=time.monotonic,
    ):
        self.ttl_s = ttl_s
        self.blocks_per_step = blocks_per_step
        self.idle_boost = idle_boost
        # hop class of the link behind the offload tier (set_link_hop):
        # scales the effective per-step page-in budget by LINK_BUDGET_FRACTION
        self.link_hop = ""
        self._clock = clock
        self._lock = threading.Lock()
        self._queue: list[_Job] = []
        self._seq = itertools.count()
        # hashes with a queued job (dedupe: N queued requests for one hot
        # prefix collapse to the first job; re-hint after execution re-queues)
        self._queued_hashes: set[int] = set()
        # hash -> page-in seconds spent bringing it into HBM (judged on
        # hit/evict); insertion-ordered for bounded forgetting
        self._cost: dict[int, float] = {}
        # counters (exported via engine stats → dyn_prefetch_* families)
        self.hints_total = 0
        self.hits_total = 0
        self.misses_total = 0
        self.stale_total = 0
        self.hidden_seconds_total = 0.0
        self.blocks_restored_total = 0   # host tier → HBM pre-restores
        self.blocks_onboarded_total = 0  # disk/remote → host promotions
        self.deferred_total = 0          # jobs postponed for HBM headroom

    # -- link pricing (topology plane) ----------------------------------------
    def set_link_hop(self, hop: str) -> None:
        """Price tier page-ins by the hop class behind the offload tier
        (from the discovered TopologyMap).  Unknown classes price like
        ``dcn`` — assume the worst about an unclassified link."""
        self.link_hop = hop or ""

    def effective_blocks_per_step(self) -> int:
        fraction = LINK_BUDGET_FRACTION.get(
            self.link_hop, LINK_BUDGET_FRACTION["dcn"]
        )
        return max(1, int(self.blocks_per_step * fraction))

    # -- queue (any thread) --------------------------------------------------
    def submit(self, block_hashes: list[int], *, source: str = "arrival") -> bool:
        """Queue a hinted prefix.  Returns False when nothing new to do
        (empty, or every hash already queued).  Only the hashes not
        already queued ride in the job — the queue and ``_queued_hashes``
        must agree exactly, or popping one job would unmark hashes a
        sibling job still carries and let a third hint re-queue them."""
        if not block_hashes:
            return False
        priority = SOURCE_PRIORITY.get(source, 10)
        with self._lock:
            fresh = [h for h in block_hashes if h not in self._queued_hashes]
            if not fresh:
                return False
            self.hints_total += 1
            self._queued_hashes.update(fresh)
            heapq.heappush(
                self._queue,
                _Job(priority, next(self._seq), fresh, self._clock()),
            )
            return True

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._queue)

    def next_job(self) -> _Job | None:
        """Pop the most urgent non-stale job (device thread)."""
        now = self._clock()
        with self._lock:
            while self._queue:
                job = heapq.heappop(self._queue)
                self._queued_hashes.difference_update(job.hashes)
                if now - job.enqueued > self.ttl_s:
                    self.stale_total += 1
                    continue
                return job
            return None

    def requeue(
        self, hashes: list[int], *, enqueued: float | None = None,
        priority: int = 5,
    ) -> None:
        """Put back a job the engine could not finish (HBM headroom): it
        retries ahead of fresh arrival hints and keeps its ORIGINAL
        enqueue time (pass the popped job's ``enqueued``), so a hint that
        keeps deferring still goes stale after ``ttl_s`` instead of being
        re-walked forever while HBM stays saturated."""
        with self._lock:
            fresh = [h for h in hashes if h not in self._queued_hashes]
            if not fresh:
                return
            self.deferred_total += 1
            self._queued_hashes.update(fresh)
            heapq.heappush(
                self._queue,
                _Job(
                    priority, next(self._seq), fresh,
                    self._clock() if enqueued is None else enqueued,
                ),
            )

    # -- accounting (device thread + allocator lock) -------------------------
    def record_restored(self, seq_hash: int, cost_s: float) -> None:
        """A block was pre-restored into HBM at this page-in cost."""
        with self._lock:
            self.blocks_restored_total += 1
            self._cost[seq_hash] = cost_s
            while len(self._cost) > MAX_TRACKED_BLOCKS:
                # forgotten unconsumed = it never hit: judge it a miss
                self._cost.pop(next(iter(self._cost)))
                self.misses_total += 1

    def record_onboarded(self, n: int) -> None:
        with self._lock:
            self.blocks_onboarded_total += n

    def on_block_hit(self, seq_hash: int) -> None:
        """Allocator hook: a sequence matched a prefetched device block."""
        with self._lock:
            cost = self._cost.pop(seq_hash, None)
            if cost is None:
                return
            self.hits_total += 1
            self.hidden_seconds_total += cost

    def on_block_evicted(self, seq_hash: int) -> None:
        """Allocator hook: a prefetched block left HBM before any hit."""
        with self._lock:
            if self._cost.pop(seq_hash, None) is not None:
                self.misses_total += 1

    def is_tracked(self, seq_hash: int) -> bool:
        with self._lock:
            return seq_hash in self._cost

    def stats(self) -> dict:
        with self._lock:
            return {
                "prefetch_hints_total": self.hints_total,
                "prefetch_hits_total": self.hits_total,
                "prefetch_misses_total": self.misses_total,
                "prefetch_stale_total": self.stale_total,
                "prefetch_hidden_seconds_total": round(self.hidden_seconds_total, 6),
                "prefetch_blocks_restored_total": self.blocks_restored_total,
                "prefetch_blocks_onboarded_total": self.blocks_onboarded_total,
                "prefetch_deferred_total": self.deferred_total,
                "prefetch_queue_depth": len(self._queue),
                "prefetch_blocks_per_step_effective": self.effective_blocks_per_step(),
            }
