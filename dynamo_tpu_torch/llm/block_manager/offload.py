"""Offload manager: moves KV blocks between tiers (a copy of
dynamo_tpu/llm/block_manager/offload.py).

(Reference: lib/llm/src/block_manager/offload.rs — priority queue, bounded
concurrency MAX_CONCURRENT_TRANSFERS=4, batching BATCH=16, per-pair transfer
strategies.)  Here the strategies are:

    G1→G2  block gather kernel, then a device→host copy (DeviceStorage)
    G2→G1  a host→device copy, then the block scatter kernel
    G2↔G3  memmap IO
    G1→G3  staged through G2

Transfers are batched and run on a bounded set of worker tasks; completion
registers the block's hash in the destination pool.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
from dataclasses import dataclass, field

from dynamo_tpu_torch.llm.block_manager.pool import BlockPool
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("llm.block_manager.offload")

MAX_CONCURRENT_TRANSFERS = 4
TRANSFER_BATCH = 16


@dataclass(order=True)
class _Job:
    priority: int
    seq: int
    src_tier: str = field(compare=False)
    dst_tier: str = field(compare=False)
    block_id: int = field(compare=False)
    seq_hash: int = field(compare=False)


class OffloadManager:
    def __init__(self, pools: dict[str, BlockPool], tier_order: list | None = None):
        self.pools = pools
        # when tier order is known, completed offloads cascade one tier
        # further down (G1→G2→G3→G4 population, reference offload.rs)
        self.tier_order = tier_order or []
        self._queue: list[_Job] = []
        self._seq = itertools.count()
        self._wake = asyncio.Event()
        self._stopping = False
        self._workers: list[asyncio.Task] = []
        self._inflight = 0
        # hashes an onboard() is currently copying up-tier: a concurrent
        # onboard for the same hash (demand restore racing a prefetch hint)
        # awaits the first copy instead of double-allocating (event per
        # batch; single-event-loop use by construction)
        self._onboard_inflight: dict[int, asyncio.Event] = {}
        self.completed = 0
        self.failed = 0
        self.skipped = 0
        self.tier_inserts: dict[str, int] = {}  # per-tier insert_sync counts

    def start(self, workers: int = MAX_CONCURRENT_TRANSFERS) -> None:
        if not self._workers:
            self._workers = [
                spawn_logged(self._worker()) for _ in range(workers)
            ]

    async def stop(self, drain_timeout: float = 5.0) -> None:
        """Drain in-flight transfers, then stop workers.

        Cancelling a task blocked in ``to_thread`` abandons a still-running
        OS thread that would race the storage close that follows — so ask
        workers to exit between batches and only cancel stragglers after
        the drain timeout."""
        self._stopping = True
        self._wake.set()
        workers, self._workers = self._workers, []
        if not workers:
            return
        done, pending = await asyncio.wait(workers, timeout=drain_timeout)
        for w in pending:
            w.cancel()
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)

    # -- API -----------------------------------------------------------------
    def request_offload(
        self, src_tier: str, dst_tier: str, block_id: int, seq_hash: int, *, priority: int = 10
    ) -> None:
        """Queue a copy of a registered block down-tier (lower priority value
        = sooner)."""
        heapq.heappush(
            self._queue,
            _Job(priority, next(self._seq), src_tier, dst_tier, block_id, seq_hash),
        )
        self._wake.set()

    async def onboard(
        self,
        seq_hashes: list[int],
        dst_tier: str,
        src_tier: str,
        *,
        on_fully_evicted=None,
    ) -> list[int] | None:
        """Bring blocks up-tier (prefix hit on a lower tier, or a prefetch
        hint promoting disk/remote content toward the device).  Returns the
        destination block ids of the hashes THIS call copied (may be empty
        when every hash was already up-tier), or None if the source lost a
        hash or the destination could not allocate — nothing is claimed on
        failure.

        Safe under concurrent demand + prefetch requests for the same
        hashes: hashes already registered in ``dst_tier`` are skipped
        (dedupe — callers re-match by hash afterwards), and hashes another
        onboard is mid-copy are awaited rather than double-allocated, so
        the same content can never occupy two destination blocks and no
        allocation leaks.  Destination-LRU evictions the allocation causes
        cascade one tier further down read-before-overwrite (same contract
        as ``insert_sync``); ``on_fully_evicted`` fires for hashes the
        cascade pushed out of the bottom tier."""
        src = self.pools[src_tier]
        dst = self.pools[dst_tier]
        # wait out copies another onboard already has in flight for these
        # hashes (re-check after each wait: the set mutates while we sleep)
        while True:
            waiting = [
                ev for h in seq_hashes
                if (ev := self._onboard_inflight.get(h)) is not None
            ]
            if not waiting:
                break
            for ev in waiting:
                await ev.wait()
        todo = [h for h in seq_hashes if not dst.has_hash(h)]
        self.skipped += len(seq_hashes) - len(todo)
        if not todo:
            return []
        done_ev = asyncio.Event()
        for h in todo:
            self._onboard_inflight[h] = done_ev
        try:
            src_ids = []
            for h in todo:
                bid = src.match_hash(h)
                if bid is None:
                    for b in src_ids:
                        src.release(b)
                    return None
                src_ids.append(bid)
            # next tier down receives anything the dst allocation evicts
            nxt = None
            if dst_tier in self.tier_order:
                idx = self.tier_order.index(dst_tier)
                if idx + 1 < len(self.tier_order):
                    nxt = self.tier_order[idx + 1]
            dst_ids = []
            for h in todo:
                captured: list[int] = []
                prev_sink = dst.evict_sink
                dst.evict_sink = captured.append
                try:
                    bid = dst.allocate()
                finally:
                    dst.evict_sink = prev_sink
                if bid is None:
                    for b in dst_ids:
                        dst.release(b)
                    for b in src_ids:
                        src.release(b)
                    return None
                for ev in captured:
                    # the evicted block's bytes still live at ``bid`` until
                    # the write below lands — cascade them down-tier now
                    placed = nxt is not None and self.insert_sync(
                        nxt, dst.read([bid]), ev, on_fully_evicted=on_fully_evicted
                    )
                    if not placed and on_fully_evicted is not None:
                        on_fully_evicted(ev)
                dst_ids.append(bid)
            # batched copy through host
            for start in range(0, len(src_ids), TRANSFER_BATCH):
                chunk_src = src_ids[start : start + TRANSFER_BATCH]
                chunk_dst = dst_ids[start : start + TRANSFER_BATCH]
                data = await asyncio.to_thread(src.read, chunk_src)
                await asyncio.to_thread(dst.write, chunk_dst, data)
            for h, src_bid, dst_bid in zip(todo, src_ids, dst_ids):
                dst.complete(dst_bid, src.blocks[src_bid].token_count)
                dst.register(dst_bid, h)
                # park inactive (discoverable + evictable): callers revive by
                # hash — the old code left the ref, leaking the block as
                # active forever once its caller released only one ref
                dst.release(dst_bid)
            for bid in src_ids:
                src.release(bid)
            self.completed += len(todo)
            return dst_ids
        finally:
            for h in todo:
                if self._onboard_inflight.get(h) is done_ev:
                    del self._onboard_inflight[h]
            done_ev.set()

    def insert_sync(
        self,
        tier,
        data,
        seq_hash: int,
        token_count: int = 0,
        *,
        on_fully_evicted=None,
    ) -> bool:
        """Synchronously insert one serialized block into ``tier``, cascading
        any LRU eviction the insertion causes one tier further down
        (read-before-overwrite: the evicted block's bytes survive in storage
        until the new write lands, so they are copied down FIRST).

        This is the serving engine's path — it runs on the device thread,
        where the async worker machinery above can't be awaited.  Returns
        False when the tier (and thus the chain) cannot take the block;
        ``on_fully_evicted`` fires for any hash the cascade pushed out of
        the bottom tier (it no longer exists anywhere).
        """
        pool = self.pools[tier]
        if pool.has_hash(seq_hash):
            return True
        captured: list[int] = []
        prev_sink = pool.evict_sink
        pool.evict_sink = captured.append
        try:
            bid = pool.allocate()
        finally:
            pool.evict_sink = prev_sink
        if bid is None:
            return False
        nxt = None
        if tier in self.tier_order:
            idx = self.tier_order.index(tier)
            if idx + 1 < len(self.tier_order):
                nxt = self.tier_order[idx + 1]
        for ev in captured:
            # the evicted block's bytes still live at ``bid`` until the
            # write below — copy them down-tier now or lose them
            placed = nxt is not None and self.insert_sync(
                nxt, pool.read([bid]), ev, on_fully_evicted=on_fully_evicted
            )
            if not placed and on_fully_evicted is not None:
                on_fully_evicted(ev)
        pool.write([bid], data)
        pool.complete(bid, token_count)
        pool.register(bid, seq_hash)
        pool.release(bid)  # park in the inactive LRU, discoverable + evictable
        self.completed += 1
        key = tier.value if hasattr(tier, "value") else str(tier)
        self.tier_inserts[key] = self.tier_inserts.get(key, 0) + 1
        return True

    # -- workers ---------------------------------------------------------------
    async def _worker(self) -> None:
        while True:
            while not self._queue:
                if self._stopping:
                    return
                self._wake.clear()
                if self._stopping:  # re-check: stop() may have set the (now
                    return          # cleared) wake event in between
                await self._wake.wait()
            # batch same src→dst pairs
            job = heapq.heappop(self._queue)
            batch = [job]
            rest: list[_Job] = []
            while self._queue and len(batch) < TRANSFER_BATCH:
                nxt = heapq.heappop(self._queue)
                if nxt.src_tier == job.src_tier and nxt.dst_tier == job.dst_tier:
                    batch.append(nxt)
                else:
                    rest.append(nxt)
            for r in rest:
                heapq.heappush(self._queue, r)
            try:
                await self._transfer(batch)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                self.failed += len(batch)
                logger.exception("offload batch failed")

    async def _transfer(self, batch: list[_Job]) -> None:
        src = self.pools[batch[0].src_tier]
        dst = self.pools[batch[0].dst_tier]
        jobs = []
        for job in batch:
            if dst.has_hash(job.seq_hash):
                self.skipped += 1  # already down-tier (dedupe)
                continue
            if src.blocks[job.block_id].seq_hash != job.seq_hash:
                self.skipped += 1  # stale: source block evicted/reused since queued
                continue
            jobs.append(job)
        if not jobs:
            return
        dst_ids = []
        kept: list[_Job] = []
        for job in jobs:
            bid = dst.allocate()
            if bid is None:
                self.failed += 1
                continue
            dst_ids.append(bid)
            kept.append(job)
        if not kept:
            return
        data = await asyncio.to_thread(src.read, [j.block_id for j in kept])
        await asyncio.to_thread(dst.write, dst_ids, data)
        next_tier = None
        if batch[0].dst_tier in self.tier_order:
            idx = self.tier_order.index(batch[0].dst_tier)
            if idx + 1 < len(self.tier_order):
                next_tier = self.tier_order[idx + 1]
        for job, bid in zip(kept, dst_ids):
            dst.complete(bid, src.blocks[job.block_id].token_count)
            dst.register(bid, job.seq_hash)
            dst.release(bid)  # parks in inactive LRU, discoverable
            self.completed += 1
            if next_tier is not None:
                self.request_offload(
                    batch[0].dst_tier, next_tier, bid, job.seq_hash,
                    priority=job.priority + 1,
                )
