"""Global KV prefix index.

A radix tree over chained block hashes, tracking which workers hold which
cached prefixes (reference: lib/llm/src/kv_router/indexer.rs:187 RadixTree,
:518 KvIndexer).  Because hashes chain their parents, each node is uniquely
addressed by its block hash; matching walks the request's hash sequence until
the first miss and counts per-worker holdings.

The indexer applies events from a single consumer task — same
single-writer-by-construction design as the reference's event loop
(indexer.rs:36-44).  A C++ twin (csrc/radix_index.cpp) accelerates
find_matches for large trees; this Python implementation is the always-
available fallback and the behavioral spec.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from dynamo_tpu_torch.llm.kv_router.protocols import OverlapScores, RouterEvent
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("llm.kv_router.indexer")


@dataclass
class _Node:
    block_hash: int
    parent: int | None = None
    children: set[int] = field(default_factory=set)
    workers: set[int] = field(default_factory=set)


class RadixTree:
    def __init__(self) -> None:
        self._nodes: dict[int, _Node] = {}
        self._worker_blocks: dict[int, set[int]] = {}

    # -- event application -------------------------------------------------
    def apply(self, event: RouterEvent) -> None:
        kv = event.event
        if kv.kind == "stored":
            parent = kv.parent_hash
            for h in kv.block_hashes:
                node = self._nodes.get(h)
                if node is None:
                    node = _Node(block_hash=h, parent=parent)
                    self._nodes[h] = node
                    if parent is not None and parent in self._nodes:
                        self._nodes[parent].children.add(h)
                node.workers.add(event.worker_id)
                self._worker_blocks.setdefault(event.worker_id, set()).add(h)
                parent = h
        elif kv.kind == "removed":
            for h in kv.block_hashes:
                self._remove_worker_block(event.worker_id, h)
        elif kv.kind == "cleared":
            self.remove_worker(event.worker_id)

    def _remove_worker_block(self, worker_id: int, block_hash: int) -> None:
        node = self._nodes.get(block_hash)
        if node is None:
            return
        node.workers.discard(worker_id)
        blocks = self._worker_blocks.get(worker_id)
        if blocks is not None:
            blocks.discard(block_hash)
        if not node.workers and not node.children:
            self._prune(block_hash)

    def _prune(self, block_hash: int) -> None:
        node = self._nodes.pop(block_hash, None)
        if node is None:
            return
        if node.parent is not None:
            parent = self._nodes.get(node.parent)
            if parent is not None:
                parent.children.discard(block_hash)
                if not parent.workers and not parent.children:
                    self._prune(node.parent)

    def remove_worker(self, worker_id: int) -> None:
        for h in list(self._worker_blocks.get(worker_id, ())):
            self._remove_worker_block(worker_id, h)
        self._worker_blocks.pop(worker_id, None)

    # -- matching ----------------------------------------------------------
    def find_matches(self, block_hashes: list[int]) -> OverlapScores:
        """Walk the request's prefix hashes; count per-worker consecutive
        matches (a worker's score only grows while it still holds the
        prefix)."""
        scores: dict[int, int] = {}
        active: set[int] | None = None
        for h in block_hashes:
            node = self._nodes.get(h)
            if node is None or not node.workers:
                break
            holders = node.workers if active is None else node.workers & active
            if not holders:
                break
            for w in holders:
                scores[w] = scores.get(w, 0) + 1
            active = set(holders)
        return OverlapScores(scores=scores, total_blocks=len(block_hashes))

    # -- introspection -----------------------------------------------------
    def size(self) -> int:
        return len(self._nodes)

    def worker_block_count(self, worker_id: int) -> int:
        return len(self._worker_blocks.get(worker_id, ()))


class KvIndexer:
    """Owns a RadixTree and applies RouterEvents from a queue (single
    consumer).  ``find_matches`` is safe to call from the event loop since
    application and matching interleave cooperatively."""

    def __init__(self, *, native: bool | None = None) -> None:
        tree = None
        if native is not False:
            try:
                from dynamo_tpu_torch.native.radix import NativeRadixTree

                tree = NativeRadixTree()
            except Exception:  # noqa: BLE001 — fall back to the Python spec
                if native is True:
                    raise
        self.tree = tree if tree is not None else RadixTree()
        self._queue: asyncio.Queue[RouterEvent | None] = asyncio.Queue()
        self._task: asyncio.Task | None = None
        self.events_applied = 0

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._loop())

    async def _loop(self) -> None:
        while True:
            event = await self._queue.get()
            if event is None:
                return
            try:
                self.tree.apply(event)
                self.events_applied += 1
            except Exception:  # noqa: BLE001
                logger.exception("failed to apply router event")

    def push(self, event: RouterEvent) -> None:
        self._queue.put_nowait(event)

    async def stop(self) -> None:
        if self._task is not None:
            self._queue.put_nowait(None)
            await self._task
            self._task = None

    def find_matches(self, block_hashes: list[int]) -> OverlapScores:
        return self.tree.find_matches(block_hashes)

    def remove_worker(self, worker_id: int) -> None:
        self.tree.remove_worker(worker_id)
