"""Block pool: lifecycle, registry, reuse, eviction (a copy of
dynamo_tpu/llm/block_manager/pool.py).

Lifecycle (reference: lib/llm/src/block_manager/block.rs):
    RESET → PARTIAL (tokens being appended) → COMPLETE (full) →
    REGISTERED (content-hashed, discoverable for reuse)

A pool keeps an *active* set (held by sequences) and an *inactive* set of
registered blocks in LRU order (reference: block_manager/pool.rs,
pool/inactive.rs).  Allocation prefers the free list, then evicts the
least-recently-used inactive registered block.  ``match_hash`` revives an
inactive registered block (prefix cache hit) instead of recomputing it.
"""

from __future__ import annotations

import enum
import time
from collections import OrderedDict, deque
from dataclasses import dataclass

from dynamo_tpu_torch.llm.block_manager.storage import Storage
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("llm.block_manager.pool")


class BlockState(enum.Enum):
    RESET = "reset"
    PARTIAL = "partial"
    COMPLETE = "complete"
    REGISTERED = "registered"


@dataclass
class BlockMeta:
    block_id: int
    state: BlockState = BlockState.RESET
    seq_hash: int | None = None
    token_count: int = 0
    ref_count: int = 0
    registered_at: float = 0.0


class BlockPool:
    def __init__(self, storage: Storage, *, tier_name: str = "pool"):
        self.storage = storage
        self.tier_name = tier_name
        self.blocks = [BlockMeta(block_id=i) for i in range(storage.num_blocks)]
        self._free: deque[int] = deque(range(storage.num_blocks))
        # inactive registered blocks: seq_hash -> block_id in LRU order
        self._inactive: OrderedDict[int, int] = OrderedDict()
        self._by_hash: dict[int, int] = {}
        # optional observer: called with the seq_hash of each block evicted
        # by allocate() (tier owners propagate removed events from it)
        self.evict_sink = None
        # stats
        self.evictions = 0
        self.reuse_hits = 0

    # -- capacity ------------------------------------------------------------
    @property
    def num_blocks(self) -> int:
        return self.storage.num_blocks

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def inactive_count(self) -> int:
        return len(self._inactive)

    @property
    def available(self) -> int:
        return self.free_count + self.inactive_count

    # -- allocation ------------------------------------------------------------
    def allocate(self) -> int | None:
        """A RESET block for writing; evicts LRU inactive if free list empty."""
        if self._free:
            bid = self._free.popleft()
        elif self._inactive:
            _, bid = self._inactive.popitem(last=False)  # LRU
            meta = self.blocks[bid]
            if meta.seq_hash is not None:
                self._by_hash.pop(meta.seq_hash, None)
                if self.evict_sink is not None:
                    self.evict_sink(meta.seq_hash)
            self.evictions += 1
        else:
            return None
        meta = self.blocks[bid]
        meta.state = BlockState.PARTIAL
        meta.seq_hash = None
        meta.token_count = 0
        meta.ref_count = 1
        return bid

    def complete(self, block_id: int, token_count: int) -> None:
        meta = self.blocks[block_id]
        meta.state = BlockState.COMPLETE
        meta.token_count = token_count

    def register(self, block_id: int, seq_hash: int) -> None:
        """Make a complete block discoverable by content hash.  If the hash
        is already registered, this block stays unregistered (dedupe —
        reference: block/registry.rs)."""
        meta = self.blocks[block_id]
        if seq_hash in self._by_hash and self._by_hash[seq_hash] != block_id:
            meta.state = BlockState.COMPLETE
            return
        meta.state = BlockState.REGISTERED
        meta.seq_hash = seq_hash
        meta.registered_at = time.monotonic()
        self._by_hash[seq_hash] = block_id

    def match_hash(self, seq_hash: int) -> int | None:
        """Prefix-cache lookup: revive an inactive registered block (bumps
        ref) or return an active one."""
        bid = self._by_hash.get(seq_hash)
        if bid is None:
            return None
        if seq_hash in self._inactive:
            self._inactive.pop(seq_hash)
        self.blocks[bid].ref_count += 1
        self.reuse_hits += 1
        return bid

    def has_hash(self, seq_hash: int) -> bool:
        return seq_hash in self._by_hash

    def peek_hash(self, seq_hash: int) -> int | None:
        """Non-reviving lookup: the block id registered under this hash
        without touching refcounts or the inactive LRU (for callers that
        already hold a pin from ``match_hash``)."""
        return self._by_hash.get(seq_hash)

    def registered_hashes(self) -> list[int]:
        return list(self._by_hash)

    def ref_count(self, seq_hash: int) -> int:
        bid = self._by_hash.get(seq_hash)
        return 0 if bid is None else self.blocks[bid].ref_count

    def release(self, block_id: int) -> None:
        """Sequence done with the block: registered blocks park in the
        inactive LRU (still reusable); others return to the free list."""
        meta = self.blocks[block_id]
        meta.ref_count = max(0, meta.ref_count - 1)
        if meta.ref_count > 0:
            return
        if meta.state == BlockState.REGISTERED and meta.seq_hash is not None:
            self._inactive[meta.seq_hash] = block_id
            self._inactive.move_to_end(meta.seq_hash)
        else:
            self._reset(block_id)

    def _reset(self, block_id: int) -> None:
        meta = self.blocks[block_id]
        if meta.seq_hash is not None:
            self._by_hash.pop(meta.seq_hash, None)
            self._inactive.pop(meta.seq_hash, None)
        meta.state = BlockState.RESET
        meta.seq_hash = None
        meta.token_count = 0
        meta.ref_count = 0
        self._free.append(block_id)

    def drop_hash(self, seq_hash: int) -> None:
        """Forcibly forget a registered hash (used when a tier invalidates)."""
        bid = self._by_hash.get(seq_hash)
        if bid is not None:
            self._reset(bid)

    # -- data ------------------------------------------------------------------
    def read(self, block_ids: list[int]):
        return self.storage.read_batch(block_ids)

    def write(self, block_ids: list[int], data) -> None:
        self.storage.write_batch(block_ids, data)
