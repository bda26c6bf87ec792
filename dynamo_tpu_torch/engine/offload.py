"""Tiered KV offload for the serving engine: G2 host → G3 disk → G4 remote
(a copy of dynamo_tpu/engine/offload.py on torch tensors).

Built ON the KV block manager (``llm/block_manager``): the tiers are a
:class:`KvBlockManager` (host / disk / remote BlockPools over the uniform
Storage interface) and every block movement goes through
:meth:`OffloadManager.insert_sync` — the reference's engine cache IS its
block manager (lib/llm/src/block_manager.rs:90; offload chain
offload.rs:77-80; G4 remote tier block_manager.rs:68-81), and this adapter
is the serving-side mount of the same machinery.

- **offload**: when the allocator evicts a registered block from device
  memory, the engine serializes that block's cache-leaf slices (works for
  any family layout, llama k/v or DeepSeek latent/rope) into one host
  block; host-LRU evictions cascade down-tier (disk, then a remote
  ``BlockStoreServer`` over TCP) read-before-overwrite, so content only
  disappears when it falls off the BOTTOM tier.
- **restore**: prompt matching extends past device-resident blocks into
  these tiers; hits are pinned at match time (whichever tier holds them)
  and scattered into freshly-allocated device blocks right before the tail
  prefill.  All calls are synchronous — this runs on the engine's device
  thread (RemoteStorage is blocking-socket by design).

Payload layout: per block, the concatenated raw bytes of each cache leaf
slice ``leaf[:, block_id]`` in sorted leaf-name order (the reference's, so
payloads compare byte for byte).

The reference's hot-prefix pinning and up-tier promotion serve its
prefetch pager; the port pages on demand only, so they come with the pager.
"""

from __future__ import annotations

import math
import os
import pathlib
import tempfile
import uuid

import torch

from dynamo_tpu_torch.llm.block_manager.manager import KvbmConfig, KvBlockManager
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("engine.offload")


class HostOffloadTier:
    """Serving-side mount of the tiered block manager (G2/G3/G4)."""

    def __init__(
        self, num_blocks: int, leaf_shapes: dict, leaf_dtypes: dict,
        *, disk_blocks: int = 0, disk_path=None, remote_addr: str | None = None,
    ):
        self._names = sorted(leaf_shapes)
        self._shapes = {n: tuple(leaf_shapes[n]) for n in self._names}
        self._dtypes = {n: leaf_dtypes[n] for n in self._names}
        self._sizes = {
            n: math.prod(self._shapes[n]) * self._dtypes[n].itemsize
            for n in self._names
        }
        self.block_nbytes = sum(self._sizes.values())
        self._disk_path = None
        if disk_blocks:
            # unique per tier: a fixed shared path would let a second
            # engine's mode="w+" memmap truncate this engine's live pool
            self._disk_path = pathlib.Path(
                disk_path
                or pathlib.Path(tempfile.gettempdir())
                / f"dynamo_tpu_torch_g3.{os.getpid()}.{uuid.uuid4().hex[:8]}.blocks"
            )
        self.kvbm = KvBlockManager(
            KvbmConfig(
                dtype=torch.uint8,
                payload_shape=(self.block_nbytes,),
                device_blocks=0,  # G1 is the engine's own paged cache
                host_blocks=num_blocks,
                disk_blocks=disk_blocks,
                disk_path=None if self._disk_path is None else str(self._disk_path),
                remote_address=remote_addr,
            )
        )
        self.tiers = [self.kvbm.pools[t] for t in self.kvbm.tier_order]
        self.tier_names = [t.value for t in self.kvbm.tier_order]
        logger.info(
            "offload tiers %s (block payload %d bytes — size a G4 store "
            "with --nbytes %d)",
            "→".join(self.tier_names), self.block_nbytes, self.block_nbytes,
        )
        self.evict_observer = None  # engine hook: hash left EVERY tier
        self.offloads = 0
        self.restores = 0
        self._tier_restores = [0] * len(self.tiers)

    # convenience views (existing tests/benchmarks address the host pool)
    @property
    def pool(self):
        return self.tiers[0]

    @property
    def disk(self):
        return self.tiers[1] if "g3" in self.tier_names else None

    # -- offload (device eviction → host, cascading further down) -----------
    def put(self, seq_hash: int, leaves: dict) -> bool:
        """Store one evicted block's content; dedupes against the HOST tier
        only — a hash that previously cascaded to disk/remote gets a fresh
        host copy here, so a hot prefix that keeps cycling through device
        eviction is re-promoted to the fastest tier instead of being pinned
        to the bottom of the cascade forever (the stale lower-tier copy
        ages out of its LRU).  False when no tier can take it (full of
        pinned blocks).  A host block this put evicts cascades down-tier
        before being overwritten (OffloadManager.insert_sync)."""
        if self.tiers[0].has_hash(seq_hash):
            return True
        buf = torch.cat(
            [leaves[n].contiguous().view(torch.uint8).reshape(-1) for n in self._names]
        )
        ok = self.kvbm.offload.insert_sync(
            self.kvbm.tier_order[0], buf[None], seq_hash,
            on_fully_evicted=self._on_fully_evicted,
        )
        if ok:
            self.offloads += 1
        return ok

    def _on_fully_evicted(self, seq_hash: int) -> None:
        if self.evict_observer is not None:
            self.evict_observer(seq_hash)

    # -- restore (any tier → device) -----------------------------------------
    def has(self, seq_hash: int) -> bool:
        return any(p.has_hash(seq_hash) for p in self.tiers)

    def pin(self, seq_hash: int) -> bool:
        """Claim a block for an upcoming restore so interleaved offloads
        can't evict it between match and prefill (whichever tier holds it)."""
        return any(p.match_hash(seq_hash) is not None for p in self.tiers)

    def unpin(self, seq_hash: int) -> None:
        for p in self.tiers:
            bid = p.peek_hash(seq_hash)
            if bid is not None:
                p.release(bid)
                return

    def read_pinned_many(self, seq_hashes: list[int]) -> dict[int, dict]:
        """Batched restore: ONE storage read per tier for all the hashes it
        holds (a 32-block G4 prefix costs one TCP round trip, not 32), pins
        released.  Missing hashes are absent from the result."""
        out: dict[int, dict] = {}
        remaining = list(seq_hashes)
        for i, p in enumerate(self.tiers):
            if not remaining:
                break
            held = [(h, p.peek_hash(h)) for h in remaining]
            held = [(h, bid) for h, bid in held if bid is not None]
            if not held:
                continue
            bufs = p.read([bid for _, bid in held])
            for (h, bid), buf in zip(held, bufs):
                p.release(bid)
                out[h] = self._deserialize(buf)
            self._tier_restores[i] += len(held)
            self.restores += len(held)
            got = {h for h, _ in held}
            remaining = [h for h in remaining if h not in got]
        return out

    def _deserialize(self, buf: torch.Tensor) -> dict:
        out = {}
        offset = 0
        for n in self._names:
            size = self._sizes[n]
            part = buf[offset : offset + size]
            if part.storage_offset() % self._dtypes[n].itemsize:
                part = part.clone()  # a dtype view needs an aligned start
            out[n] = part.view(self._dtypes[n]).reshape(self._shapes[n])
            offset += size
        return out

    def close(self) -> None:
        """Release every tier's backing (disk memmap deleted, remote
        connections closed)."""
        for p in self.tiers:
            try:
                p.storage.close()
            except Exception:  # noqa: BLE001
                pass
        if self._disk_path is not None:
            self._disk_path.unlink(missing_ok=True)

    def stats(self) -> dict:
        host = self.tiers[0]
        out = {
            "host_blocks_total": host.num_blocks,
            "host_blocks_used": host.num_blocks - host.free_count,
            "host_offloads_total": self.offloads,
            "host_restores_total": self.restores,
            "host_evictions": host.evictions,
        }
        inserts = self.kvbm.offload.tier_inserts
        for name, p, restores in zip(
            self.tier_names[1:], self.tiers[1:], self._tier_restores[1:]
        ):
            label = {"g3": "disk", "g4": "remote"}.get(name, name)
            out.update(
                {
                    f"{label}_blocks_total": p.num_blocks,
                    f"{label}_blocks_used": p.num_blocks - p.free_count,
                    f"{label}_spills_total": inserts.get(name, 0),
                    f"{label}_restores_total": restores,
                    f"{label}_evictions": p.evictions,
                }
            )
        return out

    def tiers_snapshot(self) -> dict:
        """Structured per-tier occupancy for the observability plane
        (ForwardPassMetrics.offload_tiers → dyn_worker_offload_blocks*)."""
        out = {}
        for name, p in zip(self.tier_names, self.tiers):
            out[name] = {"blocks": p.num_blocks, "used": p.num_blocks - p.free_count}
        return out
