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

Hot-prefix pinning and up-tier promotion (``locate``, ``promote_to_host``,
``note_restored``, ``pin_hot``) serve the engine's prefetch pager.
"""

from __future__ import annotations

import math
import os
import pathlib
import tempfile
import uuid

import torch

from dynamo_tpu_torch.llm.block_manager.manager import KvbmConfig, KvBlockManager
from dynamo_tpu_torch.utils import knobs
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
        # hot-prefix pinning (prefetch subsystem): hashes restored at least
        # ``pin_hits`` times are pinned host-resident — a permanent ref in
        # the host pool keeps them out of the LRU, so a hot shared prefix
        # (system prompt) can never cascade to disk.  Budgeted to a
        # fraction of the host pool so pins cannot starve offloads (put()
        # fails when the tier is full of pins).
        self.pin_hits = knobs.get("DYN_PREFETCH_PIN_HITS")
        pin_max = knobs.get("DYN_PREFETCH_PIN_MAX")
        self.pin_max = pin_max if pin_max is not None else max(1, num_blocks // 4)
        # the engine clears this when the prefetch pager is off: nothing
        # would ever drain _hot_pending, and DYN_PREFETCH=0 must be
        # bookkeeping-free demand paging
        self.pin_enabled = True
        self._pins: dict[int, int] = {}       # hash -> pinned host block id
        self._hit_counts: dict[int, int] = {}  # hash -> restore count
        self._hot_pending: list[int] = []      # crossed the threshold, unpinned
        # hashes whose offload the engine queued behind device work and has
        # not put yet; a read of one calls ``settle`` (the engine's hook,
        # which puts every queued offload) first
        self.pending: set[int] = set()
        self.settle = None

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
    def _landed(self, seq_hash: int) -> None:
        """A queued offload of ``seq_hash`` enters the tiers before it is read."""
        if seq_hash in self.pending and self.settle is not None:
            self.settle()

    def has(self, seq_hash: int) -> bool:
        self._landed(seq_hash)
        return any(p.has_hash(seq_hash) for p in self.tiers)

    def pin(self, seq_hash: int) -> bool:
        """Claim a block for an upcoming restore so interleaved offloads
        can't evict it between match and prefill (whichever tier holds it)."""
        self._landed(seq_hash)
        return any(p.match_hash(seq_hash) is not None for p in self.tiers)

    def unpin(self, seq_hash: int) -> None:
        for p in self.tiers:
            bid = p.peek_hash(seq_hash)
            if bid is not None:
                p.release(bid)
                return

    def locate(self, seq_hash: int) -> int | None:
        """Index of the highest (fastest) tier holding the hash, or None."""
        self._landed(seq_hash)
        for i, p in enumerate(self.tiers):
            if p.has_hash(seq_hash):
                return i
        return None

    # -- predictive prefetch: up-tier promotion + hot-prefix pinning ---------
    def promote_to_host(self, seq_hashes: list[int]) -> int:
        """Bring lower-tier (disk/remote) blocks up into the host tier via
        the block manager's onboard path, so a restore that follows — the
        demand page-in at admission, or the pager's host→device pre-restore
        — is a DRAM read instead of disk/network IO.  Returns blocks moved.

        Runs on the engine's device thread (blocking IO by design, same as
        every other call here); ``asyncio.run`` hosts the async onboard's
        ``to_thread`` copies.  Host-LRU evictions the promotion causes
        cascade down-tier exactly like ``put`` (read-before-overwrite), so
        promotion never destroys content."""
        moved = 0
        host_key = self.kvbm.tier_order[0]
        for tier_idx in range(1, len(self.tiers)):
            pool = self.tiers[tier_idx]
            held = [
                h for h in seq_hashes
                if pool.has_hash(h) and not self.tiers[0].has_hash(h)
            ]
            if not held:
                continue
            import asyncio

            try:
                ids = asyncio.run(
                    self.kvbm.offload.onboard(
                        held, host_key, self.kvbm.tier_order[tier_idx],
                        on_fully_evicted=self._on_fully_evicted,
                    )
                )
            except Exception:  # noqa: BLE001 — promotion is best-effort
                logger.exception("tier promotion failed (%s)", self.tier_names[tier_idx])
                continue
            if ids is not None:
                moved += len(held)
        return moved

    def note_restored(self, seq_hash: int) -> None:
        """Restore-frequency bookkeeping: a hash that keeps paging back to
        the device is hot; past ``pin_hits`` restores it becomes a pin
        candidate (picked up by ``pin_hot``)."""
        if not self.pin_enabled:
            return
        n = self._hit_counts.get(seq_hash, 0) + 1
        self._hit_counts[seq_hash] = n
        if (
            n >= self.pin_hits
            and seq_hash not in self._pins
            and len(self._hot_pending) < self.pin_max  # bounded: pin budget
            and seq_hash not in self._hot_pending
        ):
            self._hot_pending.append(seq_hash)
        if len(self._hit_counts) > 4 * max(self.pin_max, 1):
            # bounded: forget the coldest half (insertion order approximates
            # age; hot hashes re-accumulate quickly)
            for h in list(self._hit_counts)[: len(self._hit_counts) // 2]:
                if h not in self._pins:
                    del self._hit_counts[h]

    def pin_hot(self) -> int:
        """Pin pending hot prefixes host-resident (a permanent pool ref
        keeps them out of the host LRU, so they can never cascade to
        disk).  Called from the engine's prefetch loop — never on the
        demand path.  Returns newly pinned blocks."""
        if not self._hot_pending:
            return 0
        budget = self.pin_max - len(self._pins)
        # hot but currently below the host tier: one batched promotion for
        # the whole pending set (promote_to_host pays an event loop per
        # tier — per hash would put that inside the engine hot loop)
        below = [
            h for h in self._hot_pending[:budget]
            if h not in self._pins and not self.tiers[0].has_hash(h)
        ]
        if below:
            self.promote_to_host(below)
        pinned = 0
        while self._hot_pending and len(self._pins) < self.pin_max:
            h = self._hot_pending.pop(0)
            if h in self._pins:
                continue
            bid = self.tiers[0].match_hash(h)  # permanent ref = the pin
            if bid is None:
                continue
            self._pins[h] = bid
            pinned += 1
        if len(self._pins) >= self.pin_max:
            self._hot_pending.clear()
        return pinned

    def unpin_all(self) -> None:
        for h, bid in list(self._pins.items()):
            self.tiers[0].release(bid)
        self._pins.clear()
        self._hit_counts.clear()
        self._hot_pending.clear()

    def read_pinned(self, seq_hash: int) -> dict | None:
        """Deserialize a pinned block's leaves and release the pin, from
        whichever tier holds it (host, disk memmap, or the remote store
        over TCP — RemoteStorage reads are blocking by design)."""
        out = self.read_pinned_many([seq_hash])
        return out.get(seq_hash)

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
                self.note_restored(h)
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

    def clear(self) -> None:
        """Admin flush: forget everything except blocks pinned for an
        in-flight restore (clear_kv_blocks keeps running sequences' state,
        mirroring the allocator's clear_published).  Hot-prefix pins are
        dropped first — they are cache, and an admin flush means forget."""
        self.unpin_all()
        for p in self.tiers:
            for h in p.registered_hashes():
                if p.ref_count(h) > 0:
                    continue
                p.drop_hash(h)

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
            "host_blocks_pinned": len(self._pins),
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
        for i, (name, p) in enumerate(zip(self.tier_names, self.tiers)):
            row = {"blocks": p.num_blocks, "used": p.num_blocks - p.free_count}
            if i == 0:
                row["pinned"] = len(self._pins)
            out[name] = row
        return out
