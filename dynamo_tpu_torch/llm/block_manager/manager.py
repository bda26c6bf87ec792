"""KvBlockManager facade: the tiered cache as one object (a copy of
dynamo_tpu/llm/block_manager/manager.py on torch tensors).

(Reference: lib/llm/src/block_manager.rs:90-118 KvBlockManager over
KvBlockManagerState.)  Wires pools G1 (device HBM) / G2 (host) / G3 (disk)
with the offload manager, and exposes the sequence-level operations the
engine uses:

- ``store_sequence(hashes, data)``     — register freshly-computed blocks
- ``match_prefix(hashes)``             — longest cached prefix across tiers,
  onboarding lower-tier hits into the target tier
- ``release_sequence`` / eviction via pool LRU + background offload

The G1 pool lives on ``KvbmConfig.device``: the CUDA card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from dynamo_tpu_torch.llm.block_manager.offload import OffloadManager
from dynamo_tpu_torch.llm.block_manager.pool import BlockPool
from dynamo_tpu_torch.llm.block_manager.storage import (
    DeviceStorage,
    DiskStorage,
    HostStorage,
    NullStorage,
    block_shape,
)
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("llm.block_manager")


class Tier(str, enum.Enum):
    G1_DEVICE = "g1"
    G2_HOST = "g2"
    G3_DISK = "g3"
    G4_REMOTE = "g4"


@dataclass
class KvbmConfig:
    num_layers: int = 2
    block_size: int = 16
    kv_heads: int = 2
    head_dim: int = 16
    dtype: torch.dtype = torch.float32
    device_blocks: int = 0          # 0 = no device tier (host-only tests)
    device: str | None = None       # the G1 pool's device (None = the card)
    host_blocks: int = 128
    disk_blocks: int = 0            # 0 = no disk tier
    disk_path: str | None = None
    remote_address: str | None = None  # "host:port" of a BlockStoreServer (G4)
    null_storage: bool = False      # metadata-only pools (fast logic tests)
    # raw-payload mode: tiers hold pre-serialized blocks of this exact shape
    # (the serving engine's offload tier serializes each cache-pytree slice
    # to one uint8 vector), bypassing the structured layers/heads layout
    payload_shape: tuple | None = None


class KvBlockManager:
    def __init__(self, config: KvbmConfig):
        self.config = config
        shape = tuple(config.payload_shape) if config.payload_shape else block_shape(
            config.num_layers, config.block_size, config.kv_heads, config.head_dim
        )
        self.pools: dict[str, BlockPool] = {}

        def make_storage(n: int, kind: str):
            if config.null_storage:
                return NullStorage(n, shape, config.dtype)
            if kind == "device":
                return DeviceStorage(n, shape, config.dtype, device=config.device)
            if kind == "disk":
                return DiskStorage(n, shape, config.dtype, path=config.disk_path)
            return HostStorage(n, shape, config.dtype)

        if config.device_blocks:
            self.pools[Tier.G1_DEVICE] = BlockPool(
                make_storage(config.device_blocks, "device"), tier_name="g1"
            )
        if config.host_blocks:
            self.pools[Tier.G2_HOST] = BlockPool(
                make_storage(config.host_blocks, "host"), tier_name="g2"
            )
        if config.disk_blocks:
            if not config.disk_path and not config.null_storage:
                raise ValueError("disk tier needs disk_path")
            self.pools[Tier.G3_DISK] = BlockPool(
                make_storage(config.disk_blocks, "disk"), tier_name="g3"
            )
        if config.remote_address:
            # G4: a BlockStoreServer mounted over TCP. The mounter owns the
            # server's block-id space (one logical owner per store; shared
            # read-only mounts would need a coordination layer on top).
            # NOTE: mounting does blocking network IO — construct the manager
            # off the event loop (see ``create_async``).
            from dynamo_tpu_torch.llm.block_manager.remote import RemoteStorage

            remote = RemoteStorage(config.remote_address)
            if remote.shape != shape:
                raise ValueError(
                    f"block store {config.remote_address} serves blocks of shape "
                    f"{remote.shape}, but this manager is configured for {shape}"
                )
            if remote.dtype != config.dtype:
                raise ValueError(
                    f"block store {config.remote_address} serves dtype "
                    f"{remote.dtype}, but this manager is configured for "
                    f"{config.dtype}"
                )
            self.pools[Tier.G4_REMOTE] = BlockPool(remote, tier_name="g4")
        if not self.pools:
            raise ValueError("at least one tier required")
        self.tier_order = [
            t
            for t in (Tier.G1_DEVICE, Tier.G2_HOST, Tier.G3_DISK, Tier.G4_REMOTE)
            if t in self.pools
        ]
        self.offload = OffloadManager(
            {t: p for t, p in self.pools.items()}, tier_order=list(self.tier_order)
        )

    @classmethod
    async def create_async(cls, config: KvbmConfig) -> "KvBlockManager":
        """Construct off the event loop: mounting a G4 store does blocking
        TCP connect + info RPC in the constructor."""
        import asyncio

        return await asyncio.to_thread(cls, config)

    def start(self) -> None:
        self.offload.start()

    async def stop(self) -> None:
        await self.offload.stop()
        for pool in self.pools.values():
            pool.storage.close()

    # -- sequence ops --------------------------------------------------------
    @property
    def primary(self) -> BlockPool:
        return self.pools[self.tier_order[0]]

    def store_sequence(
        self, seq_hashes: list[int], data: torch.Tensor | None = None, *, offload: bool = True
    ) -> list[int] | None:
        """Register computed blocks in the primary tier (data: [n, *block]),
        queueing background offload one tier down."""
        pool = self.primary
        ids = []
        for i, h in enumerate(seq_hashes):
            existing = pool.match_hash(h)
            if existing is not None:
                ids.append(existing)
                continue
            bid = pool.allocate()
            if bid is None:
                for b in ids:
                    pool.release(b)
                return None
            if data is not None:
                pool.write([bid], data[i : i + 1])
            pool.complete(bid, self.config.block_size)
            pool.register(bid, h)
            ids.append(bid)
            if offload and len(self.tier_order) > 1:
                self.offload.request_offload(
                    self.tier_order[0], self.tier_order[1], bid, h
                )
        return ids

    def match_prefix_tier(self, seq_hashes: list[int], tier: Tier) -> int:
        """How many prefix blocks a tier holds (no side effects)."""
        pool = self.pools[tier]
        n = 0
        for h in seq_hashes:
            if not pool.has_hash(h):
                break
            n += 1
        return n

    async def match_and_onboard(self, seq_hashes: list[int]) -> tuple[list[int], Tier | None]:
        """Longest cached prefix: try primary tier first, then onboard from
        lower tiers.  Returns (primary-tier block ids with bumped refs, tier
        the data came from)."""
        primary = self.primary
        hit_ids: list[int] = []
        matched_from: Tier | None = None
        n_primary = 0
        for h in seq_hashes:
            bid = primary.match_hash(h)
            if bid is None:
                break
            hit_ids.append(bid)
            n_primary += 1
        if n_primary:
            matched_from = self.tier_order[0]
        # extend from lower tiers
        remaining = seq_hashes[n_primary:]
        for tier in self.tier_order[1:]:
            if not remaining:
                break
            n = self.match_prefix_tier(remaining, tier)
            if n == 0:
                continue
            onboarded = await self.offload.onboard(remaining[:n], self.tier_order[0], tier)
            if onboarded is None:
                break
            # bump refs for the caller (onboard registered + released them)
            for h in remaining[:n]:
                bid = primary.match_hash(h)
                if bid is not None:
                    hit_ids.append(bid)
            matched_from = tier
            remaining = remaining[n:]
        return hit_ids, matched_from

    def release_sequence(self, block_ids: list[int]) -> None:
        pool = self.primary
        for bid in block_ids:
            pool.release(bid)

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        out = {}
        for tier, pool in self.pools.items():
            out[tier.value] = {
                "total": pool.num_blocks,
                "free": pool.free_count,
                "inactive": pool.inactive_count,
                "evictions": pool.evictions,
                "reuse_hits": pool.reuse_hits,
            }
        out["offload"] = {
            "completed": self.offload.completed,
            "failed": self.offload.failed,
            "skipped": self.offload.skipped,
        }
        return out
