"""Multi-tier KV block manager (KVBM), a copy of dynamo_tpu/llm/block_manager.

A hierarchy of fixed-size KV block pools

    G1 device  →  G2 host DRAM  →  G3 local disk (→ G4 remote)

with block lifecycle Reset → Partial → Complete → Registered, content-hash
registry for dedupe/reuse, LRU eviction of registered blocks, and an offload
manager that moves cold blocks down-tier and onboards prefix hits back up
(reference: lib/llm/src/block_manager.rs:68-118 and block_manager/).

Data movement: device↔host through the hand-written block gather/scatter
kernels and one copy over the host link (replaces cudaMemcpyAsync in the
reference), host↔disk via memory-mapped files (replaces GDS), remote via a
TCP block store (replaces NIXL RDMA).  The Null storage backend provides
metadata-only pools for infrastructure tests.
"""

from dynamo_tpu_torch.llm.block_manager.storage import (
    DeviceStorage,
    DiskStorage,
    HostStorage,
    NullStorage,
)
from dynamo_tpu_torch.llm.block_manager.pool import BlockPool, BlockState
from dynamo_tpu_torch.llm.block_manager.manager import KvBlockManager, KvbmConfig, Tier
from dynamo_tpu_torch.llm.block_manager.offload import OffloadManager

__all__ = [
    "BlockPool",
    "BlockState",
    "DeviceStorage",
    "DiskStorage",
    "HostStorage",
    "KvBlockManager",
    "KvbmConfig",
    "NullStorage",
    "OffloadManager",
    "Tier",
]
