"""KV block gather and scatter by id list: the plain PyTorch versions.

Counterparts of the XLA twin of the KVBM's ``DeviceStorage``
(dynamo_tpu/llm/block_manager/storage.py:142-146: ``pool[ids]`` and
``pool.at[ids].set(blocks.astype(pool.dtype))`` over ``[N, *block]``) and of
the engine's per-leaf extract and inject (dynamo_tpu/engine/engine.py
``_build_extract`` / ``_build_inject``, :1587-1602: ``c[:, ids]`` and
``c.at[:, ids].set(x.astype(c.dtype))`` over ``[L, N, ...]`` cache leaves).
``axis`` names the block axis: 0 for the KVBM's pools, 1 for cache leaves.

They copy one block a step, as the Pallas kernel's grid runs
(dynamo_tpu/ops/pallas/block_copy.py).  The CPU path of the kernel
wrappers (``ops/kernels/block_copy.py``) and the oracle the CUDA kernels
are held against on the card; the wrappers check the ids first.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from dynamo_tpu_torch.ops.attention import to_cache_dtype


def gather_blocks(pool: torch.Tensor, ids: Sequence[int], axis: int = 0) -> torch.Tensor:
    """``out.select(axis, i) = pool.select(axis, ids[i])``."""
    shape = list(pool.shape)
    shape[axis] = len(ids)
    out = pool.new_empty(shape)
    for i, b in enumerate(ids):
        out.select(axis, i).copy_(pool.select(axis, b))
    return out


def scatter_blocks(pool: torch.Tensor, blocks: torch.Tensor, ids: Sequence[int],
                   axis: int = 0) -> torch.Tensor:
    """``pool.select(axis, ids[i]) = blocks.select(axis, i)``, cast to the
    pool's dtype as the reference's ``.astype`` casts (``to_cache_dtype``),
    in place; returns ``pool``."""
    blocks = to_cache_dtype(blocks, pool.dtype)
    for i, b in enumerate(ids):
        pool.select(axis, b).copy_(blocks.select(axis, i))
    return pool
