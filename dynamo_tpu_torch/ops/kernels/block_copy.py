"""KV block gather and scatter: the CUDA kernels' wrapper (csrc/block_copy.cu).

Counterpart of dynamo_tpu/ops/pallas/block_copy.py (``gather_blocks``,
``scatter_blocks``).  The pool is ``[*outer, N, *block]`` with the block
axis at ``axis`` (0: the KVBM's ``[N, *block]`` pools; 1: the engine's
``[L, N, ...]`` cache leaves); the kernels copy rows of bytes, so any dtype
goes.  A CPU tensor goes to the plain PyTorch version
(``ops.block_copy``); a CUDA tensor launches the kernel or raises.  Ids are
checked on the host first, on every path: each in ``[0, N)``, and no
scatter target named twice.  ``gather_launches`` and ``scatter_launches``
count kernel launches, ``plain_calls`` calls routed to the plain version.
"""

from __future__ import annotations

import math
from collections import Counter
from collections.abc import Sequence

import torch

from dynamo_tpu_torch.ops import block_copy as plain
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels.common import stream_ptr

gather_launches = 0
scatter_launches = 0
plain_calls = 0


def _check_ids(ids: Sequence[int], n_pool: int, *, unique: bool) -> list[int]:
    ids = [int(b) for b in ids]
    bad = [b for b in ids if not 0 <= b < n_pool]
    if bad:
        raise ValueError(f"block ids {bad[:8]} outside the pool's [0, {n_pool})")
    if unique and len(set(ids)) != len(ids):
        dup = sorted(b for b, count in Counter(ids).items() if count > 1)
        raise ValueError(
            f"duplicate scatter block ids {dup[:8]}: the last writer of a block "
            "named twice is not defined"
        )
    return ids


def _geometry(pool: torch.Tensor, axis: int) -> tuple[int, int, int]:
    """(outer, N, row_bytes) of ``pool`` viewed as [outer, N, row_bytes]."""
    if not 0 <= axis < pool.dim():
        raise ValueError(f"block axis {axis} out of range for a {pool.dim()}-d pool")
    outer = math.prod(pool.shape[:axis])
    row_bytes = math.prod(pool.shape[axis + 1:]) * pool.element_size()
    return outer, pool.shape[axis], row_bytes


def _device_check(pool: torch.Tensor, name: str) -> None:
    if pool.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {pool.device}")
    if not pool.is_contiguous():
        raise ValueError(f"{name}: the pool must be contiguous")


def _ids_tensor(ids: list[int], device: torch.device) -> torch.Tensor:
    return torch.tensor(ids, dtype=torch.int32).to(device)


def gather_blocks(pool: torch.Tensor, ids: Sequence[int], *, axis: int = 0) -> torch.Tensor:
    """``out.select(axis, i) = pool.select(axis, ids[i])`` — block
    extraction for offload and the KVBM's G1 reads."""
    global gather_launches, plain_calls
    outer, n_pool, row_bytes = _geometry(pool, axis)
    ids = _check_ids(ids, n_pool, unique=False)
    if pool.device.type == "cpu":
        plain_calls += 1
        return plain.gather_blocks(pool, ids, axis)
    _device_check(pool, "gather_blocks")
    shape = list(pool.shape)
    shape[axis] = len(ids)
    out = torch.empty(shape, dtype=pool.dtype, device=pool.device)
    if not ids or out.numel() == 0:
        return out
    ids_dev = _ids_tensor(ids, pool.device)
    code = build.library().dyn_gather_blocks(
        pool.data_ptr(), ids_dev.data_ptr(), out.data_ptr(),
        outer, n_pool, len(ids), row_bytes, stream_ptr(pool.device),
    )
    build.check(code, "gather_blocks")
    gather_launches += 1
    return out


def scatter_blocks(pool: torch.Tensor, blocks: torch.Tensor, ids: Sequence[int], *,
                   axis: int = 0) -> torch.Tensor:
    """``pool.select(axis, ids[i]) = blocks.select(axis, i)``, cast to the
    pool's dtype, in place — block injection for restore and the KVBM's G1
    writes.  Returns ``pool``."""
    global scatter_launches, plain_calls
    outer, n_pool, row_bytes = _geometry(pool, axis)
    ids = _check_ids(ids, n_pool, unique=True)
    expect = list(pool.shape)
    expect[axis] = len(ids)
    if list(blocks.shape) != expect:
        raise ValueError(f"blocks of shape {tuple(blocks.shape)} do not fit "
                         f"{len(ids)} ids of a pool {tuple(pool.shape)} at axis {axis}")
    if pool.device.type == "cpu":
        plain_calls += 1
        return plain.scatter_blocks(pool, blocks.to("cpu"), ids, axis)
    _device_check(pool, "scatter_blocks")
    if not ids or blocks.numel() == 0:
        return pool
    blocks = blocks.to(device=pool.device, dtype=pool.dtype).contiguous()
    ids_dev = _ids_tensor(ids, pool.device)
    code = build.library().dyn_scatter_blocks(
        pool.data_ptr(), ids_dev.data_ptr(), blocks.data_ptr(),
        outer, n_pool, len(ids), row_bytes, stream_ptr(pool.device),
    )
    build.check(code, "scatter_blocks")
    scatter_launches += 1
    return pool
