"""KV block gather and scatter: the CUDA kernels' wrapper (csrc/block_copy.cu).

Counterpart of dynamo_tpu/ops/pallas/block_copy.py (``gather_blocks``,
``scatter_blocks``).  The pool is ``[*outer, N, *block]`` with the block
axis at ``axis`` (0: the KVBM's ``[N, *block]`` pools; 1: the engine's
``[L, N, ...]`` cache leaves); the kernels copy rows of bytes, so any dtype
goes.  A CPU tensor goes to the plain PyTorch version
(``ops.block_copy``); a CUDA tensor launches the kernel or raises.  Ids are
checked on the host first, on every path, with numpy: each in ``[0, N)``,
and no scatter target named twice.

A CUDA call never waits for the stream: up to ``ID_CAPS[-1]`` ids travel by
value in the kernel's parameters, and a longer list is staged through
pinned host memory with one non-blocking copy ordered on the stream
(PyTorch's pinned allocator keeps the buffer until that copy has run).
``plan_copy`` makes the launch's plan from the shapes, the SM count and
the pointers' alignment only.  ``gather_launches`` and
``scatter_launches`` count kernel launches, ``plain_calls`` calls routed
to the plain version.
"""

from __future__ import annotations

import functools
import math
from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np
import torch

from dynamo_tpu_torch.ops import block_copy as plain
from dynamo_tpu_torch.ops.attention import to_cache_dtype
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels.common import ceil_div, sm_count, stream_ptr

gather_launches = 0
scatter_launches = 0
plain_calls = 0

# The plan's constants (phase ``sweep`` of chip_smoke.py times others).
PIECE_BYTES = 4 * 1024   # the most bytes of a row that one warp copies as a piece
CTAS_PER_SM = 8          # the grid: CTAs of WARPS warps an SM
# As csrc/block_copy.cu: warps a CTA and the by-value capacities of the id
# list (the smallest that fits is taken: a launch's cost grows with its
# parameter struct)
WARPS = 8
ID_CAPS = (64, 1024, 8160)
VECS = (16, 8, 4, 2, 1)


@dataclass(frozen=True)
class CopyPlan:
    """One launch: ``vec`` bytes a load and store; rows cut into
    ``pieces_per_row`` pieces of ``piece_bytes`` (a row's last may be
    shorter), ``pieces`` in all; ``grid`` CTAs; ids by value in a list of
    ``ids_cap`` (0: staged in device memory)."""

    vec: int
    piece_bytes: int
    pieces_per_row: int
    pieces: int
    grid: int
    ids_cap: int


def base_align(*ptrs: int) -> int:
    """The largest power of two up to 16 that divides every address."""
    x = 16
    for p in ptrs:
        x |= p
    return x & -x


def plan_copy(outer: int, n: int, row_bytes: int, sms: int, *, align: int = 16) -> CopyPlan:
    """The launch plan of a copy of ``outer * n`` rows of ``row_bytes``
    bytes whose base pointers are ``align``-aligned, on a card of ``sms``
    SMs.  The vector width is the widest that divides ``align`` and
    ``row_bytes``; each row is cut into the fewest pieces of at most
    PIECE_BYTES, of equal size rounded up to the vector; the grid deals the
    pieces to about CTAS_PER_SM CTAs an SM.  Nothing here reads the id
    values."""
    if outer < 1 or n < 1 or row_bytes < 1 or sms < 1:
        raise ValueError(f"no copy to plan: outer {outer}, n {n}, row_bytes {row_bytes}")
    return _plan(outer, n, row_bytes, sms, align, PIECE_BYTES, CTAS_PER_SM)


@functools.lru_cache(maxsize=1024)
def _plan(outer: int, n: int, row_bytes: int, sms: int, align: int, piece_max: int,
          ctas_per_sm: int) -> CopyPlan:
    vec = next(v for v in VECS if (align | row_bytes) % v == 0)
    per_row = ceil_div(row_bytes, piece_max)
    piece = ceil_div(ceil_div(row_bytes, per_row), vec) * vec
    per_row = ceil_div(row_bytes, piece)
    pieces = outer * n * per_row
    grid = min(ceil_div(pieces, WARPS), ctas_per_sm * sms)
    ids_cap = next((cap for cap in ID_CAPS if n <= cap), 0)
    return CopyPlan(vec, piece, per_row, pieces, grid, ids_cap)


def _stage_ids(ids: np.ndarray, device: torch.device) -> torch.Tensor:
    """The ids in device memory, copied from pinned host memory behind the
    stream's queued work (no wait)."""
    return torch.from_numpy(ids).pin_memory().to(device, non_blocking=True)


def _check_ids(ids: Sequence[int], n_pool: int, *, unique: bool) -> np.ndarray:
    a = np.asarray(ids, dtype=np.int64).reshape(-1)
    if a.size and (a.min() < 0 or a.max() >= n_pool):
        bad = a[(a < 0) | (a >= n_pool)]
        raise ValueError(f"block ids {bad[:8].tolist()} outside the pool's [0, {n_pool})")
    if unique and a.size > 1:
        s = np.sort(a)
        twice = s[1:][s[1:] == s[:-1]]
        if twice.size:
            raise ValueError(
                f"duplicate scatter block ids {np.unique(twice)[:8].tolist()}: the last "
                "writer of a block named twice is not defined"
            )
    return a.astype(np.int32)


def _geometry(pool: torch.Tensor, axis: int) -> tuple[int, int, int]:
    """(outer, N, row_bytes) of ``pool`` viewed as [outer, N, row_bytes]."""
    shape = tuple(pool.shape)  # slices of a tuple, not of torch.Size: cheaper
    if not 0 <= axis < len(shape):
        raise ValueError(f"block axis {axis} out of range for a {len(shape)}-d pool")
    return (math.prod(shape[:axis]), shape[axis],
            math.prod(shape[axis + 1:]) * pool.element_size())


def _device_check(pool: torch.Tensor, name: str) -> None:
    if pool.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {pool.device}")
    if not pool.is_contiguous():
        raise ValueError(f"{name}: the pool must be contiguous")


def _launch(entry, name: str, pool: torch.Tensor, batch: torch.Tensor, ids: np.ndarray,
            outer: int, n_pool: int, row_bytes: int) -> None:
    dev = pool.device
    plan = plan_copy(outer, len(ids), row_bytes, sm_count(dev),
                     align=base_align(pool.data_ptr(), batch.data_ptr()))
    staged = _stage_ids(ids, dev) if plan.ids_cap == 0 else None
    code = entry(
        pool.data_ptr(), batch.data_ptr(), ids.ctypes.data,
        None if staged is None else staged.data_ptr(),
        outer, n_pool, len(ids), row_bytes, plan.piece_bytes, plan.grid,
        plan.vec, plan.ids_cap, stream_ptr(dev),
    )
    build.check(code, name)


def gather_blocks(pool: torch.Tensor, ids: Sequence[int], *, axis: int = 0) -> torch.Tensor:
    """``out.select(axis, i) = pool.select(axis, ids[i])`` — block
    extraction for offload and the KVBM's G1 reads."""
    global gather_launches, plain_calls
    outer, n_pool, row_bytes = _geometry(pool, axis)
    ids = _check_ids(ids, n_pool, unique=False)
    if pool.device.type == "cpu":
        plain_calls += 1
        return plain.gather_blocks(pool, ids.tolist(), axis)
    _device_check(pool, "gather_blocks")
    shape = list(pool.shape)
    shape[axis] = len(ids)
    out = torch.empty(shape, dtype=pool.dtype, device=pool.device)
    if out.numel() == 0:
        return out
    _launch(build.library().dyn_gather_blocks, "gather_blocks", pool, out, ids,
            outer, n_pool, row_bytes)
    gather_launches += 1
    return out


def scatter_blocks(pool: torch.Tensor, blocks: torch.Tensor, ids: Sequence[int], *,
                   axis: int = 0) -> torch.Tensor:
    """``pool.select(axis, ids[i]) = blocks.select(axis, i)``, cast to the
    pool's dtype as the reference's ``.astype`` casts (``to_cache_dtype``:
    an fp8 pool's NaN and overflow bytes are the reference's), in place —
    block injection for restore and the KVBM's G1 writes.  Returns
    ``pool``."""
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
        return plain.scatter_blocks(pool, blocks.to("cpu"), ids.tolist(), axis)
    _device_check(pool, "scatter_blocks")
    if blocks.numel() == 0:
        return pool
    blocks = to_cache_dtype(blocks.to(pool.device), pool.dtype).contiguous()
    _launch(build.library().dyn_scatter_blocks, "scatter_blocks", pool, blocks, ids,
            outer, n_pool, row_bytes)
    scatter_launches += 1
    return pool
