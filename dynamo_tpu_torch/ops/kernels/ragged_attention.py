"""Ragged unified-batch paged attention: the CUDA kernel's wrapper
(csrc/ragged_attention.cu), the host-side packing of its page worklist and
the host work plan of its tensor-core walk.

Counterpart of dynamo_tpu/ops/pallas/ragged_attention.py.  The flat token
axis (chunked-prefill spans and decode tokens of different sequences,
packed densely) is cut into blocks of ``tb_tokens`` tokens;
``pack_page_meta`` lists for each block the physical pages its tokens can
see, and the kernel walks that list.  A CPU tensor goes to the plain
PyTorch version (``ops.attention.ragged_paged_attention``, which reads the
block tables instead of the worklist); a CUDA tensor launches the kernel or
raises.  ``launches`` counts wrapper calls that launched a kernel,
``split_launches`` those of them that took the tensor-core walk,
``plain_calls`` calls routed to the plain version.

Routes on the card (``split_route``): bf16 queries over a bf16 or fp8
(e4m3fn, e5m2) cache at head dims 64 and 128, block sizes a multiple of 16
and ``tb * H/KVH <= 64`` query rows take the tensor-core walk; float32
queries, float32 and float16 caches and head dims 16, 96 (Phi-3) and 256
(Gemma) the CUDA-core loop, which converts the cache on load.  Any other
shape raises.

The walk's balance comes from ``plan_ragged_work``: it cuts each token
block's worklist into work items from the host copy of ``page_count``
(``pack_page_meta`` builds it on the host before the step copies it to the
card, so nothing is read back).  The engine packs decode tokens first, so
one block can list every decode lane's pages; a plan made from shapes
alone could not see which.  The plan is made once a step and serves every
layer.  Without a plan the walk takes one item per token block.  The
kernels read a plan from a buffer of fixed capacity (``work_plan``): the
grid is the capacity, the live counts are in the buffer, so the unified
step's CUDA graph of a token bucket serves every plan of that bucket
(``ragged_planner(...).caps(num_tb)`` bounds them all).
"""

from __future__ import annotations

import numpy as np
import torch

from dynamo_tpu_torch.ops.attention import ragged_paged_attention as ragged_plain
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels.common import (
    check_cache,
    check_index,
    dtype_code,
    stream_ptr,
    walk_cache,
)
from dynamo_tpu_torch.ops.kernels.work_plan import DeviceWork, Planner, WorkPlan, launch_args

launches = 0
split_launches = 0
plain_calls = 0

MAX_ROWS = 64                # query rows (tb * heads / kv heads) a CTA holds
SPLIT_HEAD_DIMS = (64, 128)  # head dims of the tensor-core walk
SUB_KEYS = 16                # the walk's sub-tile: block sizes are a multiple
# the work plan's aims: items x kv heads about CTAS_PER_SM CTAs an SM (one
# wave: the walk holds three at Llama-3-8B widths; chip_smoke.py's sweep
# read 2 and 3 alike, 4 slower on a decode block), items of at least
# MIN_ITEM_PAGES entries (but a block's only one), at most
# MAX_ITEMS_PER_BLOCK items a token block (the combine's)
CTAS_PER_SM = 2
MIN_ITEM_PAGES = 16
MAX_ITEMS_PER_BLOCK = 64


def pack_page_meta(
    token_lane,     # [T] int — owning lane per token (out of range / pos<0 = pad)
    token_pos,      # [T] int — absolute position per token (-1 = pad)
    block_tables,   # [lanes, max_blocks] int — logical->physical pages
    *,
    tb_tokens: int,
    block_size: int,
    page_slots: int | None = None,
    sliding_window: int | None = None,
):
    """Host-side (numpy) page worklist, a copy of the reference's packer.

    For every token block: the lanes present in it (first-appearance
    order), then for each lane every page holding positions its tokens can
    see — causally up to ``max(token_pos) // block_size`` and, under a
    sliding window, down from ``(min(token_pos) - W + 1) // block_size``.
    Returns ``(page_phys, page_lane, page_ord, page_count)`` int32 arrays of
    width ``page_slots`` (default: the tightest width that fits).  Pad
    entries repeat the last live physical page; blocks with no live tokens
    point at page 0 with count 0."""
    token_lane = np.asarray(token_lane, np.int64)
    token_pos = np.asarray(token_pos, np.int64)
    bt = np.asarray(block_tables)
    lanes = bt.shape[0]
    t_pad = token_lane.shape[0]
    if t_pad % tb_tokens:
        raise ValueError(
            f"flat token axis ({t_pad}) must pack whole token blocks of "
            f"{tb_tokens}"
        )
    num_tb = t_pad // tb_tokens
    # the (block, lane) spans of the live tokens, in first-appearance order
    # within each block
    live = np.flatnonzero((token_pos >= 0) & (token_lane >= 0) & (token_lane < lanes))
    key = (live // tb_tokens) * lanes + token_lane[live]
    uniq, first_at, inv = np.unique(key, return_index=True, return_inverse=True)
    lo = np.full(uniq.size, np.iinfo(np.int64).max)
    hi = np.full(uniq.size, -1)
    np.minimum.at(lo, inv, token_pos[live])
    np.maximum.at(hi, inv, token_pos[live])
    order = np.argsort(live[first_at], kind="stable")  # block-major, then appearance
    blk, lane = uniq[order] // lanes, uniq[order] % lanes
    lo, hi = lo[order], hi[order]
    first = np.zeros_like(lo)
    if sliding_window is not None:
        first = np.maximum(0, lo - (sliding_window - 1)) // block_size
    n_ent = hi // block_size + 1 - first
    page_count = np.bincount(blk, weights=n_ent, minlength=num_tb).astype(np.int32)
    need = int(page_count.max(initial=0))
    ps = page_slots if page_slots is not None else max(1, need)
    if need > ps:
        raise ValueError(f"page worklist needs {need} slots but page_slots={ps}")
    # entry j of span s: ordinal first[s] + j, at column (entries of the
    # block's earlier spans) + j
    e_span = np.repeat(np.arange(blk.size), n_ent)
    span_start = np.cumsum(n_ent) - n_ent
    j = np.arange(e_span.size) - span_start[e_span]
    blk_start = np.cumsum(page_count) - page_count
    col = span_start[e_span] - blk_start[blk[e_span]] + j
    e_blk, e_lane, e_ord = blk[e_span], lane[e_span], first[e_span] + j
    e_phys = bt[e_lane, e_ord]
    # pad entries repeat each block's last live physical page (page 0 in a
    # block with none)
    last = np.zeros((num_tb,), np.int32)
    ends = np.cumsum(page_count)
    has = page_count > 0
    last[has] = e_phys[ends[has] - 1]
    page_phys = np.repeat(last[:, None], ps, axis=1)
    page_lane = np.full((num_tb, ps), -1, np.int32)
    page_ord = np.zeros((num_tb, ps), np.int32)
    page_phys[e_blk, col] = e_phys
    page_lane[e_blk, col] = e_lane
    page_ord[e_blk, col] = e_ord
    return page_phys, page_lane, page_ord, page_count


def split_route(dtype: torch.dtype, head_dim: int, block_size: int, rows: int,
                cache_dtype: torch.dtype | None = None) -> bool:
    """Whether the tensor-core walk takes this shape on the card: bf16
    queries (``dtype``) over a bf16 or fp8 cache (``cache_dtype``, default
    the queries') at head dims 64 and 128, block sizes a multiple of its
    16-key sub-tile, at most MAX_ROWS query rows a kv head."""
    return (walk_cache(dtype, cache_dtype or dtype) and head_dim in SPLIT_HEAD_DIMS
            and block_size % SUB_KEYS == 0 and rows <= MAX_ROWS)


class RaggedWorkPlan(WorkPlan):
    """The tensor-core walk's work items for one unified step (``WorkPlan``
    with at most MAX_ITEMS_PER_BLOCK items a token block, the combine's)."""

    NAME = "ragged work plan"
    MAX_PER_BLOCK = MAX_ITEMS_PER_BLOCK


def ragged_planner(kv_heads: int, sms: int, rows: int = 0, head_dim: int = 0) -> Planner:
    """Row 1's planner: ``CTAS_PER_SM * sms // kv_heads`` items a step (items
    x kv heads about CTAS_PER_SM CTAs an SM), items of at least
    MIN_ITEM_PAGES entries; a partial slot holds ``kv_heads x rows`` rows of
    ``head_dim`` accumulators, m and l."""
    return Planner(RaggedWorkPlan, max(1, CTAS_PER_SM * sms // max(1, kv_heads)),
                   MIN_ITEM_PAGES, kv_heads * rows * (head_dim + 2))


def plan_ragged_work(page_count, *, kv_heads: int, sms: int) -> RaggedWorkPlan:
    """The tensor-core walk's work plan for one step, in numpy, from the
    host copy of ``page_count`` [T // tb] that ``pack_page_meta`` returns
    (``Planner.plan`` at row 1's aims)."""
    return ragged_planner(kv_heads, sms).plan(page_count)


def ragged_paged_attention(
    q: torch.Tensor,             # [T, H, D] flat ragged token batch
    k_cache: torch.Tensor,       # [N, bs, KVH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [lanes, maxb] int32 (read by the plain version)
    token_lane: torch.Tensor,    # [T] int32 owning lane (out of range = pad)
    token_pos: torch.Tensor,     # [T] int32 absolute position (-1 = pad)
    page_phys: torch.Tensor,     # [T // tb_tokens, PS] int32 (pack_page_meta)
    page_lane: torch.Tensor,     # [T // tb_tokens, PS] int32
    page_ord: torch.Tensor,      # [T // tb_tokens, PS] int32
    page_count: torch.Tensor,    # [T // tb_tokens] int32
    *,
    tb_tokens: int = 8,
    pages_per_step: int = 1,     # accepted for signature parity; the output
                                 # does not depend on it
    sliding_window: int | None = None,
    plan: WorkPlan | DeviceWork | None = None,
) -> torch.Tensor:
    """Causally masked paged attention over one mixed prefill+decode token
    batch, several lanes per token block.  ``plan`` balances the
    tensor-core walk: a host ``RaggedWorkPlan`` (``plan_ragged_work`` over
    this step's ``page_count``; copied to the card at its tightest
    capacity), or a ``DeviceWork`` that such a plan was written into at a
    fixed capacity (the unified graphs': the grid and the partials are the
    capacity's, the live counts the buffer's); the CUDA-core loop and the
    plain version do not read it.  Pad rows come out as zeros on the kernel
    path (junk the caller discards on the plain path)."""
    global launches, split_launches, plain_calls
    t, h, d = q.shape
    if t % tb_tokens:
        raise ValueError(
            f"flat token axis ({t}) must pack whole token blocks of {tb_tokens}"
        )
    if pages_per_step < 1 or page_phys.shape[1] % pages_per_step:
        raise ValueError(
            f"page_slots ({page_phys.shape[1]}) must be a positive multiple "
            f"of pages_per_step ({pages_per_step})"
        )
    num_tb = t // tb_tokens
    if plan is not None and plan.num_tb != num_tb:
        raise ValueError(f"ragged work plan: made for {plan.num_tb} token blocks, "
                         f"the call has {num_tb}")
    if q.device.type == "cpu":
        plain_calls += 1
        return ragged_plain(
            q, k_cache, v_cache, block_tables, None, token_lane, token_pos,
            sliding_window=sliding_window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"ragged attention: unsupported device {q.device}")
    q = q.contiguous()
    n, bs, kvh, dk = k_cache.shape
    check_cache(q, k_cache, v_cache, d, dk)
    if h % kvh:
        raise ValueError(f"heads ({h}) must be a multiple of kv heads ({kvh})")
    rows = tb_tokens * (h // kvh)
    if rows > MAX_ROWS:
        raise ValueError(f"ragged attention: {rows} query rows a kv head "
                         f"(tb_tokens x heads / kv heads) > {MAX_ROWS}")
    if (token_lane.shape != (t,) or token_pos.shape != (t,)
            or page_phys.shape[0] != num_tb or page_count.shape != (num_tb,)
            or page_lane.shape != page_phys.shape or page_ord.shape != page_phys.shape):
        raise ValueError("token / page metadata shapes do not match the token axis")
    check_index(
        q.device, token_lane=token_lane, token_pos=token_pos, page_phys=page_phys,
        page_lane=page_lane, page_ord=page_ord, page_count=page_count,
    )
    split = split_route(q.dtype, d, bs, rows, k_cache.dtype)
    if walk_cache(q.dtype, k_cache.dtype) and d in SPLIT_HEAD_DIMS and not split:
        raise ValueError(f"ragged attention: bf16 at head dim {d} takes the tensor-core "
                         f"walk, which needs a block size that is a multiple of "
                         f"{SUB_KEYS} (got {bs})")
    out = torch.empty_like(q)
    (work, part_acc, part_ml, caps), scratch = (None, None, None, (0, 0, 0)), None
    if split and plan is not None:
        # scratch: the call's partials, held here until the launch
        (work, part_acc, part_ml, caps), scratch = launch_args(
            plan, q.device, kvh * rows, d, "ragged work plan")
    code = build.library().dyn_ragged_paged_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        token_lane.data_ptr(), token_pos.data_ptr(), page_phys.data_ptr(),
        page_lane.data_ptr(), page_ord.data_ptr(), page_count.data_ptr(),
        out.data_ptr(), work, part_acc, part_ml, t, h, kvh, d, bs, tb_tokens,
        page_phys.shape[1], sliding_window or 0, *caps,
        dtype_code(q.dtype), dtype_code(k_cache.dtype), stream_ptr(q.device),
    )
    build.check(code, "ragged_paged_attention")
    launches += 1
    if split:
        split_launches += 1
    return out
