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

Routes on the card (``split_route``): bf16 caches at head dims 64 and 128,
block sizes a multiple of 16 and ``tb * H/KVH <= 64`` query rows take the
tensor-core walk; float32 caches and head dim 16 the CUDA-core loop.  Any
other shape raises.

The walk's balance comes from ``plan_ragged_work``: it cuts each token
block's worklist into work items from the host copy of ``page_count``
(``pack_page_meta`` builds it on the host before the step copies it to the
card, so nothing is read back).  The engine packs decode tokens first, so
one block can list every decode lane's pages; a plan made from shapes
alone could not see which.  The plan is made once a step and serves every
layer.  Without a plan the walk takes one item per token block.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamo_tpu_torch.ops.attention import ragged_paged_attention as ragged_plain
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels.common import (
    ceil_div,
    check_cache,
    check_index,
    dtype_code,
    stream_ptr,
)

launches = 0
split_launches = 0
plain_calls = 0

MAX_ROWS = 64                # query rows (tb * heads / kv heads) a CTA holds
SPLIT_HEAD_DIMS = (64, 128)  # bf16 head dims of the tensor-core walk
SUB_KEYS = 16                # the walk's sub-tile: block sizes are a multiple
# the work plan's aims: items x kv heads about CTAS_PER_SM CTAs an SM (one
# wave: the walk holds three at Llama-3-8B widths; chip_smoke.py's sweep
# read 2 and 3 alike, 4 slower on a decode block), items of at least
# MIN_ITEM_PAGES entries (but a block's only one), at most
# MAX_ITEMS_PER_BLOCK items a token block (the combine's)
CTAS_PER_SM = 2
MIN_ITEM_PAGES = 16
MAX_ITEMS_PER_BLOCK = 64
MAX_GRID_ITEMS = 65535  # items a launch may have (the grid's y extent)


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
    token_lane = np.asarray(token_lane)
    token_pos = np.asarray(token_pos)
    bt = np.asarray(block_tables)
    lanes = bt.shape[0]
    t_pad = token_lane.shape[0]
    if t_pad % tb_tokens:
        raise ValueError(
            f"flat token axis ({t_pad}) must pack whole token blocks of "
            f"{tb_tokens}"
        )
    num_tb = t_pad // tb_tokens
    per_block: list[list[tuple[int, int, int]]] = []
    for t in range(num_tb):
        span: dict[int, tuple[int, int]] = {}
        for i in range(t * tb_tokens, (t + 1) * tb_tokens):
            lane, pos = int(token_lane[i]), int(token_pos[i])
            if pos < 0 or not 0 <= lane < lanes:
                continue
            lo, hi = span.get(lane, (pos, pos))
            span[lane] = (min(lo, pos), max(hi, pos))
        entries: list[tuple[int, int, int]] = []
        for lane, (lo, hi) in span.items():
            first = 0
            if sliding_window is not None:
                first = max(0, lo - (sliding_window - 1)) // block_size
            for ord_ in range(first, hi // block_size + 1):
                entries.append((int(bt[lane, ord_]), lane, ord_))
        per_block.append(entries)
    need = max((len(e) for e in per_block), default=0)
    ps = page_slots if page_slots is not None else max(1, need)
    if need > ps:
        raise ValueError(f"page worklist needs {need} slots but page_slots={ps}")
    page_phys = np.zeros((num_tb, ps), np.int32)
    page_lane = np.full((num_tb, ps), -1, np.int32)
    page_ord = np.zeros((num_tb, ps), np.int32)
    page_count = np.zeros((num_tb,), np.int32)
    for t, entries in enumerate(per_block):
        page_count[t] = len(entries)
        for j, (phys, lane, ord_) in enumerate(entries):
            page_phys[t, j] = phys
            page_lane[t, j] = lane
            page_ord[t, j] = ord_
        if entries:
            page_phys[t, len(entries):] = entries[-1][0]
    return page_phys, page_lane, page_ord, page_count


def split_route(dtype: torch.dtype, head_dim: int, block_size: int, rows: int) -> bool:
    """Whether the tensor-core walk takes this shape on the card: bf16 at
    head dims 64 and 128, block sizes a multiple of its 16-key sub-tile, at
    most MAX_ROWS query rows a kv head."""
    return (dtype == torch.bfloat16 and head_dim in SPLIT_HEAD_DIMS
            and block_size % SUB_KEYS == 0 and rows <= MAX_ROWS)


class RaggedWorkPlan:
    """The tensor-core walk's work items for one unified step.

    ``items`` [n, 4] int32: (token block, first entry, end entry, partial
    slot or -1), in any order (the planner lists the longest first, the
    order the grid starts them).  A token block's items tile its worklist
    ``[0, page_count[t])``; a block with one item has slot -1 (the walk
    writes its output), a block with several gives each a partial slot,
    numbered in entry order across the blocks in block order.
    ``combines`` [m, 4] int32: (token block, first slot, slots, 0) for
    every block with several items; the combine kernel merges those slots
    in order.

    The constructor refuses, by name, items that do not cover every
    block's ``[0, page_count)`` exactly once, or whose slots do not follow
    that numbering."""

    def __init__(self, items, page_count):
        items = np.asarray(items, np.int32).reshape(-1, 4)
        counts = np.asarray(page_count, np.int64).reshape(-1)
        if len(items) > MAX_GRID_ITEMS:
            raise ValueError(f"ragged work plan: {len(items)} items exceed the grid's "
                             f"{MAX_GRID_ITEMS}")
        ordered = items[np.lexsort((items[:, 1], items[:, 0]))]
        split = _check_items(ordered, counts)
        first = np.r_[True, ordered[1:, 0] != ordered[:-1, 0]] & split
        n_of = np.bincount(ordered[:, 0], minlength=counts.size)
        combines = np.stack([ordered[first, 0], ordered[first, 3], n_of[ordered[first, 0]],
                             np.zeros(int(first.sum()), np.int64)], 1)
        self.items = items
        self.combines = combines.astype(np.int32).reshape(-1, 4)
        self.n_partials = int(split.sum())
        self.num_tb = int(counts.size)
        self._work: dict[torch.device, torch.Tensor] = {}

    def work(self, device: torch.device) -> torch.Tensor:
        """Items then combines as one int32 tensor on ``device``, copied
        once a plan (every layer of the step reads the same copy), from
        pinned memory: a pageable copy would wait for the stream, so for a
        decode window still in flight."""
        if device not in self._work:
            both = torch.from_numpy(np.concatenate([self.items, self.combines]))
            if device.type == "cuda":
                both = both.pin_memory()
            self._work[device] = both.to(device, non_blocking=True)
        return self._work[device]


def _check_items(items: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Refuse ``items`` (sorted by block, then first entry) that do not
    tile every block's ``[0, page_count)`` exactly once, or whose slots are
    not the numbering of ``RaggedWorkPlan``; return which items are
    partials."""
    block, first, end, slot = (items[:, i].astype(np.int64) for i in range(4))
    num_tb = counts.size
    if block.size == 0:
        if num_tb:
            raise ValueError("ragged work plan: token block 0 has no item")
        return np.zeros(0, bool)
    if ((block < 0) | (block >= num_tb)).any():
        raise ValueError(f"ragged work plan: a token block outside [0, {num_tb})")
    n_of = np.bincount(block, minlength=num_tb)
    if (n_of == 0).any():
        raise ValueError(f"ragged work plan: token block {int(np.argmin(n_of))} has no item")
    if n_of.max(initial=0) > MAX_ITEMS_PER_BLOCK:
        raise ValueError(f"ragged work plan: a token block has {n_of.max()} items, "
                         f"more than {MAX_ITEMS_PER_BLOCK}")
    starts = np.r_[True, block[1:] != block[:-1]]
    lasts = np.r_[block[1:] != block[:-1], True]
    prev_end = np.r_[0, end[:-1]]
    tiles = (np.where(starts, first == 0, first == prev_end)
             & np.where(lasts, end == counts[block], True)
             & ((end > first) | ((end == first) & (counts[block] == 0))))
    if not tiles.all():
        bad = int(block[np.argmin(tiles)])
        raise ValueError(f"ragged work plan: the items of token block {bad} do not "
                         f"cover its entries [0, {int(counts[bad])}) exactly once")
    split = n_of[block] > 1
    if not (slot == np.where(split, np.cumsum(split) - 1, -1)).all():
        raise ValueError("ragged work plan: partial slots must number the items of "
                         "split token blocks in order, and be -1 elsewhere")
    return split


def plan_ragged_work(page_count, *, kv_heads: int, sms: int) -> RaggedWorkPlan:
    """The tensor-core walk's work plan for one step, in numpy, from the
    host copy of ``page_count`` [T // tb] that ``pack_page_meta`` returns.

    Items are about ``length = total entries / target`` long, target =
    ``CTAS_PER_SM * sms // kv_heads`` items, and never shorter than
    MIN_ITEM_PAGES: each block of ``c`` entries is cut into ``round(c /
    length)`` items of equal length (within one), at least one, at most
    ``c // MIN_ITEM_PAGES`` and MAX_ITEMS_PER_BLOCK, so no item is longer
    than 1.5 ``length`` unless its block is capped.  The items are listed
    longest first (a stable sort: ties keep block order)."""
    counts = np.asarray(page_count, np.int64).reshape(-1)
    num_tb = counts.size
    target = max(1, CTAS_PER_SM * sms // max(1, kv_heads))
    length = max(MIN_ITEM_PAGES, ceil_div(int(counts.sum()), target))
    n = np.clip(np.minimum((2 * counts + length) // (2 * length), counts // MIN_ITEM_PAGES),
                1, MAX_ITEMS_PER_BLOCK)
    block = np.repeat(np.arange(num_tb), n)
    k = np.arange(block.size) - np.repeat(np.cumsum(n) - n, n)
    c, nb = counts[block], n[block]
    first, end = k * c // nb, (k + 1) * c // nb
    split = nb > 1
    slot = np.where(split, np.cumsum(split) - 1, -1)
    items = np.stack([block, first, end, slot], 1)
    items = items[np.argsort(first - end, kind="stable")]
    return RaggedWorkPlan(items, counts)


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
    plan: RaggedWorkPlan | None = None,
) -> torch.Tensor:
    """Causally masked paged attention over one mixed prefill+decode token
    batch, several lanes per token block.  ``plan`` (``plan_ragged_work``
    over this step's ``page_count``) balances the tensor-core walk; the
    CUDA-core loop and the plain version do not read it.  Pad rows come out
    as zeros on the kernel path (junk the caller discards on the plain
    path)."""
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
    split = split_route(q.dtype, d, bs, rows)
    if q.dtype == torch.bfloat16 and d in SPLIT_HEAD_DIMS and not split:
        raise ValueError(f"ragged attention: bf16 at head dim {d} takes the tensor-core "
                         f"walk, which needs a block size that is a multiple of "
                         f"{SUB_KEYS} (got {bs})")
    out = torch.empty_like(q)
    work, part_acc, part_ml, n_items, n_combines, n_partials = None, None, None, 0, 0, 0
    if split and plan is not None:
        work = plan.work(q.device).data_ptr()
        n_items, n_combines, n_partials = len(plan.items), len(plan.combines), plan.n_partials
        if n_partials:  # the partials the combine merges: acc, then m and l
            n_rows = n_partials * kvh * rows
            scratch = torch.empty(n_rows * (d + 2), dtype=torch.float32, device=q.device)
            part_acc = scratch.data_ptr()
            part_ml = part_acc + n_rows * d * 4
    code = build.library().dyn_ragged_paged_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        token_lane.data_ptr(), token_pos.data_ptr(), page_phys.data_ptr(),
        page_lane.data_ptr(), page_ord.data_ptr(), page_count.data_ptr(),
        out.data_ptr(), work, part_acc, part_ml, t, h, kvh, d, bs, tb_tokens,
        page_phys.shape[1], sliding_window or 0, n_items, n_combines, n_partials,
        dtype_code(q.dtype), stream_ptr(q.device),
    )
    build.check(code, "ragged_paged_attention")
    launches += 1
    if split:
        split_launches += 1
    return out
