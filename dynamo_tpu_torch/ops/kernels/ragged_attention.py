"""Ragged unified-batch paged attention: the CUDA kernel's wrapper
(csrc/ragged_attention.cu) and the host-side packing of its page worklist.

Counterpart of dynamo_tpu/ops/pallas/ragged_attention.py.  The flat token
axis (chunked-prefill spans and decode tokens of different sequences,
packed densely) is cut into blocks of ``tb_tokens`` tokens;
``pack_page_meta`` lists for each block the physical pages its tokens can
see, and the kernel walks that list.  A CPU tensor goes to the plain
PyTorch version (``ops.attention.ragged_paged_attention``, which reads the
block tables instead of the worklist); a CUDA tensor launches the kernel or
raises.  ``launches`` counts kernel launches, ``plain_calls`` calls routed
to the plain version.
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
)

launches = 0
plain_calls = 0


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
) -> torch.Tensor:
    """Causally masked paged attention over one mixed prefill+decode token
    batch, several lanes per token block.  Pad rows come out as zeros on
    the kernel path (junk the caller discards on the plain path)."""
    global launches, plain_calls
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
    num_tb = t // tb_tokens
    if (token_lane.shape != (t,) or token_pos.shape != (t,)
            or page_phys.shape[0] != num_tb or page_count.shape != (num_tb,)
            or page_lane.shape != page_phys.shape or page_ord.shape != page_phys.shape):
        raise ValueError("token / page metadata shapes do not match the token axis")
    check_index(
        q.device, token_lane=token_lane, token_pos=token_pos, page_phys=page_phys,
        page_lane=page_lane, page_ord=page_ord, page_count=page_count,
    )
    out = torch.empty_like(q)
    lib = build.library()
    code = lib.dyn_ragged_paged_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        token_lane.data_ptr(), token_pos.data_ptr(), page_phys.data_ptr(),
        page_lane.data_ptr(), page_ord.data_ptr(), page_count.data_ptr(),
        out.data_ptr(), t, h, kvh, d, bs, tb_tokens, page_phys.shape[1],
        sliding_window or 0, dtype_code(q.dtype), stream_ptr(q.device),
    )
    build.check(code, "ragged_paged_attention")
    launches += 1
    return out
