"""Paged decode attention: the CUDA kernel's wrapper (csrc/paged_attention.cu).

Counterpart of dynamo_tpu/ops/pallas/paged_attention.py: the window kernel
``paged_window_attention_decode`` (W queries per sequence) and
``paged_attention_decode``, the same kernel at W=1, which the decode step
calls; speculative verify calls it at W = spec_tokens + 1.  A CPU tensor
goes to the plain PyTorch version (``ops.attention.paged_window_attention``);
a CUDA tensor launches the kernel or raises.  ``launches`` counts wrapper
calls that launched the kernel (the split walk and, with more than one
split, its combine), ``window_launches`` those of them at W > 1,
``plain_calls`` calls routed to the plain version.

bf16 queries over a bf16 or fp8 (e4m3fn, e5m2) cache at head dims 64 and
128 take the split walk (other dtypes, and head dim 16, the CUDA-core
loop, converting the cache on load): ``plan_splits``
cuts each sequence's block table into chunks from the shapes alone (never
from ``context_lens``, which would cost a device-to-host read a layer).
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.attention import paged_window_attention
from dynamo_tpu_torch.ops.kernels.common import (
    ceil_div,
    check_cache,
    check_index,
    dtype_code,
    sm_count,
    stream_ptr,
    walk_cache,
)
from dynamo_tpu_torch.ops.kernels import build

launches = 0
window_launches = 0
plain_calls = 0

MAX_ROWS = 64  # query rows (W * heads / kv heads) a kv head may have
SPLIT_HEAD_DIMS = (64, 128)  # head dims of the split tensor-core walk
ROWS_PER_CTA = 32    # query rows a CTA of the split walk holds (more: row groups)
CTAS_PER_SM = 2      # the split walk's grid aims at about this many CTAs an SM
MIN_CHUNK_KEYS = 64  # a split walks at least this many positions
MAX_SPLITS = 64      # splits a (sequence, kv head) may have (the combine's)


def plan_splits(batch: int, kv_heads: int, rows: int, max_blocks: int,
                block_size: int, sms: int) -> tuple[int, int]:
    """``(splits, chunk_pages)`` of the split walk, from shapes alone:
    split s of a (sequence, kv head, row group) walks table pages
    ``[s * chunk_pages, (s + 1) * chunk_pages)``.  Enough splits that the
    grid holds about ``CTAS_PER_SM`` CTAs an SM (splits past a sequence's
    context exit at once), no more than ``MAX_SPLITS`` and none shorter
    than ``MIN_CHUNK_KEYS`` positions, and ``splits * chunk_pages >=
    max_blocks`` with no empty trailing split."""
    max_blocks = max(1, max_blocks)
    ctas = max(1, batch * kv_heads * ceil_div(rows, ROWS_PER_CTA))
    most = min(MAX_SPLITS, ceil_div(max_blocks, ceil_div(MIN_CHUNK_KEYS, block_size)))
    splits = max(1, min(ceil_div(CTAS_PER_SM * sms, ctas), most))
    chunk = ceil_div(max_blocks, splits)
    return ceil_div(max_blocks, chunk), chunk


def check_window(w: int, heads: int, kv_heads: int) -> None:
    """The kernel takes at most MAX_ROWS = W * (heads / kv_heads) query rows
    a kv head (the CUDA-core loop holds them in one CTA); a wider window is
    refused here, by name, before a launch."""
    rows = w * (heads // kv_heads)
    if rows > MAX_ROWS:
        raise ValueError(
            f"paged window attention: W={w} queries x {heads // kv_heads} heads per kv "
            f"head = {rows} rows > the kernel's {MAX_ROWS}; lower spec_tokens "
            f"(W = spec_tokens + 1) to at most {MAX_ROWS // (heads // kv_heads) - 1}"
        )


def paged_window_attention_decode(
    q: torch.Tensor,             # [B, W, H, D]
    k_cache: torch.Tensor,       # [N, bs, KVH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, maxb] int32
    context_lens: torch.Tensor,  # [B] int32, INCLUDING the window's last token
    *,
    sliding_window: int | None = None,
    pages_per_step: int = 1,     # accepted for signature parity; the output
                                 # does not depend on it
) -> torch.Tensor:
    """Paged GQA attention for W queries per sequence (query w at position
    ``ctx - W + w``).  Idle lanes (ctx 0) come out as zeros on the kernel
    path."""
    global launches, window_launches, plain_calls
    if pages_per_step < 1:
        raise ValueError(f"pages_per_step must be >= 1, got {pages_per_step}")
    if q.device.type == "cpu":
        plain_calls += 1
        return paged_window_attention(
            q, k_cache, v_cache, block_tables, context_lens,
            sliding_window=sliding_window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged attention: unsupported device {q.device}")
    q = q.contiguous()
    b, w, h, d = q.shape
    n, bs, kvh, dk = k_cache.shape
    check_cache(q, k_cache, v_cache, d, dk)
    if h % kvh:
        raise ValueError(f"heads ({h}) must be a multiple of kv heads ({kvh})")
    check_window(w, h, kvh)
    if block_tables.shape[0] != b or context_lens.shape != (b,):
        raise ValueError("block_tables / context_lens do not match the batch")
    check_index(q.device, block_tables=block_tables, context_lens=context_lens)
    out = torch.empty_like(q)
    max_blocks = block_tables.shape[1]
    splits, chunk, part_acc, part_ml = 1, max_blocks, None, None
    if walk_cache(q.dtype, k_cache.dtype) and d in SPLIT_HEAD_DIMS:
        rows = w * (h // kvh)
        splits, chunk = plan_splits(b, kvh, rows, max_blocks, bs, sm_count(q.device))
        if splits > 1:  # the partials the combine merges: acc, then m and l
            n_rows = b * kvh * splits * rows
            scratch = torch.empty(n_rows * (d + 2), dtype=torch.float32, device=q.device)
            part_acc = scratch.data_ptr()
            part_ml = part_acc + n_rows * d * 4
    lib = build.library()
    code = lib.dyn_paged_window_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(), part_acc, part_ml,
        b, w, h, kvh, d, bs, max_blocks, sliding_window or 0, splits, chunk,
        dtype_code(q.dtype), dtype_code(k_cache.dtype), stream_ptr(q.device),
    )
    build.check(code, "paged_window_attention_decode")
    launches += 1
    if w > 1:
        window_launches += 1
    return out


def paged_attention_decode(
    q: torch.Tensor,             # [B, H, D]
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    sliding_window: int | None = None,
    pages_per_step: int = 1,
) -> torch.Tensor:
    """Plain decode: the window kernel at W=1 (``pos <= ctx - 1`` is
    ``pos < ctx``)."""
    return paged_window_attention_decode(
        q[:, None], k_cache, v_cache, block_tables, context_lens,
        sliding_window=sliding_window, pages_per_step=pages_per_step,
    )[:, 0]
