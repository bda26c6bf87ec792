"""MLA (multi-head latent attention) kernels' wrappers (csrc/mla_attention.cu).

Counterpart of dynamo_tpu/ops/pallas/mla_attention.py:
``mla_paged_attention_decode`` (the absorbed decode step),
``mla_paged_window_attention_decode`` (speculative verify: W queries a
sequence) and ``ragged_mla_attention`` (the unified ragged step, over the
page worklist of ``pack_page_meta`` built from the latent block tables).
All take the
float32 absorbed queries ``q_lat``, the roped queries ``q_rope`` and the two
caches ``ck [N, bs, R]`` (latents: keys AND values) and ``kr [N, bs, P]``
(rope keys) in the model dtype, and return the float32 context in latent
space.  A CPU tensor goes to the plain PyTorch version in ``ops.attention``;
a CUDA tensor launches the kernel or raises.  ``*_launches`` count wrapper
calls that launched the kernel (for the ragged split walk: the walk and,
with more than one chunk, its combine), ``*_plain_calls`` calls routed to
the plain version.

The ragged step at DeepSeek widths (bf16 caches, R 512, P 64, 16-position
pages, heads a multiple of 16) takes the split tensor-core walk:
``plan_chunks`` cuts every token block's page worklist into chunks from
the shapes alone (never from ``page_count``, which would cost a
device-to-host read a layer).
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.attention import (
    mla_paged_decode_attention,
    mla_paged_window_attention,
    ragged_mla_paged_attention,
)
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels.common import (
    ceil_div,
    check_index,
    check_layout,
    dtype_code,
    sm_count,
    stream_ptr,
)

decode_launches = 0
decode_plain_calls = 0
ragged_launches = 0
ragged_plain_calls = 0
window_launches = 0
window_plain_calls = 0

# (R, P) geometries the kernels are built for: DeepSeek-V2/V3 and tiny_mla
GEOMETRIES = ((512, 64), (32, 8))
MAX_TOKEN_BLOCK = 8  # tb_tokens the ragged kernel takes (query rows per CTA)
# the ragged split walk (csrc/mla_attention.cu, rtc::): its geometry, the
# 16-row MMA tiles a CTA holds, and the planner's aims
SPLIT_GEOMETRY = (512, 64, 16)  # R, P, block size
TILES_PER_CTA = 4
CTAS_PER_SM = 4        # the grid aims at about this many CTAs an SM
MIN_CHUNK_PAGES = 16   # a chunk holds at least this many worklist entries ...
MAX_CHUNK_PAGES = 256  # ... and at most this many (the kernel's list)
MAX_CHUNKS = 256       # chunks a worklist may have (the combine's)


def plan_chunks(num_tb: int, tb_tokens: int, heads: int, page_slots: int,
                sms: int) -> tuple[int, int]:
    """``(chunks, chunk_pages)`` of the ragged split walk, from shapes
    alone: chunk c of a token block walks worklist entries ``[c *
    chunk_pages, (c + 1) * chunk_pages)``.  Enough chunks that the grid
    (chunks x tile groups x token blocks) holds about ``CTAS_PER_SM`` CTAs
    an SM (chunks past a block's ``page_count`` exit at once), at most
    ``MAX_CHUNKS``, none shorter than ``MIN_CHUNK_PAGES`` or longer than
    ``MAX_CHUNK_PAGES`` (so a worklist of more than MAX_CHUNKS *
    MAX_CHUNK_PAGES entries is refused at launch), and ``chunks *
    chunk_pages >= page_slots`` with no empty trailing chunk."""
    page_slots = max(1, page_slots)
    groups = ceil_div(ceil_div(tb_tokens * heads, 16), TILES_PER_CTA)
    ctas = max(1, num_tb * groups)
    chunks = min(ceil_div(CTAS_PER_SM * sms, ctas), ceil_div(page_slots, MIN_CHUNK_PAGES),
                 MAX_CHUNKS)
    chunks = max(1, chunks, ceil_div(page_slots, MAX_CHUNK_PAGES))
    chunk = ceil_div(page_slots, chunks)
    return ceil_div(page_slots, chunk), chunk


def _check(q_lat, q_rope, ck_cache, kr_cache) -> None:
    """Device, dtype, shape, contiguity and alignment of the queries and the
    two caches: q_lat float32; q_rope and both caches in one dtype, float32
    or bfloat16."""
    if ck_cache.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"cache dtype {ck_cache.dtype} is not supported by the MLA kernels "
            "(float32, bfloat16; fp8 caches come with the quantized slice)"
        )
    if q_lat.dtype != torch.float32:
        raise ValueError(f"q_lat must be float32 (the absorbed einsum's), got {q_lat.dtype}")
    if q_rope.dtype != ck_cache.dtype or kr_cache.dtype != ck_cache.dtype:
        raise ValueError(
            f"q_rope ({q_rope.dtype}) and caches ({ck_cache.dtype}, {kr_cache.dtype}) "
            "must share one dtype"
        )
    r, p = q_lat.shape[-1], q_rope.shape[-1]
    if (r, p) not in GEOMETRIES:
        raise ValueError(f"MLA widths (R={r}, P={p}) not in {GEOMETRIES}")
    if (ck_cache.dim() != 3 or kr_cache.dim() != 3 or ck_cache.shape[2] != r
            or kr_cache.shape[2] != p or ck_cache.shape[:2] != kr_cache.shape[:2]):
        raise ValueError(
            f"caches must be ck [N, bs, {r}] and kr [N, bs, {p}], got "
            f"{tuple(ck_cache.shape)} and {tuple(kr_cache.shape)}"
        )
    if q_rope.shape[:-1] != q_lat.shape[:-1]:
        raise ValueError("q_lat and q_rope differ in their leading shape")
    check_layout(q_lat.device, q_lat=q_lat, q_rope=q_rope, ck_cache=ck_cache,
                 kr_cache=kr_cache)


def mla_paged_attention_decode(
    q_lat: torch.Tensor,         # [B, H, R] float32
    q_rope: torch.Tensor,        # [B, H, P] model dtype
    ck_cache: torch.Tensor,      # [N, bs, R]
    kr_cache: torch.Tensor,      # [N, bs, P]
    block_tables: torch.Tensor,  # [B, maxb] int32
    context_lens: torch.Tensor,  # [B] int32
    *,
    scale: float,
    pages_per_step: int = 1,     # accepted for signature parity; the output
                                 # does not depend on it
) -> torch.Tensor:
    """Absorbed MLA decode attention: positions ``pos < ctx``.  Returns the
    float32 latent context [B, H, R]; idle lanes (ctx 0) come out as zeros
    on the kernel path."""
    global decode_launches, decode_plain_calls
    if pages_per_step < 1:
        raise ValueError(f"pages_per_step must be >= 1, got {pages_per_step}")
    if q_lat.device.type == "cpu":
        decode_plain_calls += 1
        return mla_paged_decode_attention(
            q_lat, q_rope, ck_cache, kr_cache, block_tables, context_lens, scale=scale,
        )
    if q_lat.device.type != "cuda":
        raise ValueError(f"MLA decode attention: unsupported device {q_lat.device}")
    q_lat, q_rope = q_lat.contiguous(), q_rope.contiguous()
    _check(q_lat, q_rope, ck_cache, kr_cache)
    b, h, r = q_lat.shape
    if block_tables.shape[0] != b or context_lens.shape != (b,):
        raise ValueError("block_tables / context_lens do not match the batch")
    check_index(q_lat.device, block_tables=block_tables, context_lens=context_lens)
    out = torch.empty_like(q_lat)
    code = build.library().dyn_mla_paged_decode(
        q_lat.data_ptr(), q_rope.data_ptr(), ck_cache.data_ptr(), kr_cache.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        b, h, r, q_rope.shape[-1], ck_cache.shape[1], block_tables.shape[1],
        float(scale), dtype_code(ck_cache.dtype), stream_ptr(q_lat.device),
    )
    build.check(code, "mla_paged_attention_decode")
    decode_launches += 1
    return out


def mla_paged_window_attention_decode(
    q_lat: torch.Tensor,         # [B, W, H, R] float32
    q_rope: torch.Tensor,        # [B, W, H, P] model dtype
    ck_cache: torch.Tensor,      # [N, bs, R]
    kr_cache: torch.Tensor,      # [N, bs, P]
    block_tables: torch.Tensor,  # [B, maxb] int32
    context_lens: torch.Tensor,  # [B] int32, INCLUDING the window's last token
    *,
    scale: float,
) -> torch.Tensor:
    """Multi-query absorbed MLA attention for speculative verification:
    query w of a sequence sees the positions up to ``ctx - W + w``.
    Returns the float32 latent context [B, W, H, R]; idle lanes (ctx 0)
    come out as zeros on the kernel path (junk the caller discards on the
    plain path)."""
    global window_launches, window_plain_calls
    if q_lat.device.type == "cpu":
        window_plain_calls += 1
        return mla_paged_window_attention(
            q_lat, q_rope, ck_cache, kr_cache, block_tables, context_lens, scale=scale,
        )
    if q_lat.device.type != "cuda":
        raise ValueError(f"MLA window attention: unsupported device {q_lat.device}")
    q_lat, q_rope = q_lat.contiguous(), q_rope.contiguous()
    _check(q_lat, q_rope, ck_cache, kr_cache)
    b, w, h, r = q_lat.shape
    if block_tables.shape[0] != b or context_lens.shape != (b,):
        raise ValueError("block_tables / context_lens do not match the batch")
    check_index(q_lat.device, block_tables=block_tables, context_lens=context_lens)
    out = torch.empty_like(q_lat)
    code = build.library().dyn_mla_paged_window_decode(
        q_lat.data_ptr(), q_rope.data_ptr(), ck_cache.data_ptr(), kr_cache.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        b, w, h, r, q_rope.shape[-1], ck_cache.shape[1], block_tables.shape[1],
        float(scale), dtype_code(ck_cache.dtype), stream_ptr(q_lat.device),
    )
    build.check(code, "mla_paged_window_attention_decode")
    window_launches += 1
    return out


def ragged_mla_attention(
    q_lat: torch.Tensor,         # [T, H, R] float32 flat ragged token batch
    q_rope: torch.Tensor,        # [T, H, P] model dtype
    ck_cache: torch.Tensor,      # [N, bs, R]
    kr_cache: torch.Tensor,      # [N, bs, P]
    block_tables: torch.Tensor,  # [lanes, maxb] int32 (read by the plain version)
    token_lane: torch.Tensor,    # [T] int32 owning lane (out of range = pad)
    token_pos: torch.Tensor,     # [T] int32 absolute position (-1 = pad)
    page_phys: torch.Tensor,     # [T // tb_tokens, PS] int32 (pack_page_meta)
    page_lane: torch.Tensor,     # [T // tb_tokens, PS] int32
    page_ord: torch.Tensor,      # [T // tb_tokens, PS] int32
    page_count: torch.Tensor,    # [T // tb_tokens] int32
    *,
    scale: float,
    tb_tokens: int = 8,
    pages_per_step: int = 1,     # accepted for signature parity; the output
                                 # does not depend on it
) -> torch.Tensor:
    """Ragged unified-batch MLA attention over the latent cache: every
    token attends its own lane's positions up to its own.  Returns the
    float32 latent context [T, H, R]; pad rows come out as zeros on the
    kernel path (junk the caller discards on the plain path)."""
    global ragged_launches, ragged_plain_calls
    t, h, r = q_lat.shape
    if t % tb_tokens:
        raise ValueError(f"flat token axis ({t}) must pack whole token blocks of {tb_tokens}")
    if pages_per_step < 1 or page_phys.shape[1] % pages_per_step:
        raise ValueError(
            f"page_slots ({page_phys.shape[1]}) must be a positive multiple "
            f"of pages_per_step ({pages_per_step})"
        )
    if q_lat.device.type == "cpu":
        ragged_plain_calls += 1
        return ragged_mla_paged_attention(
            q_lat, q_rope, ck_cache, kr_cache, block_tables, token_lane, token_pos,
            scale=scale,
        )
    if q_lat.device.type != "cuda":
        raise ValueError(f"ragged MLA attention: unsupported device {q_lat.device}")
    if tb_tokens > MAX_TOKEN_BLOCK:
        raise ValueError(f"tb_tokens {tb_tokens} > {MAX_TOKEN_BLOCK}")
    q_lat, q_rope = q_lat.contiguous(), q_rope.contiguous()
    _check(q_lat, q_rope, ck_cache, kr_cache)
    num_tb = t // tb_tokens
    if (token_lane.shape != (t,) or token_pos.shape != (t,)
            or page_phys.shape[0] != num_tb or page_count.shape != (num_tb,)
            or page_lane.shape != page_phys.shape or page_ord.shape != page_phys.shape):
        raise ValueError("token / page metadata shapes do not match the token axis")
    check_index(
        q_lat.device, token_lane=token_lane, token_pos=token_pos, page_phys=page_phys,
        page_lane=page_lane, page_ord=page_ord, page_count=page_count,
    )
    out = torch.empty_like(q_lat)
    p, bs, slots = q_rope.shape[-1], ck_cache.shape[1], page_phys.shape[1]
    chunks, chunk, part_acc, part_ml = 1, slots, None, None
    if ck_cache.dtype == torch.bfloat16 and (r, p, bs) == SPLIT_GEOMETRY and h % 16 == 0:
        chunks, chunk = plan_chunks(num_tb, tb_tokens, h, slots, sm_count(q_lat.device))
        if chunks > 1:  # the partials the combine merges: acc, then m and l
            n_rows = num_tb * chunks * tb_tokens * h
            scratch = torch.empty(n_rows * (r + 2), dtype=torch.float32, device=q_lat.device)
            part_acc = scratch.data_ptr()
            part_ml = part_acc + n_rows * r * 4
    code = build.library().dyn_ragged_mla_attention(
        q_lat.data_ptr(), q_rope.data_ptr(), ck_cache.data_ptr(), kr_cache.data_ptr(),
        token_lane.data_ptr(), token_pos.data_ptr(), page_phys.data_ptr(),
        page_lane.data_ptr(), page_ord.data_ptr(), page_count.data_ptr(), out.data_ptr(),
        part_acc, part_ml,
        t, h, r, p, bs, tb_tokens, slots, chunks, chunk,
        float(scale), dtype_code(ck_cache.dtype), stream_ptr(q_lat.device),
    )
    build.check(code, "ragged_mla_attention")
    ragged_launches += 1
    return out
