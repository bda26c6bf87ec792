"""MLA (multi-head latent attention) kernels' wrappers (csrc/mla_attention.cu).

Counterpart of dynamo_tpu/ops/pallas/mla_attention.py:
``mla_paged_attention_decode`` (the absorbed decode step),
``mla_paged_window_attention_decode`` (speculative verify: W queries a
sequence) and ``ragged_mla_attention`` (the unified ragged step, over the
page worklist of ``pack_page_meta`` built from the latent block tables).
All take the
float32 absorbed queries ``q_lat``, the roped queries ``q_rope`` in the
model dtype and the two caches ``ck [N, bs, R]`` (latents: keys AND values)
and ``kr [N, bs, P]`` (rope keys) in the cache's dtype (the model's, or a
narrower float: fp8 e4m3fn or e5m2, float16), and return the float32
context in latent space.  A CPU tensor goes to the plain PyTorch version in ``ops.attention``;
a CUDA tensor launches the kernel or raises.  ``*_launches`` count wrapper
calls that launched the kernel (for a split walk: the walk and, with more
than one chunk, its combine), ``*_plain_calls`` calls routed to the plain
version; ``table_walk_launches`` counts the decode and window calls that
took the split table walk.

At DeepSeek widths (bf16 queries over bf16 or fp8 caches, R 512, P 64,
16-position pages, heads a multiple of 16) all three take a split
tensor-core walk with no
device-to-host read.  The ragged walk (row 3) follows the host work plan
of ``mla_planner`` (a ``work_plan.Planner``), made once a unified step
from the host copy of ``page_count`` that ``pack_page_meta`` returns, as
row 1's: partial slots only for the token blocks it splits, in a plan
buffer of fixed capacity (``mla_planner(...).caps(num_tb)``), so the
scratch is bounded by the capacity and not by the worklist's width, and one
CUDA graph of a token bucket serves every plan of it.  Without a plan it
takes one item a token block.  The decode and verify windows' table walk
(rows 4-5) is planned from shapes alone (``plan_table_chunks`` cuts every
sequence's block table; never from ``context_lens``, which would cost a
device-to-host read a layer).  Decode is the window at W = 1 on the card,
as in row 2.  Float32 queries, float32 and float16 caches and the tiny_mla
geometry take the CUDA-core loop, which converts the cache at use.
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
    Q_DTYPES,
    _DTYPES,
    check_index,
    check_layout,
    dtype_code,
    sm_count,
    stream_ptr,
    walk_cache,
)
from dynamo_tpu_torch.ops.kernels.work_plan import DeviceWork, Planner, WorkPlan, launch_args

decode_launches = 0
decode_plain_calls = 0
ragged_launches = 0
ragged_plain_calls = 0
window_launches = 0
window_plain_calls = 0
table_walk_launches = 0

# (R, P) geometries the kernels are built for: DeepSeek-V2/V3 and tiny_mla
GEOMETRIES = ((512, 64), (32, 8))
MAX_TOKEN_BLOCK = 8  # tb_tokens the ragged kernel takes (query rows per CTA)
# the ragged split walk (csrc/mla_attention.cu, rtc::): its geometry, the
# 16-row MMA tiles a CTA holds, and the planner's aims: items x tile groups
# about CTAS_PER_SM CTAs an SM (the walk holds one CTA an SM, so one wave),
# items of at least MIN_CHUNK_PAGES entries (chip_smoke.py's sweep: (1, 8)
# against (2, 16) the same on the smoke's mix and eight decode lanes, 1.8x
# as fast on a short window, and half the partials)
SPLIT_GEOMETRY = (512, 64, 16)  # R, P, block size
TILES_PER_CTA = 4
CTAS_PER_SM = 1
MIN_CHUNK_PAGES = 8
MAX_CHUNK_PAGES = 256  # entries a CTA lists at a time (the kernel's list)
MAX_CHUNKS = 256       # pieces a worklist or table may have (the combines')
# the table walk (rows 4-5, decode and verify window; rtc:: too): the
# 16-row tiles a CTA holds at most (the kernel's cap, MAX_GROUP_TILES, comes
# from shared memory and registers), and the planner's aims
MAX_GROUP_TILES = 3
GROUP_TILES = 3
TABLE_CTAS_PER_SM = 4      # the grid aims at about this many CTAs an SM
TABLE_MIN_CHUNK_KEYS = 64  # a chunk walks at least this many table positions


class MlaWorkPlan(WorkPlan):
    """The ragged MLA walk's work items for one unified step (``WorkPlan``
    with at most MAX_CHUNKS items a token block, the combine's)."""

    NAME = "ragged MLA work plan"
    MAX_PER_BLOCK = MAX_CHUNKS


def tile_groups(tb_tokens: int, heads: int) -> int:
    """CTAs (groups of TILES_PER_CTA 16-row tiles) a token block's
    ``tb_tokens * heads`` rows take."""
    return ceil_div(ceil_div(tb_tokens * heads, 16), TILES_PER_CTA)


def mla_planner(tb_tokens: int, heads: int, sms: int, r: int = 0) -> Planner:
    """Row 3's planner: ``CTAS_PER_SM * sms // groups`` items a step (items
    x tile groups about CTAS_PER_SM CTAs an SM), items of at least
    MIN_CHUNK_PAGES entries; a partial slot holds a token block's
    ``tb_tokens * heads`` rows of ``r`` accumulators, m and l."""
    return Planner(MlaWorkPlan, max(1, CTAS_PER_SM * sms // tile_groups(tb_tokens, heads)),
                   MIN_CHUNK_PAGES, tb_tokens * heads * (r + 2))


def split_route(dtype: torch.dtype, r: int, p: int, block_size: int, heads: int,
                cache_dtype: torch.dtype | None = None) -> bool:
    """Whether the split tensor-core walks take these widths and dtypes:
    bf16 queries (``dtype``) over a bf16 or fp8 cache (``cache_dtype``,
    default the queries'); the kernels test the same."""
    return (walk_cache(dtype, cache_dtype or dtype) and (r, p, block_size) == SPLIT_GEOMETRY
            and heads % 16 == 0)


def table_groups(rows: int) -> int:
    """Tile groups (CTAs a chunk) of a sequence's ``rows`` w-major query
    rows: ``ceil(rows / 16)`` tiles in balanced groups of at most
    ``GROUP_TILES`` (W = 5 at 16 heads: 3 + 2)."""
    return ceil_div(ceil_div(rows, 16), GROUP_TILES)


def plan_table_chunks(batch: int, rows: int, max_blocks: int, block_size: int,
                      sms: int) -> tuple[int, int]:
    """``(chunks, chunk_pages)`` of the table walk, from shapes alone:
    chunk c of a sequence walks table slots ``[c * chunk_pages, (c + 1) *
    chunk_pages)`` for each of the ``table_groups(rows)`` tile groups.
    Enough chunks that the grid (chunks x groups x sequences) holds about
    ``TABLE_CTAS_PER_SM`` CTAs an SM (chunks past a sequence's context exit
    at once), at most ``MAX_CHUNKS``, and ``chunks * chunk_pages >=
    max_blocks`` with no empty trailing chunk.  A chunk walks at least
    ``TABLE_MIN_CHUNK_KEYS`` positions for each tile of the largest group:
    its partial (2 KB a row) then stays a fixed share of the pages it
    reads."""
    max_blocks = max(1, max_blocks)
    groups = table_groups(rows)
    room = ceil_div(ceil_div(rows, 16), groups)
    ctas = max(1, batch * groups)
    floor = ceil_div(TABLE_MIN_CHUNK_KEYS * room, block_size)
    most = min(MAX_CHUNKS, ceil_div(max_blocks, floor))
    chunks = max(1, min(ceil_div(TABLE_CTAS_PER_SM * sms, ctas), most))
    chunk = ceil_div(max_blocks, chunks)
    return ceil_div(max_blocks, chunk), chunk


def _check(q_lat, q_rope, ck_cache, kr_cache) -> None:
    """Device, dtype, shape, contiguity and alignment of the queries and the
    two caches: q_lat float32; q_rope float32 or bfloat16; both caches of
    one dtype in ``_DTYPES``."""
    if ck_cache.dtype not in _DTYPES or kr_cache.dtype != ck_cache.dtype:
        raise ValueError(
            f"caches ({ck_cache.dtype}, {kr_cache.dtype}) must share one dtype of "
            f"{', '.join(str(t).removeprefix('torch.') for t in _DTYPES)}"
        )
    if q_lat.dtype != torch.float32:
        raise ValueError(f"q_lat must be float32 (the absorbed einsum's), got {q_lat.dtype}")
    if q_rope.dtype not in Q_DTYPES:
        raise ValueError(f"q_rope must be float32 or bfloat16, got {q_rope.dtype}")
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


def _window(q_lat, q_rope, ck_cache, kr_cache, block_tables, context_lens, scale,
            name: str) -> torch.Tensor:
    """Launch the window kernel on CUDA tensors q_lat [B, W, H, R], q_rope
    [B, W, H, P]: the split table walk at DeepSeek widths, the CUDA-core
    loop otherwise."""
    global table_walk_launches
    q_lat, q_rope = q_lat.contiguous(), q_rope.contiguous()
    _check(q_lat, q_rope, ck_cache, kr_cache)
    b, w, h, r = q_lat.shape
    if block_tables.shape[0] != b or context_lens.shape != (b,):
        raise ValueError("block_tables / context_lens do not match the batch")
    check_index(q_lat.device, block_tables=block_tables, context_lens=context_lens)
    p, bs, max_blocks = q_rope.shape[-1], ck_cache.shape[1], block_tables.shape[1]
    group_tiles, chunks, chunk, part_acc, part_ml = 0, 1, max(1, max_blocks), None, None
    walk = split_route(q_rope.dtype, r, p, bs, h, ck_cache.dtype)
    if walk:
        group_tiles = GROUP_TILES
        chunks, chunk = plan_table_chunks(b, w * h, max_blocks, bs, sm_count(q_lat.device))
    # the output, then (with more than one chunk) the partials the combine
    # merges: acc, then m and l; one allocation
    n_out, n_rows = q_lat.numel(), b * chunks * w * h if chunks > 1 else 0
    buf = torch.empty(n_out + n_rows * (r + 2), dtype=torch.float32, device=q_lat.device)
    out = buf[:n_out].view(q_lat.shape)
    if n_rows:
        part_acc = buf.data_ptr() + n_out * 4
        part_ml = part_acc + n_rows * r * 4
    code = build.library().dyn_mla_paged_window_decode(
        q_lat.data_ptr(), q_rope.data_ptr(), ck_cache.data_ptr(), kr_cache.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(), part_acc, part_ml,
        b, w, h, r, p, bs, max_blocks, group_tiles, chunks, chunk,
        float(scale), dtype_code(q_rope.dtype), dtype_code(ck_cache.dtype),
        stream_ptr(q_lat.device),
    )
    build.check(code, name)
    if walk:
        table_walk_launches += 1
    return out


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
    on the kernel path (the window kernel at W = 1)."""
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
    out = _window(q_lat[:, None], q_rope[:, None], ck_cache, kr_cache, block_tables,
                  context_lens, scale, "mla_paged_attention_decode")
    decode_launches += 1
    return out[:, 0]


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
    out = _window(q_lat, q_rope, ck_cache, kr_cache, block_tables, context_lens, scale,
                  "mla_paged_window_attention_decode")
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
    plan: WorkPlan | DeviceWork | None = None,
) -> torch.Tensor:
    """Ragged unified-batch MLA attention over the latent cache: every
    token attends its own lane's positions up to its own.  ``plan``
    balances the split walk: a host ``MlaWorkPlan`` (``mla_planner(...).plan``
    over this step's ``page_count``; copied to the card at its tightest
    capacity), or a ``DeviceWork`` such a plan was written into at a fixed
    capacity (the unified graphs'); the CUDA-core loop and the plain
    version do not read it.  Returns the float32 latent context [T, H, R];
    pad rows come out as zeros on the kernel path (junk the caller discards
    on the plain path)."""
    global ragged_launches, ragged_plain_calls
    t, h, r = q_lat.shape
    if t % tb_tokens:
        raise ValueError(f"flat token axis ({t}) must pack whole token blocks of {tb_tokens}")
    if pages_per_step < 1 or page_phys.shape[1] % pages_per_step:
        raise ValueError(
            f"page_slots ({page_phys.shape[1]}) must be a positive multiple "
            f"of pages_per_step ({pages_per_step})"
        )
    if plan is not None and plan.num_tb != t // tb_tokens:
        raise ValueError(f"ragged MLA work plan: made for {plan.num_tb} token blocks, "
                         f"the call has {t // tb_tokens}")
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
    (work, part_acc, part_ml, caps), scratch = (None, None, None, (0, 0, 0)), None
    if split_route(q_rope.dtype, r, p, bs, h, ck_cache.dtype) and plan is not None:
        # scratch: the call's partials, held here until the launch
        (work, part_acc, part_ml, caps), scratch = launch_args(
            plan, q_lat.device, tb_tokens * h, r, "ragged MLA work plan")
    code = build.library().dyn_ragged_mla_attention(
        q_lat.data_ptr(), q_rope.data_ptr(), ck_cache.data_ptr(), kr_cache.data_ptr(),
        token_lane.data_ptr(), token_pos.data_ptr(), page_phys.data_ptr(),
        page_lane.data_ptr(), page_ord.data_ptr(), page_count.data_ptr(), out.data_ptr(),
        work, part_acc, part_ml, t, h, r, p, bs, tb_tokens, slots, *caps,
        float(scale), dtype_code(q_rope.dtype), dtype_code(ck_cache.dtype),
        stream_ptr(q_lat.device),
    )
    build.check(code, "ragged_mla_attention")
    ragged_launches += 1
    return out
