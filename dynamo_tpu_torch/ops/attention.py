"""Attention over the paged KV cache: the plain PyTorch versions
(counterparts of the pure-JAX twins in dynamo_tpu/ops/attention.py).

The KV cache is a flat pool of fixed-size blocks per layer —
``[num_blocks, block_size, kv_heads, head_dim]``, or for MLA (DeepSeek) a
latent cache ``[num_blocks, block_size, R]`` beside a rope-key cache
``[num_blocks, block_size, P]`` — addressed by per-sequence block tables.  These functions are the port's CPU path and the
references that the hand-written CUDA kernels in ``ops/kernels`` are held
against; on the card the model calls the kernels instead.

Numerics follow the reference: scores and softmax in float32, masked scores
at ``NEG_INF``.  A cache may hold another float dtype than the model's (the
engine's ``kv_cache_dtype``: fp8 e4m3fn or e5m2, float16, bfloat16,
float32): every write casts to it as the reference's ``.astype`` does
(``to_cache_dtype``), every read upcasts to float32.  One-byte caches move
as ``uint8`` views (``cache_take``, the writes), which every device indexes.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30

FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
# e4m3fn has no infinity: past 448 the reference's conversion (XLA's, as
# ml_dtypes') rounds to 448 up to 464 and gives NaN above; torch's cast
# saturates at 448 instead
_E4M3_ROUNDS_TO_MAX = 464.0


def to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in a cache dtype, bit for bit as the reference's
    ``x.astype(dtype)``.  Finite values round to nearest even in both
    frameworks; they differ only where a value has no fp8 counterpart:
    - e4m3fn: a magnitude past 464 (infinity included) becomes NaN with its
      sign, where torch saturates at 448;
    - e5m2 keeps infinity; a NaN becomes 0x7e with the NaN's sign from a
      float32 value and 0x7f from a 16-bit one, where torch keeps 0x7f and
      the sign."""
    if x.dtype == dtype:
        return x
    if dtype not in FP8_DTYPES:
        return x.to(dtype)
    bits = x.to(dtype).view(torch.uint8)
    sign = torch.signbit(x).to(torch.uint8) << 7
    if dtype == torch.float8_e4m3fn:
        special, nan_bits = x.abs() > _E4M3_ROUNDS_TO_MAX, sign | 0x7F
    else:
        special = torch.isnan(x)
        nan_bits = sign | 0x7E if x.dtype == torch.float32 else torch.full_like(bits, 0x7F)
    return torch.where(special, nan_bits, bits).view(dtype)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A one-byte float tensor as its ``uint8`` view (what every index op
    takes on every device); any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype in FP8_DTYPES else t


def cache_take(leaf: torch.Tensor, index) -> torch.Tensor:
    """``leaf[index]`` for a cache leaf of any dtype."""
    return _raw(leaf)[index].view(leaf.dtype)


def _put_rows(dst: torch.Tensor, rows: torch.Tensor, new: torch.Tensor) -> None:
    """``dst[rows[i]] = new[i]`` cast to ``dst``'s dtype, in place."""
    _raw(dst).index_copy_(0, rows, _raw(to_cache_dtype(new, dst.dtype)))


def live_slots(slot_ids: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Indices of the entries of ``slot_ids`` that name a real cache slot.
    Pad tokens carry the out-of-range slot ``num_blocks * block_size``; the
    reference drops them in its scatter (``mode="drop"``), while a torch
    index out of range raises and a negative one wraps — so they are masked
    here.  On a CUDA tensor this synchronizes with the host once: the
    decode and unified forwards write through ``slot_rows`` instead, and
    only the synchronous verify step (``last_writer_slots``) keeps it."""
    valid = (slot_ids >= 0) & (slot_ids < num_slots)
    return torch.nonzero(valid).squeeze(1)


def alloc_cache_leaf(shape, dtype, device) -> torch.Tensor:
    """A zeroed cache leaf ``[L, N, bs, *row]`` whose storage holds one row
    more past its last slot: the dump row that pad tokens and idle lanes
    write into (``cache_rows``).  The leaf itself keeps its shape and
    strides, so the kernels, the block copies and the offload tiers see
    ``N`` blocks as before."""
    row = math.prod(shape[3:])
    raw = torch.uint8 if dtype in FP8_DTYPES else dtype
    flat = torch.zeros(math.prod(shape) + row, dtype=raw, device=device)
    return flat[: math.prod(shape)].view(dtype).view(shape)


def cache_rows(leaf: torch.Tensor) -> torch.Tensor:
    """Every slot of a cache leaf ``[L, N, bs, *row]`` as one row of
    ``[L * N * bs + 1, *row]``; the last row is the dump row past the leaf
    (``alloc_cache_leaf``).  Raises for a leaf made without one."""
    slots = leaf.shape[0] * leaf.shape[1] * leaf.shape[2]
    row_shape = tuple(leaf.shape[3:])
    row = math.prod(row_shape)
    need = (leaf.storage_offset() + (slots + 1) * row) * leaf.element_size()
    if not leaf.is_contiguous() or leaf.untyped_storage().nbytes() < need:
        raise ValueError(
            "cache leaf has no dump row past its last slot: make it with "
            "alloc_cache_leaf (the families' init_kv_cache do)"
        )
    return leaf.as_strided((slots + 1, *row_shape), (row, *leaf.stride()[3:]),
                           leaf.storage_offset())


def slot_rows(slot_ids: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``[L, n]`` int64 rows of ``cache_rows(leaf)`` that layer l writes
    token i to: ``l * N * bs + slot`` for a slot in range, the dump row
    ``L * N * bs`` for a pad token or an idle lane (out-of-range slot).
    Chosen on the device: no host sync, and no pad ever lands on a live
    slot (``index_copy_`` leaves the winner among repeated rows unspecified
    on a card, so pads share the dump row only)."""
    layers, n = leaf.shape[0], leaf.shape[1] * leaf.shape[2]
    slots = slot_ids.long()
    valid = (slots >= 0) & (slots < n)
    base = torch.arange(layers, device=slots.device)[:, None] * n
    return torch.where(valid[None, :], slots[None, :] + base, layers * n)


def write_rows(k_rows: torch.Tensor, v_rows: torch.Tensor, rows: torch.Tensor,
               k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """One layer's sync-free decode write: token i's K/V row into row
    ``rows[i]`` of the leaves' ``cache_rows`` views (``slot_rows(...)[l]``),
    in place."""
    _put_rows(k_rows, rows, k_new)
    _put_rows(v_rows, rows, v_new)


def last_writer_slots(slot_ids: torch.Tensor, num_slots: int) -> torch.Tensor:
    """``live_slots`` for a write that may name one slot more than once (a
    verify window clamped at the engine's last position): of the entries
    naming the same slot only the LAST is kept, the order the reference's
    scatter writes in.  ``index_copy_`` with repeated indices leaves the
    winner unspecified on a CUDA tensor; with this list each slot is
    written once."""
    live = live_slots(slot_ids, num_slots)
    slots = slot_ids.index_select(0, live)
    uniq, inverse = torch.unique(slots, return_inverse=True)
    if uniq.numel() == slots.numel():
        return live
    order = torch.arange(slots.numel(), device=slots.device)
    last = torch.full((uniq.numel(),), -1, dtype=order.dtype, device=slots.device)
    last = last.scatter_reduce(0, inverse, order, reduce="amax")
    return live.index_select(0, last)


def write_prefill_kv(
    k_cache: torch.Tensor,   # [num_blocks, block_size, kv_heads, head_dim]
    v_cache: torch.Tensor,
    k_new: torch.Tensor,     # [seq_pad, kv_heads, head_dim]
    v_new: torch.Tensor,
    block_ids: torch.Tensor,  # [max_blocks] int, padded with any value
    seq_len: int,             # valid tokens (the rest is padding, dropped)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter a prefilled sequence's first ``seq_len`` K/V rows into its
    blocks, in place (token i to slot ``block_ids[i // bs] * bs + i % bs``)."""
    num_blocks, block_size = k_cache.shape[:2]
    n = num_blocks * block_size
    idx = torch.arange(int(seq_len), device=k_new.device)
    slots = block_ids.to(k_new.device).long()[idx // block_size] * block_size + idx % block_size
    _put_rows(k_cache.view(n, *k_cache.shape[2:]), slots, k_new[: idx.numel()])
    _put_rows(v_cache.view(n, *v_cache.shape[2:]), slots, v_new[: idx.numel()])
    return k_cache, v_cache


def write_decode_kv(
    k_cache: torch.Tensor,   # [num_blocks, block_size, kv_heads, head_dim]
    v_cache: torch.Tensor,
    k_new: torch.Tensor,     # [n, kv_heads, head_dim] — one row per token
    v_new: torch.Tensor,
    slot_ids: torch.Tensor,  # [n] flat slot (block*block_size+offset); out
                             # of range ⇒ dropped (pad tokens, idle lanes)
    live: torch.Tensor | None = None,  # precomputed live_slots(slot_ids)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter one K/V row per token into its cache slot.  The reference
    returns new arrays (its cache buffer is donated); the port writes the
    cache tensors it was given in place and returns them."""
    num_blocks, block_size = k_cache.shape[:2]
    n = num_blocks * block_size
    if live is None:
        live = live_slots(slot_ids, n)
    slots = slot_ids.index_select(0, live).long()
    _put_rows(k_cache.view(n, *k_cache.shape[2:]), slots, k_new.index_select(0, live))
    _put_rows(v_cache.view(n, *v_cache.shape[2:]), slots, v_new.index_select(0, live))
    return k_cache, v_cache


def _scale(head_dim: int) -> float:
    return 1.0 / math.sqrt(head_dim)


def _window_mask(causal: torch.Tensor, pos_diff: torch.Tensor, window) -> torch.Tensor:
    """AND a sliding-window constraint into ``causal``: an int window always
    applies; a tensor window applies where it is > 0 (<= 0 = full)."""
    if isinstance(window, (int, float)):
        return causal & (pos_diff < window)
    return causal & ((window <= 0) | (pos_diff < window))


def dense_causal_attention(
    q: torch.Tensor,  # [batch, seq, heads, head_dim]
    k: torch.Tensor,  # [batch, seq, kv_heads, head_dim]
    v: torch.Tensor,
    seq_len: torch.Tensor | None = None,  # [batch] valid lengths (padding mask)
    *,
    sliding_window=None,
) -> torch.Tensor:
    """Causal self-attention for prefill (GQA, float32 scores and softmax);
    with a sliding window each query sees only the last ``sliding_window``
    positions.  Padded keys (past ``seq_len``) are masked."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * _scale(d)
    pos = torch.arange(s, device=q.device)
    causal = pos[None, :] <= pos[:, None]  # [q, s]
    if sliding_window is not None:
        causal = _window_mask(causal, pos[:, None] - pos[None, :], sliding_window)
    mask = causal[None, None, None]
    if seq_len is not None:
        valid = pos[None, :] < seq_len.to(q.device)[:, None]  # [b, s]
        mask = mask & valid[:, None, None, None, :]
    # in place: at a 4096-token prompt the scores are 2 GB a layer
    weights = torch.softmax(logits.masked_fill_(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", weights, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def paged_window_attention(
    q: torch.Tensor,             # [batch, w, heads, head_dim] — w queries per seq
    k_cache: torch.Tensor,       # [num_blocks, block_size, kv_heads, head_dim]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [batch, max_blocks] int
    context_lens: torch.Tensor,  # [batch] int: context INCLUDING the window's
                                 # last token (0 ⇒ idle lane)
    *,
    sliding_window: int | None = None,
) -> torch.Tensor:
    """Paged GQA attention for ``w`` queries per sequence: query i sits at
    absolute position ``context_lens - w + i`` and sees every cached
    position up to its own (and, with a sliding window, the last
    ``sliding_window`` of them).  Returns [batch, w, heads, head_dim]."""
    b, w, h, d = q.shape
    _, block_size, kvh, _ = k_cache.shape
    length = block_tables.shape[1] * block_size
    groups = h // kvh

    k = cache_take(k_cache, block_tables).reshape(b, length, kvh, d).float()
    v = cache_take(v_cache, block_tables).reshape(b, length, kvh, d).float()
    qg = q.reshape(b, w, kvh, groups, d).float()
    logits = torch.einsum("bwkgd,blkd->bkgwl", qg, k) * _scale(d)
    q_pos = context_lens[:, None] - w + torch.arange(w, device=q.device)[None, :]
    kv_pos = torch.arange(length, device=q.device)[None, None, :]
    mask = kv_pos <= q_pos[:, :, None]                               # [b, w, l]
    if sliding_window is not None:
        mask = mask & (q_pos[:, :, None] - kv_pos < sliding_window)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgwl,blkd->bwkgd", weights, v)
    return out.reshape(b, w, h, d).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,             # [batch, heads, head_dim] — one query per seq
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [batch, max_blocks]
    context_lens: torch.Tensor,  # [batch] (0 ⇒ idle lane: junk row)
    *,
    sliding_window: int | None = None,
) -> torch.Tensor:
    """Decode-step attention: the window form at w=1 (``pos <= ctx - 1`` is
    ``pos < ctx``).  An idle lane gets uniform weights over junk; callers
    discard it."""
    return paged_window_attention(
        q[:, None], k_cache, v_cache, block_tables, context_lens,
        sliding_window=sliding_window,
    )[:, 0]


def ragged_paged_attention(
    q: torch.Tensor,             # [T, heads, head_dim] flat ragged token batch
    k_cache: torch.Tensor,       # [num_blocks, block_size, kv_heads, head_dim]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [lanes, max_blocks]
    context_lens: torch.Tensor,  # [lanes] (unused by the mask: kept for
                                 # signature parity with the reference)
    token_lane: torch.Tensor,    # [T] owning lane per token (out of range = pad)
    token_pos: torch.Tensor,     # [T] absolute position (-1 = pad)
    *,
    sliding_window: int | None = None,
    max_gather_tokens: int = 64,
) -> torch.Tensor:
    """Ragged unified-batch attention: one flat token axis carries
    chunked-prefill spans and decode tokens of different sequences; each
    token attends its own lane's pages at positions <= its own (every
    token's K/V is already written).  Pad tokens mask fully and give junk
    rows the caller discards.  The per-token page view is gathered
    ``max_gather_tokens`` tokens at a time, which bounds the working set."""
    t, h, d = q.shape
    _, block_size, kvh, _ = k_cache.shape
    lanes, max_blocks = block_tables.shape
    groups = h // kvh
    length = max_blocks * block_size
    lane = token_lane.clamp(0, lanes - 1)
    kv_pos = torch.arange(length, device=q.device)[None, :]
    out = torch.empty_like(q)
    for c0 in range(0, t, max_gather_tokens):
        c1 = min(t, c0 + max_gather_tokens)
        n = c1 - c0
        tables = block_tables[lane[c0:c1]]                       # [n, maxb]
        k = cache_take(k_cache, tables).reshape(n, length, kvh, d).float()
        v = cache_take(v_cache, tables).reshape(n, length, kvh, d).float()
        qg = q[c0:c1].reshape(n, kvh, groups, d).float()
        logits = torch.einsum("tkgd,tlkd->tkgl", qg, k) * _scale(d)
        pos = token_pos[c0:c1, None]
        mask = kv_pos <= pos  # pads at -1 mask everything
        if sliding_window is not None:
            mask = mask & (pos - kv_pos < sliding_window)
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
        weights = torch.softmax(logits, dim=-1)
        out[c0:c1] = torch.einsum("tkgl,tlkd->tkgd", weights, v).reshape(n, h, d).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek) in latent space
# ---------------------------------------------------------------------------


def _mla_scores(q_lat, q_rope, ck, kr, scale: float) -> torch.Tensor:
    """Two-part absorbed scores q_lat·ck + q_rope·kr over gathered keys:
    q [n, H, R|P], keys [n, L, R|P] -> [n, H, L] float32."""
    return (
        torch.einsum("thr,tlr->thl", q_lat.float(), ck.float())
        + torch.einsum("thp,tlp->thl", q_rope.float(), kr.float())
    ) * scale


def mla_paged_decode_attention(
    q_lat: torch.Tensor,         # [B, H, R] float32 absorbed latent queries
    q_rope: torch.Tensor,        # [B, H, P] roped queries
    ck_cache: torch.Tensor,      # [N, bs, R] latents (keys AND values)
    kr_cache: torch.Tensor,      # [N, bs, P] rope keys
    block_tables: torch.Tensor,  # [B, max_blocks] int
    context_lens: torch.Tensor,  # [B] int (0 => idle lane: junk row)
    *,
    scale: float,
) -> torch.Tensor:
    """Absorbed MLA decode attention (the gather branch of the reference's
    ``_mla_decode_attn``): positions ``pos < ctx`` of each sequence, the
    context accumulated in latent space.  Returns float32 [B, H, R]."""
    b = q_lat.shape[0]
    _, block_size, r = ck_cache.shape
    length = block_tables.shape[1] * block_size
    ck = cache_take(ck_cache, block_tables).reshape(b, length, r).float()
    kr = cache_take(kr_cache, block_tables).reshape(b, length, -1)
    logits = _mla_scores(q_lat, q_rope, ck, kr, scale)
    valid = torch.arange(length, device=q_lat.device)[None, :] < context_lens[:, None]
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    return torch.einsum("bht,btr->bhr", torch.softmax(logits, dim=-1), ck)


def mla_paged_window_attention(
    q_lat: torch.Tensor,         # [B, W, H, R] float32 absorbed latent queries
    q_rope: torch.Tensor,        # [B, W, H, P] roped queries
    ck_cache: torch.Tensor,      # [N, bs, R] latents (keys AND values)
    kr_cache: torch.Tensor,      # [N, bs, P] rope keys
    block_tables: torch.Tensor,  # [B, max_blocks] int
    context_lens: torch.Tensor,  # [B] int: context INCLUDING the window's
                                 # last token (0 => idle lane: junk row)
    *,
    scale: float,
) -> torch.Tensor:
    """Multi-query absorbed MLA attention for speculative verification (the
    gather branch of the reference's ``_mla_window_attn``): query w of a
    sequence sits at position ``ctx - W + w`` and sees the cached positions
    up to its own.  Returns the float32 latent context [B, W, H, R]."""
    b, w, _, r = q_lat.shape
    _, block_size, _ = ck_cache.shape
    length = block_tables.shape[1] * block_size
    ck = cache_take(ck_cache, block_tables).reshape(b, length, r).float()
    kr = cache_take(kr_cache, block_tables).reshape(b, length, -1).float()
    logits = (
        torch.einsum("bwhr,btr->bhwt", q_lat.float(), ck)
        + torch.einsum("bwhp,btp->bhwt", q_rope.float(), kr)
    ) * scale
    q_pos = context_lens[:, None] - w + torch.arange(w, device=q_lat.device)[None, :]
    kv_pos = torch.arange(length, device=q_lat.device)[None, None, :]
    mask = kv_pos <= q_pos[:, :, None]                                 # [b, w, t]
    logits = torch.where(mask[:, None], logits, NEG_INF)
    return torch.einsum("bhwt,btr->bwhr", torch.softmax(logits, dim=-1), ck)


def ragged_mla_paged_attention(
    q_lat: torch.Tensor,         # [T, H, R] float32 absorbed latent queries
    q_rope: torch.Tensor,        # [T, H, P] roped queries
    ck_cache: torch.Tensor,      # [N, bs, R] latents (keys AND values)
    kr_cache: torch.Tensor,      # [N, bs, P] rope keys
    block_tables: torch.Tensor,  # [lanes, max_blocks] int
    token_lane: torch.Tensor,    # [T] owning lane per token (out of range = pad)
    token_pos: torch.Tensor,     # [T] absolute position (-1 = pad)
    *,
    scale: float,
    max_gather_tokens: int = 64,
) -> torch.Tensor:
    """Ragged unified-batch MLA attention in latent space: the contract of
    ``ragged_paged_attention`` with two-part absorbed scores, the context
    accumulated in float32 [T, H, R] for the caller to decompress through
    w_uv.  Pad tokens mask fully and give junk rows the caller discards;
    token chunks of ``max_gather_tokens`` bound the gathered working set."""
    t, h, r = q_lat.shape
    _, block_size, _ = ck_cache.shape
    lanes, max_blocks = block_tables.shape
    length = max_blocks * block_size
    lane = token_lane.clamp(0, lanes - 1)
    kv_pos = torch.arange(length, device=q_lat.device)[None, :]
    out = torch.empty((t, h, r), dtype=torch.float32, device=q_lat.device)
    for c0 in range(0, t, max_gather_tokens):
        c1 = min(t, c0 + max_gather_tokens)
        tables = block_tables[lane[c0:c1]]                      # [n, maxb]
        ck = cache_take(ck_cache, tables).reshape(c1 - c0, length, r).float()
        kr = cache_take(kr_cache, tables).reshape(c1 - c0, length, -1)
        logits = _mla_scores(q_lat[c0:c1], q_rope[c0:c1], ck, kr, scale)
        mask = kv_pos <= token_pos[c0:c1, None]  # pads at -1 mask everything
        logits = torch.where(mask[:, None, :], logits, NEG_INF)
        out[c0:c1] = torch.einsum("thl,tlr->thr", torch.softmax(logits, dim=-1), ck)
    return out


# ---------------------------------------------------------------------------
# prefill over a resident prefix, and the verify window's token order
# ---------------------------------------------------------------------------


def position_major_to_batch(t: torch.Tensor, w: int, b: int, *tail: int) -> torch.Tensor:
    """A position-major flat window axis ([w*b, ...], index = position*b +
    lane: the order that gives position-0 tokens expert-capacity priority in
    MoE verify forwards) as [b, w, ...]."""
    return t.reshape(w, b, *tail).transpose(0, 1)


def gather_prefix_kv(
    k_cache: torch.Tensor,    # [num_blocks, block_size, kv_heads, head_dim]
    v_cache: torch.Tensor,
    block_ids: torch.Tensor,  # [max_blocks]
) -> tuple[torch.Tensor, torch.Tensor]:
    """A sequence's cached K/V through its block list, as
    [max_blocks*block_size, kv_heads, head_dim] copies (chunked prefill and
    prefix-cache hits read the resident prefix from these)."""
    ids = block_ids.to(k_cache.device).long()
    k, v = cache_take(k_cache, ids), cache_take(v_cache, ids)
    n, bs = k.shape[0], k.shape[1]
    return k.reshape(n * bs, *k.shape[2:]), v.reshape(n * bs, *v.shape[2:])


def prefill_attention_with_prefix(
    q: torch.Tensor,         # [seq_pad, heads, head_dim]
    k_new: torch.Tensor,     # [seq_pad, kv_heads, head_dim]
    v_new: torch.Tensor,
    k_prefix: torch.Tensor,  # [prefix_pad, kv_heads, head_dim] (gathered pages)
    v_prefix: torch.Tensor,
    prefix_len: int,         # valid prefix tokens
    seq_len: int,            # valid new tokens
    *,
    sliding_window=None,
) -> torch.Tensor:
    """Chunked / continued prefill: the new tokens' queries attend to the
    first ``prefix_len`` prefix positions and, causally, to themselves (fp32
    scores and softmax)."""
    s, h, d = q.shape
    kvh = k_new.shape[1]
    p = k_prefix.shape[0]
    k = torch.cat([k_prefix.float(), k_new.float()], dim=0)
    v = torch.cat([v_prefix.float(), v_new.float()], dim=0)
    qg = q.reshape(s, kvh, h // kvh, d).float()
    logits = torch.einsum("qkgd,lkd->kgql", qg, k) * _scale(d)
    dev = q.device
    q_pos = prefix_len + torch.arange(s, device=dev)
    kv_idx = torch.arange(p + s, device=dev)
    kv_valid = (kv_idx < prefix_len) | ((kv_idx >= p) & (kv_idx - p < seq_len))
    # absolute position: prefix entries sit at their own index, new entries
    # at prefix_len + (index - p)
    kv_abs = torch.where(kv_idx >= p, kv_idx - (p - prefix_len), kv_idx)
    causal = kv_abs[None, :] <= q_pos[:, None]
    if sliding_window is not None:
        causal = _window_mask(causal, q_pos[:, None] - kv_abs[None, :], sliding_window)
    mask = causal & kv_valid[None, :]
    weights = torch.softmax(logits.masked_fill_(~mask[None, None], NEG_INF), dim=-1)
    out = torch.einsum("kgql,lkd->qkgd", weights, v)
    return out.reshape(s, h, d).to(q.dtype)
