"""The split-and-combine algorithm of the redesigned CUDA attention kernels,
emulated on the CPU in float32 at tiny widths, against the port's plain
versions and the JAX reference on the same numpy inputs (atol 1e-5:
summation order over up to 1024 positions).

- The paged GQA window kernel (csrc/paged_attention.cu): each sequence's
  block table is cut into the chunks of ``plan_splits``; every split that
  holds a key the window can see computes a partial (acc, m, l) in the
  log2 domain, and the partials merge in split order.
- The ragged MLA kernel (csrc/mla_attention.cu, rtc::): each token block's
  page worklist is cut into the work items of the host plan
  (``mla_planner``, read from a buffer of fixed capacity as the kernel
  reads it, junk past its live counts); an item's entries are walked in
  lists of at most MAX_CHUNK_PAGES, a token keeping the entries it sees,
  and a split block's partials merge in slot order.  The planner never
  exceeds its capacity for any page count a bucket allows (hypothesis),
  and the partials scratch at every token bucket of a 4096-position
  engine is that capacity's, far below dense per-chunk partials.
- The MLA decode and verify window kernel (the table walk, rtc:: in
  csrc/mla_attention.cu): each sequence's block table is cut into the
  chunks of ``plan_table_chunks``, its w-major query rows into the tile
  groups of ``table_groups``; every chunk up to the sequence's last page
  computes a partial per row, and the partials merge in chunk order (one
  used chunk writes the output itself).

The kernels themselves run only on a card (chip_smoke.py); what they share
with this emulation is the planner, the split bounds and the merge.  Also:
the bf16 high/low split of float32 operands that the ragged MLA kernel
feeds its bf16 tensor-core products, at DeepSeek widths, within 2e-4 of
float32 (the kernel's tolerance)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.ops import attention as jax_attn
from dynamo_tpu.ops.pallas import paged_window_attention_decode as pallas_window
from dynamo_tpu.ops.pallas.mla_attention import mla_paged_attention_decode as pallas_mla_decode
from dynamo_tpu.ops.pallas.mla_attention import (
    mla_paged_window_attention_decode as pallas_mla_window,
)
from dynamo_tpu.ops.pallas.mla_attention import ragged_mla_attention as pallas_ragged_mla
from dynamo_tpu_torch.ops import attention as attn
from dynamo_tpu_torch.ops.kernels import pack_page_meta
from dynamo_tpu_torch.ops.kernels.mla_attention import (
    GROUP_TILES,
    MAX_CHUNK_PAGES,
    MAX_CHUNKS,
    MAX_GROUP_TILES,
    MIN_CHUNK_PAGES,
    TABLE_MIN_CHUNK_KEYS,
    mla_planner,
    plan_table_chunks,
    split_route,
    table_groups,
)
from dynamo_tpu_torch.ops.kernels.paged_attention import MIN_CHUNK_KEYS, plan_splits

ATOL = 1e-5
NEG_INF = -1e30
LOG2E = 1.4426950408889634
SMS = 132  # an H100's streaming multiprocessors


def t(a):
    return torch.from_numpy(np.array(a))


def close(ours, ref, mask=None, atol=ATOL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    if mask is not None:
        ours, ref = ours[mask], ref[mask]
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=atol)


def partial(scores, values):
    """One split's softmax state over its keys: scores [..., n] in the log2
    domain (NEG_INF where masked), values [n, ...] -> (acc, m, l)."""
    m = scores.max(-1).values
    p = torch.where(scores == NEG_INF, torch.zeros_like(scores),
                    torch.exp2(scores - m[..., None]))
    return p @ values, m, p.sum(-1)


def merge(parts):
    """The combine kernels' fixed-order merge: weight 0 for a partial that
    saw no key, the denominator clamped at 1e-20."""
    big_m = torch.stack([m for _, m, _ in parts]).max(0).values
    acc, den = 0.0, 0.0
    for a, m, l in parts:
        e = torch.where(m == NEG_INF, torch.zeros_like(m), torch.exp2(m - big_m))
        acc = acc + e[..., None] * a
        den = den + e * l
    return acc / den.clamp_min(1e-20)[..., None]


def split_window(q, k, v, tables, ctx, *, window, sms=SMS):
    """csrc/paged_attention.cu's split walk: splits from plan_splits, the
    key span [begin, end) of each sequence (keys stop at the table's end,
    a sliding window starts at the page of its lowest visible position),
    only the splits that hold part of the span, then the merge."""
    b, w, h, d = q.shape
    _, bs, kvh, _ = k.shape
    maxb = tables.shape[1]
    g = h // kvh
    splits, chunk = plan_splits(b, kvh, w * g, maxb, bs, sms)
    span = chunk * bs
    kflat, vflat = k.reshape(-1, kvh, d), v.reshape(-1, kvh, d)
    out = torch.zeros(b, w, h, d)
    used_counts = []
    for bi in range(b):
        ctx_in = int(ctx[bi])
        end = min(ctx_in, maxb * bs)
        begin = 0
        if window:
            begin = min(max(0, ctx_in - w - (window - 1)), end) // bs * bs
        if end <= begin:
            used_counts.append(0)
            continue  # an idle lane: zeros
        qpos = ctx_in - w + torch.arange(w)
        first, last = begin // span, (end - 1) // span
        assert 0 <= first <= last < splits
        used_counts.append(last - first + 1)
        parts = []
        for s in range(first, last + 1):
            keys = torch.arange(max(s * span, begin), min((s + 1) * span, end))
            rows = tables[bi, keys // bs].long() * bs + keys % bs
            mask = keys[None, :] <= qpos[:, None]
            if window:
                mask &= keys[None, :] > qpos[:, None] - window
            sc = torch.einsum("wkgd,nkd->kwgn", q[bi].reshape(w, kvh, g, d), kflat[rows])
            sc = torch.where(mask[None, :, None, :], sc * (LOG2E / math.sqrt(d)), NEG_INF)
            acc, m, l = [], [], []
            for hk in range(kvh):  # one kv head a CTA
                a_, m_, l_ = partial(sc[hk], vflat[rows, hk])
                acc.append(a_), m.append(m_), l.append(l_)
            parts.append((torch.stack(acc), torch.stack(m), torch.stack(l)))
        out[bi] = merge(parts).permute(1, 0, 2, 3).reshape(w, h, d)
    return out, splits, used_counts


BS, KVH, D, MAXB = 4, 2, 16, 64  # 256 positions a table: four 64-key chunks


def window_inputs(ctx, w, heads=4, seed=0):
    rng = np.random.default_rng(seed)
    b = len(ctx)
    n = b * MAXB + 8
    k = rng.standard_normal((n, BS, KVH, D)).astype(np.float32)
    v = rng.standard_normal((n, BS, KVH, D)).astype(np.float32)
    tables = rng.permutation(n)[: b * MAXB].astype(np.int32).reshape(b, MAXB)
    q = rng.standard_normal((b, w, heads, D)).astype(np.float32)
    return q, k, v, tables, np.asarray(ctx, np.int32)


WINDOW_CASES = {
    # W = 1 decode: a long lane, an idle one, one inside the first chunk
    # (the other splits hold no key of it)
    "decode_idle_and_short": dict(ctx=[250, 0, 10], w=1),
    "decode_sliding_window_low_chunks_invisible": dict(ctx=[250, 37, 129], w=1, window=20),
    # W = 5 verify: one window past the table (ctx 258 on 256 positions),
    # one at a chunk boundary, one shorter than the window
    "verify_past_table": dict(ctx=[258, 128, 3], w=5),
    "verify_sliding_window": dict(ctx=[258, 70, 200], w=5, window=9),
    "verify_wide_rows": dict(ctx=[200, 64], w=9, heads=8),  # 36 rows: two row groups
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_split_window_matches_plain_and_jax(case):
    spec = WINDOW_CASES[case]
    window = spec.get("window")
    q, k, v, tables, ctx = window_inputs(spec["ctx"], spec["w"], spec.get("heads", 4))
    ours, splits, used = split_window(t(q), t(k), t(v), t(tables), t(ctx), window=window)
    assert splits == MAXB * BS // MIN_CHUNK_KEYS  # the grid wants more: capped at 4
    assert max(used) > 1  # some sequence merges partials
    # a query sees a key iff its position is >= 0 (an idle lane's are all
    # below 0): the plain versions give junk rows elsewhere, the kernel zeros
    qpos = ctx[:, None] - spec["w"] + np.arange(spec["w"])[None, :]
    live = qpos >= 0
    plain = attn.paged_window_attention(t(q), t(k), t(v), t(tables), t(ctx),
                                        sliding_window=window)
    ref = jax_attn.paged_window_attention(*(jnp.asarray(a) for a in (q, k, v, tables, ctx)),
                                          sliding_window=window)
    close(ours, plain, live)
    close(ours, ref, live)
    assert torch.all(ours[~torch.from_numpy(live)] == 0)  # rows that see no key: zeros


def test_split_window_matches_pallas_interpret():
    q, k, v, tables, ctx = window_inputs([258, 128, 0], 5, seed=3)
    ours, _, _ = split_window(t(q), t(k), t(v), t(tables), t(ctx), window=None)
    pallas = pallas_window(*(jnp.asarray(a) for a in (q, k, v, tables, ctx)),
                           interpret=True, pages_per_step=16)
    close(ours, pallas, ctx > 0)
    assert np.all(np.asarray(pallas)[ctx == 0] == 0)


@pytest.mark.parametrize("batch,kv_heads,rows,max_blocks,bs", [
    (1, 8, 4, 128, 16), (8, 8, 20, 128, 16), (32, 8, 4, 128, 16), (32, 8, 20, 256, 16),
    (3, 2, 36, 7, 4), (1, 1, 1, 1, 16), (64, 8, 4, 4096, 16), (2, 4, 8, 0, 16),
])
def test_plan_splits_covers_the_table(batch, kv_heads, rows, max_blocks, bs):
    splits, chunk = plan_splits(batch, kv_heads, rows, max_blocks, bs, SMS)
    assert splits >= 1 and chunk >= 1
    assert splits * chunk >= max_blocks > (splits - 1) * chunk or max_blocks == 0
    # no more splits than chunks of MIN_CHUNK_KEYS positions
    assert splits <= max(1, -(-max_blocks // -(-MIN_CHUNK_KEYS // bs)))
    # a function of the shapes alone: the same answer every time
    assert plan_splits(batch, kv_heads, rows, max_blocks, bs, SMS) == (splits, chunk)


# ---------------------------------------------------------------------------
# ragged MLA
# ---------------------------------------------------------------------------

H, R, P, MBS = 4, 32, 8, 4
SCALE = 0.17


def split_ragged_mla(q_lat, q_rope, ck, kr, token_lane, token_pos, meta, work, *, tb,
                     list_len=MAX_CHUNK_PAGES):
    """The ragged MLA split walk (rtc:: in csrc/mla_attention.cu) over the
    plan buffer ``work`` = (buffer, capacity), read as the kernels read
    it: each live item walks its block's entries [first, end), clipped to
    page_count, in lists of ``list_len`` entries, a token keeping the
    entries of its lane at or below its position (in worklist order) into
    one softmax state; a block's only item writes its rows, the items of a
    split block write partials that its combine merges in slot order.
    Unwritten rows stay NaN."""
    buffer, caps = work
    page_phys, page_lane, page_ord, page_count = (torch.from_numpy(a) for a in meta)
    n_tok = q_lat.shape[0]
    slots = page_phys.shape[1]
    n_items, n_combines = int(buffer[0, 0]), int(buffer[0, 1])
    items = buffer[1: 1 + n_items].tolist()
    combines = buffer[1 + caps.items: 1 + caps.items + n_combines].tolist()
    out = torch.full((n_tok, H, R), float("nan"))
    part = {}
    for blk, first, end, slot in items:
        assert slot < caps.partials
        count = min(int(page_count[blk]), slots)
        first, end = min(first, count), min(end, count)
        for tok in range(blk * tb, (blk + 1) * tb):
            lane, pos = int(token_lane[tok]), int(token_pos[tok])
            ents = [e for base in range(first, end, list_len)
                    for e in range(base, min(end, base + list_len))
                    if pos >= 0 and int(page_lane[blk, e]) == lane
                    and int(page_ord[blk, e]) * MBS <= pos]
            if not ents:
                state = (torch.zeros(H, R), torch.full((H,), NEG_INF), torch.zeros(H))
            else:
                phys = page_phys[blk, ents].long()
                ordp = page_ord[blk, ents].long()
                kpos = (ordp[:, None] * MBS + torch.arange(MBS)).reshape(-1)
                ckk = ck[phys].reshape(-1, R)
                krr = kr[phys].reshape(-1, P)
                sc = (q_lat[tok] @ ckk.T + q_rope[tok] @ krr.T) * (SCALE * LOG2E)
                sc = torch.where((kpos <= pos)[None, :], sc, NEG_INF)
                state = partial(sc, ckk)
            if slot < 0:
                out[tok] = merge([state])
            else:
                part[slot, tok] = state
    for blk, first_slot, n, _ in combines:
        for tok in range(blk * tb, (blk + 1) * tb):
            out[tok] = merge([part[s, tok] for s in range(first_slot, first_slot + n)])
    return out


def junk_dead_rows(buffer, caps, rng):
    """Random rows past the live items and combines (the kernels never read
    them)."""
    out = buffer.copy()
    n_items, n_combines = out[0, 0], out[0, 1]
    dead = np.r_[np.arange(1 + n_items, 1 + caps.items),
                 np.arange(1 + caps.items + n_combines, caps.rows)]
    out[dead] = rng.integers(-5, 1000, (dead.size, 4))
    return out


def mla_inputs(spans, lanes, *, maxb, t_pad=None, tb=8, seed=0):
    rng = np.random.default_rng(seed)
    n = lanes * maxb + 8
    ck = rng.standard_normal((n, MBS, R)).astype(np.float32)
    kr = rng.standard_normal((n, MBS, P)).astype(np.float32)
    tables = rng.permutation(n)[: lanes * maxb].astype(np.int32).reshape(lanes, maxb)
    total = sum(k for _, _, k in spans)
    t_pad = t_pad or -(-total // tb) * tb
    token_lane = np.full((t_pad,), lanes, np.int32)
    token_pos = np.full((t_pad,), -1, np.int32)
    cur = 0
    for lane, start, k in spans:
        token_lane[cur: cur + k] = lane
        token_pos[cur: cur + k] = np.arange(start, start + k)
        cur += k
    q_lat = rng.standard_normal((t_pad, H, R)).astype(np.float32)
    q_rope = rng.standard_normal((t_pad, H, P)).astype(np.float32)
    return q_lat, q_rope, ck, kr, tables, token_lane, token_pos


MLA_CASES = {
    # eight decode lanes in one token block: one long worklist, many items
    "decode_only_one_block": dict(spans=[(i, 40 + 19 * i, 1) for i in range(8)], lanes=8),
    # a span, a second lane's span and decodes that share a block; a pad
    # block at the end
    "mixed_lanes_and_pads": dict(spans=[(0, 0, 21), (1, 90, 5), *((2 + i, 60 + 11 * i, 1)
                                                                  for i in range(5))],
                                 lanes=7, t_pad=40),
    # one block too short to cut: no partial, no combine, at a capacity with
    # room for both
    "no_split_block": dict(spans=[(0, 3, 5), (1, 0, 2)], lanes=2, t_pad=16),
}
# a tiny card's SMs, so the tiny worklists split (two tile groups a block)
MLA_SMS = 8


@pytest.mark.parametrize("list_len", [MAX_CHUNK_PAGES, 7])
@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_split_ragged_mla_matches_plain_and_jax(case, list_len):
    """At the engine's fixed worklist width (tb x max blocks) and the plan's
    bucket capacity (junk past its live counts): the walk, in lists of
    ``list_len`` entries, against the plain version, the JAX function and
    the Pallas kernel in interpret mode, and bitwise against the same plan
    at its tightest capacity over the tight worklist."""
    spec = MLA_CASES[case]
    maxb = 64
    q_lat, q_rope, ck, kr, tables, token_lane, token_pos = mla_inputs(
        spec["spans"], spec["lanes"], maxb=maxb, t_pad=spec.get("t_pad"))
    fixed = pack_page_meta(token_lane, token_pos, tables, tb_tokens=8, block_size=MBS,
                           page_slots=8 * maxb)
    tight = pack_page_meta(token_lane, token_pos, tables, tb_tokens=8, block_size=MBS)
    planner = mla_planner(8, H, MLA_SMS)
    plan = planner.plan(fixed[3])
    caps = planner.caps(fixed[3].size)
    assert plan.fits(caps) and caps.partials > plan.n_partials and caps.combines > 0
    work = (junk_dead_rows(plan.pack(caps), caps, np.random.default_rng(3)), caps)
    args = (t(q_lat), t(q_rope), t(ck), t(kr), token_lane, token_pos)
    ours = split_ragged_mla(*args, fixed, work, tb=8, list_len=list_len)
    assert torch.equal(ours, split_ragged_mla(*args, tight, (plan.pack(), plan.caps), tb=8))
    if case == "no_split_block":
        assert plan.n_partials == 0 and len(plan.items) == fixed[3].size
    else:
        assert len(plan.combines) >= 1 and plan.n_partials > 1  # a worklist cut into items
    live = token_pos >= 0
    mla_args = (q_lat, q_rope, ck, kr, tables, token_lane, token_pos)
    plain = attn.ragged_mla_paged_attention(*(t(a) for a in mla_args), scale=SCALE)
    ref = jax_attn.ragged_mla_paged_attention(*(jnp.asarray(a) for a in mla_args), scale=SCALE)
    pallas = pallas_ragged_mla(
        *(jnp.asarray(a) for a in (q_lat, q_rope, ck, kr, token_lane, token_pos)),
        *(jnp.asarray(a) for a in fixed), scale=SCALE, tb_tokens=8, interpret=True)
    for other in (plain, ref, pallas):
        close(ours, other, live)
    assert torch.all(ours[~torch.from_numpy(live)] == 0)  # pad rows: zeros


def mla_page_counts(max_blocks=64, max_slots=2048):
    """Page counts a bucket allows: random, all equal (the split edges), or
    zeros with one heavy block."""
    n = st.integers(1, max_blocks)
    c = st.integers(0, max_slots)
    return st.one_of(
        n.flatmap(lambda k: st.lists(c, min_size=k, max_size=k)),
        st.tuples(n, c).map(lambda kc: [kc[1]] * kc[0]),
        st.tuples(n, c).map(lambda kc: [kc[1]] + [0] * (kc[0] - 1)),
    )


@settings(max_examples=300, deadline=None)
@given(counts=mla_page_counts(), heads=st.sampled_from([16, 32, 128]),
       sms=st.sampled_from([1, 8, 132]))
def test_mla_planner_never_exceeds_its_capacity(counts, heads, sms):
    """caps(num_tb) bounds every plan of num_tb blocks (items, combines,
    partials), whatever their page counts; no block has more items than
    the combine merges."""
    planner = mla_planner(8, heads, sms)
    counts = np.asarray(counts, np.int32)
    caps = planner.caps(counts.size)
    plan = planner.plan(counts)
    assert plan.fits(caps), (plan.caps, caps)
    assert plan.pack(caps).shape == (caps.rows, 4)
    assert np.bincount(plan.items[:, 0]).max() <= MAX_CHUNKS
    assert caps.partials <= 4 * planner.target // 3


# the token buckets of a 4096-position DeepSeek-V2-Lite engine on an H100
# (16 heads, latent 512, 16-position pages, tb 8, 132 SMs) and row 3's
# partials scratch there: the plan's capacity, 88 slots of 128 rows of 514
# floats, against dense partials (every chunk of every token block at the
# fixed worklist width of 8 x 256 entries, chunks of 256 entries)
DS_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
DS_SCRATCH_BYTES = 88 * 8 * 16 * (512 + 2) * 4  # 23,158,784


@pytest.mark.parametrize("bucket", DS_BUCKETS)
def test_mla_scratch_at_every_bucket(bucket):
    planner = mla_planner(8, 16, 132, 512)
    num_tb = bucket // 8
    caps = planner.caps(num_tb)
    scratch = planner.scratch_floats(caps) * 4
    assert scratch == DS_SCRATCH_BYTES
    # dense partials: at least 8 chunks a token block at the fixed width
    dense = num_tb * (8 * 256 // MAX_CHUNK_PAGES) * 8 * 16 * (512 + 2) * 4
    if bucket >= 1024:
        assert scratch * 10 < dense
    if bucket == 4096:
        assert dense == 1_077_936_128 and scratch * 46 < dense


# ---------------------------------------------------------------------------
# MLA decode and verify window: the table walk
# ---------------------------------------------------------------------------

TH, TR, TP, TBS = 16, 32, 8, 16  # heads (one 16-row tile a query), latent, rope, page


def split_table_mla(q_lat, q_rope, ck, kr, tables, ctx, *, scale=SCALE, sms=SMS):
    """The table walk (rtc:: in csrc/mla_attention.cu) for q [B, W, H, .]:
    chunks of each block table from plan_table_chunks, the W*H w-major rows
    in balanced groups of 16-row tiles (each group walks every chunk; a
    tile's rows see positions <= ctx - W + w, keys stop at the table's
    end), a partial per (chunk, row) up to the sequence's last page, then
    the merge in chunk order, or the direct write when one chunk is used."""
    b, w, h, r = q_lat.shape
    bs, maxb = ck.shape[1], tables.shape[1]
    tiles = w * h // 16
    groups = table_groups(w * h)
    chunks, chunk = plan_table_chunks(b, w * h, maxb, bs, sms)
    assert chunks <= MAX_CHUNKS and chunks * chunk >= maxb
    bounds = [g * tiles // groups for g in range(groups + 1)]  # the kernel's balanced split
    assert max(y - x for x, y in zip(bounds, bounds[1:])) <= GROUP_TILES
    out = torch.zeros(b, w * h, r)
    used = []
    for bi in range(b):
        c_in = int(ctx[bi])
        n_pages = -(-min(max(c_in, 0), maxb * bs) // bs)
        n_used = -(-n_pages // chunk)
        used.append(n_used)
        for g in range(groups):
            rows = torch.arange(bounds[g] * 16, bounds[g + 1] * 16)
            limit = c_in - w + rows // h  # each row's query position
            ql = q_lat[bi].reshape(w * h, r)[rows]
            qr = q_rope[bi].reshape(w * h, -1)[rows]
            parts = []
            for c in range(max(n_used, 1)):
                pages = torch.arange(c * chunk, min((c + 1) * chunk, n_pages))
                kpos = (pages[:, None] * bs + torch.arange(bs)).reshape(-1)
                phys = tables[bi, pages].long()
                ckk, krr = ck[phys].reshape(-1, r), kr[phys].reshape(-1, kr.shape[-1])
                sc = (ql @ ckk.T + qr @ krr.T) * (scale * LOG2E)
                sc = torch.where(kpos[None, :] <= limit[:, None], sc, NEG_INF)
                if kpos.numel() == 0:
                    sc = torch.full((rows.numel(), 1), NEG_INF)
                    ckk = torch.zeros(1, r)
                parts.append(partial(sc, ckk))
            if n_used <= 1:
                acc, _, l = parts[0]
                out[bi, rows] = acc / l.clamp_min(1e-20)[:, None]
            else:
                out[bi, rows] = merge(parts)
    return out.reshape(b, w, h, r), chunks, used


def table_inputs(ctx, w, *, maxb, seed=0):
    rng = np.random.default_rng(seed)
    b = len(ctx)
    n = b * maxb + 4
    ck = rng.standard_normal((n, TBS, TR)).astype(np.float32)
    kr = rng.standard_normal((n, TBS, TP)).astype(np.float32)
    tables = rng.permutation(n)[: b * maxb].astype(np.int32).reshape(b, maxb)
    q_lat = rng.standard_normal((b, w, TH, TR)).astype(np.float32)
    q_rope = rng.standard_normal((b, w, TH, TP)).astype(np.float32)
    return q_lat, q_rope, ck, kr, tables, np.asarray(ctx, np.int32)


TABLE_CASES = {
    # W = 1 decode: an idle lane beside long ones, several chunks used
    "decode_idle_lane": dict(ctx=[1000, 0, 37, 700], w=1, maxb=64, multi=True),
    # W = 5 verify: a lane shorter than the window (two rows see nothing)
    "window_w5": dict(ctx=[1000, 5, 300, 3], w=5, maxb=64, multi=True),
    # W = 16: 16 tiles, several tile groups
    "window_w16_groups": dict(ctx=[600, 17], w=16, maxb=48, multi=True),
    # a window clamped past the table: its queries keep their positions
    "window_past_table": dict(ctx=[64 * TBS + 2, 100], w=5, maxb=64, multi=True),
    # B = 1: a long context in a wide table (many chunks, all used) ...
    "b1_long_wide_table": dict(ctx=[64 * TBS - 1], w=1, maxb=64, multi=True),
    # ... and a short one in the same table (many chunks, one used)
    "b1_short_wide_table": dict(ctx=[TBS], w=1, maxb=64, multi=False),
    # a one-page table: one chunk
    "one_page_table": dict(ctx=[TBS, 9, 0], w=5, maxb=1, multi=False),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_split_table_mla_matches_plain_and_pallas(case):
    spec = TABLE_CASES[case]
    w, maxb = spec["w"], spec["maxb"]
    args = table_inputs(spec["ctx"], w, maxb=maxb)
    q_lat, q_rope, ck, kr, tables, ctx = args
    ours, chunks, used = split_table_mla(*(t(a) for a in args))
    assert (max(used) > 1) == spec["multi"]
    if case.startswith("b1_"):
        assert chunks > 1  # a wide table at B = 1 cuts into many chunks
    if maxb == 1:
        assert chunks == 1
    # rows whose query position is >= 0 see a key; elsewhere the plain
    # versions and the Pallas kernel (but for an idle lane) give junk rows,
    # the port's kernel zeros
    live = (ctx[:, None] - w + np.arange(w)[None, :]) >= 0
    jargs = [jnp.asarray(a) for a in args]
    if w == 1:
        plain = attn.mla_paged_decode_attention(
            *(t(a[:, 0]) for a in args[:2]), *(t(a) for a in args[2:]), scale=SCALE)[:, None]
        pallas = pallas_mla_decode(jargs[0][:, 0], jargs[1][:, 0], *jargs[2:], scale=SCALE,
                                   interpret=True)[:, None]
    else:
        plain = attn.mla_paged_window_attention(*(t(a) for a in args), scale=SCALE)
        pallas = pallas_mla_window(*jargs, scale=SCALE, interpret=True)
    close(ours, plain, live)
    close(ours, pallas, live)
    assert torch.all(ours[~torch.from_numpy(live)] == 0)
    assert np.all(np.asarray(pallas)[ctx == 0] == 0)  # idle lanes: zeros in both kernels


@pytest.mark.parametrize("batch,rows,max_blocks,bs", [
    (1, 16, 128, 16), (32, 16, 128, 16), (8, 80, 128, 16), (32, 80, 128, 16),
    (2, 256, 128, 16), (1, 16, 1, 16), (1, 16, 8192, 16), (64, 16, 4096, 16),
    (64, 80, 32768, 16), (3, 80, 7, 4), (5, 16, 0, 16),
])
def test_plan_table_chunks_covers_the_table(batch, rows, max_blocks, bs):
    groups = table_groups(rows)
    tiles = -(-rows // 16)
    assert groups * GROUP_TILES >= tiles > (groups - 1) * GROUP_TILES
    chunks, chunk = plan_table_chunks(batch, rows, max_blocks, bs, SMS)
    assert chunks >= 1 and chunk >= 1
    # the table covered, no empty trailing chunk, within the combine's cap
    assert chunks * chunk >= max_blocks > (chunks - 1) * chunk or max_blocks == 0
    assert chunks <= MAX_CHUNKS
    # no chunk shorter than the floor (positions for each tile of the
    # largest group), unless the table is
    room = -(-tiles // groups)
    assert chunks <= max(1, -(-max_blocks // -(-TABLE_MIN_CHUNK_KEYS * room // bs)))
    assert plan_table_chunks(batch, rows, max_blocks, bs, SMS) == (chunks, chunk)


def test_table_walk_route_and_group_cap():
    """The walk takes DeepSeek widths in bf16 with heads a multiple of 16;
    float32 caches and the tiny_mla geometry take the CUDA-core loop.  A
    group stays within the kernel's cap."""
    assert split_route(torch.bfloat16, 512, 64, 16, 16)
    assert split_route(torch.bfloat16, 512, 64, 16, 128)
    assert not split_route(torch.float32, 512, 64, 16, 16)
    assert not split_route(torch.bfloat16, 32, 8, 16, 16)
    assert not split_route(torch.bfloat16, 512, 64, 16, 8)
    assert not split_route(torch.bfloat16, 512, 64, 8, 16)
    assert 1 <= GROUP_TILES <= MAX_GROUP_TILES
    assert table_groups(5 * 16) == 2 and table_groups(16) == 1  # W = 5: 3 + 2 tiles


def bf16(x):
    return x.to(torch.bfloat16).float()


def test_bf16_high_low_split_holds_the_mla_tolerance():
    """At DeepSeek widths (R 512, P 64, 16 heads), bf16 caches and q_rope,
    float32 q_lat: scores from q_hi.ck + q_lo.ck + q_rope.kr and the context
    from P_hi.ck + P_lo.ck (every product exact, sums in float32, as the
    tensor cores accumulate) stay within 2e-4 of the float32 reference; a
    single bf16 pass over q_lat and P does not."""
    rng = np.random.default_rng(7)
    n_keys, heads, r, p = 600, 16, 512, 64
    scale = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2  # DeepSeek-V2-Lite's
    q_lat = torch.from_numpy(rng.standard_normal((heads, r)).astype(np.float32))
    q_rope = bf16(torch.from_numpy(rng.standard_normal((heads, p)).astype(np.float32)))
    ck = bf16(torch.from_numpy(rng.standard_normal((n_keys, r)).astype(np.float32)))
    kr = bf16(torch.from_numpy(rng.standard_normal((n_keys, p)).astype(np.float32)))

    def attend(q_parts, split_p):
        s = sum(q @ ck.T for q in q_parts) + q_rope @ kr.T
        w = torch.softmax(s * scale, dim=-1)
        parts = (bf16(w), bf16(w - bf16(w))) if split_p else (bf16(w),)
        return sum(x @ ck for x in parts)

    ref = torch.softmax((q_lat @ ck.T + q_rope @ kr.T) * scale, dim=-1) @ ck
    q_hi = bf16(q_lat)
    two = attend((q_hi, bf16(q_lat - q_hi)), split_p=True)
    one = attend((q_hi,), split_p=False)
    err_two = (two - ref).abs().max().item()
    err_one = (one - ref).abs().max().item()
    assert err_two <= 2e-4, err_two
    assert err_one > 2e-4, err_one
