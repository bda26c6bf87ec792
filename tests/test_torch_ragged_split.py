"""The balanced tensor-core walk of the ragged GQA kernel
(csrc/ragged_attention.cu), emulated on the CPU in float32 at tiny widths,
against the port's plain version, the JAX reference and the Pallas kernel
in interpret mode on the same numpy inputs (atol 1e-5: summation order over
up to ~700 positions).

The host plan (``plan_ragged_work``) cuts each token block's page worklist
into work items; a CTA holds one item's query rows of one kv head,
token-major, in 16-row tiles, and deals each stage's 16-key sub-tiles to
the warps of a tile (warp phase p of 4/MT takes sub-tile p of every stage);
the phases' softmax states merge in phase order, a block's only item writes
the output, and the items of a split block write partials that the combine
merges in slot order.  The kernel runs only on a card (chip_smoke.py); what
it shares with this emulation is the plan, the item bounds, the deal of
sub-tiles and both merges.  The kernel reads the plan from a buffer of
fixed capacity (a header of live counts, the items, the combines; the grid
is the capacity): the emulation of that buffer at a token bucket's
capacity, with junk in the rows past the live counts, gives the tight
plan's bits, and a window with no split block walks cleanly at a capacity
with room for partials.  Also: the planner's properties, its capacity
bound over every page count a bucket allows (hypothesis), the refusal of a
plan that does not cover the worklist or fit its capacity, and the plan's
plumbing through ``llama_forward_unified``."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.ops import attention as jax_attn
from dynamo_tpu.ops.pallas import ragged_paged_attention as pallas_ragged
from dynamo_tpu_torch.ops import attention as attn
from dynamo_tpu_torch.ops.kernels import pack_page_meta, ragged_attention
from dynamo_tpu_torch.ops.kernels.ragged_attention import (
    CTAS_PER_SM,
    MAX_ITEMS_PER_BLOCK,
    MIN_ITEM_PAGES,
    RaggedWorkPlan,
    plan_ragged_work,
    ragged_planner,
    split_route,
)
from dynamo_tpu_torch.ops.kernels.work_plan import WorkCaps

ATOL = 1e-5
NEG_INF = -1e30
LOG2E = 1.4426950408889634
SMS = 132  # an H100's streaming multiprocessors
BS, TB, D = 16, 8, 16  # the walk's block size is a multiple of its 16-key sub-tile


def t(a):
    return torch.from_numpy(np.array(a))


def close(ours, ref, mask=None):
    ours, ref = np.asarray(ours), np.asarray(ref)
    if mask is not None:
        ours, ref = ours[mask], ref[mask]
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=ATOL)


def state(scores, values):
    """A softmax state over keys: scores [rows, n] in the log2 domain
    (NEG_INF where masked), values [n, D] -> (acc, m, l); no key: (0,
    NEG_INF, 0)."""
    rows = scores.shape[0]
    if scores.shape[1] == 0:
        return torch.zeros(rows, values.shape[1]), torch.full((rows,), NEG_INF), torch.zeros(rows)
    m = scores.max(-1).values
    p = torch.where(scores == NEG_INF, torch.zeros_like(scores), torch.exp2(scores - m[:, None]))
    return p @ values, m, p.sum(-1)


def merge(states):
    """The kernel's fixed-order merge of states: (sum of w acc, max m, sum
    of w l), w = 2^(m - max m), 0 for a state that saw no key."""
    big_m = torch.stack([m for _, m, _ in states]).max(0).values
    acc, den = 0.0, 0.0
    for a, m, l in states:
        w = torch.where(m == NEG_INF, torch.zeros_like(m), torch.exp2(m - big_m))
        acc = acc + w[:, None] * a
        den = den + w * l
    return acc, big_m, den


def finish(acc, den):
    return acc / den.clamp_min(1e-20)[:, None]


def walk_tiles(rows):
    """MT, the 16-row tiles a CTA holds (1, 2 or 4), and the warps a tile."""
    mt = 1 if rows <= 16 else 2 if rows <= 32 else 4
    return mt, 4 // mt


def from_buffer(buffer, caps):
    """What the kernels read of a plan buffer: the live items (the grid's
    CTAs below the header's count), the live combines and the partial
    slots of the capacity."""
    n_items, n_combines, _ = buffer[0, :3]
    assert n_items <= caps.items and n_combines <= caps.combines
    return (buffer[1: 1 + n_items].tolist(),
            buffer[1 + caps.items: 1 + caps.items + n_combines].tolist(), caps.partials)


def split_walk(q, k, v, token_lane, token_pos, meta, plan, *, window=None, work=None):
    """csrc/ragged_attention.cu's tensor-core walk in float32: every item
    (or, without a plan, one item per token block over its whole worklist)
    for every kv head, then the combine; ``work`` = (plan buffer, capacity)
    reads the plan as the kernels do.  Unwritten rows stay NaN."""
    page_phys, page_lane, page_ord, page_count = (np.asarray(a) for a in meta)
    n_tok, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    rows = TB * g
    _, wpt = walk_tiles(rows)
    num_tb, slots = page_phys.shape
    if work is not None:
        items, combines, n_partials = from_buffer(*work)
    elif plan is None:
        items = [(blk, 0, slots, -1) for blk in range(num_tb)]
        combines, n_partials = [], 0
    else:
        items, combines, n_partials = plan.items.tolist(), plan.combines.tolist(), plan.n_partials
    kflat, vflat = k.reshape(-1, kvh, d), v.reshape(-1, kvh, d)
    out = torch.full((n_tok, h, d), float("nan"))
    part = {}  # (slot, head) -> (acc, m, l)
    tok = np.arange(rows) // g  # token of each row within its block (token-major)
    grp = torch.from_numpy(np.arange(rows) % g)
    for blk, first, end, slot in items:
        assert slot < n_partials
        count = min(int(page_count[blk]), slots)
        first, end = min(first, count), min(end, count)
        ents = np.arange(first, end)
        key_rows = (page_phys[blk, ents][:, None] * BS + np.arange(BS)).reshape(-1)
        key_pos = (page_ord[blk, ents][:, None] * BS + np.arange(BS)).reshape(-1)
        key_lane = np.repeat(page_lane[blk, ents], BS)
        phase = (np.arange(key_rows.size) // 16) % wpt  # the warp that takes each key
        toks = blk * TB + tok
        qpos = token_pos[toks][:, None]
        mask = (key_lane[None, :] == token_lane[toks][:, None]) & (key_pos[None, :] <= qpos)
        if window:
            mask &= key_pos[None, :] > qpos - window
        for hk in range(kvh):
            qr = q[toks, hk * g + grp]  # [rows, d], token-major
            sc = torch.where(torch.from_numpy(mask),
                             qr @ kflat[key_rows, hk].T * (LOG2E / math.sqrt(d)), NEG_INF)
            acc, m, l = merge([state(sc[:, phase == p], vflat[key_rows[phase == p], hk])
                               for p in range(wpt)])
            if slot < 0:
                out[toks, hk * g + grp] = finish(acc, l)
            else:
                part[slot, hk] = (acc, m, l)
    for blk, first_slot, n, _ in combines:
        assert first_slot + n <= n_partials
        toks = blk * TB + tok
        for hk in range(kvh):
            acc, _, l = merge([part[s, hk] for s in range(first_slot, first_slot + n)])
            out[toks, hk * g + grp] = finish(acc, l)
    return out


def ragged_inputs(spans, lanes, *, heads=8, kvh=2, maxb=48, t_pad=None, hole=None, seed=0):
    """(lane, start, length) spans packed densely (a ``hole`` of pad tokens
    at that flat index first), padded to ``t_pad``; tables of ``maxb``
    distinct pages a lane."""
    rng = np.random.default_rng(seed)
    n = lanes * maxb + 4
    k = rng.standard_normal((n, BS, kvh, D)).astype(np.float32)
    v = rng.standard_normal((n, BS, kvh, D)).astype(np.float32)
    tables = rng.permutation(n)[: lanes * maxb].astype(np.int32).reshape(lanes, maxb)
    lane_pos = [(lane, p) for lane, start, m in spans for p in range(start, start + m)]
    if hole is not None:
        at, width = hole
        lane_pos[at:at] = [(lanes, -1)] * width
    t_pad = t_pad or -(-len(lane_pos) // TB) * TB
    token_lane = np.full((t_pad,), lanes, np.int32)
    token_pos = np.full((t_pad,), -1, np.int32)
    for i, (lane, p) in enumerate(lane_pos):
        token_lane[i], token_pos[i] = lane, p
    ctx = np.zeros((lanes,), np.int32)
    for lane, start, m in spans:
        ctx[lane] = start + m
    q = rng.standard_normal((t_pad, heads, D)).astype(np.float32)
    return q, k, v, tables, token_lane, token_pos, ctx


CASES = {
    # eight decode lanes in one token block: one long worklist, many items
    "decode8_one_block": dict(spans=[(i, 40 + 83 * i, 1) for i in range(8)], lanes=8),
    # two spans and decodes sharing blocks, then two pad blocks
    "mixed_lanes_and_pad_blocks": dict(
        spans=[(0, 0, 45), (1, 300, 9), *((2 + i, 100 + 97 * i, 1) for i in range(5))],
        lanes=7, t_pad=80),
    # a sliding window of 256 over contexts up to ~700: low pages listed
    # by no token's window are left out of the worklist, partly visible
    # ones masked per key
    "sliding_window_256": dict(
        spans=[(0, 500, 20), (1, 650, 3), *((2 + i, 300 + 61 * i, 1) for i in range(6))],
        lanes=8, window=256),
    # a token block of pads between live ones: page_count 0, zeros
    "empty_block": dict(spans=[(0, 30, 12), (1, 200, 1), (2, 90, 3)], lanes=3,
                        hole=(12, 12), t_pad=32),
    # 7 head groups a kv head: 56 token-major rows, four 16-row tiles
    "groups7_rows56": dict(spans=[(0, 0, 13), *((1 + i, 120 + 150 * i, 1) for i in range(4))],
                           lanes=5, heads=14),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_walk_matches_plain_jax_and_pallas(case):
    spec = CASES[case]
    window = spec.get("window")
    heads = spec.get("heads", 8)
    q, k, v, tables, token_lane, token_pos, ctx = ragged_inputs(
        spec["spans"], spec["lanes"], heads=heads, t_pad=spec.get("t_pad"),
        hole=spec.get("hole"))
    meta = pack_page_meta(token_lane, token_pos, tables, tb_tokens=TB, block_size=BS,
                          sliding_window=window)
    plan = plan_ragged_work(meta[3], kv_heads=2, sms=SMS)
    args = (t(q), t(k), t(v), token_lane, token_pos, meta)
    ours = split_walk(*args, plan, window=window)
    unplanned = split_walk(*args, None, window=window)
    assert not torch.isnan(ours).any() and not torch.isnan(unplanned).any()  # every row written
    live = token_pos >= 0
    plain = attn.ragged_paged_attention(t(q), t(k), t(v), t(tables), t(ctx), t(token_lane),
                                        t(token_pos), sliding_window=window)
    ref = jax_attn.ragged_paged_attention(
        *(jnp.asarray(a) for a in (q, k, v, tables, ctx, token_lane, token_pos)),
        sliding_window=window)
    pallas = pallas_ragged(*(jnp.asarray(a) for a in (q, k, v, token_lane, token_pos)),
                           *(jnp.asarray(a) for a in meta), tb_tokens=TB, interpret=True,
                           sliding_window=window)
    for got in (ours, unplanned):
        close(got, plain, live)
        close(got, ref, live)
        close(got, pallas, live)
        assert torch.all(got[~torch.from_numpy(live)] == 0)  # pad rows: zeros
    if case == "decode8_one_block":
        assert meta[3].size == 1 and len(plan.items) > 4 and plan.n_partials == len(plan.items)
    if case == "empty_block":
        assert (meta[3] == 0).any()
    if case == "groups7_rows56":
        assert walk_tiles(TB * heads // 2) == (4, 1)


PLAN_SHAPES = {
    "decode8_heavy_block": dict(counts=[2048], kvh=8),
    "mix_heavy_first_block": dict(counts=[790, *range(1, 20), *([19] * 18), 35, 36, 37, 0, 0],
                                  kvh=8),
    "prefill_span_188_blocks": dict(counts=[-(-(8 * i + 8) // 16) for i in range(188)], kvh=8),
    "all_short": dict(counts=[3, 1, 0, 15, 16, 7], kvh=8),
    "cap_items_per_block": dict(counts=[40000, 5], kvh=1),
    "one_empty_block": dict(counts=[0], kvh=8),
}


@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_plan_ragged_work_properties(shape):
    spec = PLAN_SHAPES[shape]
    counts = np.asarray(spec["counts"], np.int32)
    kvh = spec["kvh"]
    plan = plan_ragged_work(counts, kv_heads=kvh, sms=SMS)
    items = plan.items
    lengths = items[:, 2] - items[:, 1]
    assert (np.diff(lengths) <= 0).all()  # listed longest first, the grid's order
    # every block's entries covered once and in order
    for blk, c in enumerate(counts):
        mine = by_first(items[items[:, 0] == blk])
        assert len(mine) >= 1 and mine[0, 1] == 0 and mine[-1, 2] == c
        assert (mine[1:, 1] == mine[:-1, 2]).all() and (mine[:, 2] >= mine[:, 1]).all()
        # no item shorter than MIN_ITEM_PAGES but a block's last (here: none)
        assert ((mine[:, 2] - mine[:, 1])[:-1] >= MIN_ITEM_PAGES).all()
        if len(mine) > 1:
            assert (mine[:, 2] - mine[:, 1] >= MIN_ITEM_PAGES).all()
        # partial slots only for split blocks, numbered in order
        if len(mine) == 1:
            assert mine[0, 3] == -1
        else:
            assert (np.diff(mine[:, 3]) == 1).all() and mine[0, 3] >= 0
        assert len(mine) <= MAX_ITEMS_PER_BLOCK
    assert plan.n_partials == int((items[:, 3] >= 0).sum())
    assert sorted(items[items[:, 3] >= 0, 3]) == list(range(plan.n_partials))
    # deterministic
    again = plan_ragged_work(counts, kv_heads=kvh, sms=SMS)
    np.testing.assert_array_equal(again.items, items)
    np.testing.assert_array_equal(again.combines, plan.combines)
    # items x kv heads near the target: one item a block at least, beyond
    # that at most the target, and no fewer than half the target when the
    # worklist can fill it (an item is under 1.5 planned lengths)
    target = CTAS_PER_SM * SMS // kvh
    total = int(counts.sum())
    assert len(items) <= target + counts.size
    if total >= 2 * MIN_ITEM_PAGES * target and counts.max() < MAX_ITEMS_PER_BLOCK * MIN_ITEM_PAGES:
        assert len(items) >= target // 2
    if shape == "decode8_heavy_block":
        assert target // 2 <= len(items) <= target and len(plan.combines) == 1
    if shape == "cap_items_per_block":
        assert (items[:, 0] == 0).sum() == MAX_ITEMS_PER_BLOCK


def test_plan_without_a_split_block_has_no_combines():
    """Blocks too short to cut: one item each, written directly, so the
    plan asks for no partial scratch and no combine launch."""
    counts = np.array([3, 0, MIN_ITEM_PAGES, 2 * MIN_ITEM_PAGES - 1, 1], np.int32)
    plan = plan_ragged_work(counts, kv_heads=8, sms=SMS)
    assert plan.n_partials == 0 and plan.combines.shape == (0, 4)
    np.testing.assert_array_equal(np.sort(plan.items[:, 0]), np.arange(counts.size))
    assert (plan.items[:, 3] == -1).all()
    work = plan.device_work(torch.device("cpu"))
    assert work.caps == WorkCaps(counts.size, 0, 0)
    assert work.buffer.shape == (1 + counts.size, 4)  # the header, then the items
    np.testing.assert_array_equal(work.buffer[0].numpy(), [counts.size, 0, 0, 0])


def by_first(items):
    """A block's items in entry order."""
    return items[np.argsort(items[:, 1], kind="stable")]


def mutate(items, how):
    items = items.copy()
    if how == "entry_left_out":
        items[0, 2] -= 1  # a gap before the block's next item
    elif how == "entry_twice":
        items[1, 1] -= 1
    elif how == "short_of_page_count":
        items[-1, 2] -= 1
    elif how == "block_missing":
        items = items[items[:, 0] != items[-1, 0]]
    elif how == "slot_misnumbered":
        items[0, 3] += 1
    elif how == "block_past_the_last":
        items[0, 0] = 3
    elif how == "block_negative":
        items[0, 0] = -1
    return items


@pytest.mark.parametrize("how", ["entry_left_out", "entry_twice", "short_of_page_count",
                                 "block_missing", "slot_misnumbered", "block_past_the_last",
                                 "block_negative"])
def test_plan_that_misses_the_worklist_is_refused(how):
    counts = np.array([100, 40, 7], np.int32)
    good = plan_ragged_work(counts, kv_heads=1, sms=4)
    assert good.n_partials > 0 and len(good.items) > 3
    RaggedWorkPlan(good.items, counts)  # the planner's own items pass, in any order
    RaggedWorkPlan(good.items[::-1], counts)
    with pytest.raises(ValueError, match="ragged work plan"):
        RaggedWorkPlan(mutate(good.items, how), counts)


def test_wrapper_refuses_a_plan_for_another_token_axis():
    q, k, v, tables, token_lane, token_pos, _ = ragged_inputs([(0, 0, 20)], 1)
    meta = pack_page_meta(token_lane, token_pos, tables, tb_tokens=TB, block_size=BS)
    other = plan_ragged_work(np.zeros(meta[3].size + 1, np.int32), kv_heads=2, sms=SMS)
    with pytest.raises(ValueError, match="ragged work plan: made for"):
        ragged_attention.ragged_paged_attention(
            t(q), t(k), t(v), t(tables), t(token_lane), t(token_pos), *(t(a) for a in meta),
            tb_tokens=TB, plan=other)


def test_split_route_takes_bf16_at_64_and_128():
    assert split_route(torch.bfloat16, 128, 16, 32)
    assert split_route(torch.bfloat16, 64, 32, 64)
    assert split_route(torch.bfloat16, 128, 16, 56)  # qwen2-7B-like: 8 x 7 rows
    assert not split_route(torch.float32, 128, 16, 32)   # the CUDA-core loop
    assert not split_route(torch.bfloat16, 16, 16, 32)   # the tiny geometry: the loop
    assert not split_route(torch.bfloat16, 128, 8, 32)   # refused by name on the card
    assert not split_route(torch.bfloat16, 128, 16, 72)


@pytest.mark.parametrize("case", ["cpu", "float32_cache", "bf16_head_dim_128"])
def test_llama_plans_only_for_the_tensor_core_walk(case, monkeypatch):
    """The llama family's plan hook, which the engine calls once a unified
    step: a plan only where the card's kernel takes the tensor-core walk;
    on the CPU (the plain version) and on the CUDA-core loop's shapes none."""
    from dynamo_tpu_torch.models import llama

    monkeypatch.setattr(llama, "sm_count", lambda device: SMS)
    dtype = torch.float32 if case == "float32_cache" else torch.bfloat16
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), num_heads=8, num_kv_heads=2,
                              head_dim=128, dtype=dtype)
    device = torch.device("cpu" if case == "cpu" else "cuda")
    counts = np.array([700, 5, 40, 0], np.int32)
    planner = llama.unified_planner(cfg, block_size=BS, tb_tokens=TB, device=device)
    if case != "bf16_head_dim_128":
        assert planner is None
        return
    plan = planner.plan(counts)
    want = plan_ragged_work(counts, kv_heads=2, sms=SMS)
    np.testing.assert_array_equal(plan.items, want.items)
    assert plan.n_partials > 0
    # a partial slot holds every kv head's TB x groups rows of head_dim + 2
    assert planner.partial_floats == 2 * TB * 4 * (128 + 2)


def test_llama_unified_forward_with_and_without_a_plan():
    """The plan reaches the wrapper through llama_forward_unified (on the
    CPU the plain version reads none of it): the logits are identical."""
    from dynamo_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    params = llama.init_params(cfg, gen, device="cpu")
    lanes, num_blocks = 3, 24
    tables = np.random.default_rng(1).permutation(num_blocks).astype(np.int32).reshape(lanes, 8)
    spans = [(0, 0, 21), (1, 0, 9), (2, 0, 3)]
    total = sum(n for *_, n in spans)
    tt = -(-total // TB) * TB
    token_ids = np.random.default_rng(2).integers(2, 400, tt).astype(np.int32)
    token_pos = np.full((tt,), -1, np.int32)
    token_lane = np.full((tt,), lanes, np.int32)
    token_slot = np.full((tt,), num_blocks * BS, np.int32)
    ctx = np.zeros((lanes,), np.int32)
    rows = np.zeros((lanes,), np.int32)
    cur = 0
    for lane, start, n in spans:
        pos = np.arange(start, start + n)
        token_pos[cur: cur + n], token_lane[cur: cur + n] = pos, lane
        token_slot[cur: cur + n] = tables[lane, pos // BS] * BS + pos % BS
        ctx[lane], rows[lane] = start + n, cur + n - 1
        cur += n
    meta = pack_page_meta(token_lane, token_pos, tables, tb_tokens=TB, block_size=BS)
    plan = plan_ragged_work(meta[3], kv_heads=cfg.num_kv_heads, sms=SMS)
    cos, sin = llama.make_rope_tables(cfg, device="cpu")
    before = ragged_attention.plain_calls
    out = []
    for p in (None, plan):
        cache = llama.init_kv_cache(cfg, num_blocks, BS, device="cpu")
        logits, _ = llama.llama_forward_unified(
            params, cfg, t(token_ids), cache, t(tables), t(ctx), t(token_pos), t(token_slot),
            t(token_lane), *(t(a) for a in meta), t(rows), cos, sin, tb_tokens=TB, plan=p)
        out.append(logits)
    assert torch.equal(out[0], out[1])
    assert ragged_attention.plain_calls - before == 2 * cfg.num_layers
    bad = plan_ragged_work(np.zeros(meta[3].size + 1, np.int32), kv_heads=1, sms=SMS)
    with pytest.raises(ValueError, match="ragged work plan"):
        llama.llama_forward_unified(
            params, cfg, t(token_ids), llama.init_kv_cache(cfg, num_blocks, BS, device="cpu"),
            t(tables), t(ctx), t(token_pos), t(token_slot), t(token_lane),
            *(t(a) for a in meta), t(rows), cos, sin, tb_tokens=TB, plan=bad)


# ---------------------------------------------------------------------------
# the plan at a token bucket's fixed capacity
# ---------------------------------------------------------------------------

def junk_dead_rows(buffer, caps, rng):
    """Random rows past the live items and combines (the kernels never read
    them)."""
    out = buffer.copy()
    n_items, n_combines = out[0, 0], out[0, 1]
    dead = np.r_[np.arange(1 + n_items, 1 + caps.items),
                 np.arange(1 + caps.items + n_combines, caps.rows)]
    out[dead] = rng.integers(-5, 1000, (dead.size, 4))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixed_capacity_plan_matches_plain_jax_and_pallas(case):
    """The engine's shapes: the worklist at the fixed width tb x max blocks
    and the plan in a buffer at its bucket's capacity, junk past the live
    counts.  The walk gives the tight plan's bits, and the plain version's,
    the JAX function's and the Pallas kernel's outputs."""
    spec = CASES[case]
    window = spec.get("window")
    q, k, v, tables, token_lane, token_pos, ctx = ragged_inputs(
        spec["spans"], spec["lanes"], heads=spec.get("heads", 8), t_pad=spec.get("t_pad"),
        hole=spec.get("hole"))
    fixed = pack_page_meta(token_lane, token_pos, tables, tb_tokens=TB, block_size=BS,
                           page_slots=TB * tables.shape[1], sliding_window=window)
    tight = pack_page_meta(token_lane, token_pos, tables, tb_tokens=TB, block_size=BS,
                           sliding_window=window)
    planner = ragged_planner(2, SMS)
    plan = planner.plan(fixed[3])
    caps = planner.caps(fixed[3].size)
    assert plan.fits(caps) and plan.caps.items < caps.items  # live counts below capacity
    buffer = junk_dead_rows(plan.pack(caps), caps, np.random.default_rng(5))
    ours = split_walk(t(q), t(k), t(v), token_lane, token_pos, fixed, None, window=window,
                      work=(buffer, caps))
    want = split_walk(t(q), t(k), t(v), token_lane, token_pos, tight, plan, window=window)
    assert torch.equal(ours, want)
    live = token_pos >= 0
    plain = attn.ragged_paged_attention(t(q), t(k), t(v), t(tables), t(ctx), t(token_lane),
                                        t(token_pos), sliding_window=window)
    ref = jax_attn.ragged_paged_attention(
        *(jnp.asarray(a) for a in (q, k, v, tables, ctx, token_lane, token_pos)),
        sliding_window=window)
    pallas = pallas_ragged(*(jnp.asarray(a) for a in (q, k, v, token_lane, token_pos)),
                           *(jnp.asarray(a) for a in fixed), tb_tokens=TB, interpret=True,
                           sliding_window=window)
    for other in (plain, ref, pallas):
        close(ours, other, live)
    assert torch.all(ours[~torch.from_numpy(live)] == 0)


def test_window_without_a_split_block_walks_at_capacity():
    """A window whose blocks are all too short to cut, at a bucket's
    capacity with room for partials and combines (the case a padded plan
    once failed on: combines past a plan with no partials): the header
    counts no combine, every block is written by its one item."""
    spans = [(0, 30, 12), (1, 200, 1), (2, 90, 3)]
    q, k, v, tables, token_lane, token_pos, ctx = ragged_inputs(spans, 3, t_pad=32)
    meta = pack_page_meta(token_lane, token_pos, tables, tb_tokens=TB, block_size=BS,
                          page_slots=TB * tables.shape[1])
    planner = ragged_planner(2, SMS)
    caps = planner.caps(meta[3].size)
    plan = planner.plan(meta[3])
    assert plan.n_partials == 0 and caps.combines > 0 and caps.partials > 0
    buffer = plan.pack(caps)
    np.testing.assert_array_equal(buffer[0], [meta[3].size, 0, 0, 0])
    ours = split_walk(t(q), t(k), t(v), token_lane, token_pos, meta, None,
                      work=(junk_dead_rows(buffer, caps, np.random.default_rng(1)), caps))
    assert not torch.isnan(ours).any()
    plain = attn.ragged_paged_attention(t(q), t(k), t(v), t(tables), t(ctx), t(token_lane),
                                        t(token_pos))
    close(ours, plain, token_pos >= 0)


def page_counts(max_blocks=64, max_slots=2048):
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
@given(counts=page_counts(), kv_heads=st.sampled_from([1, 2, 4, 8]),
       sms=st.sampled_from([1, 4, 16, 132]))
def test_planner_never_exceeds_its_capacity(counts, kv_heads, sms):
    """caps(num_tb) bounds every plan of num_tb blocks: items, combines and
    partials, whatever their page counts."""
    planner = ragged_planner(kv_heads, sms)
    counts = np.asarray(counts, np.int32)
    caps = planner.caps(counts.size)
    plan = planner.plan(counts)
    assert plan.fits(caps), (plan.caps, caps)
    assert plan.pack(caps).shape == (caps.rows, 4)
    # the bound does not grow with the worklist's width
    assert caps.partials <= 4 * planner.target // 3


def test_pack_refuses_a_plan_past_its_capacity():
    plan = plan_ragged_work(np.array([2048], np.int32), kv_heads=1, sms=SMS)
    assert plan.n_partials > 1
    with pytest.raises(ValueError, match="ragged work plan: .* does not fit"):
        plan.pack(WorkCaps(len(plan.items), 1, plan.n_partials - 1))
