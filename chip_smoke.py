"""Smoke run of the PyTorch/CUDA port (dynamo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):
  1. build   — compile the CUDA kernels from dynamo_tpu_torch/csrc.
  2. kernels — hold each kernel against its plain PyTorch version on the
               card at the main paths' shapes (Llama-3-8B attention: 32 heads,
               8 kv heads, head dim 128, 16-token blocks, bf16; DeepSeek-V2-Lite
               MLA: 16 heads, latent 512, rope 64, 16-token blocks, bf16
               caches, float32 absorbed queries; the verify windows at W=5),
               plus sliding-window, head-dim-64, head-dim-16 and tiny-MLA
               float32 cases, the split walks' edges (one lane at ctx 16,
               idle lanes, a 64-row GQA window, a 16-query MLA window, a
               56-row ragged GQA block), eight decode lanes up to 4096 in
               one ragged token block (GQA and MLA) and one 1504-token
               ragged prefill span; rows 1 and 3 as the unified graph
               runs them (the worklist at the engine's fixed width, the
               work plan at its token bucket's capacity, junk past its
               live counts) against the same plan at its tightest
               (bitwise) and without a plan, a window with no split block
               at a capacity with room for partials, each bf16 case of row
               1 also held per element against the
               output's size (RAGGED_REL), a limit that a plan which drops
               one partial must fail; the split walks (rows 1-5) launched
               twice on the same inputs must give the same bits; time
               (CUDA events, and the device's own time under
               torch.profiler) the kernel, the plain version and one
               PyTorch library call (scaled_dot_product_attention over
               gathered K/V, a yardstick the port never calls) beside the
               least time the card needs; the block gather/scatter kernels
               bitwise against theirs on ten pools (a KVBM block at 64 and
               256 ids, cache leaves at 93 ids and one, rows of 1000 and
               1002 bytes, 9000 staged ids, a 4 GiB leaf past the 2 GiB
               offset; index_select / index_copy_ as the library
               yardsticks, with the ids on the card and uploaded in the
               call), and a call of each behind queued device work must
               return to the host within NO_SYNC_MS.
  3. tiny    — serve tests/data/tiny-chat-model with
               ``python -m dynamo_tpu_torch.cli.run run in=http out=torch``
               and check that greedy chat content is the token-counter
               continuation its crafted weights produce.
  4. serve   — serve the Llama-3-8B geometry (random weights from a seed, on
               the card) over HTTP in this process with the default engine
               (decode overlapped, every decode window a CUDA graph replay):
               four concurrent chats and one ~1500-token prompt, so that
               unified steps with prefill and decode-only steps both run; the
               kernels' launch counters are zeroed just before and read just
               after (a graph replay adds the launches its capture held).
  5. mla     — the same over the DeepSeek-V2-Lite geometry (the published
               config.json, all 27 layers, random bf16 weights from a seed):
               the MLA ragged and decode kernels, and the MoE layers; every
               MLA decode (and, in phase spec, window) launch must take the
               split table walk.
  6. overlap — both configurations in process, all layers: the default
               engine warmed by ``warmup()`` (every reachable token
               bucket's unified graph, greedy and sampled, and the decode
               graphs, captured: 16 + 2), then a burst of five requests
               (one of 1500 tokens) that must capture no graph, whose
               decode and ragged attention must have launched once a layer
               in every replayed window, every unified window a replay; its
               TTFT and ITL; one decode window, and a unified window (six
               decode lanes beside a span) at buckets 32, 256 and 2048, by
               graph replay against the same step run eagerly on the same
               buffers (tokens, logprobs, the K/V rows written, the counts,
               the feedback, and the forward's logits bitwise); a unified
               window's device ms by replay and eagerly; the burst's greedy
               streams equal with overlap off and, on Llama-3-8B, with
               decode_steps=4 against decode_steps=1; the engine's phase
               accounting of the host time a window, the capture ms a
               bucket, warmup seconds and the graphs' pool.
  7. spec    — speculative decoding (prompt-lookup n-gram drafts, W = 5):
               tests/data/tiny-chat-model with and without it (equal greedy
               streams, drafts accepted), then the Llama-3-8B geometry and
               the DeepSeek-V2-Lite config, all layers, over HTTP with chats
               that repeat a phrase plus the long prompt: every prefill on
               the split step, verify through the GQA window kernel at W=5
               and the MLA window kernel; their launch counters must move
               and no plain attention may run on the card.
  8. offload — the engine's KV offload tiers at the Llama-3-8B geometry,
               then at the DeepSeek-V2-Lite config (all layers, random
               weights): 256 device blocks over a 192-block
               host tier (G2) and a 128-block disk tier (G3).  A prompt A is
               served, pushed down the tiers by churn and served again, once
               restored from G2 and once through G3: the same tokens as a
               device prefix hit, A's blocks landed bitwise equal to their
               snapshot, every evicted block in a tier, all block copies
               through the gather/scatter kernels.
  9. kvbm    — the KV block manager: a 512-block device pool of Llama-3-8B
               blocks (2 MiB, bf16) over host, disk and a localhost block
               store (G4); three sequences of 256 blocks stored, cascaded,
               and read back bitwise through G1 after onboarding from G2, G3
               and G4, with no failed transfer.
 10. quant   — the quantized paths: rows 1-5 on fp8 e4m3fn and e5m2 caches
               at the main paths' shapes (beside the same cases on bf16
               caches), each within the bf16 tolerances of its plain
               version and bitwise the same kernel on the cache's bf16
               values, the split walks' edges on fp8, fp8 under float32
               queries and a float16 cache (the CUDA-core loops); rows 6-7
               on one-byte pools byte-exact (a cast scatter of bf16 blocks
               included); the card's fp8 cast byte-equal to the CPU's; then
               the Llama-3-8B geometry with int8 weights and an fp8 cache
               and DeepSeek-V2-Lite with an fp8 cache served over HTTP
               after warmup() (phase serve's traffic and profile), decode
               and unified replays bitwise equal to eager, no capture after
               warmup, stats()'s MFU and bandwidth share; then each with
               n-gram speculation (the verify kernels on fp8).
Then one JSON line of kernel numbers, the card's name and power limit, and
the result line ``{"ok": true, "device": {...}}``.

``--phases`` runs a subset (for iterating on one phase); the result line is
printed only when every phase ran and passed.  ``--phases build,sweep``
times rows 1-5 under other grid aims of their split planners, rows 4-5
under other tiles a CTA and in one chunk at growing contexts, and rows 6-7
under other piece sizes and CTAs an SM, and their launch cost at each
by-value ids capacity (not part of the default run).
"""

from __future__ import annotations

import argparse
import asyncio
import copy
import gc
import json
import math
import random
import shutil
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "tiny", "serve", "mla", "overlap", "spec", "offload", "kvbm",
          "quant")
BF16_ATOL = 2e-2  # bf16 output (8-bit mantissa, |out| < 4) vs plain in fp32
F32_ATOL = 1e-4   # fp32 kernel vs fp32 plain: summation order only
# row 1's bf16 cases are also held per element against the output's own size:
# max |out - ref| / (|ref| + rms(ref)) (bf16 rounding of the output and of P
# is 2^-9 of it each); on an H100 it reads 0.007-0.018 on those cases and
# 0.7-7.5 for a plan that drops one partial, which must exceed it
RAGGED_REL = 0.05
# MLA kernels write float32 from the very inputs the plain version reads in
# float32: summation order alone — 576-wide scores of |q.k| up to ~100 and
# context sums over up to 2048 positions
MLA_ATOL = 2e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20):
    """One call's device time: the CUDA kernels' own time under
    torch.profiler over ``iters`` calls, over ``iters``.  Beside ``ms``
    (CUDA events around back-to-back calls), which also holds the host's
    launch cost where the host is the slower side."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages())
    return total_us / iters / 1e3 if total_us > 0 else "not measured"


def make_cache(torch, n_blocks, bs, kvh, d, dtype, gen):
    k = torch.randn((n_blocks, bs, kvh, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((n_blocks, bs, kvh, d), generator=gen, device="cuda").to(dtype)
    return k, v


def narrow(torch, caches, cache_dtype):
    """``caches`` cast to ``cache_dtype`` as the engine's cache writes cast
    (``to_cache_dtype``), and the same values in the queries' dtype (exact:
    every fp8 value is a bf16 value); ``caches`` twice when None."""
    from dynamo_tpu_torch.ops.attention import to_cache_dtype

    if cache_dtype is None:
        return caches, caches
    low = tuple(to_cache_dtype(c, cache_dtype) for c in caches)
    return low, tuple(c.to(caches[0].dtype) for c in low)


def block_tables_for(torch, lens, bs, max_blocks, n_blocks, gen):
    """Distinct random physical pages for every sequence (a context past
    the table fills the whole row)."""
    perm = torch.randperm(n_blocks, generator=gen, device="cuda").to(torch.int32)
    tables = torch.zeros((len(lens), max_blocks), dtype=torch.int32, device="cuda")
    cur = 0
    for b, n in enumerate(lens):
        need = min(-(-n // bs), max_blocks)
        tables[b, :need] = perm[cur: cur + need]
        cur += need
    return tables


def window_positions(lens, w, length, window=None):
    """Per sequence of a W-query window (contexts ``lens`` include its last
    token, 0 = idle): the visible key count of each query (positions <= its
    own inside the ``length``-position table, the last ``window`` of them
    with a sliding window) and the positions any query sees (its pages are
    read).  Returns (sum of per-query counts, per-sequence union counts)."""
    per_query, union = 0, []
    for n in lens:
        if n <= 0:
            union.append(0)
            continue
        lo_all, hi_all = None, -1
        for j in range(w):
            q = n - w + j
            hi = min(q, length - 1)
            lo = max(0, q - window + 1) if window else 0
            per_query += max(0, hi - lo + 1)
            lo_all = lo if lo_all is None else min(lo_all, lo)
            hi_all = max(hi_all, hi)
        union.append(max(0, hi_all - lo_all + 1))
    return per_query, union


def decode_case(torch, *, lens, w=1, h=32, kvh=8, d=128, bs=16, dtype=None,
                window=None, seed=0, timed=True, max_blocks=None, cache_dtype=None):
    """Paged GQA attention of ``w`` queries a sequence (contexts ``lens``
    include the window's last token): the decode wrapper at w = 1, the
    window wrapper (speculative verify) above it.  With ``cache_dtype``
    (fp8) the cache is narrowed to it, and the kernel on it must give the
    bits of the same kernel on its values in the queries' dtype
    (``equals_wide_cache``)."""
    from torch.nn import functional as F

    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels import paged_attention_decode, paged_window_attention_decode

    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    b = len(lens)
    max_blocks = max_blocks or -(-max(lens) // bs)
    n_blocks = sum(min(-(-n // bs), max_blocks) for n in lens) + 8
    (k, v), (k16, v16) = narrow(torch, make_cache(torch, n_blocks, bs, kvh, d, dtype, gen),
                                cache_dtype)
    tables = block_tables_for(torch, lens, bs, max_blocks, n_blocks, gen)
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn((b, w, h, d), generator=gen, device="cuda").to(dtype)

    def kernel(k=k, v=v):
        if w == 1:
            return paged_attention_decode(q[:, 0], k, v, tables, ctx, sliding_window=window)[:, None]
        return paged_window_attention_decode(q, k, v, tables, ctx, sliding_window=window)

    def plain_fn(qq, kk, vv):
        return plain.paged_window_attention(qq, kk, vv, tables, ctx, sliding_window=window)

    out = kernel()
    again = kernel()  # the same inputs must give the same bits
    ref = plain_fn(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    live = ctx > 0
    err = (out.float()[live] - ref[live]).abs().max().item()
    res = {"max_abs_err": err, "ref_absmax": ref[live].abs().max().item(),
           "finite": bool(torch.isfinite(out).all()),
           "pads_zero": bool((out[~live] == 0).all()) if (~live).any() else True,
           "deterministic": torch.equal(out.view(torch.uint8), again.view(torch.uint8))}
    if cache_dtype is not None:
        res["equals_wide_cache"] = torch.equal(out.view(torch.uint8),
                                               kernel(k16, v16).view(torch.uint8))
    if not timed:
        return res
    length = max_blocks * bs
    per_query, union = window_positions(lens, w, length, window)
    elem = torch.finfo(dtype).bits // 8
    bytes_ = (sum(union) * kvh * d * 2 * k.element_size() + 2 * q.numel() * elem
              + tables.numel() * 4 + ctx.numel() * 4)
    flops = 4 * per_query * h * d
    # library yardstick: one SDPA call over K/V gathered per sequence
    groups = h // kvh
    kg = k16[tables.long()].reshape(b, length, kvh, d).transpose(1, 2).repeat_interleave(groups, 1)
    vg = v16[tables.long()].reshape(b, length, kvh, d).transpose(1, 2).repeat_interleave(groups, 1)
    pos = torch.arange(length, device="cuda")[None, None, :]
    q_pos = (ctx[:, None] - w + torch.arange(w, device="cuda")[None, :])[:, :, None]
    mask = pos <= q_pos
    if window:
        mask &= (q_pos - pos) < window
    mask = mask[:, None]                              # [b, 1, w, length]
    q4 = q.transpose(1, 2)                            # [b, h, w, d]
    res.update(
        ms=time_ms(kernel, 20), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: plain_fn(q, k, v), 5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask), 20),
        bytes=bytes_, flops=flops,
        bound_ms=max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
        bound_by="bytes" if bytes_ / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
    )
    return res


def span_lens(spans) -> list[int]:
    """Per-lane cache length of ``spans`` (lane, start, length): a prefill
    span of ``length`` tokens at positions start.., or a decode token
    (length 1) at the lane's last position."""
    lens = [0] * (max(lane for lane, _, _ in spans) + 1)
    for lane, start, n in spans:
        lens[lane] = start + n
    return lens


def span_tokens(torch, spans, lanes, tb, t_pad):
    """The flat token axis of ``spans``, packed densely and padded to
    ``t_pad`` (default: whole blocks of ``tb``): host int32 (token_lane,
    token_pos), pads at lane ``lanes`` and position -1."""
    total = sum(n for _, _, n in spans)
    t = t_pad or -(-total // tb) * tb
    token_lane = torch.full((t,), lanes, dtype=torch.int32)
    token_pos = torch.full((t,), -1, dtype=torch.int32)
    cur = 0
    for lane, start, n in spans:
        token_lane[cur: cur + n] = lane
        token_pos[cur: cur + n] = torch.arange(start, start + n, dtype=torch.int32)
        cur += n
    return token_lane, token_pos


# the engine's worklist width at max_model_len 4096 and 16-position blocks:
# tb x 256 entries a token block (EngineConfig of the served phases)
ENGINE_MAX_BLOCKS = 256


def fixed_work(torch, planner, counts, t, tb, seed=0):
    """A step's plan as the unified graph holds it: packed at the capacity of
    a ``t``-token bucket, random junk in every row past its live counts (the
    kernels must never read them).  Returns (DeviceWork, plan, capacity)."""
    import numpy as np

    from dynamo_tpu_torch.ops.kernels.work_plan import DeviceWork

    caps = planner.caps(t // tb)
    plan = planner.plan(counts)
    buf = plan.pack(caps)
    n_items, n_combines = int(buf[0, 0]), int(buf[0, 1])
    dead = np.r_[np.arange(1 + n_items, 1 + caps.items),
                 np.arange(1 + caps.items + n_combines, caps.rows)]
    buf[dead] = np.random.default_rng(seed).integers(-7, 99999, (dead.size, 4))
    return DeviceWork(t // tb, caps, torch.from_numpy(buf).cuda()), plan, caps


def ragged_case(torch, *, spans, h=32, kvh=8, d=128, bs=16, tb=8, t_pad=None,
                dtype=None, window=None, seed=1, timed=True, library="gathered",
                cache_dtype=None):
    """Ragged GQA attention over ``spans`` (see ``span_lens``) as the unified
    graph runs it: the worklist at the engine's fixed width (tb x
    ENGINE_MAX_BLOCKS), the step's work plan (``ragged_planner``, as the
    engine makes it) at its token bucket's capacity with junk past the live
    counts; launched twice (the same bits), against the same plan at its
    tightest capacity over the tightest worklist (the same bits), without a
    plan (one item a token block), and held against the float32 plain
    version.  Library yardstick: one SDPA call over K/V gathered per token
    (``gathered``), or one causal SDPA over the only lane's contiguous K/V
    (``causal``, for a single span from position 0, where the per-token
    gather would not fit).  ``cache_dtype`` as in ``decode_case``."""
    from torch.nn import functional as F

    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels import pack_page_meta, ragged_attention, ragged_paged_attention

    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    lens = span_lens(spans)
    lanes = len(lens)
    max_blocks = -(-max(lens) // bs)
    n_blocks = sum(-(-n // bs) for n in lens) + 8
    (k, v), (k16, v16) = narrow(torch, make_cache(torch, n_blocks, bs, kvh, d, dtype, gen),
                                cache_dtype)
    tables = block_tables_for(torch, lens, bs, max_blocks, n_blocks, gen)
    token_lane, token_pos = span_tokens(torch, spans, lanes, tb, t_pad)
    t = token_lane.shape[0]
    meta = pack_page_meta(
        token_lane.numpy(), token_pos.numpy(), tables.cpu().numpy(),
        tb_tokens=tb, block_size=bs, sliding_window=window,
    )
    fixed = pack_page_meta(
        token_lane.numpy(), token_pos.numpy(), tables.cpu().numpy(),
        tb_tokens=tb, block_size=bs, sliding_window=window,
        page_slots=tb * max(ENGINE_MAX_BLOCKS, max_blocks),
    )
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planner = ragged_attention.ragged_planner(kvh, sms, tb * h // kvh, d)
    work, plan, caps = fixed_work(torch, planner, fixed[3], t, tb, seed)
    meta_dev = [torch.from_numpy(m).cuda() for m in meta]
    fixed_dev = [torch.from_numpy(m).cuda() for m in fixed]
    token_lane, token_pos = token_lane.cuda(), token_pos.cuda()
    q = torch.randn((t, h, d), generator=gen, device="cuda").to(dtype)

    def call(p, m=meta_dev, k=k, v=v):
        return ragged_paged_attention(
            q, k, v, tables, token_lane, token_pos, *m, tb_tokens=tb,
            sliding_window=window, plan=p,
        )

    def kernel():  # the unified graph's call
        return call(work, fixed_dev)

    def tight():
        return call(plan)

    def unsplit():
        return call(None)

    split0 = ragged_attention.split_launches
    out = kernel()
    route = "tensor-core walk" if ragged_attention.split_launches > split0 else "CUDA-core loop"
    again = kernel()  # the same inputs must give the same bits
    at_tight = tight()
    whole = unsplit()
    ref = plain.ragged_paged_attention(
        q.float(), k.float(), v.float(), tables, None, token_lane, token_pos,
        sliding_window=window,
    )
    torch.cuda.synchronize()
    live = token_pos >= 0
    ref_rms = ref[live].pow(2).mean().sqrt().item()

    def rel_err(o):  # per element, against the output's size and the case's RMS
        return ((o.float()[live] - ref[live]).abs() / (ref[live].abs() + ref_rms)).max().item()

    err = max((o.float()[live] - ref[live]).abs().max().item() for o in (out, whole))
    pad_zero = all(bool((o[~live] == 0).all()) for o in (out, whole)) if (~live).any() else True
    res = {"max_abs_err": err, "ref_absmax": ref[live].abs().max().item(), "ref_rms": ref_rms,
           "max_rel_err": max(rel_err(out), rel_err(whole)),
           "finite": bool(torch.isfinite(out).all() and torch.isfinite(whole).all()),
           "pads_zero": pad_zero, "tokens": t, "route": route,
           "deterministic": torch.equal(out.view(torch.uint8), again.view(torch.uint8)),
           "fixed_equals_tight": torch.equal(out.view(torch.uint8), at_tight.view(torch.uint8)),
           "items": len(plan.items), "partials": plan.n_partials,
           "caps": [caps.items, caps.combines, caps.partials],
           "worklist_entries": int(meta[3].sum()), "page_slots": fixed[0].shape[1]}
    if cache_dtype is not None:
        res["equals_wide_cache"] = torch.equal(
            out.view(torch.uint8), call(work, fixed_dev, k16, v16).view(torch.uint8))
    if len(plan.combines):
        # a planted fault: the first split block's combine leaves out its
        # last partial (the constructor would refuse such a plan)
        bad = copy.copy(plan)
        bad.combines = plan.combines.copy()
        bad.combines[0, 2] -= 1
        bad._device = {}
        res["dropped_partial_rel_err"] = rel_err(call(bad))
    if not timed:
        return res
    elem = torch.finfo(dtype).bits // 8
    pos_h = token_pos.cpu().tolist()
    vis = [min(p + 1, window) if window else p + 1 for p in pos_h if p >= 0]
    pages = {(int(meta[0][tt, j])) for tt in range(meta[3].shape[0])
             for j in range(int(meta[3][tt]))}
    bytes_ = (len(pages) * bs * kvh * d * 2 * k.element_size() + 2 * q.numel() * elem
              + sum(m.size * 4 for m in meta) + 2 * t * 4)
    flops = 4 * sum(vis) * h * d
    groups = h // kvh
    length = max_blocks * bs
    if library == "causal":  # one lane, one span from position 0
        kc = k16[tables[0].long()].reshape(length, kvh, d)[:t].transpose(0, 1)
        vc = v16[tables[0].long()].reshape(length, kvh, d)[:t].transpose(0, 1)
        kc = kc.repeat_interleave(groups, 0)[None]
        vc = vc.repeat_interleave(groups, 0)[None]
        q4 = q.transpose(0, 1)[None]                  # [1, h, t, d]

        def lib():
            return F.scaled_dot_product_attention(q4, kc, vc, is_causal=True)
    else:  # one SDPA call, K/V gathered per token's lane
        lane_c = token_lane.clamp(max=lanes - 1).long()
        kg = (k16[tables.long()].reshape(lanes, length, kvh, d)[lane_c]
              .transpose(1, 2).repeat_interleave(groups, 1))
        vg = (v16[tables.long()].reshape(lanes, length, kvh, d)[lane_c]
              .transpose(1, 2).repeat_interleave(groups, 1))
        kvp = torch.arange(length, device="cuda")[None, :]
        mask = kvp <= token_pos[:, None]
        if window:
            mask &= (token_pos[:, None] - kvp) < window
        mask = mask[:, None, None, :]
        q4 = q[:, :, None, :]

        def lib():
            return F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)
    stamps = []  # the host's cost of a step's plan (the engine's, once a step)
    for _ in range(20):
        t0 = time.perf_counter()
        planner.plan(fixed[3]).pack(caps)
        stamps.append(time.perf_counter() - t0)
    res["plan_host_ms"] = sorted(stamps)[len(stamps) // 2] * 1e3
    res.update(
        ms=time_ms(kernel, 10), device_ms=device_ms(kernel),
        tight_ms=time_ms(tight, 10), tight_device_ms=device_ms(tight),
        unsplit_ms=time_ms(unsplit, 10), unsplit_device_ms=device_ms(unsplit),
        plain_ms=time_ms(lambda: plain.ragged_paged_attention(
            q, k, v, tables, None, token_lane, token_pos, sliding_window=window), 3),
        library_ms=time_ms(lib, 10),
        bytes=bytes_, flops=flops,
        bound_ms=max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
        bound_by="bytes" if bytes_ / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
    )
    return res


V2_LITE_ATTN_SCALE = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2


def mla_caches(torch, n_blocks, bs, r, p, dtype, gen):
    ck = torch.randn((n_blocks, bs, r), generator=gen, device="cuda").to(dtype)
    kr = torch.randn((n_blocks, bs, p), generator=gen, device="cuda").to(dtype)
    return ck, kr


def mla_bound(torch, *, pages, bs, r, p, h, dtype, q_rows, meta_bytes, visible,
              cache_elem=None):
    """Bytes: each visible page's latent and rope rows once (``cache_elem``
    bytes an element, default the queries'), the queries (q_lat f32,
    q_rope), the f32 output and the metadata; flops: two-part scores and
    the latent context, 2 (R + P) + 2 R per (row, position)."""
    elem = torch.finfo(dtype).bits // 8
    bytes_ = (pages * bs * (r + p) * (cache_elem or elem) + q_rows * h * (r * 4 + p * elem)
              + q_rows * h * r * 4 + meta_bytes)
    flops = visible * h * (2 * (r + p) + 2 * r)
    t_bytes, t_flops = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return {"bytes": bytes_, "flops": flops, "bound_ms": max(t_bytes, t_flops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def mla_decode_case(torch, *, lens, w=1, h=16, r=512, p=64, bs=16, dtype=None, seed=0,
                    timed=True, max_blocks=None, cache_dtype=None):
    """Absorbed MLA attention of ``w`` queries a sequence at contexts
    ``lens`` (including the window's last token; 0 = an idle lane, which the
    kernel must write as zeros): the decode kernel at w = 1, the window
    kernel (speculative verify) above it.  ``cache_dtype`` as in
    ``decode_case``."""
    from torch.nn import functional as F

    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels import (
        mla_paged_attention_decode,
        mla_paged_window_attention_decode,
    )

    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    b = len(lens)
    max_blocks = max_blocks or max(1, -(-max(lens) // bs))
    n_blocks = sum(min(-(-n // bs), max_blocks) for n in lens) + 8
    (ck, kr), (ck16, kr16) = narrow(torch, mla_caches(torch, n_blocks, bs, r, p, dtype, gen),
                                    cache_dtype)
    tables = block_tables_for(torch, lens, bs, max_blocks, n_blocks, gen)
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q_lat = torch.randn((b, w, h, r), generator=gen, device="cuda")
    q_rope = torch.randn((b, w, h, p), generator=gen, device="cuda").to(dtype)
    scale = V2_LITE_ATTN_SCALE

    def kernel(ck=ck, kr=kr):
        if w == 1:
            return mla_paged_attention_decode(
                q_lat[:, 0], q_rope[:, 0], ck, kr, tables, ctx, scale=scale)[:, None]
        return mla_paged_window_attention_decode(q_lat, q_rope, ck, kr, tables, ctx, scale=scale)

    def plain_fn(qr, ckk, krr):
        if w == 1:
            return plain.mla_paged_decode_attention(
                q_lat[:, 0], qr[:, 0], ckk, krr, tables, ctx, scale=scale)[:, None]
        return plain.mla_paged_window_attention(q_lat, qr, ckk, krr, tables, ctx, scale=scale)

    out = kernel()
    again = kernel()  # the same inputs must give the same bits
    ref = plain_fn(q_rope.float(), ck.float(), kr.float())
    torch.cuda.synchronize()
    live = ctx > 0
    res = {"max_abs_err": (out[live] - ref[live]).abs().max().item(),
           "ref_absmax": ref[live].abs().max().item(),
           "finite": bool(torch.isfinite(out).all()),
           "pads_zero": bool((out[~live] == 0).all()) if (~live).any() else True,
           "deterministic": torch.equal(out.view(torch.uint8), again.view(torch.uint8))}
    if cache_dtype is not None:
        res["equals_wide_cache"] = torch.equal(out.view(torch.uint8),
                                               kernel(ck16, kr16).view(torch.uint8))
    if not timed:
        return res
    length = max_blocks * bs
    visible, union = window_positions(lens, w, length)
    pages = sum(-(-n // bs) for n in union)
    res.update(mla_bound(torch, pages=pages, bs=bs, r=r, p=p, h=h, dtype=dtype, q_rows=b * w,
                         meta_bytes=tables.numel() * 4 + b * 4, visible=visible,
                         cache_elem=ck.element_size()))
    # library yardstick: one SDPA call, q = q_lat | q_rope, K = ck | kr and
    # V = ck gathered per sequence beforehand, all in the cache dtype
    # (every head shares the one latent "kv head": the w * h query rows ride
    # the query axis of a single SDPA head, each masked to its position)
    kg = torch.cat([ck16[tables.long()], kr16[tables.long()]], dim=-1).reshape(
        b, 1, length, r + p)
    vg = ck16[tables.long()].reshape(b, 1, length, r)
    q4 = torch.cat([q_lat.to(dtype), q_rope], dim=-1).reshape(b, 1, w * h, r + p)
    q_pos = (ctx[:, None] - w + torch.arange(w, device="cuda")[None, :]).repeat_interleave(h, 1)
    mask = (torch.arange(length, device="cuda")[None, None, :] <= q_pos[:, :, None])[:, None]
    res.update(
        ms=time_ms(kernel, 20), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: plain_fn(q_rope, ck, kr), 5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask, scale=scale), 20),
    )
    return res


def mla_ragged_case(torch, *, spans, h=16, r=512, p=64, bs=16, tb=8, t_pad=None,
                    dtype=None, seed=1, timed=True, cache_dtype=None):
    """Ragged MLA attention over ``spans`` (see ``span_lens``) as the unified
    graph runs it: the worklist at the engine's fixed width, the step's work
    plan (``mla_planner``) at its token bucket's capacity with junk past the
    live counts; launched twice (the same bits), against the same plan at
    its tightest capacity over the tightest worklist (the same bits) and
    without a plan (one item a token block).  ``cache_dtype`` as in
    ``decode_case``."""
    from torch.nn import functional as F

    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels import mla_attention, pack_page_meta, ragged_mla_attention

    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    lens = span_lens(spans)
    lanes = len(lens)
    max_blocks = -(-max(lens) // bs)
    n_blocks = sum(-(-n // bs) for n in lens) + 8
    (ck, kr), (ck16, kr16) = narrow(torch, mla_caches(torch, n_blocks, bs, r, p, dtype, gen),
                                    cache_dtype)
    tables = block_tables_for(torch, lens, bs, max_blocks, n_blocks, gen)
    token_lane, token_pos = span_tokens(torch, spans, lanes, tb, t_pad)
    t = token_lane.shape[0]
    meta = pack_page_meta(token_lane.numpy(), token_pos.numpy(), tables.cpu().numpy(),
                          tb_tokens=tb, block_size=bs)
    fixed = pack_page_meta(token_lane.numpy(), token_pos.numpy(), tables.cpu().numpy(),
                           tb_tokens=tb, block_size=bs,
                           page_slots=tb * max(ENGINE_MAX_BLOCKS, max_blocks))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planner = mla_attention.mla_planner(tb, h, sms, r)
    work, plan, caps = fixed_work(torch, planner, fixed[3], t, tb, seed)
    meta_dev = [torch.from_numpy(m).cuda() for m in meta]
    fixed_dev = [torch.from_numpy(m).cuda() for m in fixed]
    token_lane, token_pos = token_lane.cuda(), token_pos.cuda()
    q_lat = torch.randn((t, h, r), generator=gen, device="cuda")
    q_rope = torch.randn((t, h, p), generator=gen, device="cuda").to(dtype)
    scale = V2_LITE_ATTN_SCALE

    def call(pl, m=meta_dev, ck=ck, kr=kr):
        return ragged_mla_attention(q_lat, q_rope, ck, kr, tables, token_lane, token_pos,
                                    *m, scale=scale, tb_tokens=tb, plan=pl)

    def kernel():  # the unified graph's call
        return call(work, fixed_dev)

    def tight():
        return call(plan)

    def unsplit():
        return call(None)

    out = kernel()
    again = kernel()  # the same inputs must give the same bits
    at_tight = tight()
    whole = unsplit()
    ref = plain.ragged_mla_paged_attention(q_lat, q_rope.float(), ck.float(), kr.float(),
                                           tables, token_lane, token_pos, scale=scale)
    torch.cuda.synchronize()
    live = token_pos >= 0
    res = {"max_abs_err": max((o[live] - ref[live]).abs().max().item() for o in (out, whole)),
           "ref_absmax": ref[live].abs().max().item(),
           "finite": bool(torch.isfinite(out).all() and torch.isfinite(whole).all()),
           "pads_zero": (all(bool((o[~live] == 0).all()) for o in (out, whole))
                         if (~live).any() else True),
           "deterministic": torch.equal(out.view(torch.uint8), again.view(torch.uint8)),
           "fixed_equals_tight": torch.equal(out.view(torch.uint8), at_tight.view(torch.uint8)),
           "items": len(plan.items), "partials": plan.n_partials,
           "caps": [caps.items, caps.combines, caps.partials],
           "scratch_mb": planner.scratch_floats(caps) * 4 / 1e6,
           "tokens": t, "page_slots": fixed[0].shape[1],
           "worklist_entries": int(meta[3].sum())}
    if cache_dtype is not None:
        res["equals_wide_cache"] = torch.equal(
            out.view(torch.uint8), call(work, fixed_dev, ck16, kr16).view(torch.uint8))
    if not timed:
        return res
    pages = {(int(meta[0][tt, j])) for tt in range(meta[3].shape[0])
             for j in range(int(meta[3][tt]))}
    visible = sum(q + 1 for q in token_pos.cpu().tolist() if q >= 0)
    res.update(mla_bound(torch, pages=len(pages), bs=bs, r=r, p=p, h=h, dtype=dtype,
                         q_rows=t, meta_bytes=sum(m.size * 4 for m in meta) + 2 * t * 4,
                         visible=visible, cache_elem=ck.element_size()))
    # library yardstick: one SDPA call, K = ck | kr and V = ck gathered per
    # token's lane, all in the cache dtype
    length = max_blocks * bs
    lane_c = token_lane.clamp(max=lanes - 1).long()
    kg = torch.cat([ck16[tables.long()], kr16[tables.long()]], dim=-1).reshape(
        lanes, length, r + p)[lane_c][:, None]
    vg = ck16[tables.long()].reshape(lanes, length, r)[lane_c][:, None]
    q4 = torch.cat([q_lat.to(dtype), q_rope], dim=-1)[:, None]
    mask = (torch.arange(length, device="cuda")[None, :] <= token_pos[:, None])[:, None, None, :]
    res.update(
        ms=time_ms(kernel, 10), device_ms=device_ms(kernel),
        tight_ms=time_ms(tight, 10), tight_device_ms=device_ms(tight),
        unsplit_ms=time_ms(unsplit, 10), unsplit_device_ms=device_ms(unsplit),
        plain_ms=time_ms(lambda: plain.ragged_mla_paged_attention(
            q_lat, q_rope, ck, kr, tables, token_lane, token_pos, scale=scale), 3),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask, scale=scale), 10),
    )
    return res


def block_copy_case(torch, *, shape, n, axis, dtype=None, seed=0, timed=True, id_range=None):
    """Block gather and scatter over a pool of ``shape`` with the block axis
    at ``axis`` and ``n`` distinct random ids (from ``id_range`` when
    given): each kernel bitwise equal to its plain version on the same
    inputs, the scatter leaving every other block of the pool unchanged;
    times of the kernels, their plain versions and one library call each
    (``index_select`` / ``index_copy_``: ``library_ms`` with the ids on the
    card beforehand, ``library_ids_ms`` uploading them from the Python list
    inside the timed call, as the port's callers hold them)."""
    from dynamo_tpu_torch.ops import block_copy as plain
    from dynamo_tpu_torch.ops.kernels import block_copy as bk
    from dynamo_tpu_torch.ops.kernels import gather_blocks, scatter_blocks

    dtype = getattr(torch, dtype or "bfloat16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n_pool = shape[axis]

    def rand(shp):
        if dtype == torch.uint8:
            return torch.randint(0, 256, shp, generator=gen, device="cuda", dtype=dtype)
        return torch.randn(shp, generator=gen, device="cuda").to(dtype)

    pool = rand(shape)
    lo, hi = id_range or (0, n_pool)
    ids = (lo + torch.randperm(hi - lo, generator=gen, device="cuda")[:n]).tolist()
    blk_shape = list(shape)
    blk_shape[axis] = n
    blocks = rand(blk_shape)

    def same(a, b):  # bitwise
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    out = gather_blocks(pool, ids, axis=axis)
    ref = plain.gather_blocks(pool, ids, axis)
    scattered = scatter_blocks(pool.clone(), blocks, ids, axis=axis)
    ref_pool = plain.scatter_blocks(pool.clone(), blocks, ids, axis)
    torch.cuda.synchronize()
    rest = torch.ones(n_pool, dtype=torch.bool, device="cuda")
    rest[ids] = False
    outer, _, row_bytes = bk._geometry(pool, axis)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = bk.plan_copy(outer, n, row_bytes, sms,
                        align=bk.base_align(pool.data_ptr(), out.data_ptr()))
    res = {
        "gather_equal": same(out, ref), "scatter_equal": same(scattered, ref_pool),
        "rest_unchanged": same(scattered.index_select(axis, rest.nonzero()[:, 0]),
                               pool.index_select(axis, rest.nonzero()[:, 0])),
        "finite": bool(torch.isfinite(out).all() and torch.isfinite(scattered).all()),
        "gather_max_abs_err": err(out, ref), "scatter_max_abs_err": err(scattered, ref_pool),
        "row_bytes": row_bytes, "ids": [min(ids), max(ids)],
        "plan": {k: v for k, v in vars(plan).items()},
    }
    del scattered, ref_pool, ref
    if not timed:
        return res
    moved = out.numel() * out.element_size()  # bytes read once, written once
    ids_dev = torch.tensor(ids, device="cuda")
    target = pool.clone()
    bound_ms = 2 * moved / HBM_BYTES_PER_S * 1e3
    res.update(
        bytes=2 * moved, bound_ms=bound_ms, bound_by="bytes",
        gather_ms=time_ms(lambda: gather_blocks(pool, ids, axis=axis), 20),
        gather_device_ms=device_ms(lambda: gather_blocks(pool, ids, axis=axis)),
        gather_plain_ms=time_ms(lambda: plain.gather_blocks(pool, ids, axis), 5),
        gather_library_ms=time_ms(lambda: torch.index_select(pool, axis, ids_dev), 20),
        gather_library_ids_ms=time_ms(lambda: torch.index_select(
            pool, axis, torch.tensor(ids, device="cuda")), 20),
        gather_library_device_ms=device_ms(lambda: torch.index_select(pool, axis, ids_dev)),
        scatter_ms=time_ms(lambda: scatter_blocks(target, blocks, ids, axis=axis), 20),
        scatter_device_ms=device_ms(lambda: scatter_blocks(target, blocks, ids, axis=axis)),
        scatter_plain_ms=time_ms(lambda: plain.scatter_blocks(target, blocks, ids, axis), 5),
        scatter_library_ms=time_ms(lambda: target.index_copy_(axis, ids_dev, blocks), 20),
        scatter_library_ids_ms=time_ms(lambda: target.index_copy_(
            axis, torch.tensor(ids, device="cuda"), blocks), 20),
        scatter_library_device_ms=device_ms(lambda: target.index_copy_(axis, ids_dev, blocks)),
    )
    return res


# block gather/scatter (rows 6-7): the KVBM's Llama-3-8B block (a 2 MiB
# row) at 64 and 256 blocks, the engine's Llama-3-8B and DeepSeek-V2-Lite
# cache leaves at A's 93 blocks (the offload phase's restore) and one block,
# raw payloads of 1000 (8-byte aligned) and 1002 (2-byte aligned) bytes,
# 9000 ids of 2 KiB rows (above the by-value capacity: staged ids), and,
# untimed, a 4 GiB Llama leaf whose ids lie in the upper half, so that
# every row from layer 16 on sits past the 2 GiB offset
COPY_CASES = {
    "copy_kvbm": dict(shape=(512, 32, 2, 16, 8, 128), n=64, axis=0),
    "copy_kvbm_n256": dict(shape=(512, 32, 2, 16, 8, 128), n=256, axis=0),
    "copy_llama_leaf": dict(shape=(32, 1024, 16, 8, 128), n=93, axis=1),
    "copy_llama_leaf_n1": dict(shape=(32, 1024, 16, 8, 128), n=1, axis=1),
    "copy_mla_latent": dict(shape=(27, 1024, 16, 1, 512), n=93, axis=1),
    "copy_mla_rope": dict(shape=(27, 1024, 16, 1, 64), n=93, axis=1),
    "copy_bytes": dict(shape=(512, 1000), n=64, axis=0, dtype="uint8"),
    "copy_bytes_1002": dict(shape=(512, 1002), n=64, axis=0, dtype="uint8"),
    "copy_staged_ids": dict(shape=(16384, 16, 1, 64), n=9000, axis=0),
    "copy_leaf_4gib": dict(shape=(32, 4096, 16, 8, 128), n=93, axis=1, id_range=(2048, 4096),
                           timed=False),
}


def sleep_cycles(torch, ms: float) -> int:
    """``torch.cuda._sleep`` cycles that keep the card busy about ``ms``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    torch.cuda.synchronize()
    return int(10**7 * ms / start.elapsed_time(end))


def queued_ms(torch, fn, cycles: int, iters: int = 50) -> float:
    """A call's device time with the host out of the way: ``iters`` calls
    queued behind ``cycles`` of device sleep, so the events time the card's
    back-to-back run of them (valid only for a wrapper that never waits for
    the stream, as rows 6-7's no-sync check holds)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


NO_SYNC_MS = 1.0  # a wrapper call's host time behind queued device work


def host_ms(fn) -> float:
    """The host's wall time of one call of ``fn``, ms."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def no_sync_route(torch, fn, list_fn, cycles: int) -> dict:
    """One route of ``no_sync_check``: five warm calls on an idle card,
    five from a Python list, then five queued behind ``cycles`` of sleep."""
    idle = []
    for _ in range(5):  # warm: the library, the pinned and device allocators
        torch.cuda.synchronize()
        idle.append(host_ms(fn))
    idle_list = []
    for _ in range(5):
        torch.cuda.synchronize()
        idle_list.append(host_ms(list_fn))
    torch.cuda.synchronize()
    torch.cuda._sleep(cycles)
    queued = [host_ms(fn) for _ in range(5)]
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    return {"host_ms": sorted(queued)[2], "host_ms_max": max(queued), "host_ms_each": queued,
            "idle_host_ms": sorted(idle)[2],
            "idle_host_ms_from_list": sorted(idle_list)[2],
            "sleep_still_running": busy}


def no_sync_check(torch) -> dict:
    """Rows 6-7 never wait for the stream: wrapper calls made behind ~20 ms
    of queued device sleep (93 ids by value; 9000 ids, above the by-value
    capacity, staged through pinned host memory) return to the host within
    NO_SYNC_MS each (five calls of each, every one held to it), with the
    sleep still running, and their copies are right.  The staged ids are a numpy array, so the
    host time is the wrapper's: the same calls from a Python list (the
    list's conversion to an array added) are timed on an idle card
    beside them."""
    import numpy as np

    from dynamo_tpu_torch.ops import block_copy as plain
    from dynamo_tpu_torch.ops.kernels import gather_blocks, scatter_blocks

    pool = torch.randn((16384, 16, 1, 64), device="cuda").to(torch.bfloat16)
    ids = {"by_value": list(range(0, 186, 2)), "staged": list(range(16383, 7383, -1))}
    arrays = {"by_value": ids["by_value"], "staged": np.array(ids["staged"], dtype=np.int32)}
    blocks = {k: torch.randn((len(v), 16, 1, 64), device="cuda").to(torch.bfloat16)
              for k, v in ids.items()}
    calls, list_calls = {}, {}
    for route in ids:
        for form, table in ((arrays, calls), (ids, list_calls)):
            i, b = form[route], blocks[route]
            table[f"gather_{route}"] = lambda i=i: gather_blocks(pool, i)
            table[f"scatter_{route}"] = lambda i=i, b=b: scatter_blocks(pool, b, i)
    cycles = sleep_cycles(torch, 20.0)

    res = {}
    gc.collect()
    gc.disable()  # as timeit does: a collection's pause is not the wrapper's
    try:
        for name, fn in calls.items():
            res[name] = no_sync_route(torch, fn, list_calls[name], cycles)
    finally:
        gc.enable()
    # the calls queued behind the sleeps still did their work
    ok = {route: torch.equal(gather_blocks(pool, id_list).view(torch.uint8),
                             plain.gather_blocks(pool, id_list).view(torch.uint8))
          for route, id_list in ids.items()}
    log(f"[kernels] no-sync check (limit {NO_SYNC_MS} ms host time): {json.dumps(res)} "
        f"bitwise after: {ok}")
    if not all(ok.values()) or any(r["host_ms_max"] > NO_SYNC_MS or not r["sleep_still_running"]
                                   for r in res.values()):
        raise AssertionError(f"a block copy call waited for the stream: {res}, bitwise {ok}")
    return res


def moe_determinism_check(torch) -> dict:
    """The routed MoE FFN at DeepSeek-V2-Lite widths (2048 hidden, 64
    experts, top 6, 1408 intermediate; 512 tokens, bf16, random weights from
    a seed) gives bitwise equal outputs on two runs: its combine sums each
    token's k expert rows in one fixed order, where atomics (an
    ``index_add_``) would round differently from run to run."""
    from dynamo_tpu_torch.ops.moe import moe_ffn

    cfg = DEEPSEEK_V2_LITE
    t, h = 512, cfg["hidden_size"]
    e, inter, k = cfg["n_routed_experts"], cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(90)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    x = rand(t, h)
    weights = (rand(h, e, scale=h ** -0.5), rand(e, h, inter, scale=h ** -0.5),
               rand(e, h, inter, scale=h ** -0.5), rand(e, inter, h, scale=inter ** -0.5))
    outs = [moe_ffn(x, *weights, top_k=k, norm_topk_prob=cfg["norm_topk_prob"])
            for _ in range(2)]
    res = {"equal": torch.equal(outs[0].view(torch.int16), outs[1].view(torch.int16)),
           "finite": bool(torch.isfinite(outs[0]).all()), "shape": list(outs[0].shape)}
    log(f"[kernels] moe_ffn at DeepSeek-V2-Lite widths, two runs bitwise: {json.dumps(res)}")
    if not (res["equal"] and res["finite"] and res["shape"] == [t, h]):
        raise AssertionError(f"moe_ffn is not deterministic or not finite: {res}")
    return res


def stale_page_check(torch) -> dict:
    """Rows 2 and 4 at the main paths' widths ignore what a lane's last page
    holds past its context: with every such position set to 1e4 the
    outputs stay bitwise equal.  (A block the allocator hands out again
    keeps its last owner's rows there.)"""
    from dynamo_tpu_torch.ops.kernels import mla_attention, paged_attention

    gen = torch.Generator(device="cuda")
    gen.manual_seed(91)
    b, bs, n = 8, 16, 256
    lens = torch.tensor([305, 21, 1, 17, 300, 33, 0, 129], dtype=torch.int32, device="cuda")
    tables = (torch.arange(b * 32, dtype=torch.int32, device="cuda") % n).view(b, 32)
    live = lens > 0

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def staled(*caches):
        out = [c.clone() for c in caches]
        for lane, ctx in enumerate(lens.tolist()):
            if ctx:
                page, off = int(tables[lane, (ctx - 1) // bs]), (ctx - 1) % bs + 1
                for c in out:
                    c[page, off:] = 1e4
        return out

    def run(fn, *caches):
        clean, stale = fn(*caches)[live], fn(*staled(*caches))[live]
        return torch.equal(clean.view(torch.uint8), stale.view(torch.uint8))

    q = rand(b, 32, 128)
    gqa = run(lambda k, v: paged_attention.paged_attention_decode(q, k, v, tables, lens),
              rand(n, bs, 8, 128), rand(n, bs, 8, 128))
    q_lat = torch.randn((b, 16, 512), generator=gen, device="cuda")
    q_rope = rand(b, 16, 64)
    mla = run(lambda ck, kr: mla_attention.mla_paged_attention_decode(
        q_lat, q_rope, ck, kr, tables, lens, scale=0.1), rand(n, bs, 512), rand(n, bs, 64))
    res = {"gqa_decode_equal": gqa, "mla_decode_equal": mla}
    log(f"[kernels] stale rows past the context, bitwise: {json.dumps(res)}")
    if not (gqa and mla):
        raise AssertionError(f"a decode kernel read past a lane's context: {res}")
    return res


def check_copy_case(name: str, res: dict) -> None:
    shown = {k: (float(f"{v:.6g}") if isinstance(v, float) else v) for k, v in res.items()}
    log(f"[kernels] {name} (bitwise): {json.dumps(shown)}")
    if not (res["gather_equal"] and res["scatter_equal"] and res["rest_unchanged"]
            and res["finite"]):
        raise AssertionError(f"{name}: block copy differs from its plain version")


def check_case(name: str, res: dict, atol: float) -> None:
    shown = {k: (float(f"{v:.6g}") if isinstance(v, float) else v) for k, v in res.items()}
    log(f"[kernels] {name} (atol {atol}): {json.dumps(shown)}")
    if not res["finite"] or not res.get("pads_zero", True):
        raise AssertionError(f"{name}: non-finite output or non-zero pad rows")
    if not res.get("deterministic", True):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    if not res.get("fixed_equals_tight", True):
        raise AssertionError(f"{name}: the plan at its bucket's capacity over the fixed-width "
                             f"worklist differs from the same plan at its tightest")
    if not res["max_abs_err"] <= atol:
        raise AssertionError(f"{name}: max_abs_err {res['max_abs_err']} > {atol}")


def check_ragged(name: str, res: dict) -> None:
    """Row 1's bf16 cases: within BF16_ATOL and RAGGED_REL of the float32
    plain version, and RAGGED_REL catches a plan that drops a partial."""
    check_case(name, res, BF16_ATOL)
    if not res["max_rel_err"] <= RAGGED_REL:
        raise AssertionError(f"{name}: max_rel_err {res['max_rel_err']} > {RAGGED_REL}")
    if not res.get("dropped_partial_rel_err", math.inf) > RAGGED_REL:
        raise AssertionError(f"{name}: a plan that drops a partial passes RAGGED_REL "
                             f"({res['dropped_partial_rel_err']})")


def phase_kernels(torch) -> dict:
    rng = random.Random(0)
    cases: dict[str, dict] = {}
    for b in (1, 8, 32):
        lens = [rng.randint(1, 2048) for _ in range(b)]
        lens[0] = 2047  # not a multiple of the block size
        if b > 1:
            lens[1] = 2048
        cases[f"decode_b{b}"] = decode_case(torch, lens=lens, seed=b)
        check_case(f"decode_b{b} lens<=2048", cases[f"decode_b{b}"], BF16_ATOL)
    decodes = [(2 + i, rng.randint(100, 2047), 1) for i in range(6)]
    mix = [(0, 0, 300), (1, 512, 37), *decodes]
    cases["ragged_mix"] = ragged_case(torch, spans=mix, t_pad=352)
    check_ragged("ragged 300+37 span tokens + 6 decode lanes, pad rows, tb=8",
                 cases["ragged_mix"])
    # the engine's heavy first token block: eight decode lanes at contexts up
    # to 4096 in one block (one worklist of up to 2048 entries); and the
    # serve phase's long prompt as one 1504-token span (188 blocks)
    dec_rng = random.Random(4096)  # its own stream: the other cases keep their contexts
    dec_lens = [4096, 4095, *(dec_rng.randint(1, 4096) for _ in range(6))]
    dec8 = [(i, n - 1, 1) for i, n in enumerate(dec_lens)]
    cases["ragged_decode8_one_block"] = ragged_case(torch, spans=dec8, t_pad=8)
    check_ragged("ragged 8 decode lanes <= 4096 in one token block",
                 cases["ragged_decode8_one_block"])
    cases["ragged_prefill_span"] = ragged_case(torch, spans=[(0, 0, 1504)], library="causal")
    check_ragged("ragged one 1504-token prefill span (188 blocks)",
                 cases["ragged_prefill_span"])
    win = decode_case(torch, lens=[2047, 700, 1500, 33], window=256, seed=5, timed=False)
    check_case("decode sliding window 256", win, BF16_ATOL)
    win_r = ragged_case(torch, spans=mix, t_pad=352, window=256, timed=False)
    check_ragged("ragged sliding window 256", win_r)
    d64 = decode_case(torch, lens=[2047, 300, 17], d=64, seed=8, timed=False)
    check_case("decode head dim 64 bf16", d64, BF16_ATOL)
    d64_r = ragged_case(torch, spans=mix, d=64, t_pad=352, timed=False)
    check_ragged("ragged head dim 64 bf16", d64_r)
    rows56_r = ragged_case(torch, spans=mix, h=28, kvh=4, t_pad=352, timed=False)
    check_ragged("ragged 28 heads / 4 kv heads (qwen2-7B-like: 56 rows, four tiles)",
                 rows56_r)
    # the split walk's edges (row 2): one lane at ctx 16 in a one-page table
    # (one split) and in a 2048-position table (one non-empty split of 32),
    # idle lanes beside long ones, and a 64-row window (two row groups)
    edges = {
        "decode_b1_ctx16": decode_case(torch, lens=[16], seed=11, timed=False),
        "decode_b1_ctx16_table2048": decode_case(torch, lens=[16], seed=12, timed=False,
                                                 max_blocks=128),
        "decode_idle_lanes": decode_case(torch, lens=[2047, 0, 16, 0, 700], seed=13,
                                         timed=False),
        "verify_w16_rows64": decode_case(torch, lens=[2047, 700, 33, 0, 2050], w=16, seed=14,
                                         timed=False, max_blocks=128),
    }
    for name, res in edges.items():
        check_case(name, res, BF16_ATOL)
    # a window with no block long enough to cut, at a bucket's capacity with
    # room for partials and combines: the walk and the combine launch, every
    # combine past the live count (0) exits
    no_split = ragged_case(torch, spans=[(0, 0, 40), (1, 100, 1), (2, 7, 1)], t_pad=48,
                           timed=False)
    check_ragged("ragged window with no split block at capacity", no_split)
    if no_split["partials"] != 0 or min(no_split["caps"][1:]) <= 0:
        raise AssertionError(f"the no-split case split or had no room: {no_split}")
    small = decode_case(torch, lens=[5, 17, 29, 64], h=4, kvh=2, d=16, bs=16,
                        dtype=torch.float32, seed=7, timed=False)
    check_case("decode head dim 16 fp32", small, F32_ATOL)
    small_r = ragged_case(torch, spans=[(0, 4, 1), (1, 8, 9), (2, 28, 1)], h=4,
                          kvh=2, d=16, bs=16, dtype=torch.float32, t_pad=16, timed=False)
    check_case("ragged head dim 16 fp32", small_r, F32_ATOL)
    from dynamo_tpu_torch.ops.kernels import ragged_attention as rk

    ragged_bf16 = {k: cases[k] for k in ("ragged_mix", "ragged_decode8_one_block",
                                         "ragged_prefill_span")}
    ragged_bf16.update(window_256=win_r, head_dim_64=d64_r, rows_56=rows56_r,
                       no_split=no_split)
    if hasattr(rk, "split_launches"):  # a parent checkout has the CUDA-core loop only
        routes = {**{k: r["route"] for k, r in ragged_bf16.items()}, "fp32_d16": small_r["route"]}
        want = {k: "CUDA-core loop" if k == "fp32_d16" else "tensor-core walk" for k in routes}
        if routes != want:
            raise AssertionError(f"row 1 took the wrong route: {routes}")
    print(json.dumps({"smoke_ragged": {
        name: {key: r.get(key) for key in (
            "route", "items", "partials", "caps", "worklist_entries", "page_slots",
            "plan_host_ms", "max_abs_err", "max_rel_err", "dropped_partial_rel_err", "ref_rms",
            "fixed_equals_tight", "ms", "device_ms", "tight_ms", "tight_device_ms",
            "unsplit_ms", "unsplit_device_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")}
        for name, r in ragged_bf16.items()}}), flush=True)
    # the sampling noise stream (threefry in int64 tensor ops) on the card
    # must give the CPU's bits
    from dynamo_tpu_torch.ops import random as threefry

    gen = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 2**32, (8, 2), dtype=torch.int64, generator=gen)
    ctx = torch.randint(1, 4096, (8,), dtype=torch.int64, generator=gen)
    folded = threefry.fold_in(keys, ctx)
    if not torch.equal(threefry.fold_in(keys.cuda(), ctx.cuda()).cpu(), folded):
        raise AssertionError("threefry fold_in differs between the card and the CPU")
    noise_err = (threefry.gumbel(folded.cuda(), 128256).cpu()
                 - threefry.gumbel(folded, 128256)).abs().max().item()
    log(f"[kernels] threefry stream on the card: fold_in bits equal, gumbel max abs "
        f"diff vs CPU {noise_err:.3g}")
    if not noise_err <= 1e-5:
        raise AssertionError(f"gumbel noise differs from the CPU's by {noise_err}")
    # MLA at DeepSeek-V2-Lite shapes: decode with one lane at 2047, one at
    # 2048 and one idle (ctx 0), the llama ragged mix, then tiny_mla in fp32
    for b in (1, 8, 32):
        lens = [rng.randint(1, 2048) for _ in range(b)]
        lens[0] = 2047
        if b > 1:
            lens[1], lens[2] = 2048, 0
        cases[f"mla_decode_b{b}"] = mla_decode_case(torch, lens=lens, seed=10 + b)
        check_case(f"mla_decode_b{b} lens<=2048 (one idle lane)", cases[f"mla_decode_b{b}"],
                   MLA_ATOL)
    cases["mla_ragged_mix"] = mla_ragged_case(torch, spans=mix, t_pad=352)
    check_case("mla ragged 300+37 span tokens + 6 decode lanes, pad rows, tb=8",
               cases["mla_ragged_mix"], MLA_ATOL)
    # eight decode lanes at contexts up to 4096 packed in one token block: one
    # worklist of ~1000 pages, split across CTAs
    cases["mla_ragged_decode8"] = mla_ragged_case(torch, spans=dec8, t_pad=8)
    check_case("mla ragged 8 decode lanes <= 4096 in one token block",
               cases["mla_ragged_decode8"], MLA_ATOL)
    # the serve phase's long prompt as one span, and a window with no block
    # long enough to cut at a bucket's capacity (the combine launches, every
    # combine past the live count exits)
    cases["mla_ragged_prefill_span"] = mla_ragged_case(torch, spans=[(0, 0, 1504)])
    check_case("mla ragged one 1504-token prefill span (188 blocks)",
               cases["mla_ragged_prefill_span"], MLA_ATOL)
    mla_no_split = mla_ragged_case(torch, spans=[(0, 0, 40), (1, 100, 1), (2, 7, 1)],
                                   t_pad=48, timed=False)
    check_case("mla ragged window with no split block at capacity", mla_no_split, MLA_ATOL)
    if mla_no_split["partials"] != 0 or min(mla_no_split["caps"][1:]) <= 0:
        raise AssertionError(f"the no-split case split or had no room: {mla_no_split}")
    mla_bf16 = {k: cases[k] for k in ("mla_ragged_mix", "mla_ragged_decode8",
                                      "mla_ragged_prefill_span")}
    mla_bf16["no_split"] = mla_no_split
    print(json.dumps({"smoke_mla_ragged": {
        name: {key: r.get(key) for key in (
            "items", "partials", "caps", "scratch_mb", "worklist_entries", "page_slots",
            "max_abs_err", "fixed_equals_tight", "ms", "device_ms", "tight_ms",
            "tight_device_ms", "unsplit_ms", "unsplit_device_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")}
        for name, r in mla_bf16.items()}}), flush=True)
    # the table walk's edges (rows 4-5): one lane at ctx 16 in a one-page
    # table (one chunk) and in a 2048-position table (one used chunk of
    # many), idle lanes beside long ones, and a 16-query window (16 tiles in
    # several tile groups)
    mla_edges = {
        "mla_decode_b1_ctx16": mla_decode_case(torch, lens=[16], seed=15, timed=False),
        "mla_decode_b1_ctx16_table2048": mla_decode_case(torch, lens=[16], seed=16,
                                                         timed=False, max_blocks=128),
        "mla_decode_idle_lanes": mla_decode_case(torch, lens=[2047, 0, 16, 0, 700], seed=17,
                                                 timed=False),
        "mla_window_w16": mla_decode_case(torch, lens=[2047, 700, 33, 0, 2050], w=16, seed=18,
                                          timed=False, max_blocks=128),
    }
    for name, res in mla_edges.items():
        check_case(name, res, MLA_ATOL)
    mla_small = mla_decode_case(torch, lens=[5, 17, 0, 64], h=4, r=32, p=8,
                                dtype=torch.float32, seed=21, timed=False)
    check_case("mla decode tiny_mla fp32", mla_small, F32_ATOL)
    mla_small_r = mla_ragged_case(torch, spans=[(0, 4, 1), (1, 8, 9), (2, 28, 1)], h=4,
                                  r=32, p=8, dtype=torch.float32, t_pad=16, timed=False)
    check_case("mla ragged tiny_mla fp32", mla_small_r, F32_ATOL)
    # speculative verify windows, W = spec_tokens + 1 = 5: row 2 at Llama-3-8B
    # widths and row 5 at DeepSeek-V2-Lite widths.  Contexts include the
    # window's last token; the tables hold 2048 positions, and one lane's
    # window runs past them (the engine clamps its slots at its last
    # position: the queries keep their positions, the keys stop at the table)
    for b in (8, 32):
        lens = [rng.randint(5, 2048) for _ in range(b)]
        lens[0], lens[1], lens[2] = 2047, 2048, 2050
        cases[f"verify_w5_b{b}"] = decode_case(torch, lens=lens, w=5, seed=30 + b,
                                               max_blocks=128)
        check_case(f"paged window W=5 b{b} lens<=2048 (+ one past the table)",
                   cases[f"verify_w5_b{b}"], BF16_ATOL)
    win5 = decode_case(torch, lens=[2047, 700, 1500, 33, 2050], w=5, window=256, seed=40,
                       timed=False, max_blocks=128)
    check_case("paged window W=5 sliding window 256", win5, BF16_ATOL)
    for b in (1, 8, 32):
        lens = [rng.randint(5, 2048) for _ in range(b)]
        lens[0] = 2047
        if b > 1:
            lens[1], lens[2] = 2048, 0
        if b > 8:
            lens[3] = 2050
        cases[f"mla_window_b{b}"] = mla_decode_case(torch, lens=lens, w=5, seed=50 + b,
                                                    max_blocks=128)
        check_case(f"mla window W=5 b{b} lens<=2048 (one idle lane)",
                   cases[f"mla_window_b{b}"], MLA_ATOL)
    mla_window_small = mla_decode_case(torch, lens=[5, 17, 0, 64], w=3, h=4, r=32, p=8,
                                       dtype=torch.float32, seed=61, timed=False)
    check_case("mla window W=3 tiny_mla fp32", mla_window_small, F32_ATOL)
    for name, kw in COPY_CASES.items():
        cases[name] = block_copy_case(torch, seed=70 + len(cases), **kw)
        check_copy_case(f"{name} {kw['shape']} n={kw['n']} axis={kw['axis']}", cases[name])
        torch.cuda.empty_cache()
    cases["copy_no_sync"] = no_sync_check(torch)
    cases["moe_deterministic"] = moe_determinism_check(torch)
    cases["stale_pages"] = stale_page_check(torch)
    errs = {  # the largest error of each kernel over its cases at the main path's widths
        "paged": max(*(cases[f"decode_b{b}"]["max_abs_err"] for b in (1, 8, 32)),
                     win["max_abs_err"], d64["max_abs_err"],
                     *(edges[e]["max_abs_err"] for e in edges if e.startswith("decode"))),
        "paged_w5": max(*(cases[f"verify_w5_b{b}"]["max_abs_err"] for b in (8, 32)),
                        win5["max_abs_err"], edges["verify_w16_rows64"]["max_abs_err"]),
        "ragged": max(r["max_abs_err"] for r in ragged_bf16.values()),
        "mla_decode": max(*(cases[f"mla_decode_b{b}"]["max_abs_err"] for b in (1, 8, 32)),
                          *(mla_edges[e]["max_abs_err"] for e in mla_edges
                            if e.startswith("mla_decode"))),
        "mla_window": max(*(cases[f"mla_window_b{b}"]["max_abs_err"] for b in (1, 8, 32)),
                          mla_edges["mla_window_w16"]["max_abs_err"]),
        "mla_ragged": max(r["max_abs_err"] for r in mla_bf16.values()),
        **{row: max(cases[c][f"{row}_max_abs_err"] for c in COPY_CASES)
           for row in ("gather", "scatter")},
    }
    return {"cases": cases, "errs": errs}


# phase "sweep", run only when named: the split planners' grid aims
SWEEP_RAGGED = ((2, 16), (3, 16), (2, 8), (2, 4), (2, 32))  # (CTAS_PER_SM, MIN_ITEM_PAGES)
SWEEP_PAGED = (1, 2, 4, 8)  # paged_attention.CTAS_PER_SM
SWEEP_MLA = ((2, 16), (2, 8), (2, 4), (1, 8), (4, 8))  # (CTAS_PER_SM, MIN_CHUNK_PAGES)
# the table walk (rows 4-5): (GROUP_TILES, TABLE_CTAS_PER_SM,
# TABLE_MIN_CHUNK_KEYS) of ops/kernels/mla_attention.py
SWEEP_TABLE = ((3, 4, 64), (2, 4, 64), (1, 4, 64), (3, 2, 64), (3, 8, 64), (3, 4, 32),
               (3, 4, 128))


# rows 6-7 under other plans: (PIECE_BYTES, CTAS_PER_SM) of
# ops/kernels/block_copy.py
SWEEP_COPY = tuple((p * 1024, c) for p in (2, 4, 8, 16, 32) for c in (2, 4, 8))
SWEEP_COPY_CASES = ("copy_kvbm", "copy_llama_leaf", "copy_mla_latent", "copy_mla_rope",
                    "copy_bytes")


def sweep_copies(torch) -> list[dict]:
    """Rows 6-7 on the kernels phase's copy cases (random bytes) under the
    plans of SWEEP_COPY: each plan bitwise equal to the plain version, and
    its device time a call by ``queued_ms``.  The constants are restored."""
    from dynamo_tpu_torch.ops import block_copy as plain
    from dynamo_tpu_torch.ops.kernels import block_copy as bk

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cycles = sleep_cycles(torch, 20.0)
    saved = (bk.PIECE_BYTES, bk.CTAS_PER_SM)
    rows = []

    def same(a, b):
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))

    try:
        for name in SWEEP_COPY_CASES:
            kw = COPY_CASES[name]
            shape, axis, n = kw["shape"], kw["axis"], kw["n"]
            dtype = getattr(torch, kw.get("dtype") or "bfloat16")
            gen = torch.Generator(device="cuda")
            gen.manual_seed(1)

            def rand(shp):  # random bits of the case's dtype
                size = dtype.itemsize
                raw = torch.randint(0, 256, (*shp[:-1], shp[-1] * size), generator=gen,
                                    device="cuda", dtype=torch.uint8)
                return raw.view(dtype)

            pool = rand(shape)
            ids = torch.randperm(shape[axis], generator=gen, device="cuda")[:n].tolist()
            blocks = rand((*shape[:axis], n, *shape[axis + 1:]))
            ref_gather = plain.gather_blocks(pool, ids, axis)
            ref_scatter = plain.scatter_blocks(pool.clone(), blocks, ids, axis)
            outer, _, row_bytes = bk._geometry(pool, axis)
            bound_ms = 2 * ref_gather.numel() * ref_gather.element_size() / HBM_BYTES_PER_S * 1e3
            for piece, ctas in SWEEP_COPY:
                bk.PIECE_BYTES, bk.CTAS_PER_SM = piece, ctas
                target = pool.clone()
                equal = (same(bk.gather_blocks(pool, ids, axis=axis), ref_gather)
                         and same(bk.scatter_blocks(target, blocks, ids, axis=axis), ref_scatter))
                plan = bk.plan_copy(outer, n, row_bytes, sms)
                rows.append({
                    "case": name, "piece_max": piece, "ctas_per_sm": ctas,
                    "piece_bytes": plan.piece_bytes, "grid": plan.grid,
                    "pieces": plan.pieces, "equal": equal, "bound_ms": bound_ms,
                    "gather_queued_ms": queued_ms(
                        torch, lambda: bk.gather_blocks(pool, ids, axis=axis), cycles),
                    "scatter_queued_ms": queued_ms(
                        torch, lambda: bk.scatter_blocks(target, blocks, ids, axis=axis), cycles),
                })
                log(f"[sweep] {json.dumps(rows[-1])}")
                del target
                if not equal:
                    raise AssertionError(f"{name}: the plan {plan} differs from the plain version")
            del pool, blocks, ref_gather, ref_scatter
            torch.cuda.empty_cache()
    finally:
        bk.PIECE_BYTES, bk.CTAS_PER_SM = saved
    return rows


def sweep_id_caps(torch) -> list[dict]:
    """The launch cost of each by-value ids capacity (a parameter struct of
    64 + 4 * cap bytes) and of the staged route (ids copied through pinned
    host memory), at n = 1 (a Llama-3-8B leaf) and n = 93 (a DeepSeek rope
    leaf): the gather entry called with the same plan but the capacity, each
    result bitwise equal to the plain version.  ``host_us``: a call's host
    time over 200 calls issued back to back (the card keeps up), the median
    of seven rounds that take the capacities in turn; ``ms``: CUDA
    events around back-to-back calls; ``queued_ms``: calls queued behind a
    device sleep (the card's time a call)."""
    import numpy as np

    from dynamo_tpu_torch.ops import block_copy as plain
    from dynamo_tpu_torch.ops.kernels import block_copy as bk
    from dynamo_tpu_torch.ops.kernels import build
    from dynamo_tpu_torch.ops.kernels.common import stream_ptr

    lib = build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cycles = sleep_cycles(torch, 20.0)
    rows = []
    for name in ("copy_llama_leaf_n1", "copy_mla_rope"):
        kw = COPY_CASES[name]
        shape, axis, n = kw["shape"], kw["axis"], kw["n"]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        pool = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        ids = bk._check_ids(torch.randperm(shape[axis], generator=gen, device="cuda")[:n].tolist(),
                            shape[axis], unique=False)
        out = bk.gather_blocks(pool, ids, axis=axis)
        ref = plain.gather_blocks(pool, ids.tolist(), axis)
        outer, n_pool, row_bytes = bk._geometry(pool, axis)
        plan = bk.plan_copy(outer, n, row_bytes, sms,
                            align=bk.base_align(pool.data_ptr(), out.data_ptr()))
        stream = stream_ptr(pool.device)
        calls = {}
        for cap in (*(c for c in bk.ID_CAPS if c >= n), 0):
            def call(cap=cap):
                staged = bk._stage_ids(ids, pool.device) if cap == 0 else None
                build.check(lib.dyn_gather_blocks(
                    pool.data_ptr(), out.data_ptr(), ids.ctypes.data,
                    None if staged is None else staged.data_ptr(), outer, n_pool, n,
                    row_bytes, plan.piece_bytes, plan.grid, plan.vec, cap, stream),
                    "gather_blocks")

            out.zero_()
            call()
            if not torch.equal(out.view(torch.uint8), ref.view(torch.uint8)):
                raise AssertionError(f"{name}: ids capacity {cap} differs from the plain version")
            calls[cap] = call
        host_us = {cap: [] for cap in calls}
        for _ in range(7):
            for cap, call in calls.items():
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    call()
                host_us[cap].append((time.perf_counter() - t0) / 200 * 1e6)
                torch.cuda.synchronize()
        for cap, call in calls.items():
            rows.append({"case": name, "n": n, "ids_cap": cap,
                         "param_bytes": 64 + 4 * cap if cap else 72, "equal": True,
                         "host_us": sorted(host_us[cap])[3], "host_us_runs": sorted(host_us[cap]),
                         "ms": time_ms(call, 50), "queued_ms": queued_ms(torch, call, cycles)})
            log(f"[sweep] {json.dumps(rows[-1])}")
        del pool, out, ref
        torch.cuda.empty_cache()
    return rows


def phase_sweep(torch) -> dict:
    """Rows 1-5 at the kernels phase's shapes (contexts drawn alike) under
    other grid aims of their split planners (``ragged_planner``,
    ``plan_splits``, ``mla_planner``, ``plan_table_chunks``) and, for rows
    4-5, other tiles a CTA, then rows 4-5 in one chunk at growing contexts:
    event and device times, and the float32 partial scratch each plan
    allocates.  The constants are restored."""
    from dynamo_tpu_torch.ops.kernels import mla_attention as mk
    from dynamo_tpu_torch.ops.kernels import paged_attention as pk
    from dynamo_tpu_torch.ops.kernels import ragged_attention as rk

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = random.Random(0)
    paged = {
        "decode_b1": dict(lens=[2047]),
        "decode_b8": dict(lens=[2047, 2048, *(rng.randint(1, 2048) for _ in range(6))]),
        "decode_b32": dict(lens=[2047, 2048, *(rng.randint(1, 2048) for _ in range(30))]),
        "verify_w5_b8": dict(lens=[2047, 2048, 2050, *(rng.randint(5, 2048) for _ in range(5))],
                             w=5, max_blocks=128),
    }
    mix = [(0, 0, 300), (1, 512, 37), *((2 + i, rng.randint(100, 2047), 1) for i in range(6))]
    dec = [4096, 4095, *(rng.randint(1, 4096) for _ in range(6))]
    # a window of the served profile: one short prompt beside seven short
    # decode lanes (one token block lists every decode lane's pages)
    short = [(0, 0, 40), *((1 + i, 40 + 7 * i, 1) for i in range(7))]
    mla = {"mla_ragged_mix": dict(spans=mix, t_pad=352),
           "mla_ragged_decode8": dict(spans=[(i, n - 1, 1) for i, n in enumerate(dec)], t_pad=8),
           "mla_ragged_short": dict(spans=short, t_pad=48)}
    table = {
        "mla_decode_b1": dict(lens=[2047]),
        "mla_decode_b32": dict(lens=[2047, 2048, 0, *(rng.randint(1, 2048) for _ in range(29))]),
        "mla_window_b8": dict(lens=[2047, 2048, 0, *(rng.randint(5, 2048) for _ in range(5))],
                              w=5, max_blocks=128),
        # the served decode step's shape: eight short chats in the engine's
        # 4096-position tables
        "mla_decode_b8_short": dict(lens=[rng.randint(30, 100) for _ in range(8)],
                                    max_blocks=256),
    }
    saved = (pk.CTAS_PER_SM, mk.CTAS_PER_SM, mk.MIN_CHUNK_PAGES, mk.GROUP_TILES,
             mk.TABLE_CTAS_PER_SM, mk.TABLE_MIN_CHUNK_KEYS, rk.CTAS_PER_SM, rk.MIN_ITEM_PAGES)
    rows = []

    def keep(name, res, **plan):
        rows.append({"case": name, **plan, **{k: res[k] for k in (
            "ms", "device_ms", "library_ms", "bound_ms", "max_abs_err", "deterministic")}})
        log(f"[sweep] {json.dumps(rows[-1])}")

    try:
        for aim, floor in SWEEP_RAGGED:
            rk.CTAS_PER_SM, rk.MIN_ITEM_PAGES = aim, floor
            for name, kw in mla.items():  # the same spans at Llama-3-8B widths
                res = ragged_case(torch, **kw)
                keep(name.replace("mla_", ""), res, ctas_per_sm=aim, min_item_pages=floor,
                     items=res["items"], partials=res["partials"],
                     scratch_mb=res["partials"] * 8 * 32 * 130 * 4 / 1e6)
        for aim in SWEEP_PAGED:
            pk.CTAS_PER_SM = aim
            for name, kw in paged.items():
                b, w = len(kw["lens"]), kw.get("w", 1)
                splits, chunk = pk.plan_splits(
                    b, 8, w * 4, kw.get("max_blocks") or -(-max(kw["lens"]) // 16), 16, sms)
                keep(name, decode_case(torch, seed=1, **kw), ctas_per_sm=aim, splits=splits,
                     chunk_pages=chunk, scratch_mb=b * 8 * splits * w * 4 * 130 * 4 / 1e6
                     if splits > 1 else 0.0)
        for aim, floor in SWEEP_MLA:
            mk.CTAS_PER_SM, mk.MIN_CHUNK_PAGES = aim, floor
            for name, kw in mla.items():
                res = mla_ragged_case(torch, **kw)
                keep(name, res, ctas_per_sm=aim, min_chunk_pages=floor, items=res["items"],
                     partials=res["partials"], scratch_mb=res["scratch_mb"])
        for group, aim, floor in SWEEP_TABLE:
            mk.GROUP_TILES, mk.TABLE_CTAS_PER_SM, mk.TABLE_MIN_CHUNK_KEYS = group, aim, floor
            for name, kw in table.items():
                b, w = len(kw["lens"]), kw.get("w", 1)
                chunks, chunk = mk.plan_table_chunks(
                    b, w * 16, kw.get("max_blocks") or -(-max(kw["lens"]) // 16), 16, sms)
                keep(name, mla_decode_case(torch, seed=2, **kw), group_tiles=group,
                     ctas_per_sm=aim, min_chunk_keys=floor, chunks=chunks, chunk_pages=chunk,
                     scratch_mb=b * chunks * w * 16 * 514 * 4 / 1e6 if chunks > 1 else 0.0)
        # one chunk (a grid aim of 0) at growing contexts: the walk's time a
        # page (the slope) and a CTA's fixed cost (the intercept)
        mk.GROUP_TILES, mk.TABLE_CTAS_PER_SM, mk.TABLE_MIN_CHUNK_KEYS = saved[3], 0, saved[5]
        for n in (16, 64, 256, 1024):
            keep(f"mla_walk_b1_ctx{n}", mla_decode_case(torch, lens=[n], seed=3), chunks=1,
                 chunk_pages=-(-n // 16))
    finally:
        (pk.CTAS_PER_SM, mk.CTAS_PER_SM, mk.MIN_CHUNK_PAGES, mk.GROUP_TILES,
         mk.TABLE_CTAS_PER_SM, mk.TABLE_MIN_CHUNK_KEYS, rk.CTAS_PER_SM, rk.MIN_ITEM_PAGES) = saved
    rows.extend(sweep_copies(torch))
    rows.extend(sweep_id_caps(torch))
    print(json.dumps({"smoke_sweep": rows}), flush=True)
    return {"rows": rows}


# ---------------------------------------------------------------------------
# phases 3-4: serving over HTTP
# ---------------------------------------------------------------------------


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def post(port: int, path: str, body: dict, timeout: float = 600) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"content-type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def phase_tiny() -> dict:
    """The CLI on the card, tiny-chat-model: exact greedy content."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import PromptFormatter
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import HfTokenizer

    model = ROOT / "tests" / "data" / "tiny-chat-model"
    port = free_port()
    server_log = ROOT / "dynamo_tpu_torch" / "_build" / "tiny_server.log"
    with open(server_log, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.cli.run", "run", "in=http",
             "out=torch", "--model-path", str(model), "--port", str(port),
             "--host", "127.0.0.1"],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=log_file,
        )
    try:
        deadline = time.time() + 300
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"server exited: {server_log.read_text()[-2000:]}")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5):
                    break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.5)
        body = {"model": "tiny-chat-model", "max_tokens": 12, "temperature": 0,
                "messages": [{"role": "user", "content": "count on from here: abc"}]}
        status, resp = post(port, "/v1/chat/completions", body)
        # the crafted weights continue token t with t+1, t+2, ...
        mdc = ModelDeploymentCard.from_local_path(model)
        tok = HfTokenizer.from_model_dir(model)
        prompt_ids = tok.encode(
            PromptFormatter(mdc.chat_template).render(ChatCompletionRequest.model_validate(body))
        )
        expect_ids = [prompt_ids[-1] + 1 + i for i in range(12)]
        eos = set(tok.eos_token_ids)
        if any(i in eos for i in expect_ids):
            expect_ids = expect_ids[: next(j for j, i in enumerate(expect_ids) if i in eos)]
        expected = tok.decode(expect_ids)
        content = resp["choices"][0]["message"]["content"]
        log(f"[tiny] status={status} content={content!r} expected={expected!r}")
        if status != 200 or content != expected:
            raise AssertionError(f"tiny model content {content!r} != {expected!r}")
        return {"content": content}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


LLAMA3_8B = {
    "model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
    "max_position_embeddings": 8192, "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0, "tie_word_embeddings": False,
    "bos_token_id": 0, "eos_token_id": 1, "torch_dtype": "bfloat16",
}

# deepseek-ai/DeepSeek-V2-Lite config.json, as published (15.7B parameters:
# MLA with a 512-wide latent, 64 routed experts top-6 plus 2 shared)
DEEPSEEK_V2_LITE = {
    "architectures": ["DeepseekV2ForCausalLM"], "model_type": "deepseek_v2",
    "vocab_size": 102400, "hidden_size": 2048, "intermediate_size": 10944,
    "moe_intermediate_size": 1408, "num_hidden_layers": 27, "num_attention_heads": 16,
    "num_key_value_heads": 16, "n_shared_experts": 2, "n_routed_experts": 64,
    "num_experts_per_tok": 6, "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "routed_scaling_factor": 1.0, "norm_topk_prob": False, "scoring_func": "softmax",
    "topk_method": "greedy", "n_group": 1, "topk_group": 1, "q_lora_rank": None,
    "kv_lora_rank": 512, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "v_head_dim": 128, "max_position_embeddings": 163840, "rms_norm_eps": 1e-6,
    "rope_theta": 10000, "rope_scaling": {
        "type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1,
        "mscale": 0.707, "mscale_all_dim": 0.707,
        "original_max_position_embeddings": 4096},
    "attention_bias": False, "hidden_act": "silu", "tie_word_embeddings": False,
    "bos_token_id": 100000, "eos_token_id": 100001, "torch_dtype": "bfloat16",
}


def zero_counters() -> None:
    """Every kernel counter to 0, just before a counted run of a path."""
    from dynamo_tpu_torch.engine.graphs import launch_counters

    for mod, name in launch_counters():
        setattr(mod, name, 0)


def read_counters() -> dict:
    """Every kernel counter as {"module.counter": n}, and the total of the
    plain-version calls (each one a kernel that did not run on the card)."""
    from dynamo_tpu_torch.engine.graphs import launch_counters

    out = {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": n
           for (mod, name), n in launch_counters().items()}
    out["plain_calls"] = sum(v for k, v in out.items() if k.endswith("plain_calls"))
    return out


# the launch counters (read_counters() keys) each served path must see
# above 0: the llama and DeepSeek MLA paths, and their speculative verify
# kernels (the window kernels at W = spec_tokens + 1)
LLAMA_PATH = ("ragged_attention.launches", "paged_attention.launches")
MLA_PATH = ("mla_attention.ragged_launches", "mla_attention.decode_launches")
LLAMA_SPEC_PATH = ("paged_attention.window_launches",)
MLA_SPEC_PATH = ("mla_attention.window_launches",)


def check_ragged_route(counts: dict) -> None:
    """Every ragged GQA call of a served Llama-3-8B path took the tensor-core
    walk (bf16, head dim 128), and no plain attention ran on the card."""
    if (counts["ragged_attention.split_launches"] != counts["ragged_attention.launches"]
            or counts["plain_calls"] != 0):
        raise AssertionError(f"a ragged GQA call missed the tensor-core walk: {counts}")


async def stream_chat(session, port: int, model: str, content: str, max_tokens: int) -> dict:
    body = {"model": model, "max_tokens": max_tokens, "temperature": 0,
            "stream": True, "stream_options": {"include_usage": True},
            "ext": {"ignore_eos": True},
            "messages": [{"role": "user", "content": content}]}
    t0 = time.perf_counter()
    stamps, usage, finish, status = [], None, None, None
    async with session.post(f"http://127.0.0.1:{port}/v1/chat/completions", json=body) as r:
        status = r.status
        async for raw in r.content:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[6:])
            if "error" in chunk:
                raise RuntimeError(chunk["error"])
            if chunk.get("usage"):
                usage = chunk["usage"]
            for choice in chunk.get("choices", []):
                stamps.append(time.perf_counter())
                finish = choice.get("finish_reason") or finish
    return {"status": status, "t0": t0, "stamps": stamps, "usage": usage,
            "finish": finish, "max_tokens": max_tokens}


async def serve_model(model_dir: Path, model: str, *, overrides=None,
                      short_prompts=None, profile=True, inspect=None) -> dict:
    import aiohttp

    from dynamo_tpu_torch.serve import serve_http

    t_load = time.perf_counter()
    handle = await serve_http(
        model_dir, model_name=model, host="127.0.0.1", port=0,
        num_blocks=1024, max_batch_size=8, max_model_len=4096, seed=0, **(overrides or {}),
    )
    load_s = time.perf_counter() - t_load
    port = handle.service.port
    short_prompts = short_prompts or [f"request {i}: tell me" for i in range(4)]
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=900)) as s:
            # warm the path once before the counted run
            await stream_chat(s, port, model, "warm up", 4)
            stats0 = handle.engine.stats()
            zero_counters()
            t0 = time.perf_counter()
            shorts = [asyncio.ensure_future(stream_chat(s, port, model, text, 64))
                      for text in short_prompts]
            await asyncio.sleep(0.5)  # the long prompt lands while they decode
            long_prompt = "".join(chr(ord("a") + i % 26) for i in range(1640))
            long = asyncio.ensure_future(stream_chat(s, port, model, long_prompt, 24))
            results = await asyncio.gather(*shorts, long)
            wall = time.perf_counter() - t0
        counts = read_counters()
        stats = handle.engine.stats()
        # the counted run's share of the cumulative engine counters
        run = {k: stats[k] - stats0[k] for k in stats
               if k.startswith(("spec_", "decode_windows_", "decode_graph_replays"))
               or k.endswith("steps_total") or k in ("iterations_total", "admission_drains_total")}
        prof = None
        if profile:  # the same window without the profiler, then under it
            quiet = await profile_decode(handle.engine, port, model, profiler=False)
            prof = await profile_decode(handle.engine, port, model)
            prof["wall_ms_per_step_profiler_off"] = quiet["wall_ms_per_step"]
            prof["graph"] = {k: v for k, v in handle.engine.stats().items()
                             if k.startswith("decode_graph")}
        checked = None
        if inspect is not None:  # on the served engine, its thread stopped
            handle.engine.stop()
            checked = inspect(handle.engine)
    finally:
        await handle.shutdown()
    return {"results": results, "wall_s": wall, "counts": counts,
            "stats": stats, "run": run, "load_s": load_s, "profile": prof,
            "inspect": checked}


def port_kernel_names() -> list[str]:
    """The __global__ functions of the port's CUDA sources."""
    import re

    names = set()
    for src in (ROOT / "dynamo_tpu_torch" / "csrc").glob("*.cu"):
        names.update(re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)",
                                src.read_text()))
    return sorted(names)


async def profile_decode(engine, port: int, model: str, profiler: bool = True) -> dict:
    """Where a decode-heavy window's time goes: eight concurrent chats
    (every lane busy) under torch.profiler.  Device time is the sum of the
    CUDA kernels' own times (the kernels of a graph replay included, where
    the profiler attributes them); the idle share is what the wall clock
    holds beyond it.  A profiler that records no device time reports that.
    ``profiler=False`` times the same window's wall clock alone."""
    import contextlib

    import aiohttp
    import torch
    from torch.profiler import ProfilerActivity, profile

    steps0 = engine.stats()["decode_steps_total"]
    tracer = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiler
              else contextlib.nullcontext())
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
        with tracer as prof:
            t0 = time.perf_counter()
            await asyncio.gather(*(stream_chat(s, port, model, f"profile {i}", 32)
                                   for i in range(8)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    steps = engine.stats()["decode_steps_total"] - steps0
    if not profiler:
        return {"wall_s": wall, "decode_steps": steps,
                "wall_ms_per_step": wall / max(steps, 1) * 1e3}
    kernels: dict[str, float] = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us
    device_s = sum(kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    port: dict[str, float] = {}  # the port's own kernels (csrc/*.cu: anonymous namespaces)
    names = port_kernel_names()
    for key, us in kernels.items():
        tail = key.removeprefix("void ")  # templates' demangled names carry it
        if not tail.startswith("(anonymous namespace)::"):
            continue
        tail = tail.removeprefix("(anonymous namespace)::").removeprefix("rtc::")
        name = next((n for n in names if tail.startswith((f"{n}(", f"{n}<"))), None)
        if name:
            port[name] = port.get(name, 0.0) + us / 1e3 / max(steps, 1)
    return {
        "wall_s": wall, "decode_steps": steps,
        "wall_ms_per_step": wall / max(steps, 1) * 1e3,
        "device_ms_per_step": device_s / max(steps, 1) * 1e3 if device_s else "not measured",
        "device_idle_share": 1 - device_s / wall if device_s else "not measured",
        "top_kernels_ms_per_step": {k[:60]: v / 1e3 / max(steps, 1) for k, v in top},
        "port_kernels_ms_per_step": port,
    }


def model_dir(model: str, config: dict) -> Path:
    """A model dir under the build dir: ``config`` and the tiny model's
    tokenizer (the weights are random, from the engine seed)."""
    build_dir = ROOT / "dynamo_tpu_torch" / "_build" / model
    build_dir.mkdir(parents=True, exist_ok=True)
    (build_dir / "config.json").write_text(json.dumps(config))
    tiny = ROOT / "tests" / "data" / "tiny-chat-model"
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(tiny / name, build_dir / name)
    return build_dir


def phase_serve(card: str, tag: str, model: str, config: dict, path, **serve_kw) -> dict:
    """Serve ``config`` (random weights from seed 0, the tiny model's
    tokenizer) over HTTP in this process, drive the counted traffic, check
    it and that every counter of ``path`` launched, print its e2e (and
    profile) lines."""
    out = asyncio.run(serve_model(model_dir(model, config), model, **serve_kw))
    ttfts, itls, toks = [], [], 0
    for r in out["results"]:
        usage = r["usage"] or {}
        log(f"[{tag}] status={r['status']} finish={r['finish']} usage={usage}")
        if r["status"] != 200:
            raise AssertionError(f"request failed with {r['status']}")
        if usage.get("completion_tokens") != r["max_tokens"] or r["finish"] != "length":
            raise AssertionError(f"completion_tokens {usage} / finish {r['finish']} "
                                 f"!= {r['max_tokens']} / length")
        toks += usage["completion_tokens"]
        ttfts.append(r["stamps"][0] - r["t0"])
        gaps = [b - a for a, b in zip(r["stamps"], r["stamps"][1:])]
        itls.extend(gaps)
    counts = out["counts"]
    launched = {k: counts[k] for k in path}
    log(f"[{tag}] launches={launched} load_s={out['load_s']:.1f} run={out['run']} "
        f"all counters={counts}")
    if any(n <= 0 for n in launched.values()):
        raise AssertionError(f"a kernel did not run on the main path: {launched}")
    if counts["plain_calls"] != 0:
        raise AssertionError(f"plain attention ran on the card: {counts}")
    check_ragged_route(counts)
    table = counts["mla_attention.decode_launches"] + counts["mla_attention.window_launches"]
    if counts["mla_attention.table_walk_launches"] != table:
        raise AssertionError(f"an MLA decode or window call missed the split table walk: {counts}")
    e2e = {
        "ttft_ms_mean": sum(ttfts) / len(ttfts) * 1e3,
        "ttft_ms_max": max(ttfts) * 1e3,
        "itl_ms_mean": sum(itls) / len(itls) * 1e3,
        "output_tok_s": toks / out["wall_s"],
        "requests": len(out["results"]), "wall_s": out["wall_s"],
        "load_s": out["load_s"], "model": model, "card": card,
    }
    if out["profile"] is not None:
        print(json.dumps({"smoke_profile": {**out["profile"], "model": model, "card": card}}),
              flush=True)
    print(json.dumps({"smoke_e2e": e2e}), flush=True)
    return {"counts": counts, "launched": launched, "e2e": e2e, "run": out["run"],
            "stats": out["stats"], "profile": out["profile"], "inspect": out["inspect"]}


# ---------------------------------------------------------------------------
# phase overlap: the overlapped decode pipeline and the graphed decode window
# ---------------------------------------------------------------------------

OVERLAP_ENGINE = dict(num_blocks=1024, max_batch_size=8, max_model_len=4096, seed=0)
# the burst: four short prompts and one of 1500 tokens, all queued before the
# engine starts, so every engine runs the same windows.  One prefill is
# admitted a step, so each asks one token fewer than the last and all finish
# in one window: a lane that finished while others decode would route its
# lagged token through DeepSeek's MoE, whose expert capacity (one pair an
# expert at eight lanes) ties the lanes of a step together.
OVERLAP_PROMPTS = (20, 24, 28, 32, 1500)
OVERLAP_FINISH = 40
REPLAY_ITERS = 20


async def run_burst(engine, prompts, max_tokens, stamps=None) -> list[list[int]]:
    """Every request queued, then the engine started; ``stamps`` (a list)
    gets the engine's start time and each request's token arrival times."""
    marks = [[] for _ in prompts]
    tasks = [asyncio.ensure_future(generate_tokens(engine, p, n, m))
             for p, n, m in zip(prompts, max_tokens, marks)]
    await asyncio.sleep(0.05)  # every request queued
    t0 = time.perf_counter()
    engine.start()
    try:
        out = await asyncio.gather(*tasks)
    finally:
        engine.stop()
    if stamps is not None:
        stamps.extend([t0, marks])
    return out


def ttft_itl(stamps) -> dict:
    """TTFT (from the engine's start, every request queued) and ITL of a
    burst's ``run_burst`` stamps, ms."""
    t0, marks = stamps
    ttft = [m[0] - t0 for m in marks if m]
    itl = [b - a for m in marks for a, b in zip(m, m[1:])]
    return {"ttft_ms": [x * 1e3 for x in ttft], "ttft_ms_mean": sum(ttft) / len(ttft) * 1e3,
            "ttft_ms_max": max(ttft) * 1e3, "itl_ms_mean": sum(itl) / max(len(itl), 1) * 1e3}


def sibling_engine(base, **mode):
    """An engine over ``base``'s weights with other EngineConfig fields."""
    import dataclasses

    from dynamo_tpu_torch.engine import TorchLlmEngine

    return TorchLlmEngine(dataclasses.replace(base.config, **mode), params=base.params,
                          device=base.device)


def replay_vs_eager(torch, engine) -> dict:
    """One decode window on eight lanes at growing contexts, by graph replay
    and by the same step run eagerly on the same buffers: sampled tokens,
    logprobs, the K/V rows written and the generated counts bitwise equal,
    greedy and sampled (both graphs).  Leaves the window's inputs in the
    buffers; returns the checks and the first iteration's slots."""
    import numpy as np

    from dynamo_tpu_torch.engine.sequence import Sequence
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.ops.attention import cache_rows

    d = engine._decode
    dev = engine.device
    lanes, bs, steps = engine.config.max_batch_size, engine.config.block_size, d.steps
    n_slots = engine.config.num_blocks * bs
    ctx = np.array([33 + 61 * i for i in range(lanes)], np.int32)
    tables = np.zeros((lanes, engine.max_blocks_per_seq), np.int32)
    stride = engine.config.num_blocks // lanes  # each lane's blocks its own
    for i, c in enumerate(ctx):
        n = -(-(int(c) + steps) // bs)
        tables[i, :n] = np.arange(i * stride, i * stride + n)
    gen = np.random.default_rng(0)
    tokens = gen.integers(3, engine.config.model.vocab_size, lanes).astype(np.int32)
    d.tables.upload({"tables": tables})
    engine._bt_clean = False  # the engine's own rows no longer match the buffer
    d.window.upload({"tokens": tokens, "use_fb": np.zeros(lanes, bool), "lens": ctx})
    pos = ctx[:, None] - 1 + np.arange(steps)[None, :]
    slots = tables[np.arange(lanes)[:, None], pos // bs] * bs + pos % bs
    layers = engine.cache["k"].shape[0]
    rows = torch.from_numpy((np.arange(layers)[:, None] * n_slots + slots.reshape(-1)[None, :])
                            .reshape(-1)).to(dev)
    views = {k: cache_rows(leaf) for k, leaf in engine.cache.items()}

    def written():  # one-byte caches are indexed through their uint8 views
        return {k: v.view(torch.uint8)[rows].clone() for k, v in views.items()}

    out = {}
    for noise in (False, True):
        seqs = []
        for lane in range(lanes):
            sampling = (SamplingOptions(temperature=0.8, seed=lane) if noise
                        else SamplingOptions(use_greedy=True))
            seq = Sequence(seq_id=f"replay{lane}", request=PreprocessedRequest(
                token_ids=[1], sampling=sampling, stop=StopConditions(max_tokens=1)))
            seq.lane = lane
            engine._seed_lane_key(seq)
            seqs.append(seq)
        engine._device_sampling_tail(seqs)
        counts0, feedback0 = engine._gen_counts.clone(), d.feedback.clone()
        d.run(noise)
        torch.cuda.synchronize()
        graph = (d.out_tokens.clone(), d.out_lps.clone(), written(), engine._gen_counts.clone())
        engine._gen_counts.copy_(counts0)
        d.feedback.copy_(feedback0)
        d.step(noise)
        torch.cuda.synchronize()
        eager = (d.out_tokens.clone(), d.out_lps.clone(), written(), engine._gen_counts.clone())
        out["sampled" if noise else "greedy"] = {
            "tokens_equal": torch.equal(graph[0], eager[0]),
            "logprobs_bitwise": torch.equal(graph[1].view(torch.int32), eager[1].view(torch.int32)),
            "kv_rows_bitwise": all(torch.equal(graph[2][k].view(torch.uint8),
                                               eager[2][k].view(torch.uint8)) for k in views),
            "gen_counts_equal": torch.equal(graph[3], eager[3]),
        }
    return out, torch.from_numpy(slots[:, 0].astype(np.int32)).to(dev)


def forward_replay_vs_eager(torch, engine, step_slots) -> dict:
    """The decode forward alone on the window's buffers, captured here and
    replayed, against its eager run: logits bitwise, else the first
    differing one and the largest difference."""
    d = engine._decode
    dev = engine.device

    def forward():
        return engine.family.forward_decode(
            engine.params, engine.config.model, d.window["tokens"], engine.cache,
            d.tables["tables"], d.window["lens"], step_slots, engine.cos, engine.sin)[0]

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        forward()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        static = forward()
    graph.replay()
    replayed = static.clone()
    eager = forward()
    torch.cuda.synchronize()
    diff = (replayed - eager).abs()
    differ = torch.nonzero(diff.view(-1)).view(-1)
    return {
        "bitwise": torch.equal(replayed.view(torch.int32), eager.view(torch.int32)),
        "max_abs_diff": float(diff.max()),
        "first_differing": int(differ[0]) if differ.numel() else None,
        "max_abs_logit": float(eager.abs().max()),
    }


def window_ms(torch, d) -> dict:
    """The decode window's time on the buffers' inputs: CUDA events around
    back-to-back replays, then eager steps, and the host's time a call."""
    def timed(fn, iters):
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        for _ in range(iters):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / iters
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / iters, host

    def launch_ms():  # one replay's host time from an idle card (median of 5)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d.run(False)
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return sorted(times)[2]

    out = {"window_steps": d.steps}
    # back to back, the host's time a replay is bounded by the card's once
    # the launch queue fills (a window of a few thousand kernels)
    out["replay_ms"], out["replay_host_ms"] = timed(lambda: d.run(False), REPLAY_ITERS)
    out["replay_launch_ms"] = launch_ms()
    out["eager_ms"], out["eager_host_ms"] = timed(lambda: d.step(False), 5)
    return out


# the buckets at which a unified window is held by replay against eager
UNIFIED_CHECK_BUCKETS = (32, 256, 2048)


def unified_window(torch, engine, bucket: int, noise: bool) -> dict:
    """Write one unified window of ``bucket`` tokens into the unified
    graph's buffers: six decode lanes at contexts 33-338 and a span of
    prefill tokens on lane 6 from position 100 (its first window: it seeds
    the lane's penalty counts), all lanes sampled (``noise``) or greedy.
    Returns the cache slots its tokens write."""
    import numpy as np

    from dynamo_tpu_torch.engine.sequence import Sequence
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.ops.kernels import pack_page_meta

    ug, d = engine._unified, engine._decode
    lanes, bs = engine.config.max_batch_size, engine.config.block_size
    vocab = engine.config.model.vocab_size
    oob = engine.config.num_blocks * bs
    ctx = [33 + 61 * i for i in range(6)]
    start, n_span = 100, bucket - 6 - 3  # three pad tokens at the end
    ends = [*ctx, start + n_span]
    tables = np.zeros((lanes, engine.max_blocks_per_seq), np.int32)
    nxt = 0
    for lane, end in enumerate(ends):  # each lane's blocks its own
        n = -(-end // bs)
        tables[lane, :n] = np.arange(nxt, nxt + n)
        nxt += n
    gen = np.random.default_rng(bucket)
    token_ids = np.zeros((bucket,), np.int32)
    token_pos = np.full((bucket,), -1, np.int32)
    token_lane = np.full((bucket,), lanes, np.int32)
    lane_of = np.r_[np.arange(6), np.full(n_span, 6)]
    pos = np.r_[np.asarray(ctx) - 1, np.arange(start, start + n_span)]
    n_tok = lane_of.size
    token_ids[:n_tok] = gen.integers(3, vocab, n_tok)
    token_pos[:n_tok], token_lane[:n_tok] = pos, lane_of
    slots = tables[lane_of, pos // bs] * bs + pos % bs
    token_slot = np.full((bucket,), oob, np.int32)
    token_slot[:n_tok] = slots
    context_lens = np.zeros((lanes,), np.int32)
    context_lens[:7] = ends
    sample_rows = np.zeros((lanes,), np.int32)
    sample_rows[:7] = [*range(6), n_tok - 1]
    sample_gate = np.zeros((lanes,), np.int32)
    sample_gate[:7] = 1
    meta = pack_page_meta(token_lane, token_pos, tables, tb_tokens=ug.tb, block_size=bs,
                          page_slots=ug.page_slots)
    plan = ug.planner.plan(meta[3]) if ug.planner else None
    d.tables.upload({"tables": tables})
    engine._bt_clean = False  # the engine's own rows no longer match the buffer
    seqs = []
    for lane in range(7):
        sampling = (SamplingOptions(temperature=0.8, seed=lane, presence_penalty=0.3)
                    if noise else SamplingOptions(use_greedy=True))
        seq = Sequence(seq_id=f"unified{lane}", request=PreprocessedRequest(
            token_ids=[1], sampling=sampling, stop=StopConditions(max_tokens=1)))
        seq.lane = lane
        engine._seed_lane_key(seq)
        seqs.append(seq)
    engine._device_sampling_tail(seqs)
    prompt_row = np.bincount(gen.integers(0, vocab, 50), minlength=vocab).astype(np.int32)
    ug.upload(bucket, {
        "token_ids": token_ids, "use_fb": np.zeros((bucket,), bool), "token_pos": token_pos,
        "token_slot": token_slot, "token_lane": token_lane, "context_lens": context_lens,
        "sample_rows": sample_rows, "sample_gate": sample_gate, "page_count": meta[3],
        "page_phys": meta[0], "page_lane": meta[1], "page_ord": meta[2],
    }, plan, [(6, prompt_row, np.zeros((vocab,), np.int32))])
    return {"slots": slots, "plan_items": None if plan is None else len(plan.items),
            "plan_partials": None if plan is None else plan.n_partials,
            "worklist_entries": int(meta[3].sum())}


def unified_replay_vs_eager(torch, engine) -> dict:
    """At each of UNIFIED_CHECK_BUCKETS: a unified window (``unified_window``)
    by its graph's replay (captured by ``warmup()``) and by the same step run
    eagerly on the same buffers, greedy and sampled: tokens, logprobs, the
    K/V rows written, the generated and prompt counts and the feedback
    bitwise equal; then the forward alone captured and replayed against its
    eager run, logits bitwise.  Replays before the check must add no
    capture."""
    import numpy as np

    from dynamo_tpu_torch.ops.attention import cache_rows

    ug, d = engine._unified, engine._decode
    dev = engine.device
    n_slots = engine.config.num_blocks * engine.config.block_size
    layers = engine.cache["k"].shape[0]
    views = {k: cache_rows(leaf) for k, leaf in engine.cache.items()}
    out = {}
    for bucket in UNIFIED_CHECK_BUCKETS:
        captured = len(ug._graphs)
        for noise in (False, True):
            info = unified_window(torch, engine, bucket, noise)
            rows = torch.from_numpy(
                (np.arange(layers)[:, None] * n_slots + info["slots"][None, :])
                .reshape(-1)).to(dev)

            def state():
                return (ug.out_tokens.clone(), ug.out_lps.clone(),
                        {k: v.view(torch.uint8)[rows].clone() for k, v in views.items()},
                        engine._gen_counts.clone(), engine._prompt_counts.clone(),
                        d.feedback.clone())

            saved = (engine._gen_counts.clone(), engine._prompt_counts.clone(),
                     d.feedback.clone())
            ug.run(bucket, noise)
            torch.cuda.synchronize()
            graph = state()
            engine._gen_counts.copy_(saved[0])
            engine._prompt_counts.copy_(saved[1])
            d.feedback.copy_(saved[2])
            ug.step(bucket, noise)
            torch.cuda.synchronize()
            eager = state()
            out[f"b{bucket}_{'sampled' if noise else 'greedy'}"] = {
                "tokens_equal": torch.equal(graph[0], eager[0]),
                "logprobs_bitwise": torch.equal(graph[1].view(torch.int32),
                                                eager[1].view(torch.int32)),
                "kv_rows_bitwise": all(torch.equal(graph[2][k].view(torch.uint8),
                                                   eager[2][k].view(torch.uint8)) for k in views),
                "gen_counts_equal": torch.equal(graph[3], eager[3]),
                "prompt_counts_equal": torch.equal(graph[4], eager[4]),
                "feedback_equal": torch.equal(graph[5], eager[5]),
                "no_new_capture": len(ug._graphs) == captured,
            }
        out[f"b{bucket}_window"] = info | {"slots": None}
        out[f"b{bucket}_logits"] = unified_forward_replay_vs_eager(torch, engine, bucket)
    return out


def unified_forward_replay_vs_eager(torch, engine, bucket: int) -> dict:
    """The unified forward alone on ``bucket``'s buffers, captured here and
    replayed, against its eager run: logits bitwise, else the largest
    difference."""
    ug, d = engine._unified, engine._decode
    dev = engine.device
    v = ug.inputs.view(bucket)
    kw = {"plan": ug.work[bucket]} if bucket in ug.work else {}

    def forward():
        return engine.family.forward_unified(
            engine.params, engine.config.model, v["token_ids"], engine.cache,
            d.tables["tables"], v["context_lens"], v["token_pos"], v["token_slot"],
            v["token_lane"], v["page_phys"], v["page_lane"], v["page_ord"], v["page_count"],
            v["sample_rows"], engine.cos, engine.sin, tb_tokens=ug.tb, **kw)[0]

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        forward()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        static = forward()
    graph.replay()
    replayed = static.clone()
    eager = forward()
    torch.cuda.synchronize()
    del graph
    return {"bitwise": torch.equal(replayed.view(torch.int32), eager.view(torch.int32)),
            "max_abs_diff": float((replayed - eager).abs().max())}


def unified_window_ms(torch, engine) -> dict:
    """A unified window's device time at each of UNIFIED_CHECK_BUCKETS
    (CUDA events around back-to-back replays of its greedy graph) against
    the same step run eagerly, and one replay's launch ms from an idle
    card (median of 5)."""
    ug = engine._unified
    out = {}
    for bucket in UNIFIED_CHECK_BUCKETS:
        unified_window(torch, engine, bucket, False)

        def timed(fn, iters):
            fn()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            for _ in range(iters):
                fn()
            ev[1].record()
            torch.cuda.synchronize()
            return ev[0].elapsed_time(ev[1]) / iters

        launch = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ug.run(bucket, False)
            launch.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        out[bucket] = {"replay_ms": timed(lambda: ug.run(bucket, False), 5),
                       "eager_ms": timed(lambda: ug.step(bucket, False), 3),
                       "replay_launch_ms": sorted(launch)[2]}
    return out


def window_mates(base, vocab: int) -> dict:
    """A 300-token request's greedy tokens alone and behind a one-token
    request admitted one step before it, with decode overlap off and on:
    the index of the first token that differs, or None.  Under overlap the
    one-token request, finished but not yet read back, rides the 300-token
    request's prefill window, and its lane is released a window late."""
    rng = random.Random(2)
    a = [rng.randrange(3, vocab) for _ in range(300)]
    d = [rng.randrange(3, vocab) for _ in range(20)]
    out = {}
    for overlap in (False, True):
        alone = asyncio.run(run_burst(sibling_engine(base, decode_overlap=overlap), [a], [16]))
        behind = asyncio.run(run_burst(sibling_engine(base, decode_overlap=overlap), [d, a],
                                       [1, 16]))
        out[f"overlap_{'on' if overlap else 'off'}_first_diff"] = next(
            (i for i, (x, y) in enumerate(zip(alone[0], behind[1])) if x != y), None)
    return out


def phase_overlap(torch, card: str, tag: str, model: str, config: dict,
                  decode_key: str, ragged_key: str, path, check_fused: bool) -> dict:
    """The default engine (overlap on, every decode and unified window a
    graph replay), warmed by ``warmup()`` (every reachable token bucket's
    unified graphs and the decode graphs captured), on the burst: no
    capture in it, its launches counted through the replays (decode and
    ragged attention once a layer a replayed window), its TTFT and ITL;
    one decode window and unified windows at three buckets by replay
    against the same step run eagerly on the same buffers; the burst's
    greedy streams equal with overlap off and, where ``check_fused``, with
    decode_steps=4 against decode_steps=1 (both on the split prefill, like
    for like: decode_steps > 1 turns the unified step off).  The engine's
    phase accounting splits the host time a window."""
    import os

    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.serve import build_torch_engine

    path_dir = model_dir(model, config)
    rng = random.Random(1)
    vocab = config["vocab_size"]
    prompts = [[rng.randrange(3, vocab) for _ in range(n)] for n in OVERLAP_PROMPTS]
    max_tokens = [OVERLAP_FINISH - i for i in range(len(prompts))]
    os.environ["DYN_ENGINE_PHASE_TIMING"] = "1"
    try:
        base = build_torch_engine(path_dir, ModelDeploymentCard.from_local_path(path_dir),
                                  device="cuda", **OVERLAP_ENGINE)
    finally:
        os.environ.pop("DYN_ENGINE_PHASE_TIMING", None)

    # the unified windows' share of the phase accounting, kept apart from
    # the decode windows' (the reference names both decode.*)
    unified_phases: dict[str, list[float]] = {}
    run_unified = base._run_unified

    def split_phases(*args, **kw):
        before = {n: list(v) for n, v in base.phase_stats.items()}
        try:
            return run_unified(*args, **kw)
        finally:
            for n, (tot, cnt) in base.phase_stats.items():
                t_b, n_b = before.get(n, (0.0, 0))
                acc = unified_phases.setdefault(n, [0.0, 0])
                acc[0] += tot - t_b
                acc[1] += cnt - n_b

    base._run_unified = split_phases
    ug = base._unified
    asyncio.run(base.warmup())
    warm = base.stats()
    want_graphs = (2 * len(ug.buckets), 2)
    if (warm["unified_graphs_captured"], warm["decode_graphs_captured"]) != want_graphs:
        raise AssertionError(f"{tag}: warmup captured {warm['unified_graphs_captured']} unified "
                             f"and {warm['decode_graphs_captured']} decode graphs, not "
                             f"{want_graphs} (buckets {ug.buckets})")
    if warm["kv_cached_blocks"] or warm["kv_active_blocks"]:
        raise AssertionError(f"{tag}: warmup left blocks behind: {warm}")
    zero_counters()
    stamps = []
    t0 = time.perf_counter()
    streams = asyncio.run(run_burst(base, prompts, max_tokens, stamps))
    wall = time.perf_counter() - t0
    counts = read_counters()
    stats = base.stats()
    burst = ttft_itl(stamps)
    layers = base.config.model.num_layers
    delta = {k: stats[k] - warm[k] for k in (
        "decode_graph_replays_total", "decode_graphs_captured", "unified_graph_replays_total",
        "unified_graphs_captured", "decode_windows_unified_total")}
    windows = delta["decode_graph_replays_total"] + delta["decode_graphs_captured"]
    unified = delta["unified_graph_replays_total"] + delta["unified_graphs_captured"]
    if (delta["unified_graphs_captured"] or delta["decode_graphs_captured"]
            or stats["unified_graphs_captured_after_warmup"]
            or stats["decode_graphs_captured_after_warmup"]):
        raise AssertionError(f"{tag}: the burst after warmup captured a graph: {delta}")
    # every unified window of the burst (no top_logprobs lane) a replay
    if not 0 < delta["unified_graph_replays_total"] == delta["decode_windows_unified_total"]:
        raise AssertionError(f"{tag}: a unified window was not a graph replay: {delta}")
    if counts[ragged_key] != layers * unified:
        raise AssertionError(f"{tag}: {ragged_key} = {counts[ragged_key]}, not {layers} layers "
                             f"x {unified} replayed unified windows: {counts}")
    launched = {k: counts[k] for k in path}
    log(f"[overlap:{tag}] launches={launched} stats={ {k: v for k, v in stats.items() if 'decode' in k or 'drain' in k} }")
    if [len(s) for s in streams] != max_tokens:
        raise AssertionError(f"{tag}: streams of {[len(s) for s in streams]} tokens, "
                             f"not {max_tokens}")
    if stats["decode_windows_overlapped_total"] <= 0 or stats["decode_graph_replays_total"] <= 0:
        raise AssertionError(f"{tag}: no overlapped or replayed decode window: {stats}")
    if any(n <= 0 for n in launched.values()) or counts["plain_calls"] != 0:
        raise AssertionError(f"{tag}: a kernel of the path did not run: {counts}")
    # every decode window's attention ran inside a replay (or the capture's
    # warm-up), one launch a layer, counted through the replays
    if counts[decode_key] != layers * windows:
        raise AssertionError(f"{tag}: {decode_key} = {counts[decode_key]}, not {layers} layers "
                             f"x {windows} windows: {counts}")
    check_ragged_route(counts)
    table = counts["mla_attention.decode_launches"] + counts["mla_attention.window_launches"]
    if counts["mla_attention.table_walk_launches"] != table:
        raise AssertionError(f"{tag}: an MLA decode call missed the split table walk: {counts}")

    replay, step_slots = replay_vs_eager(torch, base)
    replay["logits"] = forward_replay_vs_eager(torch, base, step_slots)
    replay.update(window_ms(torch, base._decode))
    log(f"[overlap:{tag}] replay vs eager: {replay}")
    for mode in ("greedy", "sampled"):
        if not all(replay[mode].values()):
            raise AssertionError(f"{tag}: replay and eager differ ({mode}): {replay[mode]}")
    if not replay["logits"]["bitwise"]:
        raise AssertionError(f"{tag}: replayed forward's logits differ: {replay['logits']}")
    u_replay = unified_replay_vs_eager(torch, base)
    log(f"[overlap:{tag}] unified replay vs eager: {u_replay}")
    for key, res in u_replay.items():
        if key.endswith(("_greedy", "_sampled")) and not all(res.values()):
            raise AssertionError(f"{tag}: unified replay and eager differ ({key}): {res}")
        if key.endswith("_logits") and not res["bitwise"]:
            raise AssertionError(f"{tag}: replayed unified forward's logits differ ({key}): "
                                 f"{res}")
    u_ms = unified_window_ms(torch, base)
    log(f"[overlap:{tag}] unified window ms: {u_ms}")
    u_phase = {n: {"total_ms": t * 1e3, "n": c, "mean_ms": t * 1e3 / max(c, 1)}
               for n, (t, c) in unified_phases.items()}
    line = {
        "model": model, "card": card, "burst_wall_s": wall,
        "burst_tokens": sum(max_tokens), "decode_windows": stats["decode_steps_total"],
        "ms_per_decode_window": wall * 1e3 / max(stats["decode_steps_total"], 1),
        "burst": burst,
        "phase_ms": stats.get("phase_ms"),
        "phase_ms_unified_windows": u_phase,
        "unified_dispatch_ms": u_phase.get("decode.dispatch", {}).get("mean_ms"),
        "unified_upload_ms": u_phase.get("decode.upload", {}).get("mean_ms"),
        "replay": replay,
        "unified_replay": u_replay,
        "unified_window_ms": u_ms,
        "warmup_s": warm["warmup_s"],
        "unified_buckets": ug.buckets,
        "unified_capture_ms_per_bucket": ug.capture_ms,
        "row_scratch_mb": ug.scratch_mb,
        "pool_mb_total": stats["unified_graph_pool_mb"] + stats["decode_graph_pool_mb"],
        "graph": {k: v for k, v in stats.items() if k.startswith(("decode_graph", "unified_graph"))},
        "windows": {k: stats[k] for k in ("decode_windows_overlapped_total",
                                           "decode_windows_sync_total",
                                           "decode_windows_unified_total",
                                           "admission_drains_total", "offload_drains_total")},
        "launches": launched, "unified_launches": counts[ragged_key],
    }

    def burst_of(**mode):
        engine = sibling_engine(base, **mode)
        try:
            return asyncio.run(run_burst(engine, prompts, max_tokens)), engine.stats()
        finally:
            del engine
            gc.collect()
            torch.cuda.empty_cache()

    sync_streams, sync_stats = burst_of(decode_overlap=False)
    line["sync_equal"] = sync_streams == streams
    line["sync_windows"] = sync_stats["decode_windows_sync_total"]
    if not line["sync_equal"]:
        raise AssertionError(f"{tag}: greedy streams differ with overlap off")
    if check_fused:
        one, _ = burst_of(unified_batch=False)
        four, four_stats = burst_of(decode_steps=4)
        line["fused_equal"] = one == four
        line["fused_windows"] = four_stats["decode_windows_overlapped_total"]
        if not line["fused_equal"]:
            raise AssertionError(f"{tag}: decode_steps=4 streams differ from decode_steps=1")
    line["window_mates"] = window_mates(base, vocab)
    log(f"[overlap:{tag}] window mates: {line['window_mates']}")
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"smoke_overlap": line}), flush=True)
    base.stop()
    return {"counts": counts, "line": line}


def phase_overlap_both(torch, card: str) -> dict:
    return {
        "llama": phase_overlap(torch, card, "llama", "llama3-8b-smoke", LLAMA3_8B,
                               "paged_attention.launches", "ragged_attention.launches",
                               LLAMA_PATH, True),
        "mla": phase_overlap(torch, card, "mla", "deepseek-v2-lite-smoke", DEEPSEEK_V2_LITE,
                             "mla_attention.decode_launches", "mla_attention.ragged_launches",
                             MLA_PATH, False),
    }


# the speculative phase's chats repeat a phrase, so prompt lookup has
# history to draft from (random weights accept what they accept)
SPEC_PROMPTS = [f"say after me, again and again: the quick brown fox number {i}. " * 6
                for i in range(4)]
SPEC = dict(speculative="ngram", spec_tokens=4)


def phase_spec_tiny(torch) -> dict:
    """tests/data/tiny-chat-model on the card, with and without speculative
    decoding: the greedy streams must be equal, and the speculative engine
    must accept drafts (its prompt holds the run the counter weights take)."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.protocols.common import (
        Annotated,
        LLMEngineOutput,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.serve import build_torch_engine

    model = ROOT / "tests" / "data" / "tiny-chat-model"
    mdc = ModelDeploymentCard.from_local_path(model)
    prompts = [list(range(10, 40)) + [10, 11], list(range(100, 140)) + [100, 101],
               [5, 9, 13, 17, 21]]

    async def run(engine):
        async def one(tokens):
            req = PreprocessedRequest(
                token_ids=tokens, sampling=SamplingOptions(use_greedy=True),
                stop=StopConditions(max_tokens=24, ignore_eos=True), eos_token_ids=[1],
            ).to_wire()
            out = []
            async for item in await engine.generate(Context(req)):
                ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
                if ann.data is not None:
                    if ann.data.error:
                        raise RuntimeError(ann.data.error)
                    out.extend(ann.data.token_ids)
            return out

        engine.start()
        try:
            return await asyncio.gather(*(one(p) for p in prompts))
        finally:
            engine.stop()

    streams, stats = {}, {}
    for mode, kw in (("plain", {}), ("spec", SPEC)):
        engine = build_torch_engine(model, mdc, device="cuda", num_blocks=64, **kw)
        zero_counters()
        streams[mode] = asyncio.run(run(engine))
        stats[mode] = {**engine.stats(), **read_counters()}
        del engine
    spec = stats["spec"]
    log(f"[spec] tiny plain={streams['plain']} spec={streams['spec']} "
        f"drafted={spec['spec_drafted_tokens_total']} accepted={spec['spec_accepted_tokens_total']} "
        f"verify_steps={spec['spec_verify_steps_total']} "
        f"W>1 launches={spec['paged_attention.window_launches']}")
    if streams["spec"] != streams["plain"]:
        raise AssertionError("speculative greedy stream differs from the plain one")
    if streams["plain"][0] != list(range(12, 36)):
        raise AssertionError(f"tiny model stream {streams['plain'][0]} is not the counter run")
    if spec["spec_accepted_tokens_total"] <= 0 or spec["paged_attention.window_launches"] <= 0:
        raise AssertionError(f"no draft accepted or no verify launch: {spec}")
    if spec["plain_calls"] or stats["plain"]["plain_calls"]:
        raise AssertionError("plain attention ran on the card")
    return {"accepted": spec["spec_accepted_tokens_total"],
            "drafted": spec["spec_drafted_tokens_total"]}


def phase_spec(torch, card: str) -> dict:
    """Speculative decoding end to end on the card: the tiny model exactly,
    then the Llama-3-8B geometry and the published DeepSeek-V2-Lite config
    at full width and depth over HTTP, through the verify kernels."""
    tiny = phase_spec_tiny(torch)
    out = {"tiny": tiny}
    for key, model, config, path in (
        ("llama", "llama3-8b-spec", LLAMA3_8B, LLAMA_SPEC_PATH),
        ("mla", "deepseek-v2-lite-spec", DEEPSEEK_V2_LITE, MLA_SPEC_PATH),
    ):
        gc.collect()  # the previous engine is shut down: free its memory first
        torch.cuda.empty_cache()
        res = phase_serve(card, "spec", model, config, path, overrides=SPEC,
                          short_prompts=SPEC_PROMPTS, profile=False)
        run = res["run"]
        line = {"model": model, "card": card, **SPEC,
                **{k: run[k] for k in ("spec_drafted_tokens_total", "spec_accepted_tokens_total",
                                       "spec_rejected_tokens_total", "spec_verify_steps_total")},
                "launches": res["launched"]}
        print(json.dumps({"smoke_spec": line}), flush=True)
        if run["spec_verify_steps_total"] <= 0:
            raise AssertionError(f"{model}: no verify step ran: {run}")
        out[key] = res
    return out


# ---------------------------------------------------------------------------
# phase quant: fp8 KV caches and int8 weight-only projections
# ---------------------------------------------------------------------------

QUANT_CACHES = ("float8_e4m3fn", "float8_e5m2")
QUANT_LLAMA = dict(kv_cache_dtype="fp8", quantize="int8")
QUANT_MLA = dict(kv_cache_dtype="fp8")


def check_wide(name: str, res: dict) -> None:
    """A kernel on an fp8 cache gives the bits of the same kernel on the
    cache's values in bf16."""
    if not res["equals_wide_cache"]:
        raise AssertionError(f"{name}: the kernel on the fp8 cache differs from the same "
                             f"kernel on its bf16 values")


def fp8_copy_case(torch, *, shape, n, axis, cache_dtype, seed=0) -> dict:
    """Rows 6-7 on a one-byte pool (an fp8 cache leaf): gather and scatter
    byte-exact against their plain versions, the rest of the pool
    unchanged, and the scatter of bf16 blocks cast to the pool's dtype as
    the plain version casts them; times beside the same leaf in bf16."""
    from dynamo_tpu_torch.ops import block_copy as plain
    from dynamo_tpu_torch.ops.attention import to_cache_dtype
    from dynamo_tpu_torch.ops.kernels import gather_blocks, scatter_blocks

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n_pool = shape[axis]
    pool = to_cache_dtype(torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16),
                          cache_dtype)
    ids = torch.randperm(n_pool, generator=gen, device="cuda")[:n].tolist()
    blk_shape = list(shape)
    blk_shape[axis] = n
    wide = torch.randn(blk_shape, generator=gen, device="cuda").to(torch.bfloat16) * 300
    blocks = to_cache_dtype(wide, cache_dtype)

    def raw(t):
        return t.view(torch.uint8)

    out = gather_blocks(pool, ids, axis=axis)
    ref = plain.gather_blocks(pool, ids, axis)
    res = {"gather_equal": torch.equal(raw(out), raw(ref))}
    for name, src in (("scatter", blocks), ("scatter_cast", wide)):
        got = scatter_blocks(pool.clone(), src, ids, axis=axis)
        want = plain.scatter_blocks(pool.clone(), src, ids, axis)
        rest = torch.ones(n_pool, dtype=torch.bool, device="cuda")
        rest[ids] = False
        keep = rest.nonzero()[:, 0]
        res[f"{name}_equal"] = torch.equal(raw(got), raw(want))
        res[f"{name}_rest_unchanged"] = torch.equal(raw(got).index_select(axis, keep),
                                                    raw(pool).index_select(axis, keep))
    torch.cuda.synchronize()
    moved = out.numel() * out.element_size()
    ids_dev = torch.tensor(ids, device="cuda")
    target = pool.clone()
    res.update(
        row_bytes=moved // n, bytes=2 * moved, bound_ms=2 * moved / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        gather_ms=time_ms(lambda: gather_blocks(pool, ids, axis=axis), 20),
        gather_device_ms=device_ms(lambda: gather_blocks(pool, ids, axis=axis)),
        gather_plain_ms=time_ms(lambda: plain.gather_blocks(pool, ids, axis), 5),
        gather_library_ms=time_ms(lambda: torch.index_select(raw(pool), axis, ids_dev), 20),
        scatter_ms=time_ms(lambda: scatter_blocks(target, blocks, ids, axis=axis), 20),
        scatter_device_ms=device_ms(lambda: scatter_blocks(target, blocks, ids, axis=axis)),
        scatter_plain_ms=time_ms(lambda: plain.scatter_blocks(target, blocks, ids, axis), 5),
        scatter_library_ms=time_ms(lambda: raw(target).index_copy_(axis, ids_dev, raw(blocks)),
                                   20),
    )
    return res


def fp8_cast_check(torch) -> dict:
    """The cache writes' cast (``to_cache_dtype``) on the card gives the
    CPU's bytes: every bf16 value and a float32 sweep (subnormals, 448-480,
    large values, infinities, NaN), to both fp8 formats."""
    from dynamo_tpu_torch.ops.attention import to_cache_dtype

    every_bf16 = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    special = torch.tensor([0.0, -0.0, 2.0**-10, 2.0**-9, 2.0**-17, 1.0, 448.0, 449.0, 464.0,
                            465.0, 480.0, -480.0, 57344.0, 65536.0, 1e30, math.inf, -math.inf,
                            math.nan])
    gen = torch.Generator().manual_seed(0)
    rand = torch.randint(-2**31, 2**31, (1 << 20,), generator=gen, dtype=torch.int32)
    sweep = torch.cat([special, rand.view(torch.float32)])
    out = {}
    for name in QUANT_CACHES:
        dt = getattr(torch, name)
        for src_name, src in (("bf16", every_bf16), ("f32", sweep)):
            cpu = to_cache_dtype(src, dt).view(torch.uint8)
            card = to_cache_dtype(src.cuda(), dt).cpu().view(torch.uint8)
            out[f"{name}_{src_name}"] = {
                "values": src.numel(), "bytes_equal": torch.equal(cpu, card),
                # torch's own cast on the card, beside the CPU's (no check)
                "torch_cast_differs": int((src.to(dt).view(torch.uint8)
                                           != src.cuda().to(dt).cpu().view(torch.uint8)).sum()),
            }
    return out


def quant_kernels(torch) -> dict:
    """Rows 1-5 on fp8 e4m3fn and e5m2 caches at the main paths' shapes
    (each case beside the same case on a bf16 cache): within the bf16
    tolerances of the float32 plain version, bitwise the same kernel on the
    cache's bf16 values, two launches the same bits; rows 6-7 on one-byte
    pools byte-exact; the card's fp8 cast the CPU's."""
    rng = random.Random(88)
    dec32 = [rng.randint(1, 2048) for _ in range(32)]
    dec32[:2] = [2047, 2048]
    ver8 = [rng.randint(5, 2048) for _ in range(8)]
    ver8[:3] = [2047, 2048, 2050]
    mla32 = [rng.randint(1, 2048) for _ in range(32)]
    mla32[:3] = [2047, 2048, 0]
    mla8 = [rng.randint(5, 2048) for _ in range(8)]
    mla8[:3] = [2047, 2048, 0]
    mix = [(0, 0, 300), (1, 512, 37), *((2 + i, rng.randint(100, 2047), 1) for i in range(6))]
    builders = {
        "decode_b32": (lambda c: decode_case(torch, lens=dec32, seed=32, cache_dtype=c),
                       BF16_ATOL, False),
        "verify_w5_b8": (lambda c: decode_case(torch, lens=ver8, w=5, seed=38, max_blocks=128,
                                               cache_dtype=c), BF16_ATOL, False),
        "ragged_mix": (lambda c: ragged_case(torch, spans=mix, t_pad=352, cache_dtype=c),
                       BF16_ATOL, True),
        "mla_decode_b32": (lambda c: mla_decode_case(torch, lens=mla32, seed=42, cache_dtype=c),
                           MLA_ATOL, False),
        "mla_window_b8": (lambda c: mla_decode_case(torch, lens=mla8, w=5, seed=58,
                                                    max_blocks=128, cache_dtype=c),
                          MLA_ATOL, False),
        "mla_ragged_mix": (lambda c: mla_ragged_case(torch, spans=mix, t_pad=352, cache_dtype=c),
                           MLA_ATOL, False),
    }
    cases: dict[str, dict] = {}
    for name, (build, atol, ragged) in builders.items():
        for cache in (None, *QUANT_CACHES):
            key = f"{name}_{cache or 'bfloat16'}"
            cases[key] = res = build(getattr(torch, cache) if cache else None)
            if ragged:
                check_ragged(f"quant {key}", res)
            else:
                check_case(f"quant {key}", res, atol)
            if cache:
                check_wide(f"quant {key}", res)
    # the split walks' edges on fp8: one lane at ctx 16 in a 2048-position
    # table, idle lanes, a 64-row GQA window, a 16-query MLA window, a head
    # dim of 64, eight decode lanes up to 4096 in one ragged block
    dec8 = [(i, n - 1, 1) for i, n in enumerate([4096, 4095, 3000, 17, 1, 2048, 700, 64])]
    for cache in QUANT_CACHES:
        dt = getattr(torch, cache)
        for key, res, atol in (
            ("decode_ctx16_table2048", decode_case(torch, lens=[16], seed=12, timed=False,
                                                   max_blocks=128, cache_dtype=dt), BF16_ATOL),
            ("decode_idle_lanes", decode_case(torch, lens=[2047, 0, 16, 0, 700], seed=13,
                                              timed=False, cache_dtype=dt), BF16_ATOL),
            ("verify_w16_rows64", decode_case(torch, lens=[2047, 700, 33, 0, 2050], w=16,
                                              seed=14, timed=False, max_blocks=128,
                                              cache_dtype=dt), BF16_ATOL),
            ("decode_head_dim_64", decode_case(torch, lens=[2047, 300, 17], d=64, seed=8,
                                               timed=False, cache_dtype=dt), BF16_ATOL),
            ("mla_window_w16", mla_decode_case(torch, lens=[2047, 700, 33, 0, 2050], w=16,
                                               seed=18, timed=False, max_blocks=128,
                                               cache_dtype=dt), MLA_ATOL),
            ("mla_ragged_decode8", mla_ragged_case(torch, spans=dec8, t_pad=8, timed=False,
                                                   cache_dtype=dt), MLA_ATOL),
        ):
            check_case(f"quant {key}_{cache}", res, atol)
            check_wide(f"quant {key}_{cache}", res)
            cases[f"{key}_{cache}"] = res
        for key, spans, d in (("ragged_decode8", dec8, 128), ("ragged_head_dim_64", mix, 64)):
            res = ragged_case(torch, spans=spans, d=d, t_pad=8 if spans is dec8 else 352,
                              timed=False, cache_dtype=dt)
            check_ragged(f"quant {key}_{cache}", res)
            check_wide(f"quant {key}_{cache}", res)
            cases[f"{key}_{cache}"] = res
        # the CUDA-core loops convert an fp8 cache on load: float32 queries
        # at head dim 16 and the tiny_mla widths
        small = decode_case(torch, lens=[5, 17, 29, 64], h=4, kvh=2, d=16, dtype=torch.float32,
                            seed=7, timed=False, cache_dtype=dt)
        check_case(f"quant decode head dim 16 fp32 queries, {cache} cache", small, F32_ATOL)
        small_m = mla_ragged_case(torch, spans=[(0, 4, 1), (1, 8, 9), (2, 28, 1)], h=4, r=32,
                                  p=8, dtype=torch.float32, t_pad=16, timed=False, cache_dtype=dt)
        check_case(f"quant mla ragged tiny_mla fp32 queries, {cache} cache", small_m, F32_ATOL)
    # a float16 cache under bf16 queries takes the CUDA-core loop
    f16 = decode_case(torch, lens=[2047, 300, 17], seed=9, timed=False,
                      cache_dtype=torch.float16)
    check_case("quant decode bf16 queries, float16 cache (CUDA-core loop)", f16, BF16_ATOL)
    copies = {}
    for name, shape in (("copy_llama_leaf", (32, 1024, 16, 8, 128)),
                        ("copy_mla_latent", (27, 1024, 16, 1, 512))):
        for cache in QUANT_CACHES:
            res = fp8_copy_case(torch, shape=shape, n=93, axis=1,
                                cache_dtype=getattr(torch, cache), seed=len(copies))
            shown = {k: (float(f"{v:.6g}") if isinstance(v, float) else v) for k, v in res.items()}
            log(f"[quant] {name} {cache} (bytes): {json.dumps(shown)}")
            if not all(v for k, v in res.items() if k.endswith(("_equal", "_unchanged"))):
                raise AssertionError(f"{name} {cache}: a block copy differs from its plain "
                                     f"version: {res}")
            copies[f"{name}_{cache}"] = res
    casts = fp8_cast_check(torch)
    log(f"[quant] fp8 casts, card against CPU: {json.dumps(casts)}")
    if not all(c["bytes_equal"] for c in casts.values()):
        raise AssertionError(f"the card's fp8 cache cast differs from the CPU's: {casts}")
    timed = [k for k, v in cases.items() if "ms" in v]
    print(json.dumps({"smoke_quant_kernels": {
        k: {key: cases[k].get(key) for key in (
            "max_abs_err", "max_rel_err", "equals_wide_cache", "ms", "device_ms", "plain_ms",
            "library_ms", "bytes", "bound_ms", "bound_by")} for k in timed},
        "copies": copies}), flush=True)
    return {"cases": cases, "copies": copies, "casts": casts}


def quant_replay_checks(torch, engine) -> dict:
    """On a served quantized engine (its thread stopped): a decode window
    and unified windows at UNIFIED_CHECK_BUCKETS by graph replay bitwise
    equal to the same steps run eagerly (tokens, logprobs, the fp8 K/V rows,
    the counts, logits), with no graph captured after warmup."""
    replay, step_slots = replay_vs_eager(torch, engine)
    replay["logits"] = forward_replay_vs_eager(torch, engine, step_slots)
    unified = unified_replay_vs_eager(torch, engine)
    stats = engine.stats()
    return {"decode": replay, "unified": unified,
            "captured_after_warmup": stats["unified_graphs_captured_after_warmup"]
            + stats["decode_graphs_captured_after_warmup"],
            "pool_mb": stats["unified_graph_pool_mb"] + stats["decode_graph_pool_mb"]}


def check_replays(tag: str, checked: dict) -> None:
    for mode in ("greedy", "sampled"):
        if not all(checked["decode"][mode].values()):
            raise AssertionError(f"{tag}: decode replay and eager differ ({mode}): "
                                 f"{checked['decode'][mode]}")
    if not checked["decode"]["logits"]["bitwise"]:
        raise AssertionError(f"{tag}: replayed decode logits differ: {checked['decode']}")
    for key, res in checked["unified"].items():
        if key.endswith(("_greedy", "_sampled")) and not all(res.values()):
            raise AssertionError(f"{tag}: unified replay and eager differ ({key}): {res}")
        if key.endswith("_logits") and not res["bitwise"]:
            raise AssertionError(f"{tag}: replayed unified logits differ ({key}): {res}")
    if checked["captured_after_warmup"]:
        raise AssertionError(f"{tag}: graphs captured after warmup: {checked}")


def phase_quant(torch, card: str) -> dict:
    """The quantized paths on the card: the kernels over fp8 caches
    (``quant_kernels``), then the Llama-3-8B geometry with int8 weights and
    an fp8 cache and the DeepSeek-V2-Lite config with an fp8 cache, each
    served over HTTP after ``warmup()`` (the counted traffic of phase serve,
    the decode profile, the replays against eager, MFU and bandwidth share
    from ``stats()``), then each again with n-gram speculation (the verify
    kernels on the fp8 cache)."""
    out = {"kernels": quant_kernels(torch)}
    for key, model, config, overrides, path, spec_path in (
        ("llama", "llama3-8b-quant", LLAMA3_8B, QUANT_LLAMA, LLAMA_PATH, LLAMA_SPEC_PATH),
        ("mla", "deepseek-v2-lite-quant", DEEPSEEK_V2_LITE, QUANT_MLA, MLA_PATH, MLA_SPEC_PATH),
    ):
        gc.collect()
        torch.cuda.empty_cache()
        res = phase_serve(card, f"quant:{key}", model, config, path, overrides=overrides,
                          inspect=lambda engine: quant_replay_checks(torch, engine))
        check_replays(f"quant:{key}", res["inspect"])
        stats = res["stats"]
        if stats["kv_cache_dtype"] != "float8_e4m3fn" or stats["quantize"] != overrides.get(
                "quantize"):
            raise AssertionError(f"quant:{key}: served {stats['kv_cache_dtype']} / "
                                 f"{stats['quantize']}, not {overrides}")
        gc.collect()
        torch.cuda.empty_cache()
        spec = phase_serve(card, f"quant:{key}:spec", f"{model}-spec", config, spec_path,
                           overrides={**overrides, **SPEC}, short_prompts=SPEC_PROMPTS,
                           profile=False)
        if spec["run"]["spec_verify_steps_total"] <= 0:
            raise AssertionError(f"quant:{key}: no verify step ran: {spec['run']}")
        line = {
            "model": model, "card": card, **overrides, "e2e": res["e2e"],
            "profile": {k: res["profile"].get(k) for k in (
                "wall_ms_per_step", "wall_ms_per_step_profiler_off", "device_ms_per_step",
                "device_idle_share", "port_kernels_ms_per_step", "top_kernels_ms_per_step")},
            "mfu_perc": stats["mfu_perc"], "bandwidth_util_perc": stats["bandwidth_util_perc"],
            "goodput_tokens_per_second": stats["goodput_tokens_per_second"],
            "model_flops_total": stats["model_flops_total"],
            "model_bytes_total": stats["model_bytes_total"],
            "graph_pool_mb": res["inspect"]["pool_mb"], "warmup_s": stats["warmup_s"],
            "launches": res["launched"], "spec_launches": spec["launched"],
            "replays_bitwise": True,
        }
        print(json.dumps({"smoke_quant": line}), flush=True)
        out[key] = res
        out[f"{key}_spec"] = spec
    return out


# ---------------------------------------------------------------------------
# phases 7-8: the KV offload tiers
# ---------------------------------------------------------------------------

OFFLOAD_PATH = ("block_copy.gather_launches", "block_copy.scatter_launches")
OFFLOAD = dict(num_blocks=256, max_batch_size=8, max_model_len=4096,
               host_offload_blocks=192, disk_offload_blocks=128)
# prompt lengths (tokens) of the offload traffic: A, the churn that evicts A
# to G2, the churn that cascades A's copies into G3
OFFLOAD_A, OFFLOAD_CHURN_G2, OFFLOAD_CHURN_G3 = 1500, (2400, 2400), (2400, 2400, 2400)


async def generate_tokens(engine, tokens: list[int], max_tokens: int,
                          stamps: list | None = None) -> list[int]:
    from dynamo_tpu_torch.llm.protocols.common import (
        Annotated,
        LLMEngineOutput,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    req = PreprocessedRequest(
        token_ids=tokens, sampling=SamplingOptions(use_greedy=True),
        stop=StopConditions(max_tokens=max_tokens, ignore_eos=True), eos_token_ids=[1],
    ).to_wire()
    out = []
    async for item in await engine.generate(Context(req)):
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is not None:
            if ann.data.error:
                raise RuntimeError(ann.data.error)
            out.extend(ann.data.token_ids)
            if stamps is not None and ann.data.token_ids:
                stamps.extend([time.perf_counter()] * len(ann.data.token_ids))
    return out


async def settled(engine, timeout_s: float = 30.0) -> None:
    """Wait until the engine holds no sequence.  With decode overlapped a
    finished request releases its lane one window late, so a request sent
    at once may land on another lane; DeepSeek's MoE, whose expert
    capacity (one pair an expert at eight lanes) is filled in lane order,
    gives a request other tokens on another lane.  Requests compared for
    equal tokens start from the same free lanes."""
    t0 = time.perf_counter()
    while engine.scheduler.num_running:
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"engine still holds {engine.scheduler.num_running} "
                                 f"sequences after {timeout_s} s")
        await asyncio.sleep(0.005)


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_offload(torch, card: str, config: dict = LLAMA3_8B, device: str = "cuda",
                  model: str = "llama3-8b-offload") -> dict:
    """The engine's offload tiers on the card at ``config``'s geometry (the
    Llama-3-8B geometry or the published DeepSeek-V2-Lite config, all
    layers, random weights from seed 0): G1 is 256 device blocks, G2 192
    host blocks, G3 128 disk blocks.  The traffic is counted in tokens, so
    the same prompts evict and cascade A's blocks at either model.  Prompt A twice (the second a
    device prefix hit: tokens T), churn that evicts A's blocks to G2, A
    again (restored from G2), churn that cascades A's copies to G3, A again
    (restored through G3).  Each restore must give T and land A's blocks
    bitwise equal to their snapshot; every evicted block must reach a tier."""
    from dynamo_tpu_torch.llm.kv_router.hashing import compute_block_hashes
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.serve import build_torch_engine

    path = model_dir(model, config)
    disk = ROOT / "dynamo_tpu_torch" / "_build" / "offload_g3.blocks"
    engine = build_torch_engine(path, ModelDeploymentCard.from_local_path(path), device=device,
                                seed=0, disk_offload_path=str(disk), **OFFLOAD)
    dev = engine.device
    bs = engine.config.block_size
    rng = random.Random(0)
    vocab = engine.config.model.vocab_size

    def prompt(n):
        return [rng.randrange(3, vocab) for _ in range(n)]

    a = prompt(OFFLOAD_A)
    hashes = compute_block_hashes(a, bs)[: (len(a) - 1) // bs]  # what a match can cover
    churn = [[prompt(n) for n in OFFLOAD_CHURN_G2], [prompt(n) for n in OFFLOAD_CHURN_G3]]
    tier = engine.host_tier

    # every eviction batch: count its blocks, and check that each evicted
    # block sits in a tier once the sink returns (the engine's sink, like
    # the reference's, would report a failed copy only as a cache miss)
    evictions = {"blocks": 0, "lost": 0}
    sink = engine.allocator.offload_sink

    def counted_sink(pairs):
        evictions["blocks"] += len(pairs)
        failed = sink(pairs)
        evictions["lost"] += sum(not tier.has(h) for _, h in pairs)
        return failed

    engine.allocator.offload_sink = counted_sink
    restores: list[dict] = []
    restore = engine._restore_blocks

    def timed_restore(plan):
        sync(torch, dev)
        t0 = time.perf_counter()
        restore(plan)
        sync(torch, dev)
        restores.append({"plan": list(plan), "ms": (time.perf_counter() - t0) * 1e3})

    engine._restore_blocks = timed_restore

    def resident_ids():
        return [engine.allocator._hash_to_block[h] for h in hashes]

    def blocks_of(ids):
        return {k: leaf[:, ids].clone() for k, leaf in engine.cache.items()}

    def same_blocks(x, y):
        return all(torch.equal(x[k].view(torch.uint8), y[k].view(torch.uint8)) for k in x)

    async def drive():
        engine.start()
        try:
            await generate_tokens(engine, a, 16)
            await settled(engine)
            snapshot = blocks_of(resident_ids())
            t_ref = await generate_tokens(engine, a, 16)  # a device prefix hit
            await settled(engine)
            checks = []
            for label, burst in (("g2", churn[0]), ("g3", churn[1])):
                for p in burst:
                    await generate_tokens(engine, p, 4)
                    await settled(engine)
                resident = sum(engine.allocator.is_registered(h) for h in hashes)
                before = engine.stats()
                n_restores = len(restores)
                tokens = await generate_tokens(engine, a, 16)
                await settled(engine)
                after = engine.stats()
                landed = {h: bid for plan in restores[n_restores:] for h, bid in plan["plan"]}
                # host_restores_total counts restores from every tier
                disk = after["disk_restores_total"] - before["disk_restores_total"]
                total = after["host_restores_total"] - before["host_restores_total"]
                checks.append({
                    "tier": label, "device_resident_before": resident,
                    "restored": {"g2": total - disk, "g3": disk},
                    "tokens_equal": tokens == t_ref,
                    "blocks_equal": len(landed) == len(hashes) and same_blocks(
                        blocks_of([landed[h] for h in hashes]), snapshot),
                    "restore_ms": [r["ms"] for r in restores[n_restores:]],
                    # the engine's own split of these restores' time
                    "parts_ms": {k: after[f"restore_{k}_ms_total"] - before[f"restore_{k}_ms_total"]
                                 for k in ("stage", "copy", "scatter")},
                })
            counts = read_counters()  # the served traffic's launches only
            return t_ref, checks, counts, engine.stats()
        finally:
            engine.stop()

    zero_counters()
    try:
        t_ref, checks, counts, stats = asyncio.run(drive())
    finally:
        disk.unlink(missing_ok=True)
    log(f"[offload] checks={checks} evictions={evictions} counts={counts} "
        f"stats={ {k: v for k, v in stats.items() if 'restore' in k or 'offload' in k} }")
    for c in checks:
        if not (c["restored"][c["tier"]] == len(hashes) and c["device_resident_before"] == 0
                and c["tokens_equal"] and c["blocks_equal"]):
            raise AssertionError(f"restore through {c['tier']} failed its checks: {c}")
    if evictions["lost"] or stats["host_offloads_total"] != evictions["blocks"]:
        raise AssertionError(f"an evicted block reached no tier: {evictions}, "
                             f"host_offloads_total {stats['host_offloads_total']}")
    if counts["plain_calls"] != 0 or any(counts[k] <= 0 for k in OFFLOAD_PATH):
        raise AssertionError(f"block copies did not run through the kernels: {counts}")
    check_ragged_route(counts)
    nbytes = len(hashes) * tier.block_nbytes
    line = {
        "model": model, "card": card, "blocks": len(hashes),
        "restore_bytes": nbytes, "tokens": t_ref,
        "restores": {k: stats[k] for k in stats if k.endswith("_restores_total")},
        "restore_ms": {c["tier"]: c["restore_ms"] for c in checks},
        "restore_gb_s": {c["tier"]: gb_s(nbytes, sum(c["restore_ms"])) for c in checks},
        "restore_parts_ms": {c["tier"]: c["parts_ms"] for c in checks},
        # host-to-device bytes over the copies' time; the scatters read and write them
        "copy_gb_s": {c["tier"]: gb_s(nbytes, c["parts_ms"]["copy"]) for c in checks},
        "scatter_gb_s": {c["tier"]: gb_s(2 * nbytes, c["parts_ms"]["scatter"]) for c in checks},
        "evicted_blocks": evictions["blocks"],
        "host_offloads_total": stats["host_offloads_total"],
        "launches": {k: counts[k] for k in OFFLOAD_PATH},
    }
    print(json.dumps({"smoke_offload": line}), flush=True)
    return {"counts": counts, "line": line}


def gb_s(nbytes: int, ms: float) -> float | None:
    return nbytes / ms / 1e6 if ms > 0 else None


KVBM_SHAPE = (32, 2, 16, 8, 128)  # Llama-3-8B: layers, k/v, block, kv heads, head dim
KVBM = dict(device_blocks=512, host_blocks=256, disk_blocks=256)
KVBM_G4_BLOCKS, KVBM_SEQ = 64, 256


def phase_kvbm(torch, card: str, device: str = "cuda") -> dict:
    """The KV block manager on the card: G1 512 device blocks of the
    Llama-3-8B block (2 MiB, bf16), G2 256 host, G3 256 disk, G4 64 in a
    block store served from a thread on localhost.  Three sequences of 256
    random blocks, each stored and cascaded down every tier; then read
    back through G1, onboarded from G2, G3 and G4 in turn (each copy
    cascades, so a lower tier holds the newest blocks: the tiers above the
    one under test forget the sequence first, as a tier invalidation
    does).  Bitwise equal to what was stored, no failed transfer."""
    import threading

    from dynamo_tpu_torch.llm.block_manager import HostStorage, KvBlockManager, KvbmConfig, Tier
    from dynamo_tpu_torch.llm.block_manager.remote import BlockStoreServer

    loop = asyncio.new_event_loop()
    server = BlockStoreServer(HostStorage(KVBM_G4_BLOCKS, KVBM_SHAPE, torch.bfloat16))
    thread = threading.Thread(target=loop.run_forever, name="g4-store", daemon=True)
    thread.start()
    asyncio.run_coroutine_threadsafe(server.start(), loop).result(timeout=60)
    disk = ROOT / "dynamo_tpu_torch" / "_build" / "kvbm_g3.blocks"
    layers, _, bs, kvh, hd = KVBM_SHAPE
    mgr = KvBlockManager(KvbmConfig(
        num_layers=layers, block_size=bs, kv_heads=kvh, head_dim=hd, dtype=torch.bfloat16,
        device=device, disk_path=str(disk), remote_address=server.address, **KVBM))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    jobs_per_seq = KVBM_SEQ * (len(mgr.tier_order) - 1)  # one copy a block a tier

    async def settle(done_before):
        off = mgr.offload
        deadline = time.time() + 300
        while off.completed + off.skipped + off.failed - done_before < jobs_per_seq:
            if time.time() > deadline:
                raise AssertionError("the offload cascade did not settle")
            await asyncio.sleep(0.01)

    async def drive():
        mgr.start()
        out = []
        try:
            for k, (source, drop) in enumerate((
                (Tier.G2_HOST, [Tier.G1_DEVICE]),
                (Tier.G3_DISK, [Tier.G1_DEVICE, Tier.G2_HOST]),
                (Tier.G4_REMOTE, [Tier.G1_DEVICE, Tier.G2_HOST, Tier.G3_DISK]),
            )):
                hashes = [(k + 1) << 32 | i for i in range(KVBM_SEQ)]
                data = torch.randn((KVBM_SEQ, *KVBM_SHAPE), generator=gen, device=device,
                                   dtype=torch.bfloat16)
                off = mgr.offload
                done = off.completed + off.skipped + off.failed
                t0 = time.perf_counter()
                ids = mgr.store_sequence(hashes, data)
                await settle(done)
                store_s = time.perf_counter() - t0
                mgr.release_sequence(ids)
                for t in drop:
                    for h in hashes:
                        mgr.pools[t].drop_hash(h)
                held = [i for i, h in enumerate(hashes) if mgr.pools[source].has_hash(h)]
                t0 = time.perf_counter()
                hit, tier = await mgr.match_and_onboard([hashes[i] for i in held])
                got = await asyncio.to_thread(mgr.primary.read, hit)
                onboard_s = time.perf_counter() - t0
                mgr.release_sequence(hit)
                equal = len(hit) == len(held) and torch.equal(
                    got.view(torch.int16), data[held].cpu().view(torch.int16))
                out.append({"source": tier.value if tier else None, "expected": source.value,
                            "blocks": len(held), "equal": equal, "store_cascade_s": store_s,
                            "onboard_read_s": onboard_s})
            return out
        finally:
            await mgr.stop()

    zero_counters()
    try:
        seqs = asyncio.run(drive())
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(timeout=60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=60)
        disk.unlink(missing_ok=True)
    counts = read_counters()
    stats = mgr.stats()
    line = {"card": card, "block_bytes": math.prod(KVBM_SHAPE) * 2, "sequences": seqs,
            "offload": stats["offload"], "launches": {k: counts[k] for k in OFFLOAD_PATH}}
    print(json.dumps({"smoke_kvbm": line}), flush=True)
    for s in seqs:
        if not (s["equal"] and s["source"] == s["expected"] and s["blocks"] > 0):
            raise AssertionError(f"KVBM read-back failed: {s}")
    if stats["offload"]["failed"] != 0:
        raise AssertionError(f"KVBM transfers failed: {stats['offload']}")
    if counts["plain_calls"] != 0 or any(counts[k] <= 0 for k in OFFLOAD_PATH):
        raise AssertionError(f"G1 did not move blocks through the kernels: {counts}")
    return {"counts": counts, "line": line}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}, or sweep")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    bad = set(phases) - set(PHASES) - {"sweep"}
    if bad:
        ap.error(f"unknown phases {sorted(bad)}")

    try:
        import torch
    except ImportError as exc:
        log(f"error: torch is not importable: {exc}")
        return 2
    if not torch.cuda.is_available():
        log("error: torch.cuda.is_available() is false: this smoke needs a CUDA card")
        return 2
    try:
        from dynamo_tpu_torch.ops.kernels import build
    except ImportError as exc:
        log(f"error: the dynamo_tpu_torch package is not next to this script: {exc}")
        return 2

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kinfo = serve = mla = overlap = spec = offload = quant = None
    t_all = time.perf_counter()
    try:
        t0 = time.perf_counter()
        build.library()
        log(f"[build] kernels ready in {time.perf_counter() - t0:.1f}s "
            f"(nvcc wall {build.build_seconds}s; None = reused)")

        def run(name, fn, *args):
            gc.collect()  # the last phase's engine is shut down: free its memory first
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            out = fn(*args)
            log(f"[{name}] phase done in {time.perf_counter() - t0:.1f}s")
            return out

        if "kernels" in phases:
            kinfo = run("kernels", phase_kernels, torch)
        if "tiny" in phases:
            run("tiny", phase_tiny)
        if "serve" in phases:
            serve = run("serve", phase_serve, card, "serve", "llama3-8b-smoke", LLAMA3_8B,
                        LLAMA_PATH)
        if "mla" in phases:
            mla = run("mla", phase_serve, card, "mla", "deepseek-v2-lite-smoke",
                      DEEPSEEK_V2_LITE, MLA_PATH)
        if "overlap" in phases:
            overlap = run("overlap", phase_overlap_both, torch, card)
        if "spec" in phases:
            spec = run("spec", phase_spec, torch, card)
        if "offload" in phases:
            offload = run("offload", phase_offload, torch, card)
            run("offload", phase_offload, torch, card, DEEPSEEK_V2_LITE, "cuda",
                "deepseek-v2-lite-offload")
        if "kvbm" in phases:
            run("kvbm", phase_kvbm, torch, card)
        if "quant" in phases:
            quant = run("quant", phase_quant, torch, card)
        if "sweep" in phases:
            run("sweep", phase_sweep, torch)
    except Exception as exc:  # noqa: BLE001 — a failed phase fails the run
        import traceback

        traceback.print_exc()
        log(f"FAILED: {type(exc).__name__}: {exc}")
        return 1
    log(f"phases {phases} passed in {time.perf_counter() - t_all:.1f}s")
    if None not in (kinfo, serve, mla, overlap, spec, offload, quant):
        cases = kinfo["cases"]
        for row in ("gather", "scatter"):  # rows 6-7 at the engine's Llama leaf
            case = cases["copy_llama_leaf"]
            cases[f"{row}_llama_leaf"] = {
                "ms": case[f"{row}_ms"], "device_ms": case[f"{row}_device_ms"],
                "plain_ms": case[f"{row}_plain_ms"],
                "library_ms": case[f"{row}_library_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"]}
        entries = []
        for name, src, repl, case, err, launches in (
            ("ragged_paged_attention", "dynamo_tpu_torch/csrc/ragged_attention.cu",
             "dynamo_tpu/ops/pallas/ragged_attention.py:262", "ragged_mix", "ragged",
             serve["counts"]["ragged_attention.launches"]),
            ("paged_window_attention_decode", "dynamo_tpu_torch/csrc/paged_attention.cu",
             "dynamo_tpu/ops/pallas/paged_attention.py:141", "decode_b32", "paged",
             serve["counts"]["paged_attention.launches"]),
            ("ragged_mla_attention", "dynamo_tpu_torch/csrc/mla_attention.cu",
             "dynamo_tpu/ops/pallas/mla_attention.py:408", "mla_ragged_mix", "mla_ragged",
             mla["counts"]["mla_attention.ragged_launches"]),
            ("mla_paged_attention_decode", "dynamo_tpu_torch/csrc/mla_attention.cu",
             "dynamo_tpu/ops/pallas/mla_attention.py:237", "mla_decode_b32", "mla_decode",
             mla["counts"]["mla_attention.decode_launches"]),
            ("mla_paged_window_attention_decode", "dynamo_tpu_torch/csrc/mla_attention.cu",
             "dynamo_tpu/ops/pallas/mla_attention.py:182", "mla_window_b8", "mla_window",
             spec["mla"]["counts"]["mla_attention.window_launches"]),
            ("paged_window_attention_decode (W=5)", "dynamo_tpu_torch/csrc/paged_attention.cu",
             "dynamo_tpu/ops/pallas/paged_attention.py:141", "verify_w5_b8", "paged_w5",
             spec["llama"]["counts"]["paged_attention.window_launches"]),
            ("gather_blocks", "dynamo_tpu_torch/csrc/block_copy.cu",
             "dynamo_tpu/ops/pallas/block_copy.py:25", "gather_llama_leaf", "gather",
             offload["counts"]["block_copy.gather_launches"]),
            ("scatter_blocks", "dynamo_tpu_torch/csrc/block_copy.cu",
             "dynamo_tpu/ops/pallas/block_copy.py:56", "scatter_llama_leaf", "scatter",
             offload["counts"]["block_copy.scatter_launches"]),
        ):
            c = cases[case]
            entries.append({
                "name": name, "route": "cuda", "source": src, "replaces": repl,
                "launches": launches, "max_abs_err": kinfo["errs"][err],
                "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                "device_ms": c.get("device_ms", "not measured"), "case": case,
            })
        # rows 1-5 on the fp8 e4m3fn cache of phase quant's served paths
        qcases = quant["kernels"]["cases"]
        fp8 = "float8_e4m3fn"
        for name, src, repl, case, counts, key in (
            ("ragged_paged_attention (fp8 cache)", "dynamo_tpu_torch/csrc/ragged_attention.cu",
             "dynamo_tpu/ops/pallas/ragged_attention.py:262", "ragged_mix",
             quant["llama"]["counts"], "ragged_attention.launches"),
            ("paged_window_attention_decode (fp8 cache)",
             "dynamo_tpu_torch/csrc/paged_attention.cu",
             "dynamo_tpu/ops/pallas/paged_attention.py:141", "decode_b32",
             quant["llama"]["counts"], "paged_attention.launches"),
            ("ragged_mla_attention (fp8 cache)", "dynamo_tpu_torch/csrc/mla_attention.cu",
             "dynamo_tpu/ops/pallas/mla_attention.py:408", "mla_ragged_mix",
             quant["mla"]["counts"], "mla_attention.ragged_launches"),
            ("mla_paged_attention_decode (fp8 cache)", "dynamo_tpu_torch/csrc/mla_attention.cu",
             "dynamo_tpu/ops/pallas/mla_attention.py:237", "mla_decode_b32",
             quant["mla"]["counts"], "mla_attention.decode_launches"),
            ("mla_paged_window_attention_decode (fp8 cache)",
             "dynamo_tpu_torch/csrc/mla_attention.cu",
             "dynamo_tpu/ops/pallas/mla_attention.py:182", "mla_window_b8",
             quant["mla_spec"]["counts"], "mla_attention.window_launches"),
            ("paged_window_attention_decode (W=5, fp8 cache)",
             "dynamo_tpu_torch/csrc/paged_attention.cu",
             "dynamo_tpu/ops/pallas/paged_attention.py:141", "verify_w5_b8",
             quant["llama_spec"]["counts"], "paged_attention.window_launches"),
        ):
            c = qcases[f"{case}_{fp8}"]
            entries.append({
                "name": name, "route": "cuda", "source": src, "replaces": repl,
                "launches": counts[key],
                "max_abs_err": max(qcases[f"{case}_{dt}"]["max_abs_err"] for dt in QUANT_CACHES),
                "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                "device_ms": c.get("device_ms", "not measured"), "case": f"{case}_{fp8}",
            })
        print(json.dumps({"kernels": entries}), flush=True)
    if not set(PHASES) <= set(phases):
        log("subset run: no result line")
        return 0
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
