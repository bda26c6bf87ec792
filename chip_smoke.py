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
               ``python -m dynamo_tpu_torch.cli.run run in=http out=torch
               --warmup`` (a worker and a frontend over the memory control
               plane in one process) and check that greedy chat content is
               the token-counter continuation its crafted weights produce.
  4. serve   — serve the Llama-3-8B geometry (16 of its 32 layers, random
               weights from a seed, on the card) over HTTP in this process with the default engine
               (decode overlapped, every decode window a CUDA graph replay):
               four concurrent chats and one ~1500-token prompt, so that
               unified steps with prefill and decode-only steps both run; the
               kernels' launch counters are zeroed just before and read just
               after (a graph replay adds the launches its capture held).
  5. dist    — the distributed path: the port's control-plane server in
               this process, two worker processes (``python -m
               dynamo_tpu_torch.cli.run run in=none out=torch --warmup
               --control-plane ...``) at phase serve's geometry and seed,
               the frontends (``serve_frontend``) in this process.  Phase
               serve's traffic through one worker over TCP; each worker's
               greedy ids for one prompt by direct routing (equal, and
               equal to phase serve's engine's); 12 four-turn sessions
               (768-token system prefixes, 64 user tokens a turn, 24
               output tokens) through a KV-routed frontend, then a random
               one, the caches flushed (``POST /clear_kv_blocks``) before
               each: follow-up TTFT, the share of follow-ups on their
               session's previous worker, each worker's prefix hits and
               cached tokens (KV routing's must exceed random's); no graph
               captured after warmup in either worker, both replaying
               unified and decode graphs, the worker's kernels launched;
               the native host codecs in use (the KV frontend's index a
               NativeRadixTree, every data-plane stream of this process
               and of each worker read by NativeFrameDecoder, none by the
               Python codec).
  6. fleet   — the routed-fleet bench: the headline's kv_routing rung (a
               mocker fleet, 12 sessions x 4 turns, the median of three
               kv/random repeats), then ``routed_fleet.compare_policies``
               on two TorchLlmEngine workers at the Llama-3-8B geometry
               (full width, 8 of its 32 layers) in this process, on one card (one set of random weights from a
               seed, each engine warmed before its replay), 8 sessions x 3
               turns of ``generate_sessions`` in real time under random and
               KV routing: TTFT p50 / p99, follow-up TTFT, prefix hits,
               every turn streamed in full, rows 1-2 launched on the card in
               each replay (counters zeroed after the warmups), no graph
               captured after warmup, and each engine's idle share (its
               loop's step time against the replay's wall: the two engines
               share the card's SMs, so the kv/random ratio reads
               contention as well as routing).
  7. prefetch — demand against predictive paging, the hints on the real
               path (FrontendHinter → PrefetchForwarder → PrefetchListener →
               the engine's pager → row 7): one worker at the Llama-3-8B
               geometry (random weights from seed 0, phase serve's lanes and
               max length, G1 256 blocks of 16, G2 1536 blocks, warmed)
               behind a KV-routed frontend over a memory control plane in
               this process; 12 sessions x 4 turns (each its own 1024-token
               context, 64 user tokens a turn, 32 output tokens, 3 s think
               time, sessions 0.5 s apart; text completions) once with
               DYN_PREFETCH=0 and once with it on, a fresh worker each;
               returning-turn TTFT, restores, the pager's hits, misses,
               restores, pins, the overlap drains, ITL and tok/s, rows 6-7's
               device ms a call; a probe prefix computed alone, pushed out of
               G1, restored by a hint (pager) or on demand, must give the
               same greedy ids; the pager must hit, restore through row 7
               and drain no more than demand paging; no graph captured after
               warmup; then /metrics, /slo, an n = 2 request and a burst
               through a frontend whose admission gate is below it (429 and
               503 with Retry-After).
  8. guided  — guided JSON decoding at the Llama-3-8B geometry (random bf16
               weights from a seed, all layers; the table built from the
               tiny model's tokenizer): the launch path installs the table;
               an engine warmed by ``warmup()`` before its table is
               installed serves eight lanes at once (two guided greedy, two
               guided seeded, four unguided, 64 tokens each): every guided
               stream a JSON prefix (a closed one parses), the guided
               counters right, the decode graph replayed with no capture
               after warmup and row 2 launched; the unguided lanes alone
               give the same ids with and without a table; a decode window
               of guided lanes in several modes by replay equals the eager
               step (greedy and seeded), each token admissible; the table's
               build time, and ITL p50 with and without guided lanes.
  9. disagg  — disaggregated prefill/decode at the Llama-3-8B geometry (one
               set of random bf16 weights): eight prompts of 2048 tokens,
               32 out (half greedy, half seeded), every prefill remote; the
               pair from ``launch_disagg_decode_worker`` /
               ``launch_prefill_workers`` over the memory control plane,
               the same-process route streamed (512-token chunks) and
               single-shot, then the TCP route with the prefill worker in a
               second process on the card: each route's streams
               byte-identical to one engine's, rows 6-7 launched a cache
               leaf an extract and an inject (no plain version), two
               topology cards published and the prober's bandwidth in
               ``dynctl topology``'s table; TTFT p50 local and remote, GB/s
               a route, the headline's kv_xfer rung, rows 6-7's device ms a
               call at the path's shapes, the streamed share hidden.
 10. mla     — the same over the DeepSeek-V2-Lite geometry (the published
               config.json at 14 of its 27 layers, random bf16 weights from
               a seed):
               the MLA ragged and decode kernels, and the MoE layers; every
               MLA decode (and, in phase spec, window) launch must take the
               split table walk.
 11. families — the other model families at their published widths, each
               served as in phase serve (over HTTP in process, the default
               engine, max length 2048, random weights from seed 0, the
               tiny model's tokenizer, four chats and the long prompt, the
               counters zeroed just before and read just after):
               Mixtral-8x7B (8 of 32 layers) and Qwen3-30B-A3B (8 of 48
               layers) on the MoE FFN with rows 1-2 at head dim 128 (the
               tensor-core walks), Gemma-2B (MQA, head dim 256) and
               Phi-3-mini-4k (MHA, head dim 96, a 2047-position window)
               with rows 1-2 on the CUDA-core loops, Gemma-2 2B and Gemma-3
               4B text on the split step with plain attention (the
               reference's attention there is XLA: no kernel) and no
               attention kernel launched; every request a 200 with its
               tokens, a greedy probe equal with overlap on and off, and a
               speculative Mixtral engine (spec_tokens 4) whose greedy ids
               equal a plain engine's, row 2 launched at W = 5 inside the
               verify graph; one ``smoke_families`` line a model.  Phase
               kernels holds rows 1-2 at head dims 96 and 256 (Phi-3's and
               Gemma-2B's heads, a window, W = 5, an fp8 cache).
 12. overlap — both configurations in process, at phases serve's and
               mla's depths (16 and 14 layers): the default
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
               bucket, warmup seconds and the graphs' pool; then a window
               the unified step skips (two admissions against one seed
               slot): its split prefill key captured once at first use,
               replayed the next time, the capture's ms and the pool.
 13. spec    — speculative decoding (prompt-lookup n-gram drafts, W = 5):
               tests/data/tiny-chat-model with and without it (equal greedy
               streams, drafts accepted), then the Llama-3-8B geometry and
               the DeepSeek-V2-Lite config at 8 of 32 and 14 of 27
               layers (``SPEC_CONFIGS``), over HTTP with chats
               that repeat a phrase plus the long prompt, warmed by
               ``warmup()`` (every split prefill key of the 4096-token
               engine and the verify window, captured): every prefill a
               split prefill graph replay, every verify window a verify
               graph replay through the GQA window kernel at W=5 and the
               MLA window kernel (launched a layer a replay; no plain
               attention on the card), as many prefill graph replays as
               split prefills, no capture after warmup; tok/s,
               TTFT, ITL, each split prefill and verify call's wall ms and
               (traced, the traffic again) device ms; verify replays
               (greedy and sampled) and prefill replays at windows of 32
               and 512 tokens over a resident prefix and a whole 2048-token
               prompt bitwise equal to the same steps run eagerly on the
               same buffers (tokens, logprobs, acceptance counts, K/V rows,
               counts, the forward's logits); the verify window's and a
               512-token chunk's ms by replay and eagerly, and the window
               kernels' device ms a layer inside the graph beside their
               bound.
 14. longctx — a speculative server of the Llama-3-8B geometry at its own
               context length (8192 positions, default warmup),
               all layers: warmup's captures, seconds and pool, a
               7000-token prompt and three short ones served with no
               capture after warmup, and the warmup budget's estimate
               (``PrefillGraph.key_bytes``) held above two keys' measured
               eager peaks.
 15. offload — the engine's KV offload tiers at the Llama-3-8B geometry,
               then at the DeepSeek-V2-Lite config (all layers, random
               weights): 256 device blocks over a 192-block
               host tier (G2) and a 128-block disk tier (G3).  A prompt A is
               served, pushed down the tiers by churn and served again, once
               restored from G2 and once through G3: the same tokens as a
               device prefix hit, A's blocks landed bitwise equal to their
               snapshot, every evicted block in a tier, all block copies
               through the gather/scatter kernels.
 16. kvbm    — the KV block manager: a 512-block device pool of Llama-3-8B
               blocks (2 MiB, bf16) over host, disk and a localhost block
               store (G4); three sequences of 256 blocks stored, cascaded,
               and read back bitwise through G1 after onboarding from G2, G3
               and G4, with no failed transfer.
 17. quant   — the quantized paths: rows 1-5 on fp8 e4m3fn and e5m2 caches
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
               n-gram speculation (the verify kernels on fp8) at phase
               spec's geometry.
 18. bench   — the headline benchmark (``python -m
               dynamo_tpu_torch.bench.headline``) through its own
               functions (ISL 3000 and OSL 150, 16 lanes, the Llama-3-8B
               geometry, all 32 layers): configuration A (int8 weights, fp8
               cache, decode_steps 8, 512-token chunks on the split prefill
               graphs, warmed at the ISL's keys; 8 requests) and C (bf16,
               decode_steps 1, every chunk in a unified graph; 8
               requests); each split prefill call's wall ms; each rung
               must stream requests x OSL tokens and the cache hold no NaN,
               no graph may be captured after warmup, MFU must lie in (0, 1], the prefix cache must
               cut TTFT, and the path's kernels must run on the card.
 19. mm      — multimodal serving, the embedding engine and GGUF weights:
               LLaVA-1.5-7B (its published config.json inline: the
               ViT-L/14-336 tower, 576 patches, and the Vicuna-7B text
               geometry, random bf16 weights from seed 0, 1024 blocks of
               16, 8 lanes, max length 4096) through the multimodal
               frontend
               (``dynamo_tpu_torch/examples/multimodal/pipeline.start_http``): four
               image chats of data: PNG URLs (480x640, about 40 text tokens
               and 64 out, two greedy, two seeded), a video of 8 frames at
               temporal pool 2 (2304 patch positions) and two text-only
               chats sent once the image lanes decode: every mm prefill a
               graph replay, rows 1-2 launched on the path; each mm prefill
               key by replay bitwise its eager step (greedy and seeded); a
               repeated image caching and publishing nothing; the same four
               images through ``RemoteEncoder`` in a second process on this
               process's control plane, embeddings and streams bitwise the
               in-process ones; Gemma-3-4B text at 4 layers taking an image
               through its embeddings prefill (no attention kernel);
               ``TorchEmbeddingEngine`` at the Llama-3-8B geometry through
               ``/v1/embeddings`` (16 inputs, the four input shapes; graph
               replay bitwise the eager trunk, unit norms); F16 and Q8_0
               GGUF files of the Llama-3.2-1B geometry written, loaded onto
               the card bitwise the host's dequant, and served.  One
               ``smoke_mm`` line: ViT encode ms, TTFT and ITL of image,
               video and text lanes, mm prefill replay ms, embedding ms at
               512 tokens, GGUF load s a file.
 20. tp      — tensor and expert parallelism: the Llama-3-8B geometry (8
               of its 32 layers) at
               tp = 2 and the published DeepSeek-V2-Lite config (14 of its
               27 layers) at tp = 2 x ep = 2, each a mesh engine (rank 0 in
               this process, its shard workers child processes) whose ranks share
               the one card over gloo, named (NCCL refuses two ranks on one
               GPU; the collectives stage through host memory, so no time
               here is NVLink's), against a tp = 1 engine on the same
               seed's weights on the same card: the first step's bf16
               logits within TP_LOGITS_ATOL, four greedy streams of 16
               tokens that may part only where tp = 1's top-2 margin is
               within that bound, rows 2 and 4 launched on every rank at
               the head shard (no plain call), TTFT and ITL of both.  One
               ``smoke_tp`` line.  Phase kernels holds rows 2 and 4 at the
               shard shapes (16 heads over 4 kv heads; 8 MLA heads).  Its
               two engine pairs serve phase meshfeat's cases (c)-(e) too,
               so selecting meshfeat runs this phase.
 21. pp      — pipeline and sequence parallelism on meshes sharing the card
               over gloo, each against one card (``phase_pp``).  One
               ``smoke_pp`` line.
 22. meshfeat — speculation, the offload tiers, disaggregation, guided JSON
               and multimodal requests on tp and ep meshes sharing the card
               over gloo, each against one card on the same seed's weights
               (``phase_meshfeat``): Llama-3-8B (16 of 32 layers) at tp 2 with
               n-gram speculation and G1 128 blocks over G2 512 (six
               sessions of two 1024-token turns, each restored block's shard
               on every rank bitwise what it held at eviction); on phase
               tp's Llama pair four 2048-token prompts disaggregated tp 2 ->
               one card and one card -> tp 2 over the same-process route,
               and four json_object requests at tp 2, each closed and
               parsed; on phase tp's DeepSeek-V2-Lite pair (tp 2 x ep 2)
               speculation; LLaVA-1.5-7B at tp 2 with two images.  The first
               logits within phase tp's bounds, streams parting only within
               one card's top-2 margin, rows 2 (W = 5) and 5 and rows 6-7 on
               every rank with no plain call.  One ``smoke_meshfeat`` line.
               Phase kernels holds rows 2 and 5 at the shard's verify shapes
               and rows 6-7 at a tp 2 rank's shard of the Llama leaf.
 23. autotune — the kernel autotuner at phase serve's engine
               (``phase_autotune``): row 1's layouts timed on the card, the
               winner's width bitwise the full width, an engine on the
               tuned table serving phase serve's traffic against the
               default one.  One ``smoke_autotune`` line.
 24. plane   — the agg example graph under the SDK's supervisor on a
               control-plane server, its worker on the allocator's card,
               scaled 1 -> 2 -> 1 by the planner under a burst of eight
               request streams, then phase bench's lines through the perf
               gate (``phase_plane``).  One ``smoke_plane`` line.
 25. soak    — the scenario soak on TorchLlmEngine workers: the shipped
               ``torch_soak`` spec (two decode workers under KV routing at
               phase plane's geometry) and worker_kill's kill_mid_stream on
               the same fleet, through ``run_scenario``: no request fails,
               every stream has its tokens, the kill resumes on the peer,
               dyn_top sees two workers then one, check_metrics finds every
               worker family, rows 1-2 launch, the card's memory returns
               after teardown (``phase_soak``).  One ``smoke_soak`` line.
Then one JSON line of kernel numbers, the card's name and power limit, and
the result line ``{"ok": true, "device": {...}}``.

``--phases`` runs a subset (for iterating on one phase); the result line is
printed only when every phase ran and passed.  ``--phases build,split``
(not part of the default run) measures the split step: phase spec's
traffic on both large configurations (``spec_traffic``) and the headline's
A and B, each split prefill and verify call clocked; it runs on a tree
without the split step's graphs too.  ``--phases build,sweep``
times rows 1-5 under other grid aims of their split planners, rows 4-5
under other tiles a CTA and in one chunk at growing contexts, and rows 6-7
under other piece sizes and CTAs an SM, and their launch cost at each
by-value ids capacity (not part of the default run).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import random
import shutil
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "tiny", "serve", "dist", "fleet", "prefetch", "guided", "disagg",
          "mla", "families", "overlap", "spec", "longctx", "offload", "kvbm", "quant", "bench",
          "mm", "tp", "pp", "meshfeat", "autotune", "plane", "soak")
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

    total = profiled_ms(torch, fn, iters, ())[0]
    return total if total > 0 else "not measured"


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
    bound = gqa_bound(lens, w, h, kvh, d, length, k.element_size(),
                      torch.finfo(dtype).bits // 8, tables.numel() * 4 + ctx.numel() * 4, window)
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
        **bound,
    )
    return res


def gqa_bound(lens, w, h, kvh, d, length, cache_elem, elem, meta_bytes, window=None) -> dict:
    """Bytes: the K/V rows of the positions any query of a sequence sees
    (``window_positions``, ``cache_elem`` bytes an element), the queries and
    the output (``elem``), the metadata; flops: scores and context, 4 D a
    (query head, visible position)."""
    per_query, union = window_positions(lens, w, length, window)
    bytes_ = (sum(union) * kvh * d * 2 * cache_elem + 2 * len(lens) * w * h * d * elem
              + meta_bytes)
    flops = 4 * per_query * h * d
    t_bytes, t_flops = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return {"bytes": bytes_, "flops": flops, "bound_ms": max(t_bytes, t_flops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


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
    if len(plan.combines) and route == "tensor-core walk":
        # a planted fault: the first split block's combine leaves out its
        # last partial (the constructor would refuse such a plan; the
        # CUDA-core loop reads no plan)
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
    # a tp = 2 rank's shard of the Llama-3-8B leaf (4 of its 8 kv heads):
    # phase meshfeat's offloads and restores on every rank
    "copy_llama_leaf_tp2": dict(shape=(32, 1024, 16, 4, 128), n=93, axis=1),
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
    # LLaVA-1.5-7B's text heads, phase mm's image lanes: MHA (one query row
    # a kv head) on the tensor-core walks, at the contexts of decode_b32 and
    # the spans of ragged_mix
    cases["decode_mha_b32"] = decode_case(torch, lens=lens, seed=33, **MHA_128)
    check_case("decode_b32 MHA h 32 kvh 32 d 128", cases["decode_mha_b32"], BF16_ATOL)
    cases["ragged_mix_mha"] = ragged_case(torch, spans=mix, t_pad=352, seed=34, **MHA_128)
    check_ragged("ragged mix MHA h 32 kvh 32 d 128", cases["ragged_mix_mha"])
    # a tp = 2 rank's head shard of Llama-3-8B (phase tp): 16 of its 32
    # query heads over 4 of its 8 kv heads, at decode_b32's contexts
    cases["decode_tp2_b32"] = decode_case(torch, lens=lens, seed=35, h=16, kvh=4)
    check_case("decode_b32 tp=2 shard h 16 kvh 4 d 128", cases["decode_tp2_b32"], BF16_ATOL)
    # a pp = 2 x tp = 2 stage's microbatch (phase pp): 4 of the 8 lanes,
    # the tp rank's 16 query heads over 4 kv heads, at decode_b32's contexts
    cases["decode_pp2tp2_mb4"] = decode_case(torch, lens=lens[:4], seed=36, h=16, kvh=4)
    check_case("decode pp=2 x tp=2 microbatch b 4 h 16 kvh 4 d 128", cases["decode_pp2tp2_mb4"],
               BF16_ATOL)
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
    other = other_head_dim_cases(torch, mix)
    cases.update(other)
    from dynamo_tpu_torch.ops.kernels import ragged_attention as rk

    ragged_bf16 = {k: cases[k] for k in ("ragged_mix", "ragged_decode8_one_block",
                                         "ragged_prefill_span")}
    ragged_bf16.update(window_256=win_r, head_dim_64=d64_r, rows_56=rows56_r,
                       no_split=no_split, mha_128=cases["ragged_mix_mha"])
    if hasattr(rk, "split_launches"):  # a parent checkout has the CUDA-core loop only
        routes = {**{k: r["route"] for k, r in ragged_bf16.items()}, "fp32_d16": small_r["route"],
                  **{k: r["route"] for k, r in other.items() if k.startswith("ragged")}}
        want = {k: "CUDA-core loop" if k == "fp32_d16" or k in other else "tensor-core walk"
                for k in routes}
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
    # a tp = 2 rank's 8 of DeepSeek-V2-Lite's 16 heads (phase tp): 8 query
    # rows a lane, half a 16-row tile, so the decode takes the CUDA-core loop
    cases["mla_decode_tp2_b32"] = mla_decode_case(torch, lens=lens, seed=45, h=8)
    check_case("mla_decode_b32 tp=2 shard 8 heads", cases["mla_decode_tp2_b32"], MLA_ATOL)
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
    # phase meshfeat's verify windows on a tp = 2 rank's head shard: row 2 at
    # W = 5 on Llama-3-8B's 16 of 32 heads over 4 of 8 kv heads, row 5 on 8 of
    # DeepSeek-V2-Lite's 16 heads (half a 16-row tile a query: the CUDA-core
    # loop), eight lanes on 2048-position tables, one window past its table
    vr = random.Random(522)  # its own stream: the other cases keep their contexts
    shard_lens = [vr.randint(5, 2048) for _ in range(8)]
    shard_lens[0], shard_lens[1], shard_lens[2] = 2047, 2048, 2050
    cases["verify_tp2_w5"] = decode_case(torch, lens=shard_lens, w=5, seed=37, h=16, kvh=4,
                                         max_blocks=128)
    check_case("paged window W=5 b8 tp=2 shard h 16 kvh 4", cases["verify_tp2_w5"], BF16_ATOL)
    mla_shard_lens = list(shard_lens)
    mla_shard_lens[3] = 0  # an idle lane
    cases["mla_verify_tp2"] = mla_decode_case(torch, lens=mla_shard_lens, w=5, h=8, seed=47,
                                              max_blocks=128)
    check_case("mla window W=5 b8 tp=2 shard 8 heads", cases["mla_verify_tp2"], MLA_ATOL)
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
        **{f"{row}_{tag}": max(r["max_abs_err"] for k, r in other.items()
                               if k.startswith(row) and tag in k)
           for row in ("ragged", "paged") for tag in ("d96", "d256")},
        **{row: max(cases[c][f"{row}_max_abs_err"] for c in COPY_CASES)
           for row in ("gather", "scatter")},
        "paged_mha": cases["decode_mha_b32"]["max_abs_err"],
        "ragged_mha": cases["ragged_mix_mha"]["max_abs_err"],
        "paged_tp2": cases["decode_tp2_b32"]["max_abs_err"],
        "paged_pp": cases["decode_pp2tp2_mb4"]["max_abs_err"],
        "mla_decode_tp2": cases["mla_decode_tp2_b32"]["max_abs_err"],
        "paged_verify_tp2": cases["verify_tp2_w5"]["max_abs_err"],
        "mla_verify_tp2": cases["mla_verify_tp2"]["max_abs_err"],
        **{f"{row}_tp2": cases["copy_llama_leaf_tp2"][f"{row}_max_abs_err"]
           for row in ("gather", "scatter")},
    }
    return {"cases": cases, "errs": errs}


# LLaVA-1.5-7B's text attention (phase mm): 32 heads over as many kv heads
MHA_128 = dict(h=32, kvh=32, d=128)


# rows 1 and 2 at the other families' head dims, on the CUDA-core loops:
# Phi-3-mini (32 heads, as many kv heads, head dim 96) and Gemma-2B (8 heads
# over one kv head, head dim 256: 64 query rows a token block of 8, and
# 8 W a sequence)
OTHER_HEADS = {"d96": dict(h=32, kvh=32, d=96), "d256": dict(h=8, kvh=1, d=256)}


def other_head_dim_cases(torch, mix) -> dict:
    """Rows 1 and 2 at head dims 96 and 256 (``OTHER_HEADS``): decode at 8
    lanes, the verify window at W = 5, the ragged mix of phase kernels,
    Gemma-2B's 1504-token prompt as one span, a sliding window of 256 and
    an fp8 e4m3fn cache (which must give the bits of the same kernel on the
    cache's bf16 values), each held against its plain version at
    BF16_ATOL (row 1 also at RAGGED_REL) and launched twice for the same
    bits; the timed ones beside their bound and one SDPA call."""
    rng = random.Random(96256)  # its own stream: the other cases keep their contexts
    lens = [rng.randint(1, 2048) for _ in range(8)]
    lens[0], lens[1] = 2047, 2048
    w5 = [rng.randint(5, 2048) for _ in range(8)]
    w5[0], w5[1], w5[2] = 2047, 2048, 2050
    fp8 = torch.float8_e4m3fn
    out = {}
    for tag, geo in OTHER_HEADS.items():
        runs = {
            f"paged_decode_{tag}_b8": lambda: decode_case(torch, lens=lens, seed=80, **geo),
            f"paged_verify_w5_{tag}_b8": lambda: decode_case(
                torch, lens=w5, w=5, seed=81, max_blocks=128, **geo),
            f"paged_window256_{tag}": lambda: decode_case(
                torch, lens=[2047, 700, 1500, 33], window=256, seed=82, timed=False, **geo),
            f"paged_fp8_{tag}": lambda: decode_case(
                torch, lens=lens, seed=83, timed=False, cache_dtype=fp8, **geo),
            f"ragged_mix_{tag}": lambda: ragged_case(torch, spans=mix, t_pad=352, **geo),
            f"ragged_window256_{tag}": lambda: ragged_case(
                torch, spans=mix, t_pad=352, window=256, timed=False, **geo),
            f"ragged_fp8_{tag}": lambda: ragged_case(
                torch, spans=mix, t_pad=352, timed=False, cache_dtype=fp8, **geo),
        }
        if tag == "d256":  # Gemma-2B's long prompt, one span of 188 token blocks
            runs[f"ragged_prefill_span_{tag}"] = lambda: ragged_case(
                torch, spans=[(0, 0, 1504)], library="causal", **geo)
        for name, run in runs.items():
            res = out[name] = run()
            label = f"{name} (h {geo['h']}, kvh {geo['kvh']}, d {geo['d']})"
            if name.startswith("ragged"):
                check_ragged(label, res)
            else:
                check_case(label, res, BF16_ATOL)
            if not res.get("equals_wide_cache", True):
                raise AssertionError(f"{name}: the kernel on the fp8 cache differs from "
                                     f"itself on the cache's bf16 values")
            torch.cuda.empty_cache()
    print(json.dumps({"smoke_other_head_dims": {
        name: {key: r.get(key) for key in (
            "route", "max_abs_err", "max_rel_err", "deterministic", "equals_wide_cache",
            "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        for name, r in out.items()}}), flush=True)
    return out


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
             "--host", "127.0.0.1", "--warmup"],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=log_file,
        )
    try:
        deadline = time.time() + 300
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"server exited: {server_log.read_text()[-2000:]}")
            try:  # the frontend answers once the worker's model registered
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
                    if json.loads(r.read())["models"]:
                        break
            except OSError:
                pass
            if time.time() > deadline:
                raise TimeoutError("the tiny model never registered")
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


LONG_PROMPT = "".join(chr(ord("a") + i % 26) for i in range(1640))
# the served engines' geometry (``overrides`` may change any of it)
SERVE_ENGINE = dict(num_blocks=1024, max_batch_size=8, max_model_len=4096, seed=0)
# phases serve and dist serve the Llama-3-8B geometry, and phase mla the
# DeepSeek-V2-Lite config, at half their depth (16 of 32 and 14 of 27
# layers), so that the whole smoke keeps its time with phase meshfeat
SERVE_LLAMA = dict(LLAMA3_8B, num_hidden_layers=16)
SERVE_MLA = dict(DEEPSEEK_V2_LITE, num_hidden_layers=14)


def pctile(xs, q):
    """The headline bench's percentile: the sample at ``int(n * q)``, so p99
    of fewer than 100 samples is the maximum."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else None


@contextlib.contextmanager
def split_step_clock(engine_cls):
    """Wrap every engine's split prefill and verify steps (``_run_prefill``,
    ``_run_verify_decode``): each call's wall ms (a call ends in its
    readback, so its device work is done), and a range
    ``smoke.split_prefill`` / ``smoke.verify_window`` in a running trace.
    Yields {"split_prefill": [ms, ...], "verify_window": [...]}."""
    from dynamo_tpu_torch.utils import profiling

    walls = {"split_prefill": [], "verify_window": []}
    saved = {}
    for name, attr in (("split_prefill", "_run_prefill"), ("verify_window", "_run_verify_decode")):
        real = saved[attr] = getattr(engine_cls, attr)

        def timed(self, *args, _real=real, _name=name, **kw):
            t0 = time.perf_counter()
            with profiling.annotate(f"smoke.{_name}"):
                out = _real(self, *args, **kw)
            walls[_name].append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(engine_cls, attr, timed)
    try:
        yield walls
    finally:
        for attr, real in saved.items():
            setattr(engine_cls, attr, real)


def clock_summary(walls: dict) -> dict:
    return {f"{name}_wall_ms": {"calls": len(ms), "mean": sum(ms) / len(ms) if ms else None,
                                "p50": pctile(ms, 0.5), "p99": pctile(ms, 0.99)}
            for name, ms in walls.items()}


async def traced_pass(torch, session, port: int, model: str, short_prompts, trace_dir: str) -> dict:
    """The counted traffic again, its texts marked (no prefix of the first
    pass but the chat template's is hit), under a trace of every thread:
    the device ms of the kernels launched inside each ``smoke.*`` range of
    ``split_step_clock`` (a graph replay's kernels belong to its launch),
    and the device's idle share over the pass."""
    from dynamo_tpu_torch.bench.trace_summary import load_events, summarize
    from dynamo_tpu_torch.utils import profiling

    with profiling.trace(trace_dir):
        with profiling.annotate("smoke.traced"):
            shorts = [asyncio.ensure_future(stream_chat(session, port, model, f"traced: {t}", 64))
                      for t in short_prompts]
            await asyncio.sleep(0.5)
            long = asyncio.ensure_future(stream_chat(session, port, model, LONG_PROMPT[7:], 24))
            await asyncio.gather(*shorts, long)
            torch.cuda.synchronize()
    summary = summarize(load_events(trace_dir), "smoke.traced",
                        annotations=("smoke.split_prefill", "smoke.verify_window"))
    return {k: summary[k] for k in ("window_ms", "device_busy_ms", "device_idle_share",
                                    "annotations")}


async def serve_traffic(session, port: int, model: str, short_prompts) -> tuple[list, float]:
    """The counted traffic: the short chats (64 tokens each), and the long
    prompt (24 tokens) landing while they decode; (results, wall s)."""
    t0 = time.perf_counter()
    shorts = [asyncio.ensure_future(stream_chat(session, port, model, text, 64))
              for text in short_prompts]
    await asyncio.sleep(0.5)  # the long prompt lands while they decode
    long = asyncio.ensure_future(stream_chat(session, port, model, LONG_PROMPT, 24))
    results = await asyncio.gather(*shorts, long)
    return results, time.perf_counter() - t0


async def lone_chats(session, port: int, model: str, n: int = 5) -> dict:
    """``n`` chats of 32 tokens one after another, each alone on the
    engine: TTFT and ITL without queueing behind other requests."""
    results = [await stream_chat(session, port, model, f"alone {i}: tell me", 32)
               for i in range(n)]
    ttft = [r["stamps"][0] - r["t0"] for r in results]
    itl = [b - a for r in results for a, b in zip(r["stamps"], r["stamps"][1:])]
    return {"ttft_ms": [x * 1e3 for x in ttft], "ttft_ms_p50": pctile(ttft, 0.5) * 1e3,
            "itl_ms_p50": pctile(itl, 0.5) * 1e3, "itl_ms_p99": pctile(itl, 0.99) * 1e3}


async def serve_model(model_dir: Path, model: str, *, overrides=None,
                      short_prompts=None, profile=True, inspect=None, clock=None,
                      traced: str | None = None, probe: list[int] | None = None) -> dict:
    """Serve ``model_dir`` over HTTP in process and drive the counted
    traffic.  ``clock`` (``split_step_clock``'s lists) is emptied just before
    the counted run and read just after; ``traced`` (a directory) runs the
    traffic once more under a trace (``traced_pass``); ``probe`` (token ids)
    is then sent alone to the engine, its greedy ids returned, and
    ``lone_chats`` run."""
    import aiohttp
    import torch

    from dynamo_tpu_torch.serve import serve_http

    t_load = time.perf_counter()
    handle = await serve_http(
        model_dir, model_name=model, host="127.0.0.1", port=0,
        **{**SERVE_ENGINE, **(overrides or {})},
    )
    load_s = time.perf_counter() - t_load
    port = handle.service.port
    short_prompts = short_prompts or [f"request {i}: tell me" for i in range(4)]
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=900)) as s:
            # warm the path once before the counted run
            await stream_chat(s, port, model, "warm up", 4)
            stats0 = handle.engine.stats()
            for ms in (clock or {}).values():
                ms.clear()
            zero_counters()
            results, wall = await serve_traffic(s, port, model, short_prompts)
            counts = read_counters()
            stats = handle.engine.stats()
            walls = clock_summary(clock) if clock is not None else None
            probe_ids = lone = None
            if probe is not None:  # alone on the engine, every lane free
                await settled(handle.engine)
                probe_ids = await generate_tokens(handle.engine, probe, PROBE_TOKENS)
                await settled(handle.engine)
                lone = await lone_chats(s, port, model)
            trace = (await traced_pass(torch, s, port, model, short_prompts, traced)
                     if traced is not None else None)
        # the counted run's share of the cumulative engine counters
        run = {k: stats[k] - stats0[k] for k in stats
               if k.startswith(("spec_", "decode_windows_", "decode_graph_replays",
                                "prefill_graph_replays", "verify_graph_replays"))
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
            "inspect": checked, "walls": walls, "trace": trace, "probe_ids": probe_ids,
            "lone": lone}


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


def traffic_e2e(tag: str, results: list[dict], wall_s: float) -> dict:
    """Check that every streamed request of a counted run was a 200 with
    the completion tokens it asked for; its TTFT, ITL and tok/s."""
    ttfts, itls, toks = [], [], 0
    for r in results:
        usage = r["usage"] or {}
        log(f"[{tag}] status={r['status']} finish={r['finish']} usage={usage}")
        if r["status"] != 200:
            raise AssertionError(f"request failed with {r['status']}")
        if usage.get("completion_tokens") != r["max_tokens"] or r["finish"] != "length":
            raise AssertionError(f"completion_tokens {usage} / finish {r['finish']} "
                                 f"!= {r['max_tokens']} / length")
        toks += usage["completion_tokens"]
        ttfts.append(r["stamps"][0] - r["t0"])
        itls.extend(b - a for a, b in zip(r["stamps"], r["stamps"][1:]))
    return {
        "ttft_ms_mean": sum(ttfts) / len(ttfts) * 1e3,
        "ttft_ms_max": max(ttfts) * 1e3,
        "ttft_ms_p50": pctile(ttfts, 0.5) * 1e3, "ttft_ms_p99": pctile(ttfts, 0.99) * 1e3,
        "itl_ms_mean": sum(itls) / len(itls) * 1e3,
        "itl_ms_p50": pctile(itls, 0.5) * 1e3, "itl_ms_p99": pctile(itls, 0.99) * 1e3,
        "output_tok_s": toks / wall_s, "requests": len(results), "wall_s": wall_s,
    }


def phase_serve(card: str, tag: str, model: str, config: dict, path, **serve_kw) -> dict:
    """Serve ``config`` (random weights from seed 0, the tiny model's
    tokenizer) over HTTP in this process, drive the counted traffic, check
    it and that every counter of ``path`` launched, print its e2e (and
    profile) lines."""
    out = asyncio.run(serve_model(model_dir(model, config), model, **serve_kw))
    e2e = traffic_e2e(tag, out["results"], out["wall_s"])
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
    e2e.update(load_s=out["load_s"], model=model, card=card, lone=out["lone"],
               flight_buffer_bytes=out["stats"]["flight_buffer_bytes"],
               flight_records_total=out["stats"]["flight_records_total"])
    if out["profile"] is not None:
        print(json.dumps({"smoke_profile": {**out["profile"], "model": model, "card": card}}),
              flush=True)
    print(json.dumps({"smoke_e2e": e2e}), flush=True)
    return {"counts": counts, "launched": launched, "e2e": e2e, "run": out["run"],
            "stats": out["stats"], "profile": out["profile"], "inspect": out["inspect"],
            "walls": out["walls"], "trace": out["trace"], "probe_ids": out["probe_ids"]}


# ---------------------------------------------------------------------------
# phase dist: the distributed serving path (control plane, workers, router)
# ---------------------------------------------------------------------------

# the greedy probe sent alone to phase serve's engine and to each worker
PROBE_PROMPT = list(range(1000, 1100))
PROBE_TOKENS = 16
# multi-turn sessions for KV-aware against random routing (the reference's
# bench.py _measure_kv_routing traffic): sessions start at the generator's
# rate (3 a second), their think time compressed DIST_THINK_SPEEDUP x
# (12 sessions, 24 before phases autotune and plane joined: the whole smoke
# keeps its time)
DIST_SESSIONS = dict(num_sessions=12, turns_per_session=4, system_tokens=768,
                     user_tokens_per_turn=64, osl=24, seed=0)
DIST_THINK_SPEEDUP = 10.0
DIST_LAUNCH_S = 600


def dist_worker_bytes(config: dict, engine: dict) -> int:
    """What one Llama-geometry worker holds on the card: bf16 weights, the
    paged cache, the unified graphs' pool (1.7 GB at Llama-3-8B on an H100) and
    a CUDA context with its workspaces (about 1 GB)."""
    h, layers, inter = config["hidden_size"], config["num_hidden_layers"], config["intermediate_size"]
    heads, kv, d = config["num_attention_heads"], config["num_key_value_heads"], config["head_dim"]
    per_layer = h * (heads * d) * 2 + h * (kv * d) * 2 + 3 * h * inter + 2 * h
    weights = 2 * (layers * per_layer + 2 * config["vocab_size"] * h + h)
    cache = 2 * 2 * layers * engine["num_blocks"] * 16 * kv * d
    return weights + cache + int(1.7e9) + int(1e9)


async def worker_stats(runtime, instance) -> dict:
    """A worker's ingress stats and its engine's ``stats()`` (under
    ``custom``), scraped over the bus."""
    from dynamo_tpu_torch.runtime.component import stats_subject

    raw = await runtime.plane.bus.request(stats_subject(instance.subject), b"", timeout=60)
    return json.loads(raw)


async def stream_completion(session, port: int, model: str, prompt: list[int],
                            max_tokens: int) -> dict:
    """A token-id completion, streamed; its status, usage and arrival
    times, as ``stream_chat``."""
    body = {"model": model, "prompt": prompt, "max_tokens": max_tokens, "temperature": 0,
            "stream": True, "stream_options": {"include_usage": True},
            "ext": {"ignore_eos": True}}
    t0 = time.perf_counter()
    stamps, usage, finish = [], None, None
    async with session.post(f"http://127.0.0.1:{port}/v1/completions", json=body) as r:
        status = r.status
        async for raw in r.content:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[6:])
            if "error" in chunk:
                raise RuntimeError(chunk["error"])
            usage = chunk.get("usage") or usage
            for choice in chunk.get("choices", []):
                stamps.append(time.perf_counter())
                finish = choice.get("finish_reason") or finish
    return {"status": status, "t0": t0, "stamps": stamps, "usage": usage,
            "finish": finish, "max_tokens": max_tokens}


async def run_sessions(session, port: int, model: str, sessions, served: list) -> dict:
    """Replay the multi-turn sessions through one frontend.  A turn's prompt
    is the session's history: its system tokens, every user turn, and after
    each turn a stand-in for the assistant's reply (its ``osl`` ids, drawn
    from the session's seed; the HTTP API returns text, and random weights'
    text does not round-trip to ids).  ``served`` (filled by the dispatch
    spy) says which worker took each request."""
    served.clear()
    t_start = time.perf_counter()
    results = []

    async def one(sess) -> None:
        delay = sess.start_s - (time.perf_counter() - t_start)
        if delay > 0:
            await asyncio.sleep(delay)
        rng = random.Random(1000 + sess.session_id)
        history = list(sess.system_tokens)
        for i, turn in enumerate(sess.turns):
            if turn.arrival_gap_s:
                await asyncio.sleep(turn.arrival_gap_s / DIST_THINK_SPEEDUP)
            history.extend(turn.user_tokens)
            r = await stream_completion(session, port, model, list(history), turn.osl)
            results.append({**r, "session": sess.session_id, "turn": i,
                            "key": (tuple(history[:16]), len(history))})
            history.extend(rng.randrange(10, 200) for _ in range(turn.osl))

    await asyncio.gather(*(one(s) for s in sessions))
    wall = time.perf_counter() - t_start
    e2e = traffic_e2e("dist", results, wall)
    by_key = {key: inst for key, inst in served}
    worker = {(r["session"], r["turn"]): by_key[r["key"]] for r in results}
    follow = [r for r in results if r["turn"] > 0]
    ttft = [r["stamps"][0] - r["t0"] for r in follow]
    same = sum(worker[(r["session"], r["turn"])] == worker[(r["session"], r["turn"] - 1)]
               for r in follow)
    return {"followup_ttft_ms_p50": pctile(ttft, 0.5) * 1e3,
            "followup_ttft_ms_p99": pctile(ttft, 0.99) * 1e3,
            "followup_same_worker_share": same / len(follow),
            "output_tok_s": e2e["output_tok_s"], "ttft_ms_p50": e2e["ttft_ms_p50"],
            "requests": len(results), "wall_s": wall,
            "requests_by_worker": {f"{w:x}": list(worker.values()).count(w)
                                   for w in sorted(set(worker.values()))}}


def native_checks(kv_watcher, model: str, before: dict, workers: list[dict]) -> dict:
    """Phase dist ran on the native host codecs: the KV frontend's index is
    the native radix tree, and every data-plane stream of this process (the
    frontends' response frames) and of each worker (its control frames)
    was read by the native decoder, none by the Python codec, so a broken
    g++ build cannot hide behind the Python fallback."""
    from dynamo_tpu_torch import native
    from dynamo_tpu_torch.native.radix import NativeRadixTree

    tree = type(kv_watcher._pipelines[model]["kv"].indexer.tree).__name__
    frontend = {k: native.counters[k] - before[k] for k in native.counters}
    out = {"frontend_index": tree, "frontend": frontend,
           "frontend_libraries": native.stats()["libraries"],
           "workers": [{k: w[k] for k in ("libraries", "native_streams", "python_streams")}
                       for w in workers]}
    if not isinstance(kv_watcher._pipelines[model]["kv"].indexer.tree, NativeRadixTree):
        raise AssertionError(f"the KV frontend's index is not the native radix tree: {tree}")
    if frontend["native_streams"] <= 0 or frontend["native_frames"] <= 0 \
            or frontend["python_streams"]:
        raise AssertionError(f"the frontend's frames did not all take the native decoder: "
                             f"{frontend}")
    for w in workers:
        if not w["libraries"].get("dataplane") or w["native_streams"] <= 0 \
                or w["python_streams"]:
            raise AssertionError(f"a worker's frames did not all take the native decoder: {w}")
    return out


async def dist_async(card: str, config: dict, device: str) -> dict:
    import aiohttp
    import torch

    from dynamo_tpu_torch import native

    from dynamo_tpu_torch.bench.data_generator import SessionConfig, generate_sessions
    from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.runtime.client import PushRouter, RouterMode
    from dynamo_tpu_torch.runtime.controlplane.server import ControlPlaneServer
    from dynamo_tpu_torch.serve import serve_frontend
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    on_card = device == "cuda"
    model = "llama3-8b-smoke"
    mdir = model_dir(model, config)
    if on_card:
        need = 2 * dist_worker_bytes(config, SERVE_ENGINE)
        free = torch.cuda.mem_get_info()[0]
        log(f"[dist] card memory free {free / 1e9:.1f} GB, two workers need "
            f"{need / 1e9:.1f} GB")
        if free < need:
            raise AssertionError(f"phase dist: {free / 1e9:.1f} GB free on the card, the "
                                 f"two workers need {need / 1e9:.1f} GB")
    server = ControlPlaneServer(port=0)
    await server.start()
    address = f"127.0.0.1:{server.port}"
    procs, logs, frontends = [], [], []
    runtime = None
    real_rendezvous = PushRouter._rendezvous
    served: list = []

    async def spy(self, request, instance_id, tried):
        pending, inst = await real_rendezvous(self, request, instance_id, tried)
        ids = request.data.get("token_ids") or []
        served.append(((tuple(ids[:16]), len(ids)), inst))
        return pending, inst

    def launch(i: int):
        path = ROOT / "dynamo_tpu_torch" / "_build" / f"dist_worker{i}.log"
        logs.append(path)
        with open(path, "w") as log_file:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dynamo_tpu_torch.cli.run", "run", "in=none",
                 "out=torch", "--warmup", "--control-plane", address, "--model-path",
                 str(mdir), "--model-name", model,
                 "--num-blocks", str(SERVE_ENGINE["num_blocks"]),
                 "--max-batch-size", str(SERVE_ENGINE["max_batch_size"]),
                 "--context-length", str(SERVE_ENGINE["max_model_len"]),
                 "--seed", str(SERVE_ENGINE["seed"]), "--device", device],
                cwd=ROOT, stdout=subprocess.DEVNULL, stderr=log_file))

    async def instances(n: int, push, t0: float) -> list:
        while len(push.client.instances) < n:
            for proc, path in zip(procs, logs):
                if proc.poll() is not None:
                    raise RuntimeError(f"worker exited: {path.read_text()[-3000:]}")
            if time.perf_counter() - t0 > DIST_LAUNCH_S:
                raise TimeoutError(f"{n} worker(s) not registered in {DIST_LAUNCH_S} s")
            await asyncio.sleep(0.2)
        return list(push.client.instances)

    async def flush(session, port: int, insts) -> None:
        async with session.post(f"http://127.0.0.1:{port}/clear_kv_blocks") as r:
            if r.status != 200:
                raise AssertionError(f"/clear_kv_blocks answered {r.status}: {await r.text()}")
        t0 = time.perf_counter()
        while True:
            cached = [(await worker_stats(runtime, i))["custom"]["kv_cached_blocks"]
                      for i in insts]
            if not any(cached):
                return
            if time.perf_counter() - t0 > 30:
                raise AssertionError(f"/clear_kv_blocks left cached blocks: {cached}")
            await asyncio.sleep(0.1)

    async def custom(insts) -> list[dict]:
        return [(await worker_stats(runtime, i))["custom"] for i in insts]

    out: dict = {"card": card}
    codecs_before = dict(native.counters)
    try:
        runtime = await DistributedRuntime.create(RuntimeConfig(control_plane=address))

        async def frontend(mode):
            service, watcher = await serve_frontend(runtime, host="127.0.0.1", port=0,
                                                    router_mode=mode)
            frontends.append((service, watcher))
            return service.port, watcher

        # one worker behind a round-robin frontend: phase serve's traffic
        t0 = time.perf_counter()
        launch(0)
        rr_port, rr_watcher = await frontend(RouterMode.ROUND_ROBIN)
        while model not in rr_watcher._pipelines:
            if procs[0].poll() is not None:
                raise RuntimeError(f"worker exited: {logs[0].read_text()[-3000:]}")
            if time.perf_counter() - t0 > DIST_LAUNCH_S:
                raise TimeoutError(f"worker 0 not registered in {DIST_LAUNCH_S} s")
            await asyncio.sleep(0.2)
        push = rr_watcher._pipelines[model]["router"]
        (first,) = await instances(1, push, t0)
        out["worker_launch_s"] = time.perf_counter() - t0
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=900)) as s:
            await stream_chat(s, rr_port, model, "warm up", 4)
            before = (await custom([first]))[0]
            results, wall = await serve_traffic(
                s, rr_port, model, [f"request {i}: tell me" for i in range(4)])
            after = (await custom([first]))[0]
            lone = await lone_chats(s, rr_port, model)
        one = {**traffic_e2e("dist", results, wall), "lone": lone}
        launches = {k: after["kernel_launches"][k] - before["kernel_launches"].get(k, 0)
                    for k in after["kernel_launches"]}
        path = {k: launches[k] for k in LLAMA_PATH}
        log(f"[dist] one worker over TCP: {one}; launches {path}")
        plain = sum(n for k, n in launches.items() if k.endswith("plain_calls"))
        if on_card and (any(n <= 0 for n in path.values()) or plain):
            raise AssertionError(f"a kernel did not run on the worker's path: {launches}")
        out["one_worker"] = {**one, "launches": path}

        # the second worker, then each one's greedy probe by direct routing
        t0 = time.perf_counter()
        launch(1)
        insts = await instances(2, push, t0)
        out["second_worker_launch_s"] = time.perf_counter() - t0
        direct = await PushRouter.from_endpoint(
            runtime.namespace("dynamo").component("backend").endpoint("generate"),
            RouterMode.DIRECT)
        await direct.client.wait_for_instances(2, timeout=60)
        from dynamo_tpu_torch.llm.protocols.common import (
            Annotated,
            LLMEngineOutput,
            PreprocessedRequest,
            SamplingOptions,
            StopConditions,
        )
        from dynamo_tpu_torch.runtime.engine import Context

        probes = []
        for inst in insts:
            wire = PreprocessedRequest(
                token_ids=PROBE_PROMPT, sampling=SamplingOptions(use_greedy=True),
                stop=StopConditions(max_tokens=PROBE_TOKENS, ignore_eos=True),
                eos_token_ids=[1]).to_wire()
            ids = []
            async for item in await direct.generate_direct(Context(wire), inst.instance_id):
                ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
                if ann.data is not None:
                    if ann.data.error:
                        raise RuntimeError(ann.data.error)
                    ids.extend(ann.data.token_ids)
            probes.append(ids)
        log(f"[dist] greedy probe ids by worker: {probes}")
        if probes[0] != probes[1] or len(probes[0]) != PROBE_TOKENS:
            raise AssertionError(f"the workers' greedy ids differ: {probes}")
        out["probe_ids"] = probes[0]

        # KV-aware against random routing on the multi-turn sessions
        vocab = HfTokenizer.from_model_dir(mdir).vocab_size
        sessions = generate_sessions(SessionConfig(**DIST_SESSIONS, vocab_size=vocab))
        kv_port, kv_watcher = await frontend(RouterMode.KV)
        rand_port, rand_watcher = await frontend(RouterMode.RANDOM)
        t0 = time.perf_counter()
        while not all(model in w._pipelines for w in (kv_watcher, rand_watcher)):
            # a pipeline is built off serve_frontend's return (a KV one
            # also builds the native radix library on its first use)
            if time.perf_counter() - t0 > 60:
                raise TimeoutError("the KV and random frontends did not list the model in 60 s")
            await asyncio.sleep(0.05)
        PushRouter._rendezvous = spy
        modes = {}
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=900)) as s:
            for name, port in (("kv", kv_port), ("random", rand_port)):
                await flush(s, port, insts)
                before = await custom(insts)
                modes[name] = await run_sessions(s, port, model, sessions, served)
                after = await custom(insts)
                modes[name]["workers"] = {
                    f"{i.instance_id:x}": {k: a[k] - b[k] for k in (
                        "prefix_hits_total", "prefix_cached_tokens_total")}
                    for i, a, b in zip(insts, after, before)}
                modes[name]["prefix_cached_tokens_total"] = sum(
                    a["prefix_cached_tokens_total"] - b["prefix_cached_tokens_total"]
                    for a, b in zip(after, before))
                log(f"[dist] {name}: {modes[name]}")
            await flush(s, rand_port, insts)
        PushRouter._rendezvous = real_rendezvous
        out.update(modes)
        if modes["kv"]["prefix_cached_tokens_total"] <= modes["random"]["prefix_cached_tokens_total"]:
            raise AssertionError("KV routing cached no more prefix tokens than random: "
                                 f"{modes['kv']['prefix_cached_tokens_total']} <= "
                                 f"{modes['random']['prefix_cached_tokens_total']}")

        final = []
        for inst in insts:
            st = await worker_stats(runtime, inst)
            c = st["custom"]
            final.append({
                "handled_total": st["handled_total"],
                **{k: c[k] for k in ("unified_graphs_captured_after_warmup",
                                     "decode_graphs_captured_after_warmup",
                                     "prefill_graphs_captured_after_warmup",
                                     "unified_graph_replays_total",
                                     "decode_graph_replays_total", "warmup_s")}})
        out["workers"] = final
        log(f"[dist] workers: {final}")
        out["native"] = native_checks(kv_watcher, model, codecs_before,
                                      [(await worker_stats(runtime, i))["custom"]["native_codecs"]
                                       for i in insts])
        log(f"[dist] native codecs: {out['native']}")
        for name in ("kv", "random"):
            if len(modes[name]["requests_by_worker"]) != 2:
                raise AssertionError(f"a worker served no request under {name} routing: "
                                     f"{modes[name]['requests_by_worker']}")
        for w in final:
            if w["handled_total"] <= 0:
                raise AssertionError(f"a worker served no request: {final}")
            if w["unified_graphs_captured_after_warmup"] or w["decode_graphs_captured_after_warmup"]:
                raise AssertionError(f"a worker captured a graph after warmup: {final}")
            if on_card and (w["unified_graph_replays_total"] <= 0
                            or w["decode_graph_replays_total"] <= 0):
                raise AssertionError(f"a worker replayed no unified or decode graph: {final}")
    finally:
        PushRouter._rendezvous = real_rendezvous
        for service, watcher in frontends:
            await watcher.stop()
            await service.stop()
        # the control-plane server runs on this loop: wait off it, so the
        # workers' shutdown (deregistration, lease revocation) reaches it
        for proc in procs:
            proc.terminate()
        for proc in procs:
            try:
                await asyncio.to_thread(proc.wait, 60)
            except subprocess.TimeoutExpired:
                proc.kill()
                await asyncio.to_thread(proc.wait)
        if runtime is not None:
            await runtime.close()
        await server.stop()
    out["worker_exit_codes"] = [proc.returncode for proc in procs]
    if any(out["worker_exit_codes"]):
        raise AssertionError(f"a worker did not stop cleanly on SIGTERM: "
                             f"{out['worker_exit_codes']} ({[str(p) for p in logs]})")
    return out


def phase_dist(card: str, config: dict = LLAMA3_8B, device: str = "cuda") -> dict:
    """Two worker processes (``run in=none out=torch --warmup``) at the
    Llama-3-8B geometry behind the port's control-plane server, the
    frontends in this process: phase serve's traffic through one worker,
    the workers' greedy ids, KV-aware against random routing.  ``device``
    "cpu" (with a small ``config``) rehearses it on the CPU, where no kernel
    launches and no graph is captured."""
    out = asyncio.run(dist_async(card, config, device))
    print(json.dumps({"smoke_dist": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase fleet: the routed-fleet bench, mockers and TorchLlmEngine workers
# ---------------------------------------------------------------------------

# bench.py's _measure_kv_routing traffic for the torch fleet, cut to 8
# sessions x 3 turns (12 before phases autotune and plane joined: the whole
# smoke keeps its time; generate_sessions' other defaults: 768-token
# system prefixes, 64 user tokens and 24 output tokens a turn, 3 s think
# time, three sessions a second), replayed in real time on two workers on
# one card
FLEET_SESSIONS = dict(num_sessions=8, turns_per_session=3, seed=0)
FLEET_WORKERS = 2
# the torch fleet's model on the card: Llama-3-8B's width at 8 of its 32
# layers (cut for time in PR 24, to pay for phase soak)
FLEET_CONFIG = dict(LLAMA3_8B, num_hidden_layers=8)
# the kv_routing rung's traffic on the card: 12 sessions x 4 turns (the
# headline's default, 24, cut for time in PR 24)
FLEET_RUNG_SESSIONS = dict(num_sessions=12, turns_per_session=4)


async def fleet_async(card: str, device: str, model_config, sessions: dict,
                      engine_kw: dict, rung=None) -> dict:
    import torch

    from dynamo_tpu_torch.bench import headline, routed_fleet
    from dynamo_tpu_torch.bench.data_generator import SessionConfig
    from dynamo_tpu_torch.engine import TorchLlmEngine
    from dynamo_tpu_torch.models.llama import LlamaConfig, init_params

    on_card = device == "cuda"
    out: dict = {"card": card}
    # (a) the headline's KV routing rung: four mockers, no device work
    t0 = time.perf_counter()
    rung = rung or (SessionConfig(**FLEET_RUNG_SESSIONS),)
    out["kv_routing_rung"] = await headline.measure_kv_routing(*rung)
    out["kv_routing_rung_s"] = time.perf_counter() - t0
    log(f"[fleet] kv_routing rung (mocker fleet): {out['kv_routing_rung']}")
    r = out["kv_routing_rung"]
    if r["kv_prefix_hits"] <= r["random_prefix_hits"]:
        raise AssertionError(f"the mocker fleet's KV routing hit no more prefixes than random: {r}")

    # (b) compare_policies on TorchLlmEngine workers sharing one set of weights
    scfg = SessionConfig(**sessions)
    longest = (scfg.system_tokens
               + scfg.turns_per_session * (scfg.user_tokens_per_turn + scfg.osl) + 32)
    dev = torch.device(device)
    mcfg = model_config or (LlamaConfig.from_hf_config(FLEET_CONFIG) if on_card
                            else LlamaConfig.tiny())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(mcfg, gen, device=dev)
    fcfg = routed_fleet.FleetConfig(
        engine="torch", num_workers=FLEET_WORKERS, speedup=1.0, device=device,
        model_config=mcfg, params=params, max_model_len=(longest + 127) // 128 * 128,
        **engine_kw)
    # the launch counters are zeroed after each engine's warmup, so a run's
    # counts are its replay's; each engine's step time is read when its
    # warmup ends and again at the fleet's teardown
    marks, runs = {}, []
    real_warmup, real_teardown = TorchLlmEngine.warmup, routed_fleet._teardown_fleet

    async def warmup(self, *args, **kwargs):
        await real_warmup(self, *args, **kwargs)
        zero_counters()
        marks[id(self)] = (time.perf_counter(), self.stats()["engine_step_time_total_s"])

    async def teardown(handles):
        t_end = time.perf_counter()
        engines = [h[0] for h in handles]
        if engines and all(id(e) in marks for e in engines):
            t_start = max(marks[id(e)][0] for e in engines)
            stats = [e.stats() for e in engines]
            runs.append({
                "counts": read_counters(),
                "replay_s": t_end - t_start,
                "engine_idle_share": [
                    1.0 - (st["engine_step_time_total_s"] - marks[id(e)][1]) / (t_end - t_start)
                    for e, st in zip(engines, stats)],
                "warmup_s": [st["warmup_s"] for st in stats],
                "graphs_captured_after_warmup": sum(
                    st[f"{k}_graphs_captured_after_warmup"] for st in stats
                    for k in ("unified", "decode", "prefill", "verify")),
            })
        await real_teardown(handles)

    TorchLlmEngine.warmup, routed_fleet._teardown_fleet = warmup, teardown
    t0 = time.perf_counter()
    try:
        result = await routed_fleet.compare_policies(scfg, fcfg)
    finally:
        TorchLlmEngine.warmup, routed_fleet._teardown_fleet = real_warmup, real_teardown
        del params
    out["torch_fleet_s"] = time.perf_counter() - t0
    keys = ("ttft_p50_ms", "ttft_p99_ms", "followup_ttft_p50_ms", "followup_ttft_p99_ms",
            "prefix_hits_total", "num_turns", "tokens_streamed_total", "turns_short", "wall_s")
    for policy, run in zip(("random", "kv"), runs):
        out[policy] = {**{k: result[policy][k] for k in keys}, **run,
                       "launches": {k: run["counts"][k] for k in LLAMA_PATH},
                       "plain_calls": run["counts"]["plain_calls"]}
        del out[policy]["counts"]
    for k in ("ttft_p50_speedup", "ttft_p99_speedup", "followup_ttft_p50_speedup"):
        out[k] = result[k]
    out["model"] = {"hidden": mcfg.hidden_size, "layers": mcfg.num_layers,
                    "workers": FLEET_WORKERS, "max_model_len": fcfg.max_model_len}
    log(f"[fleet] torch fleet: {json.dumps(out, default=str)}")
    if len(runs) != 2:
        raise AssertionError(f"phase fleet: {len(runs)} measured fleet runs, want 2")
    expected = scfg.num_sessions * scfg.turns_per_session
    for policy in ("random", "kv"):
        o = out[policy]
        if o["num_turns"] != expected or o["turns_short"] or \
                o["tokens_streamed_total"] != expected * scfg.osl:
            raise AssertionError(f"phase fleet: {policy} routing did not finish every turn "
                                 f"with its {scfg.osl} tokens: {o}")
        if o["graphs_captured_after_warmup"]:
            raise AssertionError(f"phase fleet: a graph was captured after warmup: {o}")
        if on_card and (any(n <= 0 for n in o["launches"].values()) or o["plain_calls"]):
            raise AssertionError(f"phase fleet: rows 1-2 did not launch on the card under "
                                 f"{policy} routing: {o}")
    if out["kv"]["prefix_hits_total"] <= out["random"]["prefix_hits_total"]:
        raise AssertionError("phase fleet: KV routing hit no more prefixes than random")
    return out


def phase_fleet(card: str, device: str = "cuda", model_config=None,
                sessions: dict = FLEET_SESSIONS, engine_kw: dict | None = None,
                rung=None) -> dict:
    """(a) the headline's kv_routing rung (a mocker fleet, 12 sessions x 4
    turns: ``FLEET_RUNG_SESSIONS``, the median of three kv/random repeats); (b) ``routed_fleet.
    compare_policies`` on two TorchLlmEngine workers at the Llama-3-8B
    geometry (full width, 8 layers: ``FLEET_CONFIG``) in this process (one
    set of random weights on the card, each engine warmed), 8 sessions x 3
    turns: TTFT, follow-up TTFT and prefix hits under both policies, every
    turn complete, rows 1-2 launched, each engine's idle share.  ``device``
    "cpu" (the tiny config; ``rung`` a smaller session and fleet config for
    the mocker rung) rehearses it."""
    out = asyncio.run(fleet_async(card, device, model_config, sessions, engine_kw or {}, rung))
    print(json.dumps({"smoke_fleet": out}, default=str), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase prefetch: demand against predictive paging through the hint path
# ---------------------------------------------------------------------------

# one worker at the Llama-3-8B geometry: a device cache (G1) of about three
# sessions' contexts over a host tier (G2, 3 GiB pinned at 2 MiB a block)
# that holds every session's blocks
PREFETCH_ENGINE = dict(SERVE_ENGINE, num_blocks=256, host_offload_blocks=1536)
# multi-turn sessions, each its own context; a turn's prompt is the session's
# history: the context, every user turn and, after each turn, a stand-in for
# the reply (random weights' text does not round-trip); a fixed think time
# after a turn's last token; sessions start STAGGER_S apart
PREFETCH_SESSIONS = dict(sessions=12, turns=4, context_tokens=1024, user_tokens=64, osl=32,
                         think_s=3.0, stagger_s=0.5)
PREFETCH_CHURN = (1400, 1400, 1400)  # prompts sent alone to push the probe out of G1
PREFETCH_PROBE = (1200, 24)          # the probe's prefix and its new tail, in tokens
PREFETCH_COUNTS = ("prefetch_hints_total", "prefetch_hits_total", "prefetch_misses_total",
                   "prefetch_stale_total", "prefetch_blocks_restored_total",
                   "prefetch_blocks_onboarded_total", "prefetch_deferred_total",
                   "prefetch_restore_failures_total", "prefetch_hidden_seconds_total",
                   "host_blocks_pinned", "host_restores_total", "host_offloads_total",
                   "offload_drains_total", "admission_drains_total", "prefix_hits_total",
                   "restore_stage_ms_total", "restore_copy_ms_total",
                   "restore_scatter_ms_total", "offload_gather_ms_total",
                   "num_preemptions_total")
PREFETCH_LAUNCH_S = 600


def words_after(tokenizer, rng, head: str, n_tokens: int) -> str:
    """``head`` and random lowercase words after it, each after a space, until
    the text encodes to at least ``n_tokens`` more tokens (a space before every
    word keeps the tokens of ``head`` as they were)."""
    base = len(tokenizer.encode(head)) if head else 0
    text = head
    while len(tokenizer.encode(text)) - base < n_tokens:
        text += "".join(" " + "".join(rng.choice("abcdefghijklmnopqrstuvwxyz")
                                      for _ in range(rng.randint(2, 7))) for _ in range(6))
    return text


def prefetch_texts(tokenizer, sessions: dict) -> list[list[str]]:
    """Every session's turn prompts, from seed 0."""
    out = []
    for i in range(sessions["sessions"]):
        rng = random.Random(7000 + i)
        history = words_after(tokenizer, rng, f"session {i}:", sessions["context_tokens"])
        turns = []
        for _ in range(sessions["turns"]):
            history = words_after(tokenizer, rng, history, sessions["user_tokens"])
            turns.append(history)
            history = words_after(tokenizer, rng, history, sessions["osl"])
        out.append(turns)
    return out


async def run_prefetch_sessions(session, port: int, model: str, texts, sessions: dict) -> dict:
    """Replay the sessions through the frontend (text completions, streamed,
    greedy): every request's e2e, and the returning turns' TTFT."""
    t_start = time.perf_counter()
    results = []

    async def one(i: int, turns: list[str]) -> None:
        await asyncio.sleep(i * sessions["stagger_s"])
        for t, prompt in enumerate(turns):
            if t:
                await asyncio.sleep(sessions["think_s"])
            r = await stream_completion(session, port, model, prompt, sessions["osl"])
            results.append({**r, "session": i, "turn": t})

    await asyncio.gather(*(one(i, turns) for i, turns in enumerate(texts)))
    wall = time.perf_counter() - t_start
    e2e = traffic_e2e("prefetch", results, wall)
    back = [r["stamps"][0] - r["t0"] for r in results if r["turn"] > 0]
    return {"returning_ttft_ms_p50": pctile(back, 0.5) * 1e3,
            "returning_ttft_ms_p99": pctile(back, 0.99) * 1e3,
            **{k: e2e[k] for k in ("ttft_ms_p50", "ttft_ms_p99", "itl_ms_p50", "itl_ms_p99",
                                   "output_tok_s", "requests", "wall_s")}}


async def http_json(session, method: str, url: str, body: dict | None = None):
    async with session.request(method, url, json=body) as r:
        text = await r.text()
        return r.status, r.headers, text


async def prefetch_frontend_checks(session, runtime, model: str, base: str, before: str) -> dict:
    """The frontend's surfaces after the pager run: /metrics against its
    scrape before the traffic, /slo, one n = 2 request, then a burst through
    a second frontend whose admission gate is smaller than the burst."""
    from dynamo_tpu_torch.robustness.admission import AdmissionConfig
    from dynamo_tpu_torch.runtime.client import RouterMode
    from dynamo_tpu_torch.serve import serve_frontend

    def requests_ok(text: str) -> float:
        return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                   if line.startswith("dyn_llm_http_service_requests_total{")
                   and 'status="success"' in line)

    _, _, after = await http_json(session, "GET", f"{base}/metrics")
    status, _, slo = await http_json(session, "GET", f"{base}/slo")
    slo = json.loads(slo)
    if status != 200 or set(slo["objectives"]) != {"ttft", "itl", "error_rate"}:
        raise AssertionError(f"/slo answered {status}: {slo}")
    status, _, text = await http_json(session, "POST", f"{base}/v1/completions", {
        "model": model, "prompt": "two choices, please", "max_tokens": 8, "n": 2,
        "temperature": 0, "ext": {"ignore_eos": True}})
    body = json.loads(text)
    if status != 200 or [c["index"] for c in body["choices"]] != [0, 1] \
            or body["usage"]["completion_tokens"] != 16:
        raise AssertionError(f"n = 2 answered {status}: {text[:500]}")
    gate = AdmissionConfig(max_inflight=2, max_queue_depth=2, queue_timeout_s=0.2,
                           retry_after_s=1.0)
    service, watcher = await serve_frontend(runtime, host="127.0.0.1", port=0,
                                            router_mode=RouterMode.KV, admission=gate)
    try:
        gated = f"http://127.0.0.1:{service.port}"
        t0 = time.perf_counter()
        while model not in (await http_json(session, "GET", f"{gated}/v1/models"))[2]:
            if time.perf_counter() - t0 > 60:
                raise TimeoutError("the gated frontend found no model")
            await asyncio.sleep(0.1)
        burst = await asyncio.gather(*[http_json(session, "POST", f"{gated}/v1/completions", {
            "model": model, "prompt": f"burst {i}: go on", "max_tokens": 64, "temperature": 0,
            "ext": {"ignore_eos": True}}) for i in range(10)])
        codes = [s for s, _, _ in burst]
        retry = sorted({h.get("Retry-After") for s, h, _ in burst if s != 200})
        _, _, gated_metrics = await http_json(session, "GET", f"{gated}/metrics")
        _, _, gated_slo = await http_json(session, "GET", f"{gated}/slo")
    finally:
        await watcher.stop()
        await service.stop()
    shed = [line for line in gated_metrics.splitlines() if line.startswith("dyn_shed_total")]
    out = {"requests_ok_before": requests_ok(before), "requests_ok_after": requests_ok(after),
           "slo_worst_burn_rate": slo["worst_burn_rate"],
           "slo_objectives": {k: {n: v for n, v in o.items() if n.endswith("_total")}
                              for k, o in slo["objectives"].items()},
           "burst_codes": {str(c): codes.count(c) for c in sorted(set(codes))},
           "burst_retry_after": retry, "dyn_shed_total": shed,
           "gated_slo_objectives": sorted(json.loads(gated_slo)["objectives"])}
    if set(codes) - {200, 429, 503} or 429 not in codes or 200 not in codes \
            or retry != ["1"]:
        raise AssertionError(f"the admission burst: {out}")
    return out


async def prefetch_mode(mode: str, model: str, mdir: Path, device: str, texts,
                        sessions: dict, probe: tuple, engine_kw: dict, churn: tuple) -> dict:
    """One run of the sessions through a fresh worker and KV-routed frontend
    over a memory control plane in this process: ``DYN_PREFETCH`` 0
    (demand) or 1 (pager).  Then the probe: its prefix computed alone and
    pushed out of G1 by churn sent alone, restored by a hint through the
    frontend's hinter (pager) or on demand, and its greedy ids."""
    import aiohttp

    from dynamo_tpu_torch.llm.kv_router.hashing import compute_block_hashes
    from dynamo_tpu_torch.llm.protocols.openai import CompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.runtime.client import RouterMode
    from dynamo_tpu_torch.serve import serve_frontend, serve_worker
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    os.environ["DYN_PREFETCH"] = "1" if mode == "pager" else "0"
    runtime = await DistributedRuntime.create(RuntimeConfig(
        control_plane=f"memory://smoke-prefetch-{mode}"))
    worker = service = watcher = None
    out: dict = {"mode": mode}
    try:
        t0 = time.perf_counter()
        worker = await serve_worker(runtime, mdir, model_name=model, engine_kind="torch",
                                    device=device, warmup=True, **engine_kw)
        out["worker_launch_s"] = time.perf_counter() - t0
        engine = worker.engine
        if (engine.prefetch_pager is None) != (mode == "demand"):
            raise AssertionError(f"{mode}: the worker's pager is {engine.prefetch_pager}")
        service, watcher = await serve_frontend(runtime, host="127.0.0.1", port=0,
                                                router_mode=RouterMode.KV)
        if (service.prefetch_hinter is None) != (mode == "demand"):
            raise AssertionError(f"{mode}: the frontend's hinter is {service.prefetch_hinter}")
        base = f"http://127.0.0.1:{service.port}"
        tok = HfTokenizer.from_model_dir(mdir)
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=900)) as s:
            while model not in (await http_json(s, "GET", f"{base}/v1/models"))[2]:
                if time.perf_counter() - t0 > PREFETCH_LAUNCH_S:
                    raise TimeoutError(f"{mode}: no model registered")
                await asyncio.sleep(0.1)
            status, _, text = await http_json(s, "POST", f"{base}/clear_kv_blocks")
            if status != 200:
                raise AssertionError(f"/clear_kv_blocks answered {status}: {text}")
            _, _, before = await http_json(s, "GET", f"{base}/metrics")
            stats0 = engine.stats()
            zero_counters()
            out["traffic"] = await run_prefetch_sessions(s, service.port, model, texts, sessions)
            counts = read_counters()
            stats1 = engine.stats()
            out["counts"] = counts
            out["run"] = {k: stats1[k] - stats0.get(k, 0) for k in PREFETCH_COUNTS if k in stats1}
            out["flight_buffer_bytes"] = stats1["flight_buffer_bytes"]
            out["flight_records_total"] = stats1["flight_records_total"]
            leaves = len(engine.cache)
            for row, key, ms in (("gather", "block_copy.gather_launches", "offload_gather_ms_total"),
                                 ("scatter", "block_copy.scatter_launches",
                                  "restore_scatter_ms_total")):
                calls = counts[key] / leaves
                out[f"{row}_calls"] = calls
                out[f"{row}_device_ms_per_call"] = (out["run"][ms] / calls if calls and ms in
                                                    out["run"] else "not measured")

            # the probe, alone on the engine
            await settled(engine)
            rng = random.Random(99)
            prefix = words_after(tok, rng, "probe:", probe[0])
            probe_text = words_after(tok, rng, prefix, probe[1])
            alone = [prefix] + [words_after(tok, random.Random(500 + i), "churn:", n)
                                for i, n in enumerate(churn)]
            for text in alone:
                await settled(engine)
                r = await stream_completion(s, service.port, model, text, 1)
                if r["status"] != 200:
                    raise AssertionError(f"a probe-setup request answered {r['status']}")
            await settled(engine)
            probe_ids = tok.encode(probe_text)
            hashes = compute_block_hashes(probe_ids, engine.config.block_size)
            on_device = sum(engine.allocator.is_registered(h) for h in hashes)
            # the prefix's blocks in the tiers: what a hint can restore
            held = []
            for h in hashes:
                if engine.host_tier.locate(h) is None:
                    break
                held.append(h)
            before_probe = engine.stats()
            if mode == "pager":
                # the probe's arrival hint, through the frontend's hinter, the
                # router's forwarder and the worker's listener to the pager
                service.prefetch_hinter.on_request(model, CompletionRequest(
                    model=model, prompt=probe_text, max_tokens=PROBE_TOKENS))
                t1 = time.perf_counter()
                while not all(engine.allocator.is_registered(h) for h in held):
                    if time.perf_counter() - t1 > 60:
                        raise AssertionError("the probe's hint restored nothing: "
                                             f"{engine.stats()}")
                    await asyncio.sleep(0.01)
            out["probe_ids"] = await generate_tokens(engine, probe_ids, PROBE_TOKENS)
            after_probe = engine.stats()
            out["probe"] = {"blocks": len(hashes), "on_device_before": on_device,
                            "in_tiers_before": len(held), **{
                k: after_probe[k] - before_probe.get(k, 0)
                for k in ("host_restores_total", "prefetch_hits_total",
                          "prefetch_blocks_restored_total", "prefix_hits_total")
                if k in after_probe}}
            if mode == "pager":
                out["frontend"] = await prefetch_frontend_checks(s, runtime, model, base, before)
        final = engine.stats()
        out["captured_after_warmup"] = {k: final[k] for k in final
                                        if k.endswith("captured_after_warmup")}
        out["warmup_s"] = final["warmup_s"]
    finally:
        os.environ.pop("DYN_PREFETCH", None)
        if watcher is not None:
            await watcher.stop()
        if service is not None:
            await service.stop()
        if worker is not None:
            await worker.shutdown()
        await runtime.close()
    return out


def phase_prefetch(card: str, config: dict = LLAMA3_8B, device: str = "cuda",
                   sessions: dict = PREFETCH_SESSIONS, probe: tuple = PREFETCH_PROBE,
                   engine_kw: dict = PREFETCH_ENGINE, churn: tuple = PREFETCH_CHURN) -> dict:
    """Demand against predictive paging, the hints crossing the real path
    (FrontendHinter → PrefetchForwarder → PrefetchListener → pager → row 7):
    the same sessions through a fresh worker with ``DYN_PREFETCH=0``, then
    with it on.  Fails when a request is not a 200 with its tokens, the pager
    run shows no prefetch hit or no pager restore, the probe's greedy ids
    differ between the runs, the pager drained the overlap more often than
    demand paging, or a graph was captured after warmup.  ``device`` "cpu"
    (with a small ``config``, ``sessions``, ``engine_kw`` and ``churn``)
    rehearses it on the CPU."""
    model = "llama3-8b-prefetch"
    mdir = model_dir(model, config)
    from dynamo_tpu_torch.llm.tokenizer import HfTokenizer

    texts = prefetch_texts(HfTokenizer.from_model_dir(mdir), sessions)
    runs = {}
    for mode in ("demand", "pager"):
        runs[mode] = asyncio.run(prefetch_mode(mode, model, mdir, device, texts, sessions, probe,
                                               engine_kw, churn))
        log(f"[prefetch] {mode}: {runs[mode]}")
        gc.collect()
        if device == "cuda":
            import torch

            torch.cuda.empty_cache()
    demand, pager = runs["demand"], runs["pager"]
    line = {"card": card, **{m: {k: r[k] for k in ("traffic", "run", "probe", "worker_launch_s",
                                                    "warmup_s", "gather_calls", "scatter_calls",
                                                    "gather_device_ms_per_call",
                                                    "scatter_device_ms_per_call",
                                                    "flight_buffer_bytes")}
                               for m, r in runs.items()},
            "frontend": pager["frontend"], "probe_ids_equal": demand["probe_ids"] == pager["probe_ids"]}
    print(json.dumps({"smoke_prefetch": line}), flush=True)
    run = pager["run"]
    if run.get("prefetch_hits_total", 0) <= 0 or run.get("prefetch_blocks_restored_total", 0) <= 0:
        raise AssertionError(f"the pager run shows no prefetch hit or restore: {run}")
    if device == "cuda" and pager["counts"]["block_copy.scatter_launches"] <= 0:
        raise AssertionError(f"no restore ran through row 7 under the pager: {pager['counts']}")
    if pager["probe"].get("prefetch_hits_total", 0) <= 0 or demand["probe"]["host_restores_total"] <= 0:
        raise AssertionError(f"the probe was not restored by hint and on demand: "
                             f"{pager['probe']} / {demand['probe']}")
    if demand["probe_ids"] != pager["probe_ids"]:
        raise AssertionError(f"the probe's greedy ids differ: demand {demand['probe_ids']}, "
                             f"pager {pager['probe_ids']}")
    front = pager["frontend"]
    if front["requests_ok_after"] - front["requests_ok_before"] < len(texts) * sessions["turns"]:
        raise AssertionError(f"/metrics counted too few successful requests: {front}")
    if run["offload_drains_total"] > demand["run"]["offload_drains_total"]:
        raise AssertionError(f"the pager drained the overlap {run['offload_drains_total']} "
                             f"times, demand paging {demand['run']['offload_drains_total']}")
    for r in runs.values():
        if any(r["captured_after_warmup"].values()):
            raise AssertionError(f"a graph was captured after warmup: {r['captured_after_warmup']}")
        if device == "cuda" and (r["counts"]["plain_calls"] or any(
                r["counts"][k] <= 0 for k in LLAMA_PATH + OFFLOAD_PATH)):
            raise AssertionError(f"a kernel of the path did not run on the card: {r['counts']}")
    return line


# ---------------------------------------------------------------------------
# phase overlap: the overlapped decode pipeline and the graphed decode window
# ---------------------------------------------------------------------------

OVERLAP_ENGINE = SERVE_ENGINE
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


def replay_vs_eager(torch, engine, cursors=None) -> dict:
    """One decode window on eight lanes at growing contexts, by graph replay
    and by the same step run eagerly on the same buffers: sampled tokens,
    logprobs, the K/V rows written and the generated counts bitwise equal,
    greedy and sampled (both graphs).  ``cursors`` (a guided cursor or None
    a lane) masks the lanes by their automaton modes (phase guided); the
    replayed tokens are then returned too.  Leaves the window's inputs in
    the buffers; returns the checks and the first iteration's slots."""
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
            if cursors is not None:
                seq.guided = cursors[lane]
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
        if cursors is not None:
            out["sampled" if noise else "greedy"]["tokens"] = graph[0][0].tolist()
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
    v = ug.inputs.view(bucket)
    kw = {"plan": ug.work[bucket]} if bucket in ug.work else {}

    def forward():
        return engine.family.forward_unified(
            engine.params, engine.config.model, v["token_ids"], engine.cache,
            d.tables["tables"], v["context_lens"], v["token_pos"], v["token_slot"],
            v["token_lane"], v["page_phys"], v["page_lane"], v["page_ord"], v["page_count"],
            v["sample_rows"], engine.cos, engine.sin, tb_tokens=ug.tb, **kw)[0]

    return captured_vs_eager(torch, engine.device, forward)


def captured_vs_eager(torch, dev, forward) -> dict:
    """``forward`` (a forward on a graph's buffers, returning logits)
    captured here and replayed, against its eager run: logits bitwise, else
    the largest difference."""
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
        "unified_capture_ms_per_bucket": ug.bucket_capture_ms,
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
    line["unified_skip"] = unified_skip_check(torch, base, vocab)
    log(f"[overlap:{tag}] a skipped unified window: {line['unified_skip']}")
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"smoke_overlap": line}), flush=True)
    base.stop()
    return {"counts": counts, "line": line}


def unified_skip_check(torch, engine, vocab: int) -> dict:
    """A window the unified step skips, on a warmed unified engine: two
    admissions in one step against its one seed slot (``seed_overflow``)
    send both prompts to the split prefill (a whole prompt and a first
    chunk), whose keys the engine captures at their first use (counted
    after warmup); the same window again replays them.  Returns each
    pass's wall ms, captures, capture ms and the pools after it."""
    rng = random.Random(5)
    slots = engine.scheduler.max_prefills_per_step
    engine.scheduler.max_prefills_per_step = 2
    out = {}
    try:
        for name in ("first_use", "again"):
            before = engine.stats()
            prompts = [[rng.randrange(3, vocab) for _ in range(300)] for _ in range(2)]
            t0 = time.perf_counter()
            streams = asyncio.run(run_burst(engine, prompts, [4, 4]))
            wall = (time.perf_counter() - t0) * 1e3
            after = engine.stats()
            out[name] = {
                "wall_ms": wall, "tokens": [len(t) for t in streams],
                "seed_overflow": after["unified_fallbacks"].get("seed_overflow", 0)
                - before["unified_fallbacks"].get("seed_overflow", 0),
                **{k: after[k] - before[k] for k in (
                    "prefill_graphs_captured_after_warmup", "prefill_graph_replays_total",
                    "prefill_graph_capture_ms")},
                "prefill_graph_pool_mb": after["prefill_graph_pool_mb"],
                "pool_mb_total": sum(after[f"{k}_graph_pool_mb"]
                                     for k in ("unified", "decode", "prefill")),
            }
    finally:
        engine.scheduler.max_prefills_per_step = slots
    first, again = out["first_use"], out["again"]
    if not (first["seed_overflow"] > 0 and first["prefill_graphs_captured_after_warmup"] > 0
            and again["seed_overflow"] > 0 and again["prefill_graphs_captured_after_warmup"] == 0
            and again["prefill_graph_replays_total"] > 0):
        raise AssertionError(f"a skipped unified window did not capture its split prefill keys "
                             f"at first use and replay them after: {out}")
    return out


def phase_overlap_both(torch, card: str) -> dict:
    """Phase overlap on both configurations at phases serve's and mla's
    depths (16 of Llama-3-8B's 32 layers, 14 of DeepSeek-V2-Lite's 27), so
    that the whole smoke keeps its time with phases autotune and plane."""
    llama = phase_overlap(torch, card, "llama", "llama3-8b-smoke", SERVE_LLAMA,
                          "paged_attention.launches", "ragged_attention.launches",
                          LLAMA_PATH, True)
    gc.collect()  # the Llama engines are stopped: free them before DeepSeek's
    torch.cuda.empty_cache()
    return {"llama": llama,
            "mla": phase_overlap(torch, card, "mla", "deepseek-v2-lite-smoke", SERVE_MLA,
                                 "mla_attention.decode_launches", "mla_attention.ragged_launches",
                                 MLA_PATH, False)}


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


def verify_window(torch, engine, noise: bool):
    """Write one verify window into the verify graph's buffers: every lane
    at its own context (2043 down by 250, as the kernels' verify cases
    reach 2048), its own blocks, random window tokens, every other lane
    drafting; all lanes sampled (``noise``) or greedy.  Returns the
    window's cache slots [lanes, w] and its context lengths (including the
    window's last token)."""
    import numpy as np

    from dynamo_tpu_torch.llm.protocols.common import SamplingOptions

    vg, d = engine._verify, engine._decode
    lanes, bs, w = engine.config.max_batch_size, engine.config.block_size, vg.w
    ctx = np.array([2048 - w - 250 * i for i in range(lanes)], np.int32)
    tables = np.zeros((lanes, engine.max_blocks_per_seq), np.int32)
    stride = engine.config.num_blocks // lanes  # each lane's blocks its own
    for i, c in enumerate(ctx):
        n = -(-(int(c) + w) // bs)
        tables[i, :n] = np.arange(i * stride, i * stride + n)
    gen = np.random.default_rng(7 + noise)
    pos = ctx[:, None] - 1 + np.arange(w)[None, :]
    slots = (tables[np.arange(lanes)[:, None], pos // bs] * bs + pos % bs).astype(np.int32)
    d.tables.upload({"tables": tables})
    engine._bt_clean = False  # the engine's own rows no longer match the buffer
    engine._device_sampling_tail([
        lane_seq(engine, lane, SamplingOptions(temperature=0.8, seed=lane, presence_penalty=0.3)
                 if noise else SamplingOptions(use_greedy=True))
        for lane in range(lanes)])
    vg.inputs.upload({
        "tokens": gen.integers(3, engine.config.model.vocab_size, (lanes, w)).astype(np.int32),
        "slots": slots, "context_lens": ctx + w - 1, "base_lens": ctx,
        "spec_ok": np.arange(lanes) % 2 == 0})
    return slots, (ctx + w - 1).tolist()


def lane_seq(engine, lane: int, sampling):
    """A sequence on ``lane`` with ``sampling``, its key seeded."""
    from dynamo_tpu_torch.engine.sequence import Sequence
    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest, StopConditions

    seq = Sequence(seq_id=f"check{lane}", request=PreprocessedRequest(
        token_ids=[1], sampling=sampling, stop=StopConditions(max_tokens=1)))
    seq.lane = lane
    engine._seed_lane_key(seq)
    return seq


def written_rows(torch, engine, slots):
    """A function giving the cache bytes at ``slots`` (every layer)."""
    import numpy as np

    from dynamo_tpu_torch.ops.attention import cache_rows

    n_slots = engine.config.num_blocks * engine.config.block_size
    layers = engine.cache["k"].shape[0]
    rows = torch.from_numpy((np.arange(layers)[:, None] * n_slots
                             + np.asarray(slots).reshape(-1)[None, :]).reshape(-1)).to(engine.device)
    views = {k: cache_rows(leaf) for k, leaf in engine.cache.items()}
    return lambda: {k: v.view(torch.uint8)[rows].clone() for k, v in views.items()}


def replay_vs_eager_state(torch, engine, out, run, step, written) -> dict:
    """``run`` (a graph replay) and ``step`` (the same step eagerly on the
    same buffers), the penalty counts restored between: the ``out`` buffer,
    the cache rows written and the counts bitwise equal."""
    counts = (engine._gen_counts, engine._prompt_counts)
    saved = [c.clone() for c in counts]
    states = []
    for fn in (run, step):
        for c, s in zip(counts, saved):
            c.copy_(s)
        fn()
        torch.cuda.synchronize()
        states.append((out.clone(), written(), [c.clone() for c in counts]))
    (g_out, g_kv, g_counts), (e_out, e_kv, e_counts) = states
    return {"out_bitwise": torch.equal(g_out, e_out),
            "kv_rows_bitwise": all(torch.equal(g_kv[k], e_kv[k]) for k in g_kv),
            "counts_equal": all(torch.equal(a, b) for a, b in zip(g_counts, e_counts))}


def verify_replay_vs_eager(torch, engine) -> dict:
    """A verify window (``verify_window``) by the graph's replay (captured by
    ``warmup()``) and by the same step run eagerly on the same buffers,
    greedy and sampled: tokens, acceptance counts, logprobs, the cache rows
    written and the counts bitwise equal; then the verify forward alone
    captured and replayed against its eager run, logits bitwise.  No replay
    may add a capture."""
    vg, d = engine._verify, engine._decode
    out = {}
    for noise in (False, True):
        captured = len(vg._graphs)
        slots, _ = verify_window(torch, engine, noise)
        res = replay_vs_eager_state(
            torch, engine, vg.out, lambda: vg.run(noise), lambda: vg.step(noise),
            written_rows(torch, engine, slots))
        out["sampled" if noise else "greedy"] = res | {"no_new_capture": len(vg._graphs) == captured}
    v = vg.inputs.views
    out["logits"] = captured_vs_eager(torch, engine.device, lambda: engine.family.forward_verify(
        engine.params, engine.config.model, v["tokens"], engine.cache, d.tables["tables"],
        v["context_lens"], v["slots"], engine.cos, engine.sin)[0])
    return out


# the split prefill keys held by replay against eager in phase spec: windows
# of 32 and 512 tokens over a resident prefix, and a whole 2048-token prompt
SPEC_PREFILL_KEYS = (("prefix", 32, 8), ("prefix", 512, 64), ("prefill", 2048))


def prefill_window(torch, engine, key: tuple, noise: bool):
    """Write one split prefill of ``key`` into the prefill graph's buffers
    (lane 3, its own blocks, a few pad tokens; a continued window over a
    block-aligned resident prefix), sampled (``noise``) or greedy.  Returns
    the cache slots its valid tokens write."""
    import numpy as np

    from dynamo_tpu_torch.llm.protocols.common import SamplingOptions

    pg = engine._prefill
    bs, vocab, lane = engine.config.block_size, engine.config.model.vocab_size, 3
    gen = np.random.default_rng(key[1] + noise)
    b = key[1]
    if key[0] == "prefix":
        table_len = key[2]
        n_tail = b - 5
        start = (table_len * bs - b - bs) // bs * bs
        n = start + n_tail
    else:
        table_len, n_tail, start = engine.max_blocks_per_seq, b - 5, 0
        n = n_tail
    blocks = np.zeros((table_len,), np.int32)
    used = -(-n // bs)
    blocks[:used] = 100 + np.arange(used)
    token_ids = np.zeros((b,), np.int32)
    token_ids[:n_tail] = gen.integers(3, vocab, n_tail)
    seq = lane_seq(engine, lane, SamplingOptions(temperature=0.8, seed=5, presence_penalty=0.3)
                   if noise else SamplingOptions(use_greedy=True))
    arrays = dict(zip(("temp", "top_k", "top_p", "greedy", "pres", "freq", "rep", "bias_ids",
                       "bias_vals"), engine._sampling_arrays([seq], [0], 1)))
    arrays.update(token_ids=token_ids, seq_len=n_tail, start_pos=start, fold=n, lane=lane,
                  gate=1, key=engine._lane_keys[[lane]].astype(np.int64),
                  prompt=np.bincount(gen.integers(0, vocab, 64), minlength=vocab).astype(np.int32),
                  gen=np.bincount(gen.integers(0, vocab, 4), minlength=vocab).astype(np.int32),
                  gmode=np.full((1,), -1, np.int32))
    if key[0] == "prefix":
        tail_ids = np.zeros_like(blocks)
        tail_ids[: used - start // bs] = blocks[start // bs: used]
        arrays.update(full_ids=blocks, tail_ids=tail_ids)
    else:
        arrays["block_ids"] = blocks
    pg.upload(key, arrays)
    pos = start + np.arange(n_tail)
    return blocks[pos // bs] * bs + pos % bs


def prefill_replay_vs_eager(torch, engine) -> dict:
    """At each of SPEC_PREFILL_KEYS: a split prefill (``prefill_window``) by
    its key's graph replay (captured by ``warmup()``) and by the same step
    run eagerly on the same buffers, a greedy lane and a sampled one:
    token, logprob, the cache rows written and the counts bitwise equal;
    then the forward alone captured and replayed against its eager run,
    logits bitwise."""
    pg = engine._prefill
    out = {}
    for key in SPEC_PREFILL_KEYS:
        name = "_".join(map(str, key))
        for noise in (False, True):
            captured = len(pg._graphs)
            slots = prefill_window(torch, engine, key, noise)
            res = replay_vs_eager_state(
                torch, engine, pg.out, lambda: pg.run(key), lambda: pg.step(key),
                written_rows(torch, engine, slots))
            out[f"{name}_{'sampled' if noise else 'greedy'}"] = res | {
                "no_new_capture": len(pg._graphs) == captured}
        v = pg.inputs.view(key)
        fam, e = engine.family, engine
        if key[0] == "prefill":
            forward = lambda: fam.forward_prefill(  # noqa: E731
                e.params, e.config.model, v["token_ids"], e.cache, v["block_ids"], v["seq_len"],
                0, e.cos, e.sin)[0]
        else:
            forward = lambda: fam.forward_prefill_with_prefix(  # noqa: E731
                e.params, e.config.model, v["token_ids"], e.cache, v["full_ids"], v["tail_ids"],
                v["seq_len"], v["start_pos"], e.cos, e.sin)[0]
        out[f"{name}_logits"] = captured_vs_eager(torch, engine.device, forward)
    return out


def walk_kernel_names(source: str) -> list[str]:
    """The __global__ functions of one of the port's CUDA sources."""
    import re

    text = (ROOT / "dynamo_tpu_torch" / "csrc" / source).read_text()
    return re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)", text)


def profiled_ms(torch, fn, iters: int, names) -> tuple[float, float, int]:
    """``fn`` run ``iters`` times under torch.profiler: (device ms of all
    kernels, device ms of the kernels named in ``names``, their launches),
    each over ``iters``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = walk = 0.0
    launches = 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        total += us
        tail = ev.key.removeprefix("void ").removeprefix("(anonymous namespace)::")
        tail = tail.removeprefix("rtc::")
        if any(tail.startswith((f"{n}(", f"{n}<")) for n in names):
            walk += us
            launches += ev.count
    return total / iters / 1e3, walk / iters / 1e3, launches // iters


def window_bound(torch, engine, lens, w: int, mla: bool) -> dict:
    """The least time of one layer's window attention call of a verify
    window at contexts ``lens``: phase kernels' bound (``decode_case``,
    ``mla_bound``) at the engine's shapes and table width."""
    cfg, bs = engine.config.model, engine.config.block_size
    lanes, width = len(lens), engine.max_blocks_per_seq
    cache_elem = engine.cache["k"].element_size()
    meta = lanes * width * 4 + lanes * 4
    if mla:
        per_query, union = window_positions(lens, w, width * bs)
        return mla_bound(torch, pages=sum(-(-n // bs) for n in union), bs=bs,
                         r=cfg.kv_lora_rank, p=cfg.qk_rope_head_dim, h=cfg.num_heads,
                         dtype=torch.bfloat16, q_rows=lanes * w, meta_bytes=meta,
                         visible=per_query, cache_elem=cache_elem)
    return gqa_bound(lens, w, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, width * bs,
                     cache_elem, 2, meta)


def split_step_ms(torch, engine, walk: str) -> dict:
    """The greedy verify window's and a 512-token continued prefill's time,
    by graph replay and eagerly on the same buffers: CUDA events around
    back-to-back calls, the device's own time under torch.profiler, and the
    window attention's (``walk``, a csrc file: its walk and combine) device
    ms a layer's call inside the graph and eagerly, beside its bound."""
    names = walk_kernel_names(walk)
    vg, pg = engine._verify, engine._prefill
    layers = engine.config.model.num_layers

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

    _, lens = verify_window(torch, engine, False)
    out = {"window_bound": window_bound(torch, engine, lens, vg.w, walk == "mla_attention.cu"),
           "window_lens": lens}
    for mode, fn, iters in (("replay", lambda: vg.run(False), REPLAY_ITERS),
                            ("eager", lambda: vg.step(False), 5)):
        dev_ms, walk_ms, launches = profiled_ms(torch, fn, 5, names)
        out[f"verify_{mode}"] = {
            "ms": timed(fn, iters), "device_ms": dev_ms,
            "window_kernel_device_ms": walk_ms / layers,
            "window_kernels_per_window": launches, "layers": layers,
            "share_of_bound": out["window_bound"]["bound_ms"] / (walk_ms / layers)}
    key = SPEC_PREFILL_KEYS[1]
    prefill_window(torch, engine, key, False)
    for mode, fn in (("replay", lambda: pg.run(key)), ("eager", lambda: pg.step(key))):
        dev_ms, _, _ = profiled_ms(torch, fn, 3, names)
        out[f"prefill_{mode}"] = {"key": list(key), "ms": timed(fn, 3), "device_ms": dev_ms}
    return out


def spec_graph_checks(torch, engine, walk: str) -> dict:
    """Phase spec's checks on the served engine (its thread stopped): the
    verify and prefill replays against eager, and their times."""
    return {"verify": verify_replay_vs_eager(torch, engine),
            "prefill": prefill_replay_vs_eager(torch, engine),
            "ms": split_step_ms(torch, engine, walk), "pool_bound_mb": pool_bound_mb(engine)}


def spec_traffic(torch, card: str, model: str, config: dict, path, inspect=None) -> dict:
    """Phase serve's traffic on a speculative engine (its chats repeat a
    phrase): served and counted as in phase serve, each split prefill and
    verify call clocked (``split_step_clock``), then the traffic once more
    under a trace for their device ms.  Returns phase_serve's result and
    ``line``, the numbers of the ``smoke_spec`` line."""
    import tempfile

    from dynamo_tpu_torch.engine import TorchLlmEngine

    with tempfile.TemporaryDirectory() as trace_dir, split_step_clock(TorchLlmEngine) as walls:
        res = phase_serve(card, "spec", model, config, path, overrides=SPEC,
                          short_prompts=SPEC_PROMPTS, profile=False, inspect=inspect,
                          clock=walls, traced=trace_dir)
    run, e2e, trace = res["run"], res["e2e"], res["trace"]
    res["line"] = {
        "model": model, "card": card, **SPEC,
        **{k: run[k] for k in ("spec_drafted_tokens_total", "spec_accepted_tokens_total",
                               "spec_rejected_tokens_total", "spec_verify_steps_total")},
        **{k: e2e[k] for k in ("output_tok_s", "ttft_ms_p50", "ttft_ms_p99", "itl_ms_p50",
                               "itl_ms_p99", "wall_s")},
        **res["walls"],
        "device_ms_per_call": {name.removeprefix("smoke."): a["device_ms_per_range"]
                               for name, a in trace["annotations"].items()},
        "traced_calls": {name.removeprefix("smoke."): a["ranges"]
                         for name, a in trace["annotations"].items()},
        "traced_device_idle_share": trace["device_idle_share"],
        "launches": res["launched"],
    }
    return res


# phase spec's (and phase quant's speculative runs') configurations: the
# published widths, Llama-3-8B at a quarter of its depth (8 of 32 layers)
# and DeepSeek-V2-Lite at half (14 of 27; at 7 its random
# weights drafted nothing in phase quant), so that the whole smoke keeps
# inside its time with phases guided, disagg and meshfeat
SPEC_CONFIGS = {"llama": dict(LLAMA3_8B, num_hidden_layers=8),
                "mla": dict(DEEPSEEK_V2_LITE, num_hidden_layers=14)}


def phase_spec(torch, card: str) -> dict:
    """Speculative decoding end to end on the card: the tiny model exactly,
    then the Llama-3-8B geometry and the published DeepSeek-V2-Lite config
    at full width and 8 and 14 layers (``SPEC_CONFIGS``) over HTTP
    (``spec_traffic``), every split
    prefill and verify window a graph replay captured by ``warmup()``:
    no capture after it, the verify kernels launched a layer a replayed
    window, replays bitwise equal to eager (``spec_graph_checks``)."""
    tiny = phase_spec_tiny(torch)
    out = {"tiny": tiny}
    for key, model, config, path, walk in (
        ("llama", "llama3-8b-spec", SPEC_CONFIGS["llama"], LLAMA_SPEC_PATH, "paged_attention.cu"),
        ("mla", "deepseek-v2-lite-spec", SPEC_CONFIGS["mla"], MLA_SPEC_PATH, "mla_attention.cu"),
    ):
        gc.collect()  # the previous engine is shut down: free its memory first
        torch.cuda.empty_cache()
        res = spec_traffic(torch, card, model, config, path,
                           inspect=lambda e, walk=walk: spec_graph_checks(torch, e, walk))
        run, stats, checks = res["run"], res["stats"], res["inspect"]
        layers = config["num_hidden_layers"]
        kinds = ("unified", "decode", "prefill", "verify")
        line = res["line"] | {
            "graphs_captured": {k: stats[f"{k}_graphs_captured"] for k in kinds},
            "graphs_captured_after_warmup": {
                k: stats[f"{k}_graphs_captured_after_warmup"] for k in kinds},
            "graph_pool_mb": {k: stats[f"{k}_graph_pool_mb"] for k in kinds},
            "prefill_capture_ms": stats["prefill_graph_capture_ms"],
            "prefill_pool_bound_mb": checks["pool_bound_mb"],
            "warmup_s": stats["warmup_s"],
            "replays": {k: run[k] for k in ("prefill_graph_replays_total",
                                            "verify_graph_replays_total")},
            "split_step_ms": checks["ms"],
            "verify_replay": checks["verify"], "prefill_replay": checks["prefill"],
        }
        print(json.dumps({"smoke_spec": line}), flush=True)
        failures = []
        if run["spec_verify_steps_total"] <= 0:
            failures.append(f"no verify step ran: {run}")
        if any(line["graphs_captured_after_warmup"].values()):
            failures.append(f"a graph was captured after warmup: {line['graphs_captured_after_warmup']}")
        if line["graph_pool_mb"]["prefill"] > line["prefill_pool_bound_mb"]:
            failures.append(f"the prefill pool {line['graph_pool_mb']['prefill']} MB passed "
                            f"key_bytes of its largest key, {line['prefill_pool_bound_mb']} MB")
        if run["verify_graph_replays_total"] != run["spec_verify_steps_total"]:
            failures.append(f"a verify window was not a graph replay: {run}")
        prefills = res["walls"]["split_prefill_wall_ms"]["calls"]
        if not 0 < run["prefill_graph_replays_total"] == prefills:
            failures.append(f"{run['prefill_graph_replays_total']} prefill graph replays for "
                            f"{prefills} split prefills")
        window = res["counts"][path[0]]
        if window != layers * run["verify_graph_replays_total"]:
            failures.append(f"{path[0]} = {window}, not {layers} layers x "
                            f"{run['verify_graph_replays_total']} verify replays")
        for name, res_ in (*checks["verify"].items(), *checks["prefill"].items()):
            if (not res_["bitwise"]) if name.endswith("logits") else not all(res_.values()):
                failures.append(f"replay and eager differ ({name}): {res_}")
        if failures:
            raise AssertionError(f"{model}: " + "; ".join(failures))
        out[key] = res
    return out


# ---------------------------------------------------------------------------
# phase longctx: a speculative server at the model's own context length
# ---------------------------------------------------------------------------

# the geometry's own context length (the tiny tokenizer's model card says
# 2048, which serve_http would take by default)
LONGCTX_ENGINE = dict(num_blocks=1024, max_batch_size=8, seed=0,
                      max_model_len=LLAMA3_8B["max_position_embeddings"], **SPEC)
LONGCTX_PROMPTS = (7000, 40, 300, 900)  # tokens: a whole prompt at the 8192 bucket, and three


def peak_vs_key_bytes(torch, engine, key: tuple) -> dict:
    """``key``'s step run eagerly with nothing valid: its peak allocation
    beside ``PrefillGraph.key_bytes``, the estimate warmup budgets by."""
    pg = engine._prefill
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pg.step(key, idle=True)
    torch.cuda.synchronize()
    cfg = engine.config
    scores = cfg.model.num_heads * key[1] * (
        key[1] + (key[2] * cfg.block_size if key[0] == "prefix" else 0)) * 4
    peak = torch.cuda.max_memory_allocated() - base
    return {"key": list(key), "peak_mb": peak / 2**20, "key_bytes_mb": pg.key_bytes(key) / 2**20,
            "scores_mb": scores / 2**20, "peak_over_scores": peak / scores}


def pool_bound_mb(engine) -> float:
    """``key_bytes`` of the largest split prefill key warmup captured, MB:
    the pool its captures add must stay under it (the pool holds the
    largest step, not the sum)."""
    pg = engine._prefill
    return max((pg.key_bytes(k) for k in pg.keys if k not in pg.deferred), default=0) / 2**20


def phase_longctx(torch, card: str) -> dict:
    """A speculative server at the Llama-3-8B geometry's own context length
    (8192 positions), full width and depth.  First, on an engine that
    captured nothing, the largest split prefill keys run eagerly: their
    measured peak beside ``PrefillGraph.key_bytes``, the estimate warmup
    budgets by, which must not be under it.  Then the server, warmed by
    default (no prompt lengths): ``warmup()`` captures every key whose
    activations fit the free memory (the rest left to first use), and a
    7000-token prompt beside three short ones is served with no capture
    after warmup.  Logs the warmup seconds, the captures, the keys left to
    first use and the pool."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.serve import build_torch_engine, serve_http

    path = model_dir("llama3-8b-longctx", LLAMA3_8B)
    engine = build_torch_engine(path, ModelDeploymentCard.from_local_path(path),
                                **LONGCTX_ENGINE)
    peaks = [peak_vs_key_bytes(torch, engine, key) for key in sorted(
        engine._prefill.keys, key=engine._prefill.key_bytes, reverse=True)[:3]]
    log(f"[longctx] eager peaks: {peaks}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    async def drive():
        t0 = time.perf_counter()
        handle = await serve_http(path, model_name="llama3-8b-longctx", host="127.0.0.1",
                                  port=0, **LONGCTX_ENGINE)
        load_s = time.perf_counter() - t0
        engine = handle.engine
        try:
            warm = engine.stats()
            rng = random.Random(8)
            prompts = [[rng.randrange(3, LLAMA3_8B["vocab_size"]) for _ in range(n)]
                       for n in LONGCTX_PROMPTS]
            t0 = time.perf_counter()
            streams = await asyncio.gather(*(generate_tokens(engine, p, 8) for p in prompts))
            wall = time.perf_counter() - t0
            stats = engine.stats()
            reserved = torch.cuda.memory_reserved() / 2**20
        finally:
            await handle.shutdown()
        return engine, warm, stats, streams, wall, load_s, reserved

    engine, warm, stats, streams, wall, load_s, reserved = asyncio.run(drive())
    kinds = ("unified", "decode", "prefill", "verify")
    line = {
        "model": "llama3-8b-longctx", "card": card, "max_model_len": engine.max_len,
        **LONGCTX_ENGINE, "load_s": load_s, "warmup_s": warm["warmup_s"],
        "prefill_keys": len(engine._prefill.keys),
        "keys_left_to_first_use": warm["prefill_graph_keys_deferred"],
        "graphs_captured": {k: warm[f"{k}_graphs_captured"] for k in kinds},
        "graph_pool_mb": {k: warm[f"{k}_graph_pool_mb"] for k in kinds},
        "device_reserved_mb_serving": reserved,
        "graphs_captured_after_warmup": {k: stats[f"{k}_graphs_captured_after_warmup"]
                                         for k in kinds},
        "served_wall_s": wall, "tokens": [len(t) for t in streams],
        "prefill_graph_replays": stats["prefill_graph_replays_total"], "eager_peaks": peaks,
        "prefill_pool_bound_mb": pool_bound_mb(engine),
    }
    print(json.dumps({"smoke_longctx": line}), flush=True)
    del engine
    failures = []
    if line["max_model_len"] != LLAMA3_8B["max_position_embeddings"]:
        failures.append(f"max length {line['max_model_len']}, not the model's own")
    if any(line["graphs_captured_after_warmup"].values()):
        failures.append("a graph was captured after warmup")
    if line["tokens"] != [8] * len(LONGCTX_PROMPTS):
        failures.append(f"streams of {line['tokens']} tokens")
    if not warm["prefill_graphs_captured"] or stats["prefill_graph_replays_total"] < 4:
        failures.append("the split prefills were not graph replays")
    for peak in peaks:
        if peak["peak_mb"] > peak["key_bytes_mb"]:
            failures.append(f"key_bytes under the measured peak: {peak}")
    if line["graph_pool_mb"]["prefill"] > line["prefill_pool_bound_mb"]:
        failures.append(f"the prefill pool passed key_bytes of its largest key: {line}")
    if failures:
        raise AssertionError("longctx: " + "; ".join(failures))
    return line


# ---------------------------------------------------------------------------
# phase quant: fp8 KV caches and int8 weight-only projections
# ---------------------------------------------------------------------------

QUANT_CACHES = ("float8_e4m3fn", "float8_e5m2")
# the served quantized configurations at phase spec's depth (half of each
# model's layers, every width the published one's), to keep the whole
# smoke's time for phase pp
QUANT_CONFIGS = SPEC_CONFIGS
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
    an fp8 cache and the DeepSeek-V2-Lite config with an fp8 cache (at 8
    and 14 layers, ``QUANT_CONFIGS``), each
    served over HTTP after ``warmup()`` (the counted traffic of phase serve,
    the decode profile, the replays against eager, MFU and bandwidth share
    from ``stats()``), then each again with n-gram speculation (the verify
    kernels on the fp8 cache)."""
    out = {"kernels": quant_kernels(torch)}
    for key, model, config, overrides, path, spec_path in (
        ("llama", "llama3-8b-quant", QUANT_CONFIGS["llama"], QUANT_LLAMA, LLAMA_PATH,
         LLAMA_SPEC_PATH),
        ("mla", "deepseek-v2-lite-quant", QUANT_CONFIGS["mla"], QUANT_MLA, MLA_PATH,
         MLA_SPEC_PATH),
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
        # the speculative engine at phase spec's geometry
        spec = phase_serve(card, f"quant:{key}:spec", f"{model}-spec", SPEC_CONFIGS[key], spec_path,
                           overrides={**overrides, **SPEC},
                           short_prompts=SPEC_PROMPTS, profile=False)
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
# demand paging (no prefetch pager), so its restores compare with earlier runs
OFFLOAD = dict(num_blocks=256, max_batch_size=8, max_model_len=4096,
               host_offload_blocks=192, disk_offload_blocks=128, prefetch=False)
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
    """Wait until the engine holds no sequence and no queued offload or
    restore (their copies land, and their times are counted, at a loop
    top).  With decode overlapped a finished request releases its lane one
    window late, so a request sent at once may land on another lane;
    DeepSeek's MoE, whose expert capacity (one pair an expert at eight
    lanes) is filled in lane order, gives a request other tokens on another
    lane.  Requests compared for equal tokens start from the same free
    lanes."""
    t0 = time.perf_counter()
    while (engine.scheduler.num_running or getattr(engine, "_queued_restores", None)
           or getattr(engine, "_queued_offloads", None)):
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


# ---------------------------------------------------------------------------
# phase guided: guided JSON decoding on the card
# ---------------------------------------------------------------------------

GUIDED_ENGINE = dict(num_blocks=512, max_batch_size=8, max_model_len=1024, seed=0)
GUIDED_OSL = 64
# the lanes of the mixed burst: (guided, seeded) each
GUIDED_LANES = ((True, False),) * 2 + ((True, True),) * 2 + ((False, False),) * 4


async def sampled_stream(engine, tokens: list[int], max_tokens: int, *, seed=None,
                         output_format=None, stamps: list | None = None):
    """One request's (ids, finish reason): greedy, or seeded at temperature
    0.9; ``output_format`` "json" guides it."""
    from dynamo_tpu_torch.llm.protocols.common import (
        Annotated,
        LLMEngineOutput,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    sampling = (SamplingOptions(use_greedy=True) if seed is None
                else SamplingOptions(temperature=0.9, seed=seed))
    req = PreprocessedRequest(token_ids=tokens, sampling=sampling,
                              stop=StopConditions(max_tokens=max_tokens),
                              eos_token_ids=[1], output_format=output_format).to_wire()
    out, finish = [], None
    async for item in await engine.generate(Context(req)):
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is None:
            continue
        if ann.data.error:
            raise RuntimeError(ann.data.error)
        out.extend(ann.data.token_ids)
        if stamps is not None and ann.data.token_ids:
            stamps.append(time.perf_counter())
        finish = ann.data.finish_reason or finish
    return out, None if finish is None else finish.value


def itl_p50_ms(stamps: list[list[float]]) -> float | None:
    gaps = sorted(b - a for m in stamps for a, b in zip(m, m[1:]))
    return gaps[len(gaps) // 2] * 1e3 if gaps else None


def phase_guided(torch, card: str, config: dict = LLAMA3_8B, device: str = "cuda",
                 engine_kw: dict = GUIDED_ENGINE, osl: int = GUIDED_OSL) -> dict:
    """Guided JSON decoding at ``config``'s geometry (all layers, random
    bf16 weights from seed 0), the table built from the tiny model's
    tokenizer.  An engine built by the launch path (``build_torch_engine``:
    the table installed) and one over its weights warmed by ``warmup()``
    before its table is installed; on the latter, eight lanes at once (two
    guided greedy, two guided seeded, four unguided, ``osl`` tokens each):
    every guided stream a JSON prefix (a closed one parses), the guided
    counters right, the decode graph replayed (no capture after warmup) and
    row 2 launched; the unguided lanes alone give the same ids as on an
    engine with no table; a decode window with guided lanes by graph replay
    equals the same step eagerly (greedy and seeded), each guided lane's
    token admissible in its mode.  Prints the table's build time and ITL p50
    with and without guided lanes."""
    import tempfile

    from dynamo_tpu_torch.llm import guided
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
    from dynamo_tpu_torch.serve import build_torch_engine

    path = model_dir("llama3-8b-guided", config)
    tok = HfTokenizer.from_model_dir(path)
    with tempfile.TemporaryDirectory(dir=ROOT / "dynamo_tpu_torch" / "_build") as cache:
        t0 = time.perf_counter()
        masks, strings = guided.build_for_tokenizer(tok, cache_dir=cache)
        build_s = time.perf_counter() - t0
    served = build_torch_engine(path, ModelDeploymentCard.from_local_path(path), device=device,
                                **engine_kw)
    if served.guided_masks is None or not holds_table(served._guided_table, masks):
        raise AssertionError("the launch path did not install the guided table")
    engine = sibling_engine(served)   # no table until after its warmup
    bare = sibling_engine(served)     # never a table
    vocab = config["vocab_size"]
    rng = random.Random(0)
    prompts = [[rng.randrange(3, vocab) for _ in range(24 + 8 * i)] for i in range(8)]
    eos = tok.eos_token_ids

    async def drive() -> dict:
        out: dict = {"table_build_s": build_s}
        engine.start()
        bare.start()
        try:
            await engine.warmup()
            t0 = time.perf_counter()
            engine.set_guided(masks, strings, eos)  # after warmup: the graphs read it in place
            out["table_install_ms"] = (time.perf_counter() - t0) * 1e3
            before = engine.stats()
            zero_counters()
            stamps = [[] for _ in GUIDED_LANES]
            results = await asyncio.gather(*[
                sampled_stream(engine, p, osl, seed=(100 + i) if seeded else None,
                               output_format="json" if g else None, stamps=stamps[i])
                for i, (p, (g, seeded)) in enumerate(zip(prompts, GUIDED_LANES))])
            counts = read_counters()
            after = engine.stats()
            await settled(engine)
            checks = []
            completed = 0
            for (ids, finish), (g, _) in zip(results, GUIDED_LANES):
                if not g:
                    continue
                cursor = guided.JsonCursor(masks, strings, eos_ids=eos)
                for t in ids:
                    cursor.advance(t)
                    if cursor.failed:
                        raise AssertionError(f"guided stream left JSON at {t}: {ids}")
                completed += cursor.complete
                text = tok.decode(ids, skip_special_tokens=True)
                if finish == "stop" and cursor.complete:
                    json.loads(text)
                checks.append({"tokens": len(ids), "finish": finish,
                               "complete": cursor.complete, "text": text[:80]})
            out["guided"] = checks
            out["counters"] = {k: after[k] for k in ("guided_requests_total",
                                                     "guided_completions_total")}
            if out["counters"] != {"guided_requests_total": 4,
                                   "guided_completions_total": completed}:
                raise AssertionError(f"guided counters {out['counters']}, {completed} completed")
            replays = after["decode_graph_replays_total"] - before["decode_graph_replays_total"]
            if after["decode_graphs_captured_after_warmup"] or (
                    device == "cuda" and replays <= 0):
                raise AssertionError(f"decode graph: {replays} replays, "
                                     f"{after['decode_graphs_captured_after_warmup']} late")
            if device == "cuda" and (counts["paged_attention.launches"] <= 0
                                     or counts["plain_calls"]):
                raise AssertionError(f"guided decode windows missed row 2: {counts}")
            out["decode_graph_replays"] = replays
            out["unified_fallbacks"] = after["unified_fallbacks"]
            out["itl_p50_ms_mixed"] = itl_p50_ms(stamps)
            # the unguided lanes alone, with and without a table: the same ids
            # (the burst's prefixes flushed first: a prefix hit computes the
            # prompt's tail alone, in bf16 other bits than a whole prompt).
            # Each engine's loop is stopped while the four are queued and
            # started after, so both take them in one first window: a
            # window's bf16 sums depend on its mates, and prompts that reach
            # a running loop apart land in windows that differ by engine.
            await engine.clear_kv_blocks()
            plain = [p for p, (g, _) in zip(prompts, GUIDED_LANES) if not g]
            alone = []
            for e in (engine, bare):
                st = [[] for _ in plain]
                e.stop()
                tasks = [asyncio.ensure_future(sampled_stream(e, p, osl, stamps=st[i]))
                         for i, p in enumerate(plain)]
                await asyncio.sleep(0.05)
                e.start()
                alone.append(await asyncio.gather(*tasks))
                await settled(e)
                if e is engine:
                    out["itl_p50_ms_unguided"] = itl_p50_ms(st)
            if alone[0] != alone[1]:
                raise AssertionError("unguided lanes differ once a table is installed")
            out["unguided_equal_without_table"] = True
        finally:
            engine.stop()
            bare.stop()
        return out

    out = asyncio.run(drive())
    if device == "cuda":
        out["replay_vs_eager"] = guided_replay_vs_eager(torch, engine, masks, tok)
    log(f"[guided] {card}: table built in {build_s:.3f} s ({masks.mask.shape}); "
        f"ITL p50 {out['itl_p50_ms_mixed']:.2f} ms with guided lanes, "
        f"{out['itl_p50_ms_unguided']:.2f} ms without")
    print("smoke_guided " + json.dumps({"card": card, **out}), flush=True)
    del engine, bare, served
    return out


def guided_replay_vs_eager(torch, engine, masks, tok) -> dict:
    """A decode window of guided lanes in several automaton modes (and
    unguided ones), replayed and run eagerly on the same buffers of the
    idle engine: bitwise equal, each guided lane's token admissible in its
    mode."""
    cursors = []
    walk = [tok.encode(x)[0] for x in ("{", '"', "a", '"', ":", " ", "[")]
    for lane in range(engine.config.max_batch_size):
        if lane % 4 == 3:
            cursors.append(None)
            continue
        c = engine._make_guided_cursor("json")
        for t in walk[: lane + 1]:
            c.advance(t)
        cursors.append(c)
    rve, _ = replay_vs_eager(torch, engine, cursors=cursors)
    width = masks.mask.shape[1]
    for mode, res in rve.items():
        if not all(v for k, v in res.items() if k != "tokens"):
            raise AssertionError(f"guided decode window: replay != eager ({mode}): {res}")
        for c, t in zip(cursors, res["tokens"]):
            if c is not None and c.mode_id >= 0 and not (t < width and masks.mask[c.mode_id, t]):
                raise AssertionError(f"guided lane sampled an inadmissible {t} ({mode})")
    rve["modes"] = [None if c is None else c.mode_id for c in cursors]
    return rve


def holds_table(table, masks) -> bool:
    """The engine's resident table holds ``masks`` (padded with False)."""
    import numpy as np

    want = np.zeros(tuple(table.shape), bool)
    width = min(masks.mask.shape[1], table.shape[1])
    want[:, :width] = masks.mask[:, :width]
    return bool((table.cpu().numpy() == want).all())


# ---------------------------------------------------------------------------
# phase disagg: disaggregated prefill/decode over the KV transfer plane
# ---------------------------------------------------------------------------

# the decode side's engine and the one engine held against it: the split
# prefill in 512-token chunks on both (the prefill engine's route), the
# decode window graphed
DISAGG_ENGINE = dict(num_blocks=1216, max_batch_size=8, max_model_len=2304, seed=0,
                     prefill_buckets=(512,), prefill_chunk_tokens=512)
DISAGG_PREFILL = dict(DISAGG_ENGINE, num_blocks=320, unified_batch=False)
DISAGG_PROMPTS = 8
DISAGG_ISL = 2048
DISAGG_OSL = 32
DISAGG_LAUNCH_S = 600

DISAGG_WORKER = """
import asyncio, json, sys
from pathlib import Path

async def main():
    from dynamo_tpu_torch.engine.graphs import launch_counters
    from dynamo_tpu_torch.llm.disagg import PrefillQueue, PrefillWorker
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.serve import build_torch_engine
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    path, address, kw = Path(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
    engine = build_torch_engine(path, ModelDeploymentCard.from_local_path(path), **kw)
    engine.start()
    rt = await DistributedRuntime.create(RuntimeConfig(control_plane=address))
    worker = PrefillWorker(rt, engine, PrefillQueue(rt, "smoke", "disagg_tcp"), stream=True)
    worker.start()
    print("PREFILL_READY", flush=True)
    while not await rt.plane.kv.get("smoke/disagg/done"):
        await asyncio.sleep(0.1)
    counts = {f"{m.__name__.rsplit('.', 1)[1]}.{n}": v for (m, n), v in launch_counters().items()}
    await rt.plane.kv.put("smoke/disagg/prefill", json.dumps(dict(
        counts=counts, extract_calls=engine.extract_calls, **worker.stats())).encode())
    await worker.stop()
    engine.stop()
    await rt.close()

asyncio.run(main())
"""


def phase_disagg(torch, card: str, config: dict = LLAMA3_8B, device: str = "cuda",
                 engine_kw: dict = DISAGG_ENGINE, prefill_kw: dict = DISAGG_PREFILL,
                 n_prompts: int = DISAGG_PROMPTS, isl: int = DISAGG_ISL,
                 osl: int = DISAGG_OSL, max_local: int = 512) -> dict:
    """Disaggregated prefill/decode at ``config``'s geometry (all layers,
    random bf16 weights from seed 0): ``n_prompts`` prompts of ``isl``
    tokens, ``osl`` out, half greedy and half seeded, every prefill remote
    (``max_local_prefill_length`` 512).  One engine serves them alone
    first.  Then the pair of the launch path in this process
    (``launch_disagg_decode_worker`` / ``launch_prefill_workers`` over one
    set of weights and the memory control plane): the same-process
    ``device`` route, streamed (chunks of 512) and single-shot; then the
    ``host_tcp`` route, the prefill worker in a second process on the same
    card over the control-plane server, streamed.  Every route's streams
    byte-identical to the one engine's; rows 6-7 launched once a cache leaf
    for each extract and inject, no plain version on the card; two topology
    cards on the plane and the prober's measured bandwidth in
    ``dynctl topology``'s table.  Prints TTFT p50 local and remote, GB/s a
    route (the decode side's inject-active bytes, and the headline's
    ``kv_xfer`` rung), rows 6-7's device ms a call at the path's shapes and
    the streamed share hidden behind prefill.  Frees both engines."""
    from dynamo_tpu_torch.bench.headline import measure_kv_xfer
    from dynamo_tpu_torch.cli.dynctl import render_topology
    from dynamo_tpu_torch.llm.disagg import DisaggConfig, DisaggDecodeEngine, DisaggRouter
    from dynamo_tpu_torch.llm.disagg import PrefillQueue, PrefillWorker
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.ops.kernels.block_copy import gather_blocks, scatter_blocks
    from dynamo_tpu_torch.runtime.controlplane.server import ControlPlaneServer
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.serve import build_torch_engine, launch_disagg_decode_worker
    from dynamo_tpu_torch.serve import launch_prefill_workers
    from dynamo_tpu_torch.topology import CARDS_PREFIX
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    path = model_dir("llama3-8b-disagg", config)
    mdc = ModelDeploymentCard.from_local_path(path)
    rng = random.Random(0)
    vocab = config["vocab_size"]
    prompts = [[rng.randrange(3, vocab) for _ in range(isl)] for _ in range(n_prompts)]
    seeds = [None if i % 2 == 0 else 200 + i for i in range(n_prompts)]
    env0 = {k: os.environ.get(k) for k in ("DYN_TOPO", "DYN_TOPO_PROBE_PERIOD_S", "DYN_KV_STREAM")}
    os.environ.update(DYN_TOPO="1", DYN_TOPO_PROBE_PERIOD_S="0.5", DYN_KV_STREAM="1")
    log_path = ROOT / "dynamo_tpu_torch" / "_build" / "disagg_prefill_worker.log"

    async def traffic(engine, ttfts: list) -> list:
        async def one(p, seed):
            t0 = time.perf_counter()
            st: list = []
            res = await sampled_stream(engine, p, osl, seed=seed, stamps=st)
            ttfts.append((st[0] - t0) * 1e3)
            return res
        return list(await asyncio.gather(*[one(p, s) for p, s in zip(prompts, seeds)]))

    async def drive() -> dict:
        out: dict = {}
        cp = ControlPlaneServer(port=0)
        await cp.start()
        address = f"127.0.0.1:{cp.port}"
        log_file = open(log_path, "wb")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-c", DISAGG_WORKER, str(path), address,
            json.dumps({**prefill_kw, "device": device}), cwd=str(ROOT), env=env,
            stdout=asyncio.subprocess.PIPE, stderr=log_file)
        handles: list = []
        decode_handle = rt = rt_tcp = tcp_decode = None
        try:
            # the one engine: the prompts alone, local prefill
            one = build_torch_engine(path, mdc, device=device, **{**engine_kw,
                                                                  "unified_batch": False})
            params = one.params
            one.start()
            try:
                local_ttft: list = []
                want = await traffic(one, local_ttft)
            finally:
                one.stop()
            del one
            out["ttft_p50_ms_local"] = sorted(local_ttft)[len(local_ttft) // 2]

            # the pair of the launch path, same process: the device route
            rt = await DistributedRuntime.create(RuntimeConfig(control_plane="memory://smoke-disagg"))
            queue = PrefillQueue(rt, "dynamo", "backend")
            decode_handle = await launch_disagg_decode_worker(
                rt, path, queue, max_local_prefill_length=max_local, device=device, params=params,
                **engine_kw)
            disagg = decode_handle.engine
            decode = disagg.engine
            handles = await launch_prefill_workers(rt, path, queue, device=device, params=params,
                                                   **prefill_kw)
            pre, pump = handles[0].engine, handles[0].pump
            leaves = len(decode.cache)
            routes = {}
            for mode, stream in (("device_streamed", True), ("device_single_shot", False)):
                # each route prefills from scratch, as the one engine did (a
                # prefix hit would compute the tail alone: other bf16 bits)
                await pre.clear_kv_blocks()
                await pump.stop()
                pump = handles[0].pump = PrefillWorker(rt, pre, queue, stream=stream)
                if handles[0].watcher is not None:
                    pump.attach_topology(handles[0].watcher.map,
                                         self_worker_id=handles[0].lease.id)
                pump.start()
                base = disagg.stats()
                x0, i0 = pre.extract_calls, decode.inject_calls
                zero_counters()
                ttfts: list = []
                got = await traffic(disagg, ttfts)
                await settled(decode)
                counts = read_counters()
                cur = disagg.stats()
                extracts, injects = pre.extract_calls - x0, decode.inject_calls - i0
                routes[mode] = check_route(mode, got, want, counts, extracts, injects, leaves,
                                           base, cur, ttfts, n_prompts, local=True,
                                           card=device == "cuda")
            out["routes"] = routes
            # the topology plane: both cards published, the prober's bandwidth
            cards = await rt.plane.kv.get_prefix(CARDS_PREFIX)
            roles = sorted(json.loads(e.value)["role"] for e in cards)
            topo_map = handles[0].watcher.map
            for _ in range(100):
                link = topo_map.link(handles[0].lease.id, decode_handle.service.instance.instance_id)
                if link is not None and link.measured_bps > 0:
                    break
                await asyncio.sleep(0.1)
            table = render_topology(topo_map.to_dict())
            if roles != ["decode", "prefill"] or link is None or link.measured_bps <= 0:
                raise AssertionError(f"topology: cards {roles}, link {link}\n{table}")
            out["topology"] = {"cards": roles, "probe_gbps": link.measured_bps / 1e9,
                               "rtt_ms": link.rtt_s * 1e3, "hop": link.hop,
                               "probes": link.probes_total}
            log("[disagg] dynctl topology:\n" + table)
            # the plane's microbench at the path's engine (the headline rung)
            out["kv_xfer"] = await measure_kv_xfer(decode)
            # rows 6-7 a call at the path's shapes: one leaf, a prompt's blocks
            ids = list(range(-(-isl // decode.config.block_size)))
            leaf = decode.cache["k"]
            blocks = gather_blocks(leaf, ids, axis=1)
            if device == "cuda":
                out["row6_device_ms"] = device_ms(lambda: gather_blocks(leaf, ids, axis=1))
                out["row7_device_ms"] = device_ms(
                    lambda: scatter_blocks(leaf, blocks, ids, axis=1))
            else:
                out["row6_device_ms"] = out["row7_device_ms"] = "not measured"
            await decode.clear_kv_blocks()

            # the host_tcp route: the prefill worker in the second process
            line = await asyncio.wait_for(proc.stdout.readline(), DISAGG_LAUNCH_S)
            if b"PREFILL_READY" not in line:
                raise AssertionError(f"prefill process: {line!r}; see {log_path}")
            rt_tcp = await DistributedRuntime.create(RuntimeConfig(control_plane=address))
            router = DisaggRouter(rt_tcp, "tcp", DisaggConfig(max_local_prefill_length=max_local))
            tcp_decode = DisaggDecodeEngine(rt_tcp, decode, router,
                                            PrefillQueue(rt_tcp, "smoke", "disagg_tcp"))
            await tcp_decode.start()
            base = tcp_decode.stats()
            i0 = decode.inject_calls
            zero_counters()
            ttfts = []
            got = await traffic(tcp_decode, ttfts)
            await settled(decode)
            counts = read_counters()
            await rt_tcp.plane.kv.put("smoke/disagg/done", b"1")
            remote = None
            for _ in range(300):
                remote = await rt_tcp.plane.kv.get("smoke/disagg/prefill")
                if remote:
                    break
                await asyncio.sleep(0.1)
            remote = json.loads(remote.value if hasattr(remote, "value") else remote)
            rc = remote["counts"]
            counts["block_copy.gather_launches"] = rc["block_copy.gather_launches"]
            counts["plain_calls"] += sum(v for k, v in rc.items() if k.endswith("plain_calls"))
            routes["host_tcp_streamed"] = check_route(
                "host_tcp_streamed", got, want, counts, remote["extract_calls"],
                decode.inject_calls - i0, leaves, base, tcp_decode.stats(), ttfts, n_prompts,
                local=False, card=device == "cuda")
            out["prefill_process"] = {k: remote[k] for k in ("prefills_done",
                                                              "kv_parts_sent_total")}
            out["launches"] = {
                "gather_blocks": sum(r["gather_launches"] for r in routes.values()),
                "scatter_blocks": sum(r["scatter_launches"] for r in routes.values())}
            return out
        finally:
            if tcp_decode is not None:
                await tcp_decode.stop()
            if rt_tcp is not None:
                await rt_tcp.close()
            for h in handles:
                await h.stop()
            if decode_handle is not None:
                await decode_handle.shutdown()
            if rt is not None:
                await rt.close()
            if proc.returncode is None:
                try:
                    await asyncio.wait_for(proc.wait(), 30)
                except asyncio.TimeoutError:
                    proc.kill()
                    await proc.wait()
            log_file.close()
            await cp.stop()

    try:
        out = asyncio.run(drive())
    finally:
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"[disagg] {card}: TTFT p50 local {out['ttft_p50_ms_local']:.1f} ms, remote "
        + ", ".join(f"{k} {r['ttft_p50_ms']:.1f} ms ({r['inject_gbps']:.2f} GB/s inject)"
                    for k, r in out["routes"].items())
        + f"; kv_xfer {out['kv_xfer']}; row 6 {out['row6_device_ms']} ms, "
        f"row 7 {out['row7_device_ms']} ms a call")
    print("smoke_disagg " + json.dumps({"card": card, **out}), flush=True)
    return out


def check_route(mode: str, got, want, counts: dict, extracts: int, injects: int, leaves: int,
                base: dict, cur: dict, ttfts: list, n: int, local: bool,
                card: bool = True) -> dict:
    """One route's checks: the streams byte-identical to the one engine's,
    every prefill remote, at least one extract and one inject a prompt and,
    on the card, rows 6-7 launched a leaf an extract and an inject (the
    extracts' gathers counted in the prefill's process) and nothing on a
    plain version."""
    if got != want:
        raise AssertionError(f"[{mode}] disaggregated streams differ from one engine's")
    remote = cur["disagg_remote_prefills_total"] - base["disagg_remote_prefills_total"]
    if remote != n:
        raise AssertionError(f"[{mode}] {remote} of {n} prefills remote")
    if extracts < n or injects < n or card and (
            counts["block_copy.gather_launches"] != extracts * leaves
            or counts["block_copy.scatter_launches"] != injects * leaves
            or counts["plain_calls"]):
        raise AssertionError(f"[{mode}] rows 6-7: {extracts} extracts, {injects} injects, "
                             f"{leaves} leaves, counts {counts}")
    secs = cur["disagg_kv_transfer_seconds_total"] - base["disagg_kv_transfer_seconds_total"]
    nbytes = cur["disagg_kv_transfer_bytes_total"] - base["disagg_kv_transfer_bytes_total"]
    hidden = (cur["disagg_kv_transfer_hidden_seconds_total"]
              - base["disagg_kv_transfer_hidden_seconds_total"])
    return {"ttft_p50_ms": sorted(ttfts)[len(ttfts) // 2], "extracts": extracts,
            "injects": injects, "gather_launches": counts["block_copy.gather_launches"],
            "scatter_launches": counts["block_copy.scatter_launches"],
            "parts": cur["disagg_kv_transfer_parts_total"] - base["disagg_kv_transfer_parts_total"],
            "bytes": nbytes, "inject_gbps": nbytes / secs / 1e9 if secs > 0 else 0.0,
            "hidden_share": hidden / secs if secs > 0 else 0.0, "same_process": local}


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


# ---------------------------------------------------------------------------
# phase bench: the headline benchmark's configurations
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase families: the other model families, at their published widths
# ---------------------------------------------------------------------------

# the published config.json of each family (the text_config for Gemma-3),
# the token ids of the tiny model's tokenizer that serves them (bos 0, eos
# 1), the depth cut where bf16 weights would not leave the card room:
# mistralai/Mixtral-8x7B-v0.1 (32 layers are 93 GB)
MIXTRAL_8X7B = {
    "model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 8, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_local_experts": 8, "num_experts_per_tok": 2,
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-5, "rope_theta": 1e6,
    "sliding_window": None, "tie_word_embeddings": False, "hidden_act": "silu",
    "bos_token_id": 0, "eos_token_id": 1, "torch_dtype": "bfloat16",
}
# Qwen/Qwen3-30B-A3B (48 layers are 61 GB, too little room left for the graphs)
QWEN3_30B_A3B = {
    "model_type": "qwen3_moe", "vocab_size": 151936, "hidden_size": 2048,
    "intermediate_size": 6144, "moe_intermediate_size": 768, "num_hidden_layers": 8,
    "num_attention_heads": 32, "num_key_value_heads": 4, "head_dim": 128,
    "num_experts": 128, "num_experts_per_tok": 8, "norm_topk_prob": True,
    "max_position_embeddings": 40960, "rms_norm_eps": 1e-6, "rope_theta": 1e6,
    "rope_scaling": None, "sliding_window": None, "use_sliding_window": False,
    "max_window_layers": 48, "tie_word_embeddings": False, "attention_bias": False,
    "bos_token_id": 0, "eos_token_id": 1, "torch_dtype": "bfloat16",
}
# google/gemma-2b (Gemma 1)
GEMMA_2B = {
    "model_type": "gemma", "vocab_size": 256000, "hidden_size": 2048,
    "intermediate_size": 16384, "num_hidden_layers": 18, "num_attention_heads": 8,
    "num_key_value_heads": 1, "head_dim": 256, "max_position_embeddings": 8192,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "rope_scaling": None,
    "hidden_act": "gelu", "hidden_activation": "gelu_pytorch_tanh",
    "bos_token_id": 0, "eos_token_id": 1, "torch_dtype": "bfloat16",
}
# microsoft/Phi-3-mini-4k-instruct
PHI3_MINI_4K = {
    "model_type": "phi3", "vocab_size": 32064, "hidden_size": 3072,
    "intermediate_size": 8192, "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "max_position_embeddings": 4096,
    "original_max_position_embeddings": 4096, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "rope_scaling": None, "sliding_window": 2047, "tie_word_embeddings": False,
    "hidden_act": "silu", "bos_token_id": 0, "eos_token_id": 1, "torch_dtype": "bfloat16",
}
# google/gemma-2-2b
GEMMA2_2B = {
    "model_type": "gemma2", "vocab_size": 256000, "hidden_size": 2304,
    "intermediate_size": 9216, "num_hidden_layers": 26, "num_attention_heads": 8,
    "num_key_value_heads": 4, "head_dim": 256, "max_position_embeddings": 8192,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "sliding_window": 4096,
    "query_pre_attn_scalar": 256, "attn_logit_softcapping": 50.0,
    "final_logit_softcapping": 30.0, "hidden_activation": "gelu_pytorch_tanh",
    "bos_token_id": 0, "eos_token_id": 1, "torch_dtype": "bfloat16",
}
# google/gemma-3-4b-it's text_config
GEMMA3_4B_TEXT = {
    "model_type": "gemma3_text", "vocab_size": 262208, "hidden_size": 2560,
    "intermediate_size": 10240, "num_hidden_layers": 34, "num_attention_heads": 8,
    "num_key_value_heads": 4, "head_dim": 256, "max_position_embeddings": 131072,
    "rms_norm_eps": 1e-6, "rope_theta": 1000000.0, "rope_local_base_freq": 10000.0,
    "rope_scaling": {"factor": 8.0, "rope_type": "linear"}, "sliding_window": 1024,
    "sliding_window_pattern": 6, "query_pre_attn_scalar": 256,
    "hidden_activation": "gelu_pytorch_tanh", "bos_token_id": 0, "eos_token_id": 1,
    "torch_dtype": "bfloat16",
}
# (family, served name, config, depth cut, the counters its path must
# launch, the route row 1 must take): rows 1-2 at head dim 128 on the
# tensor-core walks, at 256 and 96 on the CUDA-core loops; Gemma-2 and
# Gemma-3 attend plainly, as the reference's XLA path does
# the dense families at half their depth (every width the published
# one's), to keep the whole smoke's time for phase pp
FAMILIES = (
    ("mixtral", "mixtral-8x7b-smoke", MIXTRAL_8X7B, "8 of 32 layers", LLAMA_PATH, "walk"),
    ("qwen3_moe", "qwen3-30b-a3b-smoke", QWEN3_30B_A3B, "8 of 48 layers", LLAMA_PATH, "walk"),
    ("gemma", "gemma-2b-half", dict(GEMMA_2B, num_hidden_layers=9), "9 of 18 layers",
     LLAMA_PATH, "loop"),
    ("phi3", "phi3-mini-4k-half", dict(PHI3_MINI_4K, num_hidden_layers=16), "16 of 32 layers",
     LLAMA_PATH, "loop"),
    ("gemma2", "gemma2-2b-half", dict(GEMMA2_2B, num_hidden_layers=13), "13 of 26 layers", (),
     None),
    ("gemma3", "gemma3-4b-text-half", dict(GEMMA3_4B_TEXT, num_hidden_layers=17),
     "17 of 34 layers", (), None),
)
FAMILIES_ENGINE = dict(num_blocks=1024, max_batch_size=8, max_model_len=2048, seed=0)
ATTENTION_COUNTERS = ("ragged_attention.launches", "paged_attention.launches",
                      "mla_attention.ragged_launches", "mla_attention.decode_launches",
                      "mla_attention.window_launches")
# the speculative probe: a repeated phrase, so that drafts are proposed
SPEC_PROBE = list(range(1000, 1010)) * 6
SPEC_PROBE_TOKENS = 96


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


async def probe_on(engine, prompt, n: int, warm: bool = False) -> list[int]:
    """``prompt``'s greedy ids on ``engine`` alone, started here and stopped
    after; ``warm`` captures its graphs first (``warmup`` at the probe's
    length)."""
    engine.start()
    try:
        if warm:
            await engine.warmup([len(prompt)])
        return await generate_tokens(engine, prompt, n)
    finally:
        engine.stop()


# the speculative check's engines: the served Mixtral in float32 (see
# spec_check), drafting from one-token matches so that a random model's
# recurring tokens give drafts
SPEC_NGRAM = 1


async def spec_check(torch, config: dict) -> dict:
    """Row 2 at W = 5 inside the verify graph: a speculative engine (n-gram
    drafts, spec_tokens 4) against a plain one over the same weights, the
    same greedy ids for SPEC_PROBE.  The plain engine prefills on the split
    step, as the speculative one does.  A greedy id is compared, so the
    engines run ``config`` (its widths and depth) in float32, random
    weights from seed 0: in bf16 a random model's top two logits lie
    within a rounding of each other often enough that the verify window's
    products (40 rows a step) and decode's (8) pick other ids within a few
    tokens (10 of 48 equal on an H100).  Both hold every routed
    token (capacity_factor = experts /
    top-k): the verify window's position-major dispatch may drop a draft's
    expert pair where a decode step would not
    (dynamo_tpu/models/mixtral.py:478-490), and what is compared here is
    the verify path, not the capacity rule."""
    import dataclasses

    from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
    from dynamo_tpu_torch.models.mixtral import MixtralConfig

    cfg = dataclasses.replace(MixtralConfig.from_hf_config(config), dtype=torch.float32)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    plain = TorchLlmEngine(EngineConfig(
        model=cfg, model_family="mixtral", num_blocks=64, max_batch_size=8,
        max_model_len=FAMILIES_ENGINE["max_model_len"], seed=0, decode_overlap=False,
        unified_batch=False), device="cuda")
    spec = sibling_engine(plain, speculative="ngram", spec_tokens=4, spec_ngram=SPEC_NGRAM)
    plain_ids = await probe_on(plain, SPEC_PROBE, SPEC_PROBE_TOKENS, warm=True)
    spec.start()
    try:
        await spec.warmup([len(SPEC_PROBE)])
        before = spec.stats()
        zero_counters()
        spec_ids = await generate_tokens(spec, SPEC_PROBE, SPEC_PROBE_TOKENS)
        torch.cuda.synchronize()
        counts = read_counters()
        after = spec.stats()
    finally:
        spec.stop()
    run = {k: after[k] - before[k] for k in ("spec_verify_steps_total",
                                             "verify_graph_replays_total",
                                             "spec_drafted_tokens_total",
                                             "spec_accepted_tokens_total")}
    window = counts["paged_attention.window_launches"]
    out = {"equal": spec_ids == plain_ids, "window_launches": window, **run,
           "layers": cfg.num_layers, "dtype": "float32",
           "capacity_factor": cfg.capacity_factor}
    if not out["equal"]:
        raise AssertionError(f"speculative greedy ids {spec_ids} differ from the plain "
                             f"engine's {plain_ids}")
    if not 0 < run["verify_graph_replays_total"] == run["spec_verify_steps_total"]:
        raise AssertionError(f"no verify window, or one not a graph replay: {run}")
    if window != cfg.num_layers * run["verify_graph_replays_total"]:
        raise AssertionError(f"row 2 at W = 5 launched {window} times for "
                             f"{run['verify_graph_replays_total']} verify replays of "
                             f"{cfg.num_layers} layers")
    return out


async def family_model(torch, model: str, config: dict) -> dict:
    """Serve ``config`` (random weights from seed 0, the tiny model's
    tokenizer) over HTTP in this process with the default engine (decode
    overlapped, graphs captured by warmup) and drive phase serve's traffic,
    the counters zeroed just before and read just after; then a greedy
    probe with overlap on and off, each on a fresh engine over the same
    weights."""
    import aiohttp

    from dynamo_tpu_torch.serve import serve_http

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    handle = await serve_http(model_dir(model, config), model_name=model, host="127.0.0.1",
                              port=0, **FAMILIES_ENGINE)
    up_s = time.perf_counter() - t0
    engine, port = handle.engine, handle.service.port
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=900)) as s:
            await stream_chat(s, port, model, "warm up", 4)
            zero_counters()
            results, wall = await serve_traffic(s, port, model,
                                                [f"request {i}: tell me" for i in range(4)])
            torch.cuda.synchronize()
            counts = read_counters()
        stats = engine.stats()
        await settled(engine)
        # on fresh engines over the same weights, so that the probe takes
        # lane 0 in both: the served engine's free lanes are a stack, and
        # the MoE families' idle lanes before the probe's take expert
        # capacity first
        probe, probe_off = [
            await probe_on(sibling_engine(engine, decode_overlap=overlap, num_blocks=64),
                           PROBE_PROMPT, PROBE_TOKENS)
            for overlap in (True, False)]
        weights = tree_bytes(engine.params)
    finally:
        await handle.shutdown()
    return {"results": results, "wall_s": wall, "counts": counts, "stats": stats,
            "up_s": up_s, "probe": probe, "probe_off": probe_off,
            "weights_gb": weights / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_families(torch, card: str) -> dict:
    """Each family of FAMILIES served at its published widths: every request
    a 200 with its tokens; rows 1-2 launched on the path of Mixtral,
    Qwen3-MoE, Gemma-2B and Phi-3 (the tensor-core walk at head dim 128,
    the CUDA-core loop at 96 and 256), no attention kernel for Gemma-2 and
    Gemma-3, no plain attention through a kernel wrapper; the greedy probe
    equal with overlap on and off; Mixtral's speculative check.  One
    ``smoke_families`` line a model."""
    from dynamo_tpu_torch.models.registry import get_family

    out = {}
    for family, model, config, cut, path, route in FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = asyncio.run(family_model(torch, model, config))
        if family == "mixtral":  # the served engine is gone: its memory first
            gc.collect()
            torch.cuda.empty_cache()
            res["spec"] = asyncio.run(spec_check(torch, config))
        e2e = traffic_e2e(model, res["results"], res["wall_s"])
        counts, stats = res["counts"], res["stats"]
        cfg = get_family(family).config_from_hf(config)
        launched = {k: counts[k] for k in ATTENTION_COUNTERS}
        failures = []
        if path:
            if any(counts[k] <= 0 for k in path):
                failures.append(f"a kernel did not run on the path: {launched}")
            walked = counts["ragged_attention.split_launches"]
            want = counts["ragged_attention.launches"] if route == "walk" else 0
            if walked != want:
                failures.append(f"row 1 took {walked} tensor-core walks of "
                                f"{counts['ragged_attention.launches']} (want the {route})")
        elif any(launched.values()):
            failures.append(f"an attention kernel ran for {family}: {launched}")
        if counts["plain_calls"] != 0:
            failures.append(f"plain attention ran through a kernel wrapper: {counts}")
        if res["probe"] != res["probe_off"]:
            failures.append(f"greedy probe {res['probe']} with overlap on, "
                            f"{res['probe_off']} off")
        line = {
            "model": model, "family": family, "card": card, "depth_cut": cut,
            "layers": cfg.num_layers, "head_dim": cfg.head_dim,
            "heads": [cfg.num_heads, cfg.num_kv_heads],
            "attention": ("kernels rows 1-2, " + ("tensor-core walk" if route == "walk"
                                                  else "CUDA-core loop"))
            if path else "plain (as the reference's XLA path: no kernel)",
            "launches": launched, "split_launches": counts["ragged_attention.split_launches"],
            **{k: e2e[k] for k in ("ttft_ms_p50", "ttft_ms_p99", "itl_ms_p50", "itl_ms_p99",
                                   "output_tok_s", "wall_s")},
            "load_s": res["up_s"] - stats["warmup_s"], "warmup_s": stats["warmup_s"],
            "weights_gb": res["weights_gb"], "peak_allocated_gb": res["peak_gb"],
            "unified_windows": stats["decode_windows_unified_total"],
            "unified_fallbacks": stats["unified_fallbacks"],
            "graphs_captured": {k: stats[f"{k}_graphs_captured"]
                                for k in ("unified", "decode", "prefill")},
            "probe_equal_overlap_off": res["probe"] == res["probe_off"],
            "spec": res.get("spec"), "phase_s": time.perf_counter() - t0,
        }
        print(json.dumps({"smoke_families": line}), flush=True)
        log(f"[families] {model}: launches={launched} "
            + ("(no attention kernel: plain, as the reference's)" if not path else ""))
        if failures:
            raise AssertionError(f"{model}: " + "; ".join(failures))
        out[family] = {"counts": counts, "line": line}
    return out


# configurations of ``python -m dynamo_tpu_torch.bench.headline`` (ISL 3000,
# OSL 150, 16 lanes, 512-token chunks, the Llama-3-8B geometry, all 32
# layers): A is the reference's headline (int8 weights, fp8 cache,
# decode_steps 8: every prompt on the eager split step, the decode windows
# graphed) cut to the bench's least, 8 requests (its 32 take ~170 s of the
# smoke's limit on a slow host); C bf16 at decode_steps 1 (every chunk in a
# unified graph, rows 1-2) cut to 16 requests (room for phase tp), then to
# 8 (room for phase pp)
BENCH_CONFIGS = (
    ("A", {"DYN_BENCH_REQUESTS": "8"}, ("paged_attention.launches",)),
    ("C", {"DYN_BENCH_REQUESTS": "8", "DYN_BENCH_QUANT": "none",
           "DYN_BENCH_KV_DTYPE": "model", "DYN_BENCH_DECODE_STEPS": "1"}, LLAMA_PATH),
)


# each configuration's headline line (``run_bench``'s result) from phase
# bench, for phase plane's perf gate
BENCH_LINES: dict[str, dict] = {}


def phase_bench(torch, configs=BENCH_CONFIGS) -> dict:
    """Each configuration through the headline bench's own functions
    (``settings_from_env``, ``run_bench``: warmup, the burst, the pipeline
    and prefix rungs), the launch counters zeroed just before and read just
    after; one ``smoke_bench`` line each.  Fails when a rung streams fewer
    than requests x OSL tokens, a graph is captured after warmup, MFU is
    outside (0, 1], the prefix cache does not cut TTFT, or a kernel of the
    path did not run (or a plain version ran on the card)."""
    from dynamo_tpu_torch.bench import headline
    from dynamo_tpu_torch.engine import TorchLlmEngine

    out = {}
    for name, env, path in configs:
        gc.collect()
        torch.cuda.empty_cache()
        settings = headline.settings_from_env(env)
        zero_counters()
        t0 = time.perf_counter()
        with split_step_clock(TorchLlmEngine) as walls:
            result = asyncio.run(headline.run_bench(settings))
        counts = read_counters()
        BENCH_LINES[name] = result
        d = result["detail"]
        line = {"config": name, "env": env, "seconds": round(time.perf_counter() - t0, 1),
                "tok_s": result["value"], **clock_summary(walls),
                **{k: d.get(k) for k in (
                    "decode_phase_tok_s", "vs_baseline_decode_phase", "ttft_p50_ms",
                    "ttft_p99_ms", "ttft_samples", "itl_p50_ms", "itl_p99_ms", "itl_samples",
                    "mfu", "mfu_basis", "engine_mfu_perc_rolling",
                    "engine_bandwidth_util_perc_rolling", "engine_mfu_burst",
                    "engine_bandwidth_util_burst", "prefix_ttft_miss_ms", "prefix_ttft_hit_ms",
                    "prefix_ttft_speedup", "pipeline_tok_s", "pipeline_overhead_pct",
                    "graphs_captured", "graphs_captured_by_kind", "graph_pool_mb",
                    "warmup_s", "graphs_captured_after_warmup", "tokens_expected",
                    "tokens_direct", "pipeline_tokens", "cache_finite", "device_kind",
                    "power_limit_w")},
                "launches": {k: counts[k] for k in (*LLAMA_PATH, "plain_calls")}}
        print(json.dumps({"smoke_bench": line}), flush=True)
        failures = []
        if not d["outputs_ok"]:
            failures.append("outputs wrong: a rung streamed other than requests x OSL "
                            "tokens, or the cache holds a NaN or inf")
        if d["graphs_captured_after_warmup"] != 0:
            failures.append("a graph was captured after warmup")
        if not 0 < d["mfu"] <= 1:
            failures.append(f"mfu {d['mfu']} outside (0, 1]")
        if not d["prefix_ttft_speedup"] > 1:
            failures.append(f"prefix speedup {d['prefix_ttft_speedup']} <= 1")
        if counts["plain_calls"] != 0 or any(counts[k] <= 0 for k in path):
            failures.append(f"the path's kernels did not all run on the card: {counts}")
        if failures:
            raise AssertionError(f"bench {name}: " + "; ".join(failures))
        out[name] = line
    return out


# the split step's measurement (``--phases build,split``): the speculative
# traffic of phase spec on both large configurations, and the headline's A
# and B, both on the split prefill step
SPLIT_BENCH = (("A", {}, ("paged_attention.launches",)),
               ("B", {"DYN_BENCH_QUANT": "none", "DYN_BENCH_KV_DTYPE": "model"},
                ("paged_attention.launches",)))


def phase_split(torch, card: str) -> dict:
    """Phase spec's traffic (``spec_traffic``: tok/s, TTFT, ITL, the wall
    and device ms of each split prefill and verify call) on Llama-3-8B and
    DeepSeek-V2-Lite, then the headline's configurations A and B (every
    chunk on the split prefill step, each call's wall ms)."""
    out = {}
    for key, model, config, path in (
        ("llama", "llama3-8b-spec", LLAMA3_8B, LLAMA_SPEC_PATH),
        ("mla", "deepseek-v2-lite-spec", DEEPSEEK_V2_LITE, MLA_SPEC_PATH),
    ):
        gc.collect()
        torch.cuda.empty_cache()
        out[key] = spec_traffic(torch, card, model, config, path)["line"]
        print(json.dumps({"smoke_split": out[key]}), flush=True)
    out["bench"] = phase_bench(torch, SPLIT_BENCH)
    return out


# ---------------------------------------------------------------------------
# phase 19: multimodal serving, the embedding engine, GGUF weights
# ---------------------------------------------------------------------------

# llava-hf/llava-1.5-7b-hf config.json: the published vision tower (CLIP
# ViT-L/14 at 336: 576 patches) and projector setting; its text_config
# (Vicuna-7B) with the Llama defaults it relies on written out, and the tiny
# tokenizer's bos/eos, as every served config here
LLAVA_1_5_7B = {
    "architectures": ["LlavaForConditionalGeneration"], "model_type": "llava",
    "ignore_index": -100, "image_token_index": 32000, "projector_hidden_act": "gelu",
    "vision_feature_layer": -2, "vision_feature_select_strategy": "default",
    "text_config": {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 32064,
        "hidden_size": 4096, "intermediate_size": 11008, "num_hidden_layers": 32,
        "num_attention_heads": 32, "num_key_value_heads": 32,
        "max_position_embeddings": 4096, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "tie_word_embeddings": False, "bos_token_id": 0, "eos_token_id": 1,
        "torch_dtype": "bfloat16"},
    "vision_config": {
        "model_type": "clip_vision_model", "hidden_size": 1024, "image_size": 336,
        "intermediate_size": 4096, "num_attention_heads": 16, "num_hidden_layers": 24,
        "patch_size": 14, "projection_dim": 768, "vocab_size": 32000},
}
MM_ENGINE = dict(num_blocks=1024, max_batch_size=8, max_model_len=4096, seed=0,
                 prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096))
MM_PHOTO = (480, 640)   # the images' size before the encoder's resize to 336
MM_TEXT = "please describe what this picture shows, in a few short sentences: " * 3
MM_OSL = 64
MM_VIDEO = (8, 2)       # frames, temporal pool: 4 x 576 = 2304 patch positions
MM_VIDEO_TEXT = 40      # text tokens of the video request
MM_REMOTE_OSL = 16
MM_LAUNCH_S = 300
MM_GEMMA = dict(GEMMA3_4B_TEXT, num_hidden_layers=4)
EMBED_LEN = 512
GGUF_KINDS = ("F16", "Q8_0")
GGUF_NAMES = {
    "attn_norm": "attn_norm.weight", "wq": "attn_q.weight", "wk": "attn_k.weight",
    "wv": "attn_v.weight", "wo": "attn_output.weight", "mlp_norm": "ffn_norm.weight",
    "w_gate": "ffn_gate.weight", "w_up": "ffn_up.weight", "w_down": "ffn_down.weight",
}


def png_data_url(seed: int, size=MM_PHOTO) -> tuple[str, bytes]:
    """A random RGB photo of ``size`` as a PNG ``data:`` URL, and its bytes."""
    import base64
    import io

    import numpy as np
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, (*size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    raw = buf.getvalue()
    return "data:image/png;base64," + base64.b64encode(raw).decode(), raw


async def mm_chat(session, port: int, model: str, content, max_tokens: int,
                  seed: int | None = None, stamps: list | None = None) -> float:
    """One streamed chat completion (greedy, or seeded at temperature 0.9),
    ``content`` a string or content parts; returns its start, each chunk's
    arrival (a token each) appended to ``stamps``."""
    body = {"model": model, "max_tokens": max_tokens, "stream": True,
            "stream_options": {"include_usage": True}, "ext": {"ignore_eos": True},
            "messages": [{"role": "user", "content": content}]}
    body.update({"temperature": 0} if seed is None else {"temperature": 0.9, "seed": seed})
    t0 = time.perf_counter()
    stamps = [] if stamps is None else stamps
    usage = None
    async with session.post(f"http://127.0.0.1:{port}/v1/chat/completions", json=body) as r:
        if r.status != 200:
            raise AssertionError(f"chat answered {r.status}: {await r.text()}")
        async for raw in r.content:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[6:])
            if "error" in chunk:
                raise RuntimeError(chunk["error"])
            if chunk.get("usage"):
                usage = chunk["usage"]
            for _ in chunk.get("choices", []):
                stamps.append(time.perf_counter())
    if (usage or {}).get("completion_tokens") != max_tokens:
        raise AssertionError(f"chat streamed {usage} of {max_tokens} tokens")
    return t0


async def mm_stream(engine, tokens: list[int], max_tokens: int, *, seed=None, extra=None,
                    stamps: list | None = None) -> tuple[list, list]:
    """One request through ``engine`` (a MultimodalEngine: ``extra`` adds its
    ``image`` or ``video``): ids and logprobs, greedy or seeded at 0.9."""
    from dynamo_tpu_torch.llm.protocols.common import (
        Annotated,
        LLMEngineOutput,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    sampling = (SamplingOptions(use_greedy=True) if seed is None
                else SamplingOptions(temperature=0.9, seed=seed))
    req = PreprocessedRequest(token_ids=tokens, sampling=sampling,
                              stop=StopConditions(max_tokens=max_tokens, ignore_eos=True),
                              eos_token_ids=[1]).to_wire()
    ids, lps = [], []
    async for item in await engine.generate(Context({**req, **(extra or {})})):
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is None:
            continue
        if ann.data.error:
            raise RuntimeError(ann.data.error)
        ids.extend(ann.data.token_ids)
        lps.extend(ann.data.logprobs or [])
        if stamps is not None and ann.data.token_ids:
            stamps.append(time.perf_counter())
    if len(ids) != max_tokens:
        raise AssertionError(f"{len(ids)} of {max_tokens} tokens streamed")
    return ids, lps


def ttft_itl_ms(runs: list[tuple[float, list[float]]]) -> dict:
    """TTFT and ITL p50 (ms) of (start, stamps) runs."""
    ttft = sorted((st[0] - t0) * 1e3 for t0, st in runs if st)
    itl = sorted((b - a) * 1e3 for _, st in runs for a, b in zip(st, st[1:]))
    return {"ttft_ms_p50": pctile(ttft, 0.5), "itl_ms_p50": pctile(itl, 0.5),
            "itl_ms_p90": pctile(itl, 0.9), "tokens": sum(len(st) for _, st in runs)}


def mm_prefill_window(torch, engine, key: tuple, n_patch: int, noise: bool):
    """Write one multimodal prefill of ``key`` (``n_patch`` random patch
    rows, then text, a few pad tokens) into the prefill graph's buffers on
    lane 3 and blocks of its own, sampled (``noise``) or greedy; returns the
    cache slots its valid positions write."""
    import numpy as np

    from dynamo_tpu_torch.llm.protocols.common import SamplingOptions

    pg = engine._prefill
    bs, vocab, lane = engine.config.block_size, engine.config.model.vocab_size, 3
    gen = np.random.default_rng(key[1] + noise)
    b = key[1]
    n = min(b - 5, n_patch + 40)
    blocks = np.zeros((engine.max_blocks_per_seq,), np.int32)
    used = -(-n // bs)
    blocks[:used] = 100 + np.arange(used)
    token_ids = np.zeros((b,), np.int32)
    token_ids[n_patch:n] = gen.integers(3, vocab, n - n_patch)
    embeds = np.zeros((b, engine.config.model.hidden_size), np.float32)
    embeds[:n_patch] = gen.normal(size=(n_patch, embeds.shape[1]))
    seq = lane_seq(engine, lane, SamplingOptions(temperature=0.8, seed=5, presence_penalty=0.3)
                   if noise else SamplingOptions(use_greedy=True))
    arrays = dict(zip(("temp", "top_k", "top_p", "greedy", "pres", "freq", "rep", "bias_ids",
                       "bias_vals"), engine._sampling_arrays([seq], [0], 1)))
    arrays.update(token_ids=token_ids, block_ids=blocks, embeds=embeds, n_patch=n_patch,
                  seq_len=n, start_pos=0, fold=n, lane=lane, gate=1,
                  key=engine._lane_keys[[lane]].astype(np.int64),
                  prompt=np.bincount(token_ids[n_patch:n], minlength=vocab).astype(np.int32),
                  gen=np.zeros((vocab,), np.int32), gmode=np.full((1,), -1, np.int32))
    pg.upload(key, arrays)
    pos = np.arange(n)
    return blocks[pos // bs] * bs + pos % bs


def mm_replay_vs_eager(torch, engine, keys: dict) -> dict:
    """At each multimodal key the traffic captured (``keys``: key ->
    patch rows): a prefill by the key's graph replay and by the same step
    run eagerly on the same buffers, greedy and sampled: token, logprob
    bits, the cache rows written and the counts bitwise equal; and the
    replay's device ms."""
    pg = engine._prefill
    out = {}
    for key, n_patch in keys.items():
        name = "_".join(map(str, key))
        for noise in (False, True):
            slots = mm_prefill_window(torch, engine, key, n_patch, noise)
            out[f"{name}_{'sampled' if noise else 'greedy'}"] = replay_vs_eager_state(
                torch, engine, pg.out, lambda: pg.run(key), lambda: pg.step(key),
                written_rows(torch, engine, slots))
        out[f"{name}_replay_ms"] = time_ms(lambda: pg._launch(key), 5, warmup=1)
    return out


@contextlib.contextmanager
def mm_lane_windows(llm):
    """While open, the engine's split decode step and its unified step are
    wrapped: each window in which an image or video lane decodes adds its
    row 1 and row 2 launches (a graph replay adds those it holds) to the
    yielded {"decode": {...}, "unified": {...}}, beside the count of such
    windows.  The engine loop is the only launcher of rows 1-2 meanwhile."""
    seen = {step: {"windows": 0, **dict.fromkeys(LLAMA_PATH, 0)}
            for step in ("decode", "unified")}

    def wrap(step, run, lanes):
        def call(*args):
            if not any(seq.mm_embeds is not None for seq in lanes(*args)):
                return run(*args)
            before = read_counters()
            try:
                return run(*args)
            finally:
                after = read_counters()
                seen[step]["windows"] += 1
                for k in LLAMA_PATH:
                    seen[step][k] += after[k] - before[k]
        return call

    llm._run_decode = wrap("decode", llm._run_decode, lambda seqs: seqs)
    llm._run_unified = wrap("unified", llm._run_unified, lambda spans, decodes, *_: decodes)
    try:
        yield seen
    finally:
        del llm._run_decode, llm._run_unified  # the class's methods again


@contextlib.asynccontextmanager
async def encode_worker(device: str, vision_path: Path):
    """A control-plane server in this process and the encoder as a component
    of its own in a second process on the card (``pipeline
    --encode-worker``); yields (address, a wait for its ready line), and
    stops both."""
    from dynamo_tpu_torch.runtime.controlplane.server import ControlPlaneServer

    cp = ControlPlaneServer(port=0)
    await cp.start()
    address = f"127.0.0.1:{cp.port}"
    log_path = ROOT / "dynamo_tpu_torch" / "_build" / "mm_encode_worker.log"
    log_file = open(log_path, "wb")
    t0 = time.perf_counter()
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_tpu_torch.examples.multimodal.pipeline",
        "--encode-worker", "--control-plane", address, "--vision-config", str(vision_path),
        "--seed", "0", "--device", device, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=asyncio.subprocess.PIPE,
        stderr=log_file)

    async def ready() -> float:
        line = await asyncio.wait_for(proc.stdout.readline(), MM_LAUNCH_S)
        if b"ENCODE_READY" not in line:
            raise AssertionError(f"encode worker: {line!r}; see {log_path}")
        return time.perf_counter() - t0

    try:
        yield address, ready
    finally:
        if proc.returncode is None:
            proc.terminate()
            try:
                await asyncio.wait_for(proc.wait(), 30)
            except asyncio.TimeoutError:
                proc.kill()
                await proc.wait()
        log_file.close()
        await cp.stop()


async def mm_remote_check(llm, local, address: str, ready, images) -> dict:
    """Over the encode worker at ``address``: each image's embeddings
    through ``RemoteEncoder`` bitwise the in-process encoder's, and four
    requests on them (two greedy, two seeded) bitwise the in-process
    streams (ids and logprobs)."""
    import numpy as np

    from dynamo_tpu_torch.examples.multimodal.components import RemoteEncoder
    from dynamo_tpu_torch.examples.multimodal.pipeline import MultimodalEngine
    from dynamo_tpu_torch.llm.multimodal import encode_image_wire
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    vocab = llm.config.model.vocab_size
    rng = random.Random(1)
    prompts = [[rng.randrange(3, vocab) for _ in range(40)] for _ in images]
    seeds = [None, None, 301, 302]

    async def four(engine) -> list:
        got = await asyncio.gather(*[
            mm_stream(engine, p, MM_REMOTE_OSL, seed=s, extra={"image": encode_image_wire(im)})
            for p, s, im in zip(prompts, seeds, images)])
        await settled(llm)
        return got

    out: dict = {}
    want = await four(MultimodalEngine(llm, local))
    out["worker_up_s"] = await ready()
    rt = await DistributedRuntime.create(RuntimeConfig(control_plane=address))
    remote = None
    try:
        remote = await RemoteEncoder.connect(rt)
        for i, im in enumerate(images):
            theirs, mine = await remote.aencode(im), local.encode(im)
            if theirs.dtype != mine.dtype or not np.array_equal(theirs, mine):
                raise AssertionError(f"image {i}: remote embeddings differ from local "
                                     f"(max {float(np.abs(theirs - mine).max())})")
        out["embeds_bitwise"] = True
        t0 = time.perf_counter()
        got = await four(MultimodalEngine(llm, remote))
        out["remote_four_s"] = time.perf_counter() - t0
        if got != want:
            raise AssertionError(f"streams over the remote encoder differ: {got} vs {want}")
        out["streams_bitwise"] = True
    finally:
        if remote is not None:
            await remote.close()
        await rt.close()
    return out


async def mm_serving(torch, device: str, llava: dict, engine_kw: dict) -> dict:
    """Part (a): LLaVA-1.5-7B through the multimodal frontend
    (``pipeline.start_http``): four image chats (data: PNG URLs, two greedy,
    two seeded), a video through the MultimodalEngine and two text-only
    chats once the image lanes decode, the counters zeroed just before and
    read just after; the replay checks, the repeated image, the remote
    encoder (a second process, started first: its start-up overlaps the
    traffic)."""
    from dynamo_tpu_torch.models.vision import VisionConfig

    vcfg = VisionConfig.from_hf_config(llava)
    path = model_dir("llava-1.5-7b-smoke", llava["text_config"])
    vision_path = path / "llava_config.json"
    vision_path.write_text(json.dumps(llava))
    async with encode_worker(device, vision_path) as (address, ready):
        return await mm_serving_with(torch, device, engine_kw, vcfg, path, address, ready)


async def mm_serving_with(torch, device: str, engine_kw: dict, vcfg, path, address: str,
                          ready) -> dict:
    import aiohttp
    import numpy as np

    from dynamo_tpu_torch.examples.multimodal.pipeline import start_http
    from dynamo_tpu_torch.llm.multimodal import decode_image_bytes
    from dynamo_tpu_torch.models.vision import vit_encode

    t0 = time.perf_counter()
    handle = await start_http(path, 0, device=device, name="llava-smoke", vision=vcfg,
                              **engine_kw)
    out: dict = {"up_s": time.perf_counter() - t0, "patches": vcfg.num_patches}
    llm, encoder, port = handle.llm, handle.encoder, handle.service.port
    vocab = llm.config.model.vocab_size
    urls = [png_data_url(i) for i in range(4)]
    images = [decode_image_bytes(raw) for _, raw in urls]
    frames_n, pool = MM_VIDEO
    video = np.random.default_rng(9).random((frames_n, *MM_PHOTO, 3), np.float32)
    rng = random.Random(0)
    video_prompt = [rng.randrange(3, vocab) for _ in range(MM_VIDEO_TEXT)]
    try:
        # the encoder alone: wall (host clock, synchronised) and device ms
        for _ in range(2):
            encoder.encode(images[0])
        walls = []
        for im in images:
            t1 = time.perf_counter()
            encoder.encode(im)
            walls.append((time.perf_counter() - t1) * 1e3)
        out["vit_encode_wall_ms"] = sorted(walls)[len(walls) // 2]
        if device == "cuda":
            x = encoder._fit(images[0])[None].to(vcfg.dtype)
            out["vit_encode_device_ms"] = device_ms(
                lambda: vit_encode(encoder.params, vcfg, x), iters=5)
            t1 = time.perf_counter()
            encoder.encode_video(video, temporal_pool=pool)
            out["vit_video_wall_ms"] = (time.perf_counter() - t1) * 1e3
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=900)) as s:
            # a warm pass of the traffic's shapes: the graphs it needs (the
            # mm keys, the unified buckets, the decode windows) captured
            # before the counted run
            await asyncio.gather(*[
                mm_chat(s, port, "llava-smoke", [
                    {"type": "text", "text": MM_TEXT},
                    {"type": "image_url", "image_url": {"url": urls[0][0]}}], 16, seed=seed)
                for seed in (None, 1)], mm_stream(
                    handle.engine, video_prompt, 16,
                    extra={"video": video, "video_temporal_pool": pool}),
                *[mm_chat(s, port, "llava-smoke", f"text-only request {i}: " + MM_TEXT, 4)
                  for i in range(2)])
            await settled(llm)
            stats0 = llm.stats()
            zero_counters()
            image_st, text_st, video_st = [[] for _ in range(4)], [[], []], []

            async def image(i):
                content = [{"type": "text", "text": MM_TEXT},
                           {"type": "image_url", "image_url": {"url": urls[i][0]}}]
                return await mm_chat(s, port, "llava-smoke", content, MM_OSL,
                                     seed=None if i < 2 else 100 + i, stamps=image_st[i])

            async def text(i):
                # sent once every image and video lane decodes: the text
                # prefills then share unified windows with their decode
                # tokens, and no mm prefill sends those windows to the
                # split step
                t1 = time.perf_counter()
                while (not all(len(st) >= 2 for st in (*image_st, video_st))
                       and time.perf_counter() - t1 < 120):
                    await asyncio.sleep(0.005)
                return await mm_chat(s, port, "llava-smoke", f"text-only request {i}: " + MM_TEXT,
                                     MM_OSL, seed=None if i == 0 else 200, stamps=text_st[i])

            async def clip():
                t1 = time.perf_counter()
                await mm_stream(handle.engine, video_prompt, MM_OSL, seed=7,
                                extra={"video": video, "video_temporal_pool": pool},
                                stamps=video_st)
                return t1

            t1 = time.perf_counter()
            with mm_lane_windows(llm) as lanes:
                starts = await asyncio.gather(*[image(i) for i in range(4)], clip(),
                                              *[text(i) for i in range(2)])
            if device == "cuda":
                torch.cuda.synchronize()
            counts = read_counters()
            out["traffic_s"] = time.perf_counter() - t1
        await settled(llm)
        stats = llm.stats()
        out["image"] = ttft_itl_ms(list(zip(starts[:4], image_st)))
        out["video"] = ttft_itl_ms([(starts[4], video_st)])
        out["text"] = ttft_itl_ms(list(zip(starts[5:], text_st)))
        out["counts"], out["mm_lane_windows"] = counts, lanes
        mm_prefills = 5
        replays = stats["prefill_graph_replays_total"] - stats0["prefill_graph_replays_total"]
        out["prefill_graph_replays"] = replays
        out["graphs_captured_in_traffic"] = {
            k: stats[f"{k}_graphs_captured"] - stats0[f"{k}_graphs_captured"]
            for k in ("unified", "decode", "prefill")}
        out["unified_fallbacks"] = stats["unified_fallbacks"]
        keys = sorted(k for k in llm._prefill._graphs if k[0] == "mm")
        out["mm_keys"] = [list(k) for k in keys]
        if device == "cuda":
            if replays < mm_prefills:
                raise AssertionError(f"{replays} prefill replays for {mm_prefills} mm prefills")
            if any(counts[k] <= 0 for k in LLAMA_PATH) or counts["plain_calls"]:
                raise AssertionError(f"rows 1-2 did not both run on the mm path: {counts}")
            check_ragged_route(counts)
            # the image and video lanes' own decode: row 2 in the decode
            # graph, row 1 in the unified windows of the text prefills
            if (lanes["decode"]["paged_attention.launches"] <= 0
                    or lanes["unified"]["ragged_attention.launches"] <= 0):
                raise AssertionError(f"the image lanes' decode did not launch rows 1-2: {lanes}")
        # a repeated identical image: nothing cached, nothing published
        events: list = []
        llm._event_sink = events.append
        cached0 = llm.stats()["prefix_cached_tokens_total"]
        again = [await mm_stream(handle.engine, video_prompt[:8], 8,
                                 extra={"image": images[0]}) for _ in range(2)]
        await settled(llm)
        llm._event_sink = None
        stored = [e for e in events if e.kind == "stored"]
        cached = llm.stats()["prefix_cached_tokens_total"] - cached0
        if cached or stored or again[0] != again[1]:
            raise AssertionError(f"repeated image: {cached} cached tokens, {len(stored)} "
                                 f"stored events, streams equal {again[0] == again[1]}")
        out["repeat_cached_tokens"], out["repeat_stored_events"] = cached, len(stored)
        out["remote"] = await mm_remote_check(llm, encoder, address, ready, images)
    finally:
        await handle.shutdown()
    if device == "cuda":
        n_video = -(-frames_n // pool) * vcfg.num_patches
        keys = {k: (n_video if k[1] >= n_video else vcfg.num_patches)
                for k in map(tuple, out["mm_keys"])}
        out["replay_vs_eager"] = checked = mm_replay_vs_eager(torch, llm, keys)
        bad = [k for k, v in checked.items() if isinstance(v, dict) and not all(v.values())]
        if bad:
            raise AssertionError(f"mm prefill replay differs from eager: {bad}: {checked}")
    del llm, handle
    return out


async def mm_gemma(torch, device: str, llava: dict, config: dict) -> dict:
    """Gemma-3-4B text at 4 layers, one image request (the LLaVA vision
    tower projected into its width) through ``gemma3_forward_prefill_embeds``
    (plain attention, as the reference's: no kernel)."""
    import numpy as np

    from dynamo_tpu_torch.examples.multimodal.pipeline import (
        MultimodalEngine,
        TorchVisionEncoder,
    )
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.vision import VisionConfig
    from dynamo_tpu_torch.serve import build_torch_engine

    path = model_dir("gemma3-4b-mm-smoke", config)
    llm = build_torch_engine(path, ModelDeploymentCard.from_local_path(path), device=device,
                             num_blocks=256, max_batch_size=4, max_model_len=1024, seed=0)
    llm.start()
    try:
        vcfg = VisionConfig.from_hf_config(llava, llm_hidden_size=llm.config.model.hidden_size)
        encoder = TorchVisionEncoder(vcfg, seed=0, device=llm.device)
        image = np.random.default_rng(3).random((*MM_PHOTO, 3), np.float32)
        zero_counters()
        ids, lps = await mm_stream(MultimodalEngine(llm, encoder), list(range(3, 43)), 16,
                                   extra={"image": image})
        counts = read_counters()
        stats = llm.stats()
    finally:
        llm.stop()
    launched = {k: counts[k] for k in ATTENTION_COUNTERS}
    if any(launched.values()) or counts["plain_calls"]:
        raise AssertionError(f"an attention kernel ran for gemma3: {counts}")
    if not all(math.isfinite(x) for x in lps):
        raise AssertionError(f"gemma3 image request: logprobs {lps}")
    if device == "cuda" and stats["prefill_graph_replays_total"] < 1:
        raise AssertionError("gemma3's mm prefill did not replay its graph")
    return {"tokens": len(ids), "prefill_graph_replays": stats["prefill_graph_replays_total"],
            "launches": launched}


async def mm_embeddings(torch, device: str, config: dict, max_len: int) -> dict:
    """Part (b): ``TorchEmbeddingEngine`` at ``config``'s geometry (random
    bf16 weights from seed 0), ``max_len`` padding, through ``/v1/embeddings``:
    16 inputs across the four input shapes; graph replay bitwise the eager
    trunk, every norm within 1e-3 of 1, the same text twice the same bits."""
    import base64

    import aiohttp
    import numpy as np

    from dynamo_tpu_torch.engine.embedding import EmbeddingEngineConfig, TorchEmbeddingEngine
    from dynamo_tpu_torch.llm.http import HttpService, ModelManager
    from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
    from dynamo_tpu_torch.models.registry import get_family

    cfg = get_family("llama").config_from_hf(config)
    tok = HfTokenizer.from_model_dir(ROOT / "tests" / "data" / "tiny-chat-model")
    t0 = time.perf_counter()
    engine = TorchEmbeddingEngine(EmbeddingEngineConfig(model=cfg, max_length=max_len), tok,
                                  device=device)
    out: dict = {"init_s": time.perf_counter() - t0}
    rng = random.Random(2)
    ids = lambda n: [rng.randrange(3, cfg.vocab_size) for _ in range(n)]  # noqa: E731
    text = "the quick brown fox jumps over the lazy dog. "
    bodies = [{"input": text * 8},
              {"input": [text * (i + 1) for i in range(5)]},
              {"input": ids(max_len)},
              {"input": [ids(n) for n in (1, 7, 64, 200, 333, 511, 512, 600, 48)],
               "encoding_format": "base64"}]
    manager = ModelManager()
    manager.add_embedding_model("embed-smoke", engine)
    service = HttpService(manager, host="127.0.0.1", port=0)
    await service.start()
    vectors = []
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
            answers = []
            for body in bodies + bodies[:1]:
                async with s.post(f"http://127.0.0.1:{service.port}/v1/embeddings",
                                  json={"model": "embed-smoke", **body}) as r:
                    if r.status != 200:
                        raise AssertionError(f"/v1/embeddings answered {r.status}: "
                                             f"{await r.text()}")
                    answers.append(await r.json())
    finally:
        await service.stop()
    for body, ans in zip(bodies, answers):
        for d in ans["data"]:
            e = d["embedding"]
            vectors.append(np.frombuffer(base64.b64decode(e), np.float32)
                           if isinstance(e, str) else np.asarray(e, np.float32))
    out["inputs"] = len(vectors)
    out["usage_tokens"] = sum(a["usage"]["total_tokens"] for a in answers[:4])
    norms = [float(np.linalg.norm(v.astype(np.float64))) for v in vectors]
    out["norm_max_dev"] = max(abs(n - 1.0) for n in norms)
    if len(vectors) != 16 or out["norm_max_dev"] > 1e-3:
        raise AssertionError(f"{len(vectors)} vectors, norms {norms}")
    if answers[4]["data"][0]["embedding"] != answers[0]["data"][0]["embedding"]:
        raise AssertionError("the same text twice gave other bits")
    probe = ids(max_len)
    for x in (probe, probe[:100], [5]):
        if not np.array_equal(engine.embed_ids(x), engine.embed_ids(x, eager=True)):
            raise AssertionError(f"graph replay differs from the eager trunk at {len(x)} tokens")
    out["replay_bitwise_eager"] = True
    out["graph"] = engine.stats()
    if device == "cuda":
        out["embed_wall_ms_512"] = time_ms(lambda: engine.embed_ids(probe), 5, warmup=1)
        out["embed_replay_ms_512"] = time_ms(lambda: engine._graph._launch(None), 5, warmup=1)
        if out["graph"]["embedding_graphs_captured"] != 1:
            raise AssertionError(f"embedding graphs: {out['graph']}")
    del engine
    return out


def gguf_layout(cfg, params: dict) -> dict:
    """``params`` (the llama layout) under llama.cpp's tensor names, each
    projection transposed to [out, in] as GGUF files store it (views, on
    the params' device)."""
    out = {"token_embd.weight": params["embed"], "output_norm.weight": params["final_norm"]}
    for i in range(cfg.num_layers):
        for ours, name in GGUF_NAMES.items():
            t = params["layers"][ours][i]
            out[f"blk.{i}.{name}"] = t.T if ours[0] == "w" else t
    return out


def export_gguf(path: Path, cfg, tensors: dict, kind: str) -> None:
    """``tensors`` (``gguf_layout``) as a GGUF file of ``kind`` written by
    the port's writer: norms in F32, every matrix in F16 (cast on the
    device) or Q8_0 (``quantize_q8_0`` on the host, a tensor a thread); the
    metadata ``config_from_gguf`` reads."""
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.llm import gguf

    def enc(t):
        if t.ndim == 1:
            return t.float().cpu().numpy()
        if kind == "F16":
            return t.half().contiguous().cpu().numpy()
        t = t.float().contiguous().cpu().numpy()
        return (gguf.GGML_Q8_0, t.shape, gguf.quantize_q8_0(t))

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        encoded = dict(zip(tensors, pool.map(enc, tensors.values())))
    meta = {"general.architecture": "llama", "general.name": f"llama32-1b-{kind}",
            "llama.embedding_length": cfg.hidden_size,
            "llama.feed_forward_length": cfg.intermediate_size,
            "llama.block_count": cfg.num_layers, "llama.attention.head_count": cfg.num_heads,
            "llama.attention.head_count_kv": cfg.num_kv_heads,
            "llama.attention.key_length": cfg.head_dim,
            "llama.attention.layer_norm_rms_epsilon": cfg.rms_norm_eps,
            "llama.context_length": 8192, "llama.rope.freq_base": cfg.rope_theta,
            "llama.vocab_size": cfg.vocab_size}
    gguf.write_gguf(path, meta, encoded)


async def mm_gguf(torch, device: str, cfg) -> dict:
    """Part (c): ``cfg``'s random weights (seed 0) written as F16 and Q8_0
    GGUF files by the port's writer; ``load_gguf_weights`` puts each on the
    device, each leaf bitwise the host's dequant cast to the model dtype on
    the CPU; an engine on each serves four greedy requests."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
    from dynamo_tpu_torch.llm import gguf
    from dynamo_tpu_torch.models.llama import init_params

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    source = gguf_layout(cfg, init_params(cfg, gen, device))
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "dynamo_tpu_torch" / "_build") as tmp:
        for kind in GGUF_KINDS:
            path = Path(tmp) / f"llama32-1b-{kind}.gguf"
            t0 = time.perf_counter()
            export_gguf(path, cfg, source, kind)
            write_s = time.perf_counter() - t0
            g = gguf.GGUFFile(path)
            lcfg = dataclasses.replace(gguf.config_from_gguf(g), dtype=cfg.dtype)
            t0 = time.perf_counter()
            params = gguf.load_gguf_weights(lcfg, g, device)
            if device == "cuda":
                torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            # every leaf, in the file's layout, against the host's own
            # dequant cast on the CPU (a tensor a thread)
            t0 = time.perf_counter()
            loaded = gguf_layout(lcfg, params)

            def same(item) -> bool:
                name, got = item
                want = torch.from_numpy(g.tensor_data(name)).to(lcfg.dtype)
                return torch.equal(_bits(torch, got.contiguous().cpu()), _bits(torch, want))

            with ThreadPoolExecutor(os.cpu_count()) as pool:
                bad = [n for n, ok in zip(loaded, pool.map(same, loaded.items())) if not ok]
            if bad:
                raise AssertionError(f"{kind}: {bad[:4]} on the device differ from the host")
            check_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            engine = TorchLlmEngine(EngineConfig(model=lcfg, num_blocks=256, max_batch_size=4,
                                                 max_model_len=512, seed=0),
                                    params=params, device=device)
            engine.start()
            try:
                streams = await asyncio.gather(*[
                    mm_stream(engine, list(range(10 + i, 60 + 3 * i)), 16) for i in range(4)])
            finally:
                engine.stop()
            out[kind] = {"file_gb": path.stat().st_size / 1e9, "write_s": write_s,
                         "load_s": load_s, "check_s": check_s,
                         "serve_s": time.perf_counter() - t0, "leaves_bitwise": len(loaded),
                         "tied": lcfg.tie_word_embeddings,
                         "greedy": [ids[:4] for ids, _ in streams]}
            del engine, params, loaded
    return out


def _bits(torch, t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


# phase mm's LLaVA at half its text model's depth (16 of 32 layers), so that
# the whole smoke keeps its time with phase meshfeat
MM_LLAVA = {**LLAVA_1_5_7B, "text_config": dict(LLAVA_1_5_7B["text_config"],
                                                num_hidden_layers=16)}


def phase_mm(torch, card: str, device: str = "cuda", llava: dict = MM_LLAVA,
             engine_kw: dict = MM_ENGINE, gemma: dict = MM_GEMMA,
             embed_config: dict = SERVE_LLAMA, embed_len: int = EMBED_LEN,
             gguf_cfg=None) -> dict:
    """Multimodal serving, the embedding engine and GGUF weights on the card:
    (a) LLaVA-1.5-7B (the published config: ViT-L/14-336 and the Vicuna-7B
    text geometry at 16 of its 32 layers, random bf16 weights from seed 0,
    1024 blocks of 16, 8
    lanes, max length 4096) through the multimodal frontend: four image
    chats (data: PNG URLs of 480x640 photos, about 40 text tokens and 64
    out, two greedy, two seeded), a video of 8 frames at temporal pool 2
    (2304 patch positions) and two text-only chats beside them; every mm
    prefill a graph replay, rows 1-2 launched (the image lanes' decode in
    the decode graph and in unified windows beside the text prefills); each
    mm prefill key by replay bitwise its eager step, greedy and seeded; a
    repeated image caches and publishes nothing; the same four images
    through ``RemoteEncoder`` in a second process bitwise the in-process
    embeddings and streams; Gemma-3-4B text at 4 layers takes an image
    through its embeddings prefill.  (b) the embedding engine at the
    Llama-3-8B geometry through ``/v1/embeddings``.  (c) GGUF F16 and Q8_0
    files of the Llama-3.2-1B geometry loaded onto the card and served.
    One ``smoke_mm`` line."""
    from dynamo_tpu_torch.models.llama import LlamaConfig

    gguf_cfg = gguf_cfg or LlamaConfig.llama32_1b()
    out: dict = {"card": card}
    t0 = time.perf_counter()
    out["llava"] = asyncio.run(mm_serving(torch, device, llava, engine_kw))
    out["llava_s"] = time.perf_counter() - t0
    for part, fn, args in (("gemma3", mm_gemma, (torch, device, llava, gemma)),
                           ("embeddings", mm_embeddings, (torch, device, embed_config,
                                                          embed_len)),
                           ("gguf", mm_gguf, (torch, device, gguf_cfg))):
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[part] = asyncio.run(fn(*args))
        out[f"{part}_s"] = time.perf_counter() - t0
    a = out["llava"]
    log(f"[mm] {card}: ViT encode {a['vit_encode_wall_ms']:.1f} ms wall, "
        f"{a.get('vit_encode_device_ms')} ms device; image TTFT p50 {a['image']['ttft_ms_p50']} "
        f"ms, ITL p50 {a['image']['itl_ms_p50']} ms; text TTFT p50 {a['text']['ttft_ms_p50']} "
        f"ms; gguf load s {[(k, v['load_s']) for k, v in out['gguf'].items()]}")
    print("smoke_mm " + json.dumps(out, default=str), flush=True)
    return {"counts": a["counts"], "line": out}

# ---------------------------------------------------------------------------
# phase tp: tensor and expert parallelism, the ranks sharing the one card
# ---------------------------------------------------------------------------

# The smoke's machine has one card, and NCCL refuses two ranks on one GPU:
# phase tp names gloo, the only backend under which ranks may share a card.
# Its collectives stage through host memory, so the phase's times are of
# ranks sharing one card over host-staged gloo, not of NVLink.
TP_BACKEND = "gloo"
# Llama-3-8B at a quarter of its depth (8 of 32 layers), DeepSeek-V2-Lite
# at half (14 of 27: phase meshfeat's case (e) drafts on it), so that the
# whole smoke keeps its time with phase meshfeat
TP_MODELS = (("llama3-8b-tp", "llama", dict(LLAMA3_8B, num_hidden_layers=8), dict(tp=2)),
             ("deepseek-v2-lite-tp", "deepseek", dict(DEEPSEEK_V2_LITE, num_hidden_layers=14),
              dict(tp=2, ep=2)))
# tp = 1 runs the same split step (unified off, as on a mesh) on the same
# weights, so the two differ only by the sharding.  Phase meshfeat's cases
# (c)-(e) run on these engine pairs (``MF_ON_TP``): the Llama pair holds
# their 2048-token disaggregated prompts; the DeepSeek pair drafts n-grams
# (a lane drafts only once its last two tokens occurred before, so phase
# tp's prompts, whose ids never repeat, start at W = 1) and holds every
# routed pair (a capacity factor of experts / top-k)
TP_ENGINE = dict(max_batch_size=8, seed=0, decode_overlap=False, unified_batch=False)
TP_ENGINES = {"llama": dict(TP_ENGINE, num_blocks=1024, max_model_len=4096,
                            prefill_buckets=(128, 256, 512, 1024, 2048, 4096)),
              "deepseek": dict(TP_ENGINE, num_blocks=512, max_model_len=1024,
                               prefill_buckets=(128, 256, 512, 1024), speculative="ngram",
                               spec_tokens=4)}
TP_PROMPT_LENS = (200, 150, 120, 90)
TP_OSL = 16
# bf16 logits of the mesh against tp = 1 on the same weights and card: each
# rank rounds its row-parallel partial product (wo, w_down, the experts'
# down projections) to bf16 before their float32 sum, where one card rounds
# the whole product once, so every summed layer output differs by about one
# bf16 rounding (2^-9 relative) and the difference grows through the
# residual stream's layers.  Logits of these random weights are N(0, 1)
# (|max| about 5 over the vocabulary): 0.25 is 5 % of that.  DeepSeek's
# router can flip a near-tied expert choice on such a difference, which
# moves that token's FFN output wholesale: twice the bound there.  A greedy
# stream may part from tp = 1's only where tp = 1's top-2 margin is within
# the same bound (a near-tie the rounding may flip).
TP_LOGITS_ATOL = {"llama": 0.25, "deepseek": 0.5}
TP_PATH = {"llama": "paged_attention.launches", "deepseek": "mla_attention.decode_launches"}


def held_capacity(cfg):
    """A MoE config whose experts hold every routed pair (a capacity
    factor of experts / top-k), whatever the lanes route together."""
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)


async def generate_top2(engine, tokens: list[int], max_tokens: int, stamps: list, *,
                        output_format=None, extra=None):
    """Greedy tokens and, at each position, the top-2 logprob margin of one
    request through ``engine`` (a TorchLlmEngine, a DisaggDecodeEngine or a
    MultimodalEngine: ``extra`` adds its ``image``); a guided request
    (``output_format``) stops at its EOS."""
    from dynamo_tpu_torch.llm.protocols.common import (
        Annotated,
        LLMEngineOutput,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    req = PreprocessedRequest(
        token_ids=tokens, sampling=SamplingOptions(use_greedy=True, top_logprobs=2),
        stop=StopConditions(max_tokens=max_tokens, ignore_eos=output_format is None),
        eos_token_ids=[1], output_format=output_format,
    ).to_wire()
    out, margins = [], []
    async for item in await engine.generate(Context({**req, **(extra or {})})):
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is None:
            continue
        if ann.data.error:
            raise RuntimeError(ann.data.error)
        out.extend(ann.data.token_ids)
        for rows in ann.data.top_logprobs or []:
            lps = sorted((lp for _, lp in rows), reverse=True)
            margins.append(lps[0] - lps[1])
        stamps.extend([time.perf_counter()] * len(ann.data.token_ids))
    return out, margins


async def tp_burst(engine, prompts, osl, *, start=False, counted=None, sequential=False, **kw):
    """Every request through ``engine``: all at once (with ``start``, all
    queued before the engine starts; it keeps running) or one after
    another.  ``counted``: the engine whose ranks' counters are zeroed just
    before and read just after (or None).  Returns (streams, stamps,
    counts); stamps are (t0, each request's stamps), or with
    ``sequential`` (each request's start, its stamps)."""
    marks = [[] for _ in prompts]
    if counted is not None:
        counted.zero_mesh_counts()
    if sequential:
        t0, outs = [], []
        for p, m in zip(prompts, marks):
            t0.append(time.perf_counter())
            outs.append(await generate_top2(engine, p, osl, m, **kw))
    else:
        tasks = [asyncio.ensure_future(generate_top2(engine, p, osl, m, **kw))
                 for p, m in zip(prompts, marks)]
        if start:
            await asyncio.sleep(0.05)
        t0 = time.perf_counter()
        if start:
            engine.start()
        outs = await asyncio.gather(*tasks)
    counts = counted.mesh_counts() if counted is not None else None
    return outs, (t0, marks), counts


def first_logits(torch, engine, prompt: list[int]):
    """The engine's split prefill forward on ``prompt`` (every rank of a
    mesh), before it serves: the first token's logits, float32 on the
    host."""
    dev = engine.device
    n = len(prompt)
    ids = torch.zeros(engine._bucket_len(n), dtype=torch.int32, device=dev)
    ids[:n] = torch.tensor(prompt, dtype=torch.int32)
    blocks = torch.arange(engine.max_blocks_per_seq, dtype=torch.int32, device=dev)
    with torch.no_grad():
        logits, _ = engine.family.forward_prefill(
            engine.params, engine.config.model, ids, engine.cache, blocks,
            torch.tensor(n, dtype=torch.int32, device=dev), 0, engine.cos, engine.sin)
    return logits.float().cpu()


def parted_streams(case: str, ref_outs, outs, bound) -> list[dict]:
    """Where each stream parts from one card's, with one card's top-2 margin
    there; raises where that margin exceeds ``bound``."""
    parted = []
    for i, ((ref, margins), (got, _)) in enumerate(zip(ref_outs, outs)):
        at = next((k for k, (a, b) in enumerate(zip(ref, got)) if a != b), None)
        if at is None and len(ref) != len(got):
            at = min(len(ref), len(got))
        if at is not None:
            margin = margins[at] if at < len(margins) else None
            parted.append({"request": i, "position": at, "one_card_top2_margin": margin})
            if margin is None or margin > bound:
                raise AssertionError(f"{case}: a stream parts from one card's where its top-2 "
                                     f"margin is {margin} > {bound}: {parted[-1]}")
    return parted


def rank_checks(case: str, counts: list[dict], keys, enforce: bool) -> list[dict]:
    """Every rank's launches of ``keys``, its plain calls and its mesh
    seconds; with ``enforce`` (on the card) each key launched on every
    rank, no plain call."""
    ranks = [{"rank": r, **{k: c.get(k, 0) for k in keys},
              "plain_calls": sum(v for k, v in c.items() if k.endswith("plain_calls")),
              **{k: v for k, v in c.items() if k.startswith("mesh.") and k.endswith("_s")}}
             for r, c in enumerate(counts)]
    if enforce:
        for r in ranks:
            if any(r[k] <= 0 for k in keys) or r["plain_calls"]:
                raise AssertionError(f"{case}: rank {r['rank']} launched {r}")
    return ranks


def logits_check(case: str, mesh_logits, one_logits, bound: float) -> dict:
    """The mesh's first logits against one card's, within ``bound``."""
    diff = (mesh_logits - one_logits).abs().max().item()
    if not diff <= bound:
        raise AssertionError(f"{case}: mesh logits differ from one card's by {diff} > {bound}")
    return {"logits_max_abs_diff": diff, "logits_bound": bound,
            "logits_ref_absmax": one_logits.abs().max().item(),
            "argmax_equal": bool((mesh_logits.argmax(-1) == one_logits.argmax(-1)).all())}


def free_card(torch, cuda: bool) -> None:
    """Collect the engines the caller no longer holds and return their
    memory to the card, before the next engine is built."""
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def build_engine(path, device: str, sizes: dict | None, **kw):
    """``build_torch_engine`` on one card or on a mesh of ``sizes`` over
    gloo; (engine, build seconds)."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.parallel.mesh import MeshConfig
    from dynamo_tpu_torch.serve import build_torch_engine

    if sizes is not None:
        kw.update(mesh=MeshConfig(**sizes), mesh_backend=TP_BACKEND)
    t0 = time.perf_counter()
    engine = build_torch_engine(path, ModelDeploymentCard.from_local_path(path), device=device,
                                **kw)
    return engine, time.perf_counter() - t0


def phase_tp(torch, card: str, device: str = "cuda", models=TP_MODELS, engines=TP_ENGINES,
             prompt_lens=TP_PROMPT_LENS, osl: int = TP_OSL, meshfeat: bool = False) -> dict:
    """Each model served at tp = 1, then on its mesh (the ranks sharing the
    card over gloo), from the same seed's weights: the first step's logits
    within ``TP_LOGITS_ATOL``, the greedy streams equal but where tp = 1's
    top-2 margin is within it, rows 2 and 4 launched on every rank (no
    plain call), TTFT and ITL of both.  One ``smoke_tp`` line.  With
    ``meshfeat``, phase meshfeat's cases on each pair (``MF_ON_TP``) follow,
    both engines up: their reports under the result's ``"meshfeat"``."""
    from dynamo_tpu_torch.models.registry import get_family

    cuda = device == "cuda"
    report: dict = {"card": card, "backend": TP_BACKEND}
    on_tp: dict = {}
    for model, fam, config, sizes in models:
        path = model_dir(model, config)
        kw = dict(engines[fam])
        if fam == "deepseek":
            kw["model"] = held_capacity(get_family(config["model_type"]).config_from_hf(config))
        vocab = config["vocab_size"]
        prompts = [[(1000 + 37 * i + 11 * j) % vocab for j in range(n)]
                   for i, n in enumerate(prompt_lens)]
        up, runs, cases = {}, {}, {}
        try:
            for label, mesh in (("tp1", None), ("mesh", sizes)):
                engine, build_s = build_engine(path, device, mesh, **kw)
                up[label] = engine
                logits = first_logits(torch, engine, prompts[0])
                outs, stamps, counts = asyncio.run(
                    tp_burst(engine, prompts, osl, start=True, counted=engine))
                runs[label] = dict(logits=logits, outs=outs, e2e=ttft_itl(stamps),
                                   counts=counts, build_s=build_s, stats=engine.stats())
            if meshfeat:
                cases = MF_ON_TP[fam](torch, device, path, config, up["tp1"], up["mesh"])
        finally:
            for engine in up.values():
                engine.stop()
            up.clear()
            engine = None
            free_card(torch, cuda)
        bound = TP_LOGITS_ATOL[fam]
        one, mesh = runs["tp1"], runs["mesh"]
        path_key = TP_PATH[fam]
        row = {
            "mesh": sizes, **logits_check(f"tp {model}", mesh["logits"], one["logits"], bound),
            "streams_equal": sum(1 for (a, _), (b, _) in zip(one["outs"], mesh["outs"])
                                 if a == b),
            "streams": len(prompts),
            "parted": parted_streams(f"tp {model}", one["outs"], mesh["outs"], bound),
            "rank_launches": rank_checks(f"tp {model}", mesh["counts"], (path_key,), cuda),
            "mesh_steps": mesh["stats"].get("mesh_steps_total"),
            # rank 0's seconds a step: wall, collectives, hand-offs, ring
            "per_step_s": per_step(mesh["stats"].get("mesh_step_time", {})),
            "tp1": {**{k: one["e2e"][k] for k in ("ttft_ms_mean", "itl_ms_mean")},
                    "build_s": one["build_s"]},
            "mesh_e2e": {**{k: mesh["e2e"][k] for k in ("ttft_ms_mean", "itl_ms_mean")},
                         "build_s": mesh["build_s"]},
        }
        row["ranks"] = len(row["rank_launches"])
        report[fam] = row
        for case in cases.values():  # the pair's first logits, held above
            case["logits"] = {k: row[k] for k in ("logits_max_abs_diff", "logits_bound",
                                                  "argmax_equal")}
        on_tp.update(cases)
        log(f"[tp] {model} {sizes}: logits max |diff| {row['logits_max_abs_diff']:.4f} "
            f"(bound {bound}), streams equal {row['streams_equal']}/{len(prompts)}, "
            f"parted {row['parted']}, ranks' {path_key} "
            f"{[r[path_key] for r in row['rank_launches']]}, per step {row['per_step_s']}")
    print(json.dumps({"smoke_tp": report}), flush=True)
    return {**report, "meshfeat": on_tp}


# ---------------------------------------------------------------------------
# phase pp: pipeline and sequence parallelism, the ranks sharing the one card
# ---------------------------------------------------------------------------

# As phase tp: the ranks share the one card over gloo, named, so every stage
# hand-off, ring rotation and collective stages through host memory; the
# times are of that arrangement, not of NVLink.  Each model runs on one
# card first, then on each mesh, from the same seed's weights.
PP_LLAMA_MESHES = (("pp2", dict(pp=2)), ("pp2tp2", dict(pp=2, tp=2)), ("sp2", dict(sp=2)))
# the sp prefill's prompt: one bucket of 4096 positions, 2048 a rank
PP_LONG = 4096
PP_ENGINE = dict(num_blocks=1536, max_batch_size=8, max_model_len=PP_LONG + 512, seed=0,
                 prefill_buckets=(128, 256, 512, 1024, 2048, 4096), decode_overlap=False,
                 unified_batch=False)
PP_SMALL_ENGINE = dict(PP_ENGINE, num_blocks=512, max_model_len=1024,
                       prefill_buckets=(128, 256, 512, 1024))
PP_PROMPT_LENS = (200, 150, 120, 90)
PP_OSL = 16
# bf16 logits of a mesh against one card on the same weights: the stages
# alone run the same products on the same rows as one card (the hand-offs
# are bitwise), but a tp or ep rank rounds its row-parallel partial product
# to bf16 before the float32 sum (phase tp's reason: 0.25, 5 % of these
# random weights' |logit| of about 5), and the ring's float32 online
# softmax sums its chunks in another order than the dense prefill, a
# difference the bf16 attention output can round either way.  Mixtral's
# router can flip a near-tied expert on such a difference, which moves
# that token's FFN output wholesale: twice the bound, as DeepSeek's in
# phase tp.
PP_LOGITS_ATOL = {"llama": 0.25, "mixtral": 0.5}
# Gemma-2's random logits run up to its final soft-cap (30, against the
# Llama logits' 5: its sqrt(hidden) embedding scale and sandwich norms), so
# the same rounding reads larger there: 5 % of one card's |logit| max, the
# share 0.25 is of Llama's.  (Held to an absolute 0.25, an H100 at 700 W
# read 1.328 with every stream equal.)
PP_LOGITS_REL = {"gemma2": 0.05}
# the decode's kernel on every rank of these meshes (Gemma-2's attention is
# the plain form on every device: no kernel stands behind it)
PP_PATH = "paged_attention.launches"


def pp_models(torch):
    """(label, registry family, config, meshes, engine fields, prompt lengths)
    of the phase: Llama-3-8B at full width and an eighth of its depth (4
    of its 32 layers, so that the whole smoke keeps its time with phases
    meshfeat, autotune and plane) on
    pp, pp x tp and sp (a 4096-token prompt beside the short ones),
    Mixtral-8x7B at full width
    and 8 of its 32 layers on pp x ep (every routed token held: a capacity
    factor of experts / top-k, since a microbatch routes alone), Gemma-2-2B
    at full width and depth on pp x tp."""
    from dynamo_tpu_torch.models.registry import get_family

    def parse(family, config):
        return get_family(family).config_from_hf(config)

    mix = held_capacity(parse("mixtral", MIXTRAL_8X7B))
    return (
        ("llama3-8b", "llama", parse("llama", dict(LLAMA3_8B, num_hidden_layers=4)),
         PP_LLAMA_MESHES, PP_ENGINE,
         (*PP_PROMPT_LENS, PP_LONG)),
        ("mixtral-8x7b-8l", "mixtral", mix, (("pp2ep2", dict(pp=2, ep=2)),), PP_SMALL_ENGINE,
         PP_PROMPT_LENS),
        ("gemma2-2b", "gemma2", parse("gemma2", GEMMA2_2B), (("pp2tp2", dict(pp=2, tp=2)),),
         PP_SMALL_ENGINE, PP_PROMPT_LENS),
    )


def per_step(step_time: dict) -> dict:
    """Rank 0's seconds a step of each program: wall, and of it in
    collectives, stage hand-offs, ring rotations and block transfers."""
    return {prog: {"steps": r["steps"],
                   **{k: r.get(k, 0.0) / max(r["steps"], 1)
                      for k in ("wall_s", "collective_s", "handoff_s", "ring_s", "transfer_s")}}
            for prog, r in step_time.items()}


def phase_pp(torch, card: str, device: str = "cuda", models=None, osl: int = PP_OSL) -> dict:
    """Each model on one card, then on each of its meshes (the ranks sharing
    the card over gloo), from the same seed's weights: the first step's
    logits of every prompt within ``PP_LOGITS_ATOL``, the greedy streams
    equal but where one card's top-2 margin is within it, row 2 launched
    on every rank of the llama and Mixtral meshes (no plain call), and the
    seconds per step in collectives, stage hand-offs and ring rotations
    beside the step's wall time.  One ``smoke_pp`` line."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
    from dynamo_tpu_torch.parallel.mesh import MeshConfig

    cuda = device == "cuda"
    report: dict = {"card": card, "backend": TP_BACKEND}
    for model, family, cfg, meshes, engine_kw, lens in models or pp_models(torch):
        vocab = cfg.vocab_size
        prompts = [[(1000 + 37 * i + 11 * j) % vocab for j in range(n)]
                   for i, n in enumerate(lens)]
        runs = {}
        for label, sizes in (("one", None), *meshes):
            # the long prompt (the sp prefill's) on one card and the sp mesh
            mine = [p for p in prompts if len(p) < PP_LONG or label == "one"
                    or (sizes or {}).get("sp", 1) > 1]
            over = dict(engine_kw)
            if sizes is not None:
                over.update(mesh=MeshConfig(**sizes), mesh_backend=TP_BACKEND)
            t0 = time.perf_counter()
            engine = TorchLlmEngine(EngineConfig(model=cfg, model_family=family, **over),
                                    device=device)
            build_s = time.perf_counter() - t0
            try:
                logits = {len(p): first_logits(torch, engine, p) for p in mine}
                outs, stamps, counts = asyncio.run(
                    tp_burst(engine, mine, osl, start=True, counted=engine))
                stats = engine.stats()
            finally:
                engine.stop()
                engine = None
                free_card(torch, cuda)
            runs[label] = dict(logits=logits, outs={len(p): o for p, o in zip(mine, outs)},
                               e2e=ttft_itl(stamps), counts=counts, build_s=build_s,
                               stats=stats)
        one = runs["one"]
        ref_absmax = max(x.abs().max().item() for x in one["logits"].values())
        bound = PP_LOGITS_ATOL.get(family) or PP_LOGITS_REL[family] * ref_absmax
        rows = {}
        for label, sizes in meshes:
            run = runs[label]
            case = f"pp {model} {label}"
            lens_run = list(run["outs"])
            rows[label] = row = {
                "mesh": sizes,
                **logits_check(case, torch.stack([run["logits"][n] for n in lens_run]),
                               torch.stack([one["logits"][n] for n in lens_run]), bound),
                "streams_equal": sum(1 for n, (got, _) in run["outs"].items()
                                     if got == one["outs"][n][0]),
                "streams": len(run["outs"]),
                "parted": [{**p, "prompt_len": lens_run[p["request"]]} for p in parted_streams(
                    case, [one["outs"][n] for n in lens_run], list(run["outs"].values()),
                    bound)],
                # the Gemma-2 meshes' attention is the plain form on every
                # device: no kernel stands behind it
                "rank_launches": rank_checks(case, run["counts"], (PP_PATH,),
                                             cuda and family != "gemma2"),
                "mesh_steps": run["stats"].get("mesh_steps_total"),
                "per_step_s": per_step(run["stats"].get("mesh_step_time", {})),
                "e2e": {**{k: run["e2e"][k] for k in ("ttft_ms_mean", "itl_ms_mean")},
                        "build_s": run["build_s"]},
            }
            row["ranks"] = len(row["rank_launches"])
            log(f"[pp] {model} {sizes}: logits max |diff| {row['logits_max_abs_diff']:.4f} "
                f"(bound {bound:.4f}), streams equal {row['streams_equal']}/{row['streams']}, "
                f"parted {row['parted']}, ranks' {PP_PATH} "
                f"{[r[PP_PATH] for r in row['rank_launches']]}, per step {row['per_step_s']}")
        report[model] = {"family": family, "layers": cfg.num_layers, "meshes": rows,
                         "one_card": {**{k: one["e2e"][k] for k in ("ttft_ms_mean",
                                                                     "itl_ms_mean")},
                                      "build_s": one["build_s"]}}
    print(json.dumps({"smoke_pp": report}), flush=True)
    return report


# ---------------------------------------------------------------------------
# phase meshfeat: speculation, offload, disaggregation, guided JSON and
# multimodal requests on an engine mesh, the ranks sharing the one card
# ---------------------------------------------------------------------------

# As phases tp and pp: the ranks share the one card over gloo, named; every
# collective and every block transfer to and from rank 0 stages through host
# memory.  Each case serves one card and the mesh on the same seed's
# weights, and holds the mesh to one card with phase tp's bounds.  (a) and
# (b) share one engine pair here (speculation with the offload tiers under
# it), and (f) has its own; (c) + (d) and (e) run on phase tp's Llama and
# DeepSeek pairs (``MF_ON_TP``), whose first logits phase tp holds.
# (a) and (b) serve Llama-3-8B at 16 of its 32 layers (all 32 before phase
# plane came); (f) LLaVA-1.5-7B at 16 of its text model's 32, so that the
# whole smoke keeps its time
MF_LLAMA = dict(LLAMA3_8B, num_hidden_layers=16)
MF_LLAVA = {**LLAVA_1_5_7B, "text_config": dict(LLAVA_1_5_7B["text_config"],
                                                num_hidden_layers=16)}
MF_SPEC_OFFLOAD = dict(num_blocks=128, host_offload_blocks=512, prefetch=True, max_batch_size=8,
                       max_model_len=2048, seed=0, prefill_buckets=(128, 256, 512, 1024, 2048),
                       decode_overlap=False, unified_batch=False, speculative="ngram",
                       spec_tokens=4)
MF_MM = dict(num_blocks=1024, max_batch_size=8, max_model_len=2048, seed=0,
             prefill_buckets=(128, 256, 512, 1024, 2048), decode_overlap=False,
             unified_batch=False)
MF_SPEC_OSL = 32
MF_SESSIONS, MF_SESSION_LEN, MF_TURN_OSL = 6, 1024, 2
MF_DISAGG_PROMPTS, MF_DISAGG_ISL, MF_DISAGG_OSL = 4, 2048, 16
# (d): greedy decoding of random weights seldom ends a JSON number (a run of
# one digit is its fixed point), so the four guided prompts are those of
# these candidates whose documents one card closes, at the widest top-2
# margins (the mesh then has the least room to part from them); on the
# mesh each of the four must close and parse
MF_GUIDED_CANDIDATES, MF_GUIDED_PROMPTS, MF_GUIDED_OSL = 32, 4, 32
MF_MM_OSL = 16
# each case's kernel on every rank, none of them a plain call
MF_PATHS = {"spec": ("paged_attention.window_launches",),
            "offload": ("block_copy.gather_launches", "block_copy.scatter_launches"),
            "disagg_tp2_to_one": ("block_copy.gather_launches",),
            "disagg_one_to_tp2": ("block_copy.scatter_launches",),
            "guided": ("paged_attention.launches",),
            "deepseek_spec": ("mla_attention.window_launches",),
            "llava": ("paged_attention.launches",)}
MF_SPEC_KEYS = ("spec_drafted_tokens_total", "spec_accepted_tokens_total",
                "spec_verify_steps_total")


def lookup_prompts(vocab: int, n: int = 4, length: int = 192) -> list[list[int]]:
    """Prompt-lookup-friendly prompts: each a phrase of 12 ids repeated."""
    rng = random.Random(22)
    out = []
    for _ in range(n):
        phrase = [rng.randrange(3, vocab) for _ in range(12)]
        out.append((phrase * (length // 12 + 1))[:length])
    return out


def own_ttft_ms(stamps) -> float:
    """Mean TTFT of requests sent one after another, each from its own
    start (``tp_burst(sequential=True)``'s stamps)."""
    starts, marks = stamps
    return sum(m[0] - s for s, m in zip(starts, marks)) / len(marks) * 1e3


def e2e_ms(stamps) -> dict:
    return {k: ttft_itl(stamps)[k] for k in ("ttft_ms_mean", "itl_ms_mean")}


def mf_spec_offload(torch, device: str) -> dict:
    """(a) n-gram speculation (row 2 at W = 5 on each rank's head shard)
    and (b) six sessions of two 1024-token turns over G1 128 blocks on
    G2 512 (every returning turn restores; the pager on): Llama-3-8B at 16
    of its 32 layers, tp 2 against one card.  After (b) each block restored on the
    mesh and still resident is gathered from every rank's shard again:
    each rank's slice bitwise equal to what it held when the block was
    evicted."""
    cuda = device == "cuda"
    path = model_dir("llama3-8b-meshfeat-spec", MF_LLAMA)
    vocab = MF_LLAMA["vocab_size"]
    spec_prompts = lookup_prompts(vocab)
    rng = random.Random(6)
    heads = [[rng.randrange(3, vocab) for _ in range(MF_SESSION_LEN)] for _ in range(MF_SESSIONS)]
    runs = {}
    for label, sizes in (("one", None), ("mesh", dict(tp=2))):
        engine, build_s = build_engine(path, device, sizes, **MF_SPEC_OFFLOAD)
        mesh = engine if sizes is not None else None
        evicted, restored = {}, []
        if mesh is not None:
            put = engine._put_offloaded

            def record(pairs, gathered, put=put):
                for i, (_, h) in enumerate(pairs):
                    evicted.setdefault(h, {k: v[:, i].cpu().clone()
                                           for k, v in gathered.items()})
                return put(pairs, gathered)

            engine._put_offloaded = record
            reg = engine.allocator.register_restored

            def on_restore(plan, reg=reg):
                restored.extend(plan)
                return reg(plan)

            engine.allocator.register_restored = on_restore
        try:
            logits = first_logits(torch, engine, spec_prompts[0])
            engine.start()

            async def drive():
                spec = await tp_burst(engine, spec_prompts, MF_SPEC_OSL, counted=engine)
                st_a = engine.stats()
                await settled(engine)
                # both turns counted: the first turn's evictions offload, the
                # returning turns restore (and evict again)
                engine.zero_mesh_counts()
                first = await tp_burst(engine, [h[:] for h in heads], MF_TURN_OSL,
                                       sequential=True)
                turn2 = [h + out + [(7 * i + 3) % vocab for i in range(16)]
                         for h, (out, _) in zip(heads, first[0])]
                second = await tp_burst(engine, turn2, MF_TURN_OSL, sequential=True)
                await settled(engine)
                return spec, st_a, first, second, engine.mesh_counts(), engine.stats()

            (spec, st_a, first, second, counts_b, st_b) = asyncio.run(drive())
            shard_check = None
            if mesh is not None:
                shard_check = {"restored": len(restored), "checked": 0, "rank_slices_equal": 0}
                # the restored blocks still resident, gathered in one step
                live = [(h, bid) for h, bid in dict(restored).items()
                        if engine.allocator._hash_to_block.get(h) == bid and h in evicted]
                now = engine._gather_cache([bid for _, bid in live]) if live else {}
                for name, whole in now.items():
                    whole = whole.cpu()
                    for i, (h, bid) in enumerate(live):
                        before = evicted[h][name]
                        for r in range(engine.mesh.world_size):
                            sl = engine._shards.slices(name, 1, r)
                            a = whole[(sl[0], slice(i, i + 1), *sl[2:])][:, 0]
                            b = before[(sl[0], *sl[2:])]
                            if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                                raise AssertionError(f"meshfeat offload: rank {r}'s shard of "
                                                     f"restored block {bid} ({name}) differs "
                                                     f"from its shard at eviction")
                            shard_check["rank_slices_equal"] += 1
                shard_check["checked"] = len(live)
                if shard_check["checked"] <= 0:
                    raise AssertionError(f"meshfeat offload: no restored block to check: "
                                         f"{shard_check}")
            runs[label] = dict(logits=logits, spec=spec, st_a=st_a, first=first, second=second,
                               counts_b=counts_b, st_b=st_b, build_s=build_s,
                               shard_check=shard_check)
        finally:
            engine.stop()
            engine = mesh = put = reg = record = on_restore = None
            free_card(torch, cuda)
    one, mesh_run = runs["one"], runs["mesh"]
    bound = TP_LOGITS_ATOL["llama"]
    out = {"logits": logits_check("meshfeat spec", mesh_run["logits"], one["logits"], bound)}
    out["spec"] = {
        "parted": parted_streams("meshfeat spec", one["spec"][0], mesh_run["spec"][0], bound),
        "streams": len(spec_prompts),
        "ranks": rank_checks("meshfeat spec", mesh_run["spec"][2], MF_PATHS["spec"], cuda),
        "mesh": {**{k: mesh_run["st_a"].get(k) for k in MF_SPEC_KEYS},
                 **e2e_ms(mesh_run["spec"][1])},
        "one": {**{k: one["st_a"].get(k) for k in MF_SPEC_KEYS}, **e2e_ms(one["spec"][1])},
        "verify_step_s": per_step(mesh_run["st_a"].get("mesh_step_time", {})).get("verify"),
    }
    if not mesh_run["st_a"].get("spec_verify_steps_total"):
        raise AssertionError(f"meshfeat spec: no verify window ran: {out['spec']}")
    st = mesh_run["st_b"]
    restores = st.get("host_restores_total", 0)
    out["offload"] = {
        "parted": (parted_streams("meshfeat offload", one["first"][0], mesh_run["first"][0],
                                  bound)
                   + parted_streams("meshfeat offload", one["second"][0],
                                    mesh_run["second"][0], bound)),
        "streams": 2 * MF_SESSIONS,
        "ranks": rank_checks("meshfeat offload", mesh_run["counts_b"], MF_PATHS["offload"],
                             cuda),
        "host_offloads": st.get("host_offloads_total"), "host_restores": restores,
        "one_card_restores": one["st_b"].get("host_restores_total"),
        "prefetch_restored": st.get("prefetch_blocks_restored_total"),
        "shard_check": mesh_run["shard_check"],
        "transfer_s": {p: r.get("transfer_s") for p, r in st.get("mesh_step_time", {}).items()
                       if p in ("gather", "scatter")},
        "gather_scatter_step_s": {p: v for p, v in per_step(st.get("mesh_step_time", {})).items()
                                  if p in ("gather", "scatter")},
        "turn_ttft_ms": {label: {turn: own_ttft_ms(r[turn][1]) for turn in ("first", "second")}
                         for label, r in (("mesh", mesh_run), ("one", one))},
    }
    if restores <= 0:
        raise AssertionError(f"meshfeat offload: no returning turn restored: {out['offload']}")
    out["build_s"] = {"one": one["build_s"], "mesh": mesh_run["build_s"]}
    return out


def json_docs(tok, masks, strings, streams) -> list[dict]:
    """Each guided stream walked through the JSON automaton (raises where it
    leaves JSON); its text, and whether it closed and parses."""
    from dynamo_tpu_torch.llm import guided

    docs = []
    for ids, margins in streams:
        cursor = guided.JsonCursor(masks, strings, eos_ids=tok.eos_token_ids)
        for t in ids:
            cursor.advance(t)
            if cursor.failed:
                raise AssertionError(f"meshfeat guided: a stream left JSON at {t}: {ids}")
        text = tok.decode(ids, skip_special_tokens=True)
        parses = False
        if cursor.complete:
            json.loads(text)
            parses = True
        docs.append({"tokens": len(ids), "parses": parses, "text": text[:80],
                     "min_top2_margin": min(margins, default=0.0)})
    return docs


def mf_disagg_guided(torch, device: str, path, config: dict, one, mesh) -> dict:
    """On phase tp's Llama pair (both engines serving).  (c) Disaggregation
    over the same-process route (the blocks stay on the card), four
    2048-token prompts each way: the tp 2 engine prefilling for the
    one-card engine, and the one-card engine for the tp 2 engine; each
    stream held against the one-card engine's aggregated one.  (d) Four
    ``json_object`` requests on the tp 2 engine (the launch path installs
    the table), chosen on one card (``MF_GUIDED_CANDIDATES``): each must
    close and parse, held against one card's."""
    from dynamo_tpu_torch.llm.disagg import (
        DisaggConfig,
        DisaggDecodeEngine,
        DisaggRouter,
        PrefillQueue,
        PrefillWorker,
    )
    from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    cuda = device == "cuda"
    tok = HfTokenizer.from_model_dir(path)
    vocab = config["vocab_size"]
    rng = random.Random(8)
    prompts = [[rng.randrange(3, vocab) for _ in range(MF_DISAGG_ISL)]
               for _ in range(MF_DISAGG_PROMPTS)]
    candidates = [[rng.randrange(3, vocab) for _ in range(24 + 4 * i)]
                  for i in range(MF_GUIDED_CANDIDATES)]
    if one.guided_masks is None or mesh.guided_masks is None:
        raise AssertionError("meshfeat guided: the launch path installed no table")
    masks, strings = mesh.guided_masks, mesh._guided_strings

    async def route(prefill, decode, n: int):
        rt = await DistributedRuntime.create(RuntimeConfig(
            control_plane=f"memory://smoke-meshfeat-{n}"))
        router = DisaggRouter(rt, "meshfeat", DisaggConfig(max_local_prefill_length=64))
        queue = PrefillQueue(rt, "smoke", "meshfeat")
        front = DisaggDecodeEngine(rt, decode, router, queue)
        await front.start()
        worker = PrefillWorker(rt, prefill, queue, stream=False)
        worker.start()
        try:
            res = await tp_burst(front, prompts, MF_DISAGG_OSL, counted=mesh)
            return res, {"remote_prefills": front.remote_prefills,
                         "kv_transfer_bytes": front.kv_transfer_bytes_total}
        finally:
            await worker.stop()
            await front.stop()
            await rt.close()

    async def drive():
        for e in (one, mesh):
            await settled(e)
            await e.clear_kv_blocks()
        agg = await tp_burst(one, prompts, MF_DISAGG_OSL)
        await settled(one)
        routes = {}
        for n, (name, pre, dec) in enumerate((("disagg_tp2_to_one", mesh, one),
                                               ("disagg_one_to_tp2", one, mesh))):
            for e in (one, mesh):
                await e.clear_kv_blocks()
            routes[name] = await route(pre, dec, n)
            await settled(one)
            await settled(mesh)
        cands = await tp_burst(one, candidates, MF_GUIDED_OSL, output_format="json_object")
        await settled(one)
        closed = [(d["min_top2_margin"], i) for i, d in
                  enumerate(json_docs(tok, masks, strings, cands[0])) if d["parses"]]
        if len(closed) < MF_GUIDED_PROMPTS:
            raise AssertionError(f"meshfeat guided: one card closed {len(closed)} of "
                                 f"{len(candidates)} documents, fewer than "
                                 f"{MF_GUIDED_PROMPTS}")
        pick = [i for _, i in sorted(closed, reverse=True)[:MF_GUIDED_PROMPTS]]
        chosen = [candidates[i] for i in pick]
        g_one = await tp_burst(one, chosen, MF_GUIDED_OSL, output_format="json_object")
        g_mesh = await tp_burst(mesh, chosen, MF_GUIDED_OSL, counted=mesh,
                                output_format="json_object")
        return agg, routes, (len(closed), pick), g_one, g_mesh, mesh.stats()

    agg, routes, (n_closed, pick), g_one, g_mesh, st = asyncio.run(drive())
    bound = TP_LOGITS_ATOL["llama"]
    out = {}
    for name, (res, info) in routes.items():
        if info["remote_prefills"] != len(prompts):
            raise AssertionError(f"meshfeat {name}: {info['remote_prefills']} of {len(prompts)} "
                                 f"prompts prefilled remotely")
        out[name] = {"parted": parted_streams(f"meshfeat {name}", agg[0], res[0], bound),
                     "streams": len(prompts),
                     "ranks": rank_checks(f"meshfeat {name}", res[2], MF_PATHS[name], cuda),
                     **info, **e2e_ms(res[1])}
    out["aggregated_one_card"] = e2e_ms(agg[1])
    docs = json_docs(tok, masks, strings, g_mesh[0])
    unparsed = [d for d in docs if not d["parses"]]
    if unparsed:
        raise AssertionError(f"meshfeat guided: {len(unparsed)} of {len(docs)} documents did "
                             f"not close: {unparsed}")
    out["guided"] = {"parted": parted_streams("meshfeat guided", g_one[0], g_mesh[0], bound),
                     "docs": docs, "parse": len(docs),
                     "one_card_closed": f"{n_closed} of {len(candidates)}", "chosen": pick,
                     "ranks": rank_checks("meshfeat guided", g_mesh[2], MF_PATHS["guided"],
                                          cuda),
                     "guided_requests": st.get("guided_requests_total"), **e2e_ms(g_mesh[1])}
    out["transfer_step_s"] = {p: v for p, v in per_step(st.get("mesh_step_time", {})).items()
                              if p in ("gather", "scatter")}
    return {"disagg_guided": out}


def mf_deepseek(torch, device: str, path, config: dict, one, mesh) -> dict:
    """(e) On phase tp's DeepSeek-V2-Lite pair (tp 2 x ep 2, every routed
    pair held, n-gram speculation; both engines serving): four
    prompt-lookup prompts, row 5 on each rank's 8 heads over the whole
    latent cache, against one card."""
    cuda = device == "cuda"
    prompts = lookup_prompts(config["vocab_size"])

    async def drive():
        res = {}
        for label, e in (("one", one), ("mesh", mesh)):
            await settled(e)
            before = e.stats()
            burst = await tp_burst(e, prompts, MF_SPEC_OSL, counted=e)
            after = e.stats()
            res[label] = (burst, {k: after.get(k, 0) - before.get(k, 0) for k in MF_SPEC_KEYS},
                          after)
        return res

    res = asyncio.run(drive())
    (one_res, one_spec, _), (mesh_res, mesh_spec, st) = res["one"], res["mesh"]
    bound = TP_LOGITS_ATOL["deepseek"]
    out = {"parted": parted_streams("meshfeat deepseek", one_res[0], mesh_res[0], bound),
           "streams": len(prompts),
           "ranks": rank_checks("meshfeat deepseek", mesh_res[2], MF_PATHS["deepseek_spec"],
                                cuda),
           "mesh": {**mesh_spec, **e2e_ms(mesh_res[1])},
           "one": {**one_spec, **e2e_ms(one_res[1])},
           "verify_step_s": per_step(st.get("mesh_step_time", {})).get("verify")}
    if not mesh_spec["spec_verify_steps_total"]:
        raise AssertionError(f"meshfeat deepseek: no verify window ran: {out}")
    return {"deepseek_spec": out}


# phase meshfeat's cases on phase tp's engine pairs, by family
MF_ON_TP = {"llama": mf_disagg_guided, "deepseek": mf_deepseek}


def mf_llava(torch, device: str) -> dict:
    """(f) LLaVA-1.5-7B at tp 2: two images through ``MultimodalEngine`` (the
    ViT on rank 0's card, the patch embeddings spliced on every rank), the
    first logits of the first image's prefill and the greedy streams held
    against one card's."""
    import numpy as np

    from dynamo_tpu_torch.examples.multimodal.pipeline import start_engine
    from dynamo_tpu_torch.llm.multimodal import decode_image_bytes
    from dynamo_tpu_torch.models.vision import VisionConfig
    from dynamo_tpu_torch.parallel.mesh import MeshConfig

    cuda = device == "cuda"
    vcfg = VisionConfig.from_hf_config(MF_LLAVA)
    path = model_dir("llava-1.5-7b-meshfeat", MF_LLAVA["text_config"])
    vocab = MF_LLAVA["text_config"]["vocab_size"]
    images = [decode_image_bytes(png_data_url(40 + i)[1]) for i in range(2)]
    rng = random.Random(9)
    text = [[rng.randrange(3, vocab) for _ in range(48)] for _ in images]
    runs = {}
    for label, sizes in (("one", None), ("mesh", dict(tp=2))):
        over = dict(MF_MM)
        if sizes is not None:
            over.update(mesh=MeshConfig(**sizes), mesh_backend=TP_BACKEND)

        async def drive(over=over):
            t0 = time.perf_counter()
            handle = await start_engine(str(path), device=device, name=f"meshfeat-{label}",
                                        vision=vcfg, **over)
            build_s = time.perf_counter() - t0
            try:
                llm = handle.llm
                embeds = handle.encoder.encode(images[0])
                logits = first_logits_mm(torch, llm, text[0], np.asarray(embeds, np.float32))
                marks = [[] for _ in images]
                llm.zero_mesh_counts()
                t1 = time.perf_counter()
                outs = await asyncio.gather(*[
                    generate_top2(handle.engine, t, MF_MM_OSL, m, extra={"image": im})
                    for t, im, m in zip(text, images, marks)])
                return dict(logits=logits, outs=outs, stamps=(t1, marks),
                            counts=llm.mesh_counts(), st=llm.stats(), build_s=build_s)
            finally:
                await handle.shutdown()

        runs[label] = asyncio.run(drive())
        free_card(torch, cuda)
    one, mesh_run = runs["one"], runs["mesh"]
    bound = TP_LOGITS_ATOL["llama"]
    return {"logits": logits_check("meshfeat llava", mesh_run["logits"], one["logits"], bound),
            "parted": parted_streams("meshfeat llava", one["outs"], mesh_run["outs"], bound),
            "streams": len(images), "patches": vcfg.num_patches,
            "ranks": rank_checks("meshfeat llava", mesh_run["counts"], MF_PATHS["llava"], cuda),
            "embeds_steps": mesh_run["st"].get("mesh_step_time", {}).get("embeds",
                                                                          {}).get("steps"),
            "mesh": e2e_ms(mesh_run["stamps"]), "one": e2e_ms(one["stamps"]),
            "build_s": {"one": one["build_s"], "mesh": mesh_run["build_s"]}}


def first_logits_mm(torch, engine, tokens: list[int], embeds) -> "torch.Tensor":
    """The engine's multimodal prefill (``forward_prefill_spliced``, every
    rank of a mesh) of ``embeds`` then ``tokens``, before it serves: the
    first token's logits, float32 on the host."""
    dev = engine.device
    n_patch, n = len(embeds), len(embeds) + len(tokens)
    pad = engine._bucket_len(n)
    ids = torch.zeros(pad, dtype=torch.int32, device=dev)
    ids[n_patch:n] = torch.tensor(tokens, dtype=torch.int32)
    x = torch.zeros((pad, embeds.shape[1]), dtype=torch.float32, device=dev)
    x[:n_patch] = torch.from_numpy(embeds).to(dev)
    blocks = torch.arange(engine.max_blocks_per_seq, dtype=torch.int32, device=dev)
    with torch.no_grad():
        logits, _ = engine.family.forward_prefill_spliced(
            engine.params, engine.config.model, ids, engine.cache, x,
            torch.tensor(n_patch, dtype=torch.int32, device=dev), blocks,
            torch.tensor(n, dtype=torch.int32, device=dev), 0, engine.cos, engine.sin)
    return logits.float().cpu()


def phase_meshfeat(torch, card: str, device: str = "cuda", on_tp: dict | None = None) -> dict:
    """Speculation, the offload tiers, disaggregation, guided JSON and
    multimodal requests on engine meshes (the ranks sharing the card over
    gloo), each against one card on the same seed's weights: (a) + (b)
    ``mf_spec_offload`` and (f) ``mf_llava`` here, (c) + (d) and (e) from
    phase tp's engine pairs (``on_tp``, phase tp's result's
    ``"meshfeat"``).  Each: the first logits within phase tp's bound, the
    greedy streams equal but where one card's top-2 margin is within it,
    the case's kernels on every rank with no plain call (rows 2 at W = 5
    and 5, rows 6-7), TTFT and ITL, rank 0's transfer seconds.  One
    ``smoke_meshfeat`` line."""
    report: dict = {"card": card, "backend": TP_BACKEND}
    for name, fn in (("spec_offload", mf_spec_offload), ("llava", mf_llava)):
        free_card(torch, device == "cuda")
        t0 = time.perf_counter()
        report[name] = fn(torch, device)
        report[name]["wall_s"] = time.perf_counter() - t0
        log(f"[meshfeat] {name} in {report[name]['wall_s']:.1f}s: "
            + json.dumps(report[name], default=str))
    missing = {"disagg_guided", "deepseek_spec"} - set(on_tp or {})
    if missing:
        raise AssertionError(f"meshfeat: phase tp ran no {sorted(missing)}")
    report.update(on_tp)
    print("smoke_meshfeat " + json.dumps(report, default=str), flush=True)
    return report


# ---------------------------------------------------------------------------
# phase autotune: the ragged kernel's measured layout in the unified graphs
# ---------------------------------------------------------------------------

# phase serve's engine (Llama-3-8B geometry at 16 layers, 8 lanes, 4096
# positions, 1024 blocks of 16, bf16) and its traffic: four chats of 64
# tokens, the long prompt (24 out) landing while they decode
AUTOTUNE_CHATS = [f"request {i}: tell me" for i in range(4)]
AUTOTUNE_OSL = (64, 24)   # the chats', the long prompt's
AUTOTUNE_REPS = 50        # timed launches a candidate and workload
AUTOTUNE_LOGITS_ATOL = TP_LOGITS_ATOL["llama"]  # the smoke's bf16 bound on Llama logits


def autotune_geometry(config: dict, engine_kw: dict):
    """The autotuner's key for phase serve's engine."""
    from dynamo_tpu_torch.ops.autotune import Geometry

    return Geometry(num_heads=config["num_attention_heads"],
                    num_kv_heads=config["num_key_value_heads"], head_dim=config["head_dim"],
                    block_size=16, lanes=engine_kw["max_batch_size"],
                    max_blocks_per_seq=-(-engine_kw["max_model_len"] // 16))


def width_bitwise(torch, geom, tb: int, ps: int) -> dict:
    """Row 1 at ``tb`` on the two synthetic workloads, the worklist at
    ``ps`` and at the full width, the same inputs and the same work plan
    (made from ``page_count``, which the width does not change): the outputs
    must be equal bit for bit."""
    import numpy as np

    from dynamo_tpu_torch.ops import autotune
    from dynamo_tpu_torch.ops.kernels import ragged_attention as ra

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    h, kvh, d, bs = geom.num_heads, geom.num_kv_heads, geom.head_dim, geom.block_size
    pages = geom.lanes * geom.max_blocks_per_seq
    k = torch.randn((pages, bs, kvh, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((pages, bs, kvh, d), generator=gen, device=dev).to(torch.bfloat16)
    rows = tb * (h // kvh)
    planner = ra.ragged_planner(kvh, torch.cuda.get_device_properties(dev).multi_processor_count,
                                rows, d)
    full = tb * geom.max_blocks_per_seq
    out = {}
    for name, (token_lane, token_pos, bt) in zip(("decode", "mixed"),
                                                 autotune._synthetic_workloads(geom, tb)):
        q = torch.randn((len(token_lane), h, d), generator=gen, device=dev).to(torch.bfloat16)
        res = []
        for width in (ps, full):
            meta = ra.pack_page_meta(token_lane, token_pos, bt, tb_tokens=tb, block_size=bs,
                                     page_slots=width)
            args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                    for a in (bt, token_lane, token_pos, *meta)]
            res.append(ra.ragged_paged_attention(q, k, v, *args, tb_tokens=tb,
                                                 plan=planner.plan(meta[3])))
        torch.cuda.synchronize()
        out[name] = {"tokens": len(token_lane), "page_count_max": int(meta[3].max()),
                     "bitwise": bool(torch.equal(res[0], res[1]))}
        if not out[name]["bitwise"]:
            raise AssertionError(f"autotune: row 1 at width {ps} is not its full-width "
                                 f"result at tb {tb} ({name}): "
                                 f"{(res[0].float() - res[1].float()).abs().max().item()}")
    return out


def unified_logits(torch, engine, prompts: list[list[int]]):
    """The family's unified forward over ``prompts`` as one window of whole
    prefill spans (lane i, fresh blocks from the bottom of the pool; the
    engine stopped, its cache free) at the engine's token block and
    worklist width, balanced by its planner's plan: each lane's last-token
    logits, float32 on the host."""
    import numpy as np

    from dynamo_tpu_torch.ops.kernels import pack_page_meta

    cfg, dev = engine.config, engine.device
    bs, tb, lanes = cfg.block_size, engine._unified_tb, cfg.max_batch_size
    total = sum(len(p) for p in prompts)
    t = -(-total // tb) * tb
    ids = np.zeros((t,), np.int32)
    pos = np.full((t,), -1, np.int32)
    slot = np.full((t,), cfg.num_blocks * bs, np.int32)
    lane = np.full((t,), lanes, np.int32)
    bt = np.zeros((lanes, engine.max_blocks_per_seq), np.int32)
    ctx = np.zeros((lanes,), np.int32)
    rows = np.zeros((lanes,), np.int32)
    cursor = block = 0
    for i, p in enumerate(prompts):
        n, nb = len(p), -(-len(p) // bs)
        bt[i, :nb] = np.arange(block, block + nb)
        block += nb
        ppos = np.arange(n, dtype=np.int32)
        ids[cursor: cursor + n] = p
        pos[cursor: cursor + n] = ppos
        slot[cursor: cursor + n] = bt[i, ppos // bs] * bs + ppos % bs
        lane[cursor: cursor + n] = i
        ctx[i], rows[i] = n, cursor + n - 1
        cursor += n
    ug = engine._unified
    try:
        meta = pack_page_meta(lane, pos, bt, tb_tokens=tb, block_size=bs,
                              page_slots=ug.page_slots)
    except ValueError:
        meta = pack_page_meta(lane, pos, bt, tb_tokens=tb, block_size=bs,
                              page_slots=ug.full_slots)
    plan = ug.planner.plan(meta[3]) if ug.planner else None

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    with torch.no_grad():
        logits, _ = engine.family.forward_unified(
            engine.params, cfg.model, up(ids), engine.cache, up(bt), up(ctx), up(pos),
            up(slot), up(lane), *(up(a) for a in meta), up(rows), engine.cos, engine.sin,
            tb_tokens=tb, pages_per_step=engine._unified_pps, plan=plan)
    return logits[: len(prompts)].float().cpu()


async def autotune_traffic(engine, prompts: list[list[int]]) -> tuple[list[list[int]], dict]:
    """Phase serve's traffic on ``engine`` in process, greedy: the four
    chats, and the long prompt landing half a second later; each stream's
    ids, and the traffic's wall seconds, the long prompt's TTFT and the
    chats' ITL p50 (host clock)."""
    stamps = [[] for _ in prompts]
    t0 = time.perf_counter()
    chats = [asyncio.ensure_future(generate_tokens(engine, p, AUTOTUNE_OSL[0], m))
             for p, m in zip(prompts[:-1], stamps)]
    await asyncio.sleep(0.5)
    t_long = time.perf_counter()
    long = asyncio.ensure_future(generate_tokens(engine, prompts[-1], AUTOTUNE_OSL[1],
                                                 stamps[-1]))
    out = list(await asyncio.gather(*chats, long))
    itl = [b - a for m in stamps[:-1] for a, b in zip(m, m[1:]) if b > a]
    return out, {"wall_s": time.perf_counter() - t0,
                 "long_ttft_ms": (stamps[-1][0] - t_long) * 1e3,
                 "chat_itl_ms_p50": pctile(itl, 0.5) * 1e3 if itl else None}


async def traffic_twice(engine, prompts):
    """``autotune_traffic`` twice on one engine: the first pass captures the
    graphs its windows reach (no warmup), the second, on ``prompts[1]``
    (other texts, so no prefix hit), is timed warm.  Both passes' streams,
    and the second's times."""
    first, _ = await autotune_traffic(engine, prompts[0])
    await settled(engine)
    second, times = await autotune_traffic(engine, prompts[1])
    return [first, second], times


def phase_autotune(torch, card: str, config: dict = SERVE_LLAMA,
                   engine_kw: dict = SERVE_ENGINE) -> dict:
    """The kernel autotuner (``ops/autotune.py``) on the card and its tuned
    layout in the unified graphs, at phase serve's engine (the Llama-3-8B
    geometry at 16 layers: 32 heads over 8 kv heads, head dim 128, 16-token
    blocks, 8 lanes, 4096 positions, a bf16 cache; random weights from seed
    0, the tiny model's tokenizer).  (a) ``tune()`` with the measured runner
    into a table of this run: every candidate (tb, page_slots) timed on
    row 1 (the sum of the synthetic decode and mixed workloads' CUDA-event
    µs, ``AUTOTUNE_REPS`` launches each), the winner row, the default
    layout's µs (tb 8, the full width).  (b) At the winner's tb, row 1 at
    its width bitwise its full-width result on both workloads.  (c) An
    engine on that table (``DYN_KERNEL_PERF``) reports ``source: tuned``
    with the row's values and serves phase serve's traffic in process (the
    four chats "request i: tell me", 64 tokens each, and the ~1640-token
    long prompt, 24 tokens, landing 0.5 s later; greedy, token ids from the
    tokenizer; then the same again on fresh texts, timed warm)
    through unified graph replays, the counters zeroed just before and read
    just after: row 1 launched, every call on the tensor-core walk, no
    plain call.  Its streams equal the default
    engine's where tb is the default's; where tb changed, the first
    window's logits are held to the default's within
    ``AUTOTUNE_LOGITS_ATOL`` and a parting stream must part where the
    default's top-2 margin is within it.  The overflows repacked at the
    full width and the full-width graphs captured are printed.  (d) The
    default engine, built first with ``DYN_AUTOTUNE=0`` on the same table,
    reports ``source: default``.  One ``smoke_autotune`` line."""
    import tempfile

    from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
    from dynamo_tpu_torch.ops import autotune

    model = "llama3-8b-smoke"
    mdir = model_dir(model, config)
    geom = autotune_geometry(config, engine_kw)
    tok = HfTokenizer.from_model_dir(mdir)
    # the two passes' texts: phase serve's, then as many fresh ones
    prompts = [[tok.encode(text) for text in (*AUTOTUNE_CHATS, LONG_PROMPT)],
               [tok.encode(text) for text in (*(f"{c} again" for c in AUTOTUNE_CHATS),
                                              LONG_PROMPT[1:] + LONG_PROMPT[0])]]
    table = Path(tempfile.mkdtemp(prefix="autotune_")) / "KERNEL_PERF_CUDA.json"
    kind = torch.cuda.get_device_name(0)
    report: dict = {"card": card, "geometry": geom.key, "table": str(table)}
    saved = {k: os.environ.get(k) for k in ("DYN_KERNEL_PERF", "DYN_AUTOTUNE")}
    os.environ["DYN_KERNEL_PERF"] = str(table)
    try:
        # (d) the default engine, autotuning off: phase serve's layout
        os.environ["DYN_AUTOTUNE"] = "0"
        base, build_s = build_engine(mdir, "cuda", None, **engine_kw)
        kc0 = base.stats()["kernel_config"]
        report["default"] = {"kernel_config": kc0, "build_s": build_s}
        if kc0["source"] != "default" or kc0["tb_tokens"] != 8 \
                or kc0["page_slots"] != 8 * geom.max_blocks_per_seq:
            raise AssertionError(f"autotune: DYN_AUTOTUNE=0 gave {kc0}")
        buckets = tuple(base.buckets)
        base.start()
        base_out, report["default"]["traffic"] = asyncio.run(traffic_twice(base, prompts))
        base.stop()
        base_logits = unified_logits(torch, base, prompts[0])
        params = base.params
        del base
        free_card(torch, True)

        # (a) the measured sweep, into this run's table
        t0 = time.perf_counter()
        runner = autotune.measured_runner(geom, device="cuda", reps=AUTOTUNE_REPS)
        row, cached = autotune.tune(table, geom, dtype="bfloat16", buckets=buckets,
                                    runner=runner, device_kind=kind)
        sweep_s = time.perf_counter() - t0
        times = {f"tb{tb}_ps{ps}": us for (tb, ps), us in sorted(runner.times.items())}
        default_us = runner.times.get((8, 8 * geom.max_blocks_per_seq))
        report["sweep"] = {"row": row, "cached": cached, "seconds": sweep_s,
                           "candidates_us": times, "default_layout_us": default_us,
                           "winner_us": row["cost"]}
        log(f"[autotune] swept {row['swept']} candidates ({len(times)} timed) in "
            f"{sweep_s:.1f}s: winner {row}; default layout (tb 8, width "
            f"{8 * geom.max_blocks_per_seq}) {default_us} us; every candidate {times}")
        if cached or row["source"] != "measured" or row["device_kind"] != kind:
            raise AssertionError(f"autotune: the sweep's row is not this card's measure: {row}")
        if default_us is None:
            raise AssertionError("autotune: the default layout was not timed")

        # (b) the winner's width bitwise the full width at its tb
        report["bitwise"] = width_bitwise(torch, geom, row["tb_tokens"], row["page_slots"])

        # (c) the tuned engine on phase serve's traffic
        os.environ.pop("DYN_AUTOTUNE")
        tuned, build_s = build_engine(mdir, "cuda", None, params=params, **engine_kw)
        kc = tuned.stats()["kernel_config"]
        want = {k: row[k] for k in ("tb_tokens", "page_slots", "pages_per_step")}
        if kc["source"] != "tuned" or {k: kc[k] for k in want} != want \
                or kc["geometry"] != geom.key:
            raise AssertionError(f"autotune: the tuned engine resolved {kc}, the row {row}")
        tuned.start()
        zero_counters()
        out, traffic = asyncio.run(traffic_twice(tuned, prompts))
        counts = read_counters()
        st = tuned.stats()
        tuned.stop()
        report["tuned"] = {
            "kernel_config": kc, "build_s": build_s, "traffic": traffic,
            "launches": {k: counts[k] for k in LLAMA_PATH},
            "unified_windows": st["decode_windows_unified_total"],
            "unified_replays": st["unified_graph_replays_total"],
            "overflows": st["unified_ps_overflows_total"],
            "full_width_graphs": st["unified_full_width_graphs_captured"]}
        if counts["ragged_attention.launches"] <= 0 or st["unified_graph_replays_total"] <= 0:
            raise AssertionError(f"autotune: no unified replay launched row 1: {report['tuned']}")
        check_ragged_route(counts)
        if row["tb_tokens"] == kc0["tb_tokens"]:
            report["streams"] = "equal" if out == base_out else "differ"
            if out != base_out:
                raise AssertionError(f"autotune: at the default's tb the tuned engine's "
                                     f"greedy streams differ from the default's")
        else:
            logits = unified_logits(torch, tuned, prompts[0])
            report["logits"] = logits_check("autotune", logits, base_logits,
                                            AUTOTUNE_LOGITS_ATOL)
            # the first pass's streams (the second's prompts hit the prefix
            # cache on both engines alike)
            base_out, out = base_out[0], out[0]
            parted = [i for i, (a, b) in enumerate(zip(base_out, out)) if a != b]
            margins = []
            if parted:  # the default's top-2 margins, eagerly, on its own weights
                ref, _ = build_engine(mdir, "cuda", None, params=params, **engine_kw)
                ref.start()
                for i in parted:
                    margins.append(asyncio.run(generate_top2(
                        ref, prompts[0][i], AUTOTUNE_OSL[i == len(prompts[0]) - 1], []))[1])
                ref.stop()
                del ref
            report["parted"] = parted_streams(
                "autotune", [(base_out[i], m) for i, m in zip(parted, margins)],
                [(out[i], None) for i in parted], AUTOTUNE_LOGITS_ATOL)
        del tuned
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(table.parent, ignore_errors=True)
        free_card(torch, True)
    print(json.dumps({"smoke_autotune": report}, default=str), flush=True)
    return report


# ---------------------------------------------------------------------------
# phase plane: the agg graph under the SDK's supervisor, scaled by the planner
# ---------------------------------------------------------------------------

PLANE_CONFIG = dict(LLAMA3_8B, num_hidden_layers=4)   # phase dist's geometry, 4 layers
PLANE_ENGINE = dict(num_blocks=512, max_batch_size=8, max_model_len=2048, seed=0)
PLANE_CLIENTS = 8        # request streams during the burst (one request each at a time)
PLANE_OSL = 48           # tokens out a request
PLANE_TICK_S = 1.0       # the planner's adjustment interval
# after a scale-up the pool holds for the planner's cooldown: at least this
# long, and past the new replica's start and the burst after its first
# token.  That start (11.5-15.6 s at 4 layers on an H100, more on a slower
# host) runs its warmup on the card beside the burst, and the served rate
# dips to 0 across it; a cooldown that ends before the burst does flaps the
# pool back to one replica while the burst still runs.  The phase sizes it
# from the first replica's measured start (``plane_cooldown_s``).
PLANE_COOLDOWN_S = 20.0
PLANE_START_MARGIN = 2.0  # the second replica's start over the first's (0.96-1.26 seen)
PLANE_AFTER_S = 5.0      # the burst after the new replica's first token
PLANE_LAUNCH_S = 300


def plane_cooldown_s(first_up_s: float) -> float:
    """The planner's cooldown after a scale-up: the new replica's start
    (``PLANE_START_MARGIN`` times the first replica's, measured), the burst
    after its first token and two ticks, or ``PLANE_COOLDOWN_S`` if longer."""
    return max(PLANE_COOLDOWN_S,
               PLANE_START_MARGIN * first_up_s + PLANE_AFTER_S + 2 * PLANE_TICK_S)


def worker_env(pid: int) -> dict:
    """A child's environment, from /proc."""
    raw = Path(f"/proc/{pid}/environ").read_bytes()
    return dict(kv.split("=", 1) for kv in raw.decode(errors="replace").split("\0") if "=" in kv)


async def plane_async(torch, card: str, bench_lines: dict, device: str = "cuda",
                      config: dict = PLANE_CONFIG, engine: dict = PLANE_ENGINE) -> dict:
    import aiohttp

    from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import KvMetricsAggregator
    from dynamo_tpu_torch.planner import (
        PerfProfile,
        Planner,
        PlannerConfig,
        ProfilePoint,
        sample_from_endpoints,
    )
    from dynamo_tpu_torch.planner.connectors import LocalConnector
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.runtime.client import PushRouter
    from dynamo_tpu_torch.runtime.controlplane.server import ControlPlaneServer
    from dynamo_tpu_torch.sdk import ProcessSpec, ProcessSupervisor
    from dynamo_tpu_torch.sdk.allocator import ResourceError, plan_resource_envs
    from dynamo_tpu_torch.sdk.graph import service
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    on_card = device == "cuda"
    model = "llama3-8b-plane"
    mdir = model_dir(model, config)
    report: dict = {"card": card}

    # the agg graph's services as the SDK declares them: the worker asks for
    # one card; a second card-bound replica cannot be planned on this host
    @service(name="plane-frontend")
    class Frontend:
        pass

    @service(name="plane-worker", workers=1, resources={"gpu": 1})
    class Worker:
        pass

    @service(name="plane-worker", workers=2, resources={"gpu": 1})
    class TwoWorkers:
        pass

    envs = plan_resource_envs([Frontend, Worker])
    report["allocation"] = envs
    if envs.get("plane-worker") != [{"CUDA_VISIBLE_DEVICES": "0", "DYN_GPUS": "0"}]:
        raise AssertionError(f"plane: the allocator planned {envs} on this one-card host")
    try:
        plan_resource_envs([Frontend, TwoWorkers])
        raise AssertionError("plane: a second GPU replica was planned on a one-card host")
    except ResourceError as exc:
        report["second_replica_refused"] = str(exc)
        if "remain unassigned" not in str(exc):
            raise
    log(f"[plane] allocation {envs}; a second replica refused: "
        f"{report['second_replica_refused']}")

    server = ControlPlaneServer(port=0)
    await server.start()
    address = f"127.0.0.1:{server.port}"
    port = free_port()
    sup = ProcessSupervisor()
    runtime = aggregator = None
    worker_cmd = [sys.executable, "-m", "dynamo_tpu_torch.cli.run", "run", "in=none",
                  "out=torch", "--warmup", "--control-plane", address, "--model-path",
                  str(mdir), "--model-name", model,
                  "--num-blocks", str(engine["num_blocks"]),
                  "--max-batch-size", str(engine["max_batch_size"]),
                  "--context-length", str(engine["max_model_len"]),
                  "--seed", str(engine["seed"]), "--device", device]
    sup.add_watcher(ProcessSpec(
        name="worker", cmd=worker_cmd, cwd=str(ROOT), stop_timeout_s=60.0,
        # replica 0 on the allocator's card; replica 1 opts out of the
        # allocation and time-slices the same card (one card on this host)
        replica_env=envs["plane-worker"] + [{"DYN_DISABLE_AUTO_GPU_ALLOCATION": "1"}]),
        replicas=1)
    sup.add_watcher(ProcessSpec(
        name="frontend", cwd=str(ROOT), cmd=[
            sys.executable, "-m", "dynamo_tpu_torch.cli.run", "run", "in=http", "out=dyn",
            "--control-plane", address, "--host", "127.0.0.1", "--port", str(port),
            "--router-mode", "round_robin"]), replicas=1)
    # the agg graph has no prefill pool: its watcher stays at 0
    sup.add_watcher(ProcessSpec(name="prefill", cmd=[sys.executable, "-c", "pass"]),
                    replicas=0)
    results: list[dict] = []
    lost: list[str] = []
    decisions: list[dict] = []
    stop_burst, stop_all = asyncio.Event(), asyncio.Event()
    try:
        runtime = await DistributedRuntime.create(RuntimeConfig(control_plane=address))
        backend = runtime.namespace("dynamo").component("backend")
        client = (await PushRouter.from_endpoint(backend.endpoint("generate"))).client
        aggregator = KvMetricsAggregator(backend)
        await aggregator.start()
        t0 = time.perf_counter()
        await sup.start()
        await client.wait_for_instances(1, timeout=PLANE_LAUNCH_S)
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
            while True:  # the frontend lists the model once its pipeline is built
                try:
                    async with s.get(f"http://127.0.0.1:{port}/v1/models") as r:
                        if model in [m["id"] for m in (await r.json()).get("data", [])]:
                            break
                except aiohttp.ClientError:
                    pass
                if time.perf_counter() - t0 > PLANE_LAUNCH_S:
                    raise TimeoutError("plane: the frontend did not list the model")
                await asyncio.sleep(0.2)
            report["first_worker_up_s"] = time.perf_counter() - t0
            first = client.instances[0]
            w0 = sup._replicas["worker"][0].process.pid
            env0 = worker_env(w0)
            st0 = (await worker_stats(runtime, first))["custom"]
            report["worker0"] = {k: env0.get(k) for k in (
                "CUDA_VISIBLE_DEVICES", "DYN_GPUS", "DYN_REPLICA_INDEX")}
            report["worker0"].update(device=st0["device"], device_name=st0["device_name"])
            log(f"[plane] worker 0 up in {report['first_worker_up_s']:.1f}s: "
                f"{report['worker0']}")
            if (env0.get("CUDA_VISIBLE_DEVICES"), env0.get("DYN_GPUS")) != ("0", "0") \
                    or (on_card and st0["device_name"] != torch.cuda.get_device_name(0)):
                raise AssertionError(f"plane: worker 0 is not on the allocated card: "
                                     f"{report['worker0']}")

            async def stream(k: int, burst: bool) -> None:
                i = 0
                while not (stop_burst if burst else stop_all).is_set():
                    text = f"client {k} request {i}: tell me about the number {i}"
                    try:
                        r = await stream_chat(s, port, model, text, PLANE_OSL)
                    except Exception as exc:  # noqa: BLE001 — a lost request is a finding
                        lost.append(f"{k}.{i}: {exc!r}")
                        raise
                    results.append({**r, "client": k, "burst": burst})
                    i += 1

            # the burst, then the planner's loop over the workers' metrics
            clients = [asyncio.ensure_future(stream(k, k > 0)) for k in range(PLANE_CLIENTS)]
            await asyncio.sleep(3.0)
            t_warm = time.perf_counter()
            n_warm = len(results)
            await asyncio.sleep(3.0)
            done = [r for r in results[n_warm:]]
            burst_tok_s = len(done) * PLANE_OSL / (time.perf_counter() - t_warm)
            # the profile: one decode replica serves half of the burst's
            # output rate, so the burst needs two and the ebb one
            profile = PerfProfile([ProfilePoint(
                isl=16, osl=PLANE_OSL, prefill_tok_s=1e6, decode_tok_s=0.5 * burst_tok_s,
                ttft_s=0.1, itl_s=0.02)])
            cooldown_s = plane_cooldown_s(report["first_worker_up_s"])
            planner = Planner(profile, LocalConnector(sup, decode_watcher="worker"),
                              PlannerConfig(predictor="constant", min_prefill=0,
                                            max_prefill=0, min_decode=1, max_decode=2,
                                            scale_down_headroom=1.0,
                                            cooldown_s=cooldown_s,
                                            saturation_occupancy=1.01))
            report["profile_decode_tok_s"] = 0.5 * burst_tok_s
            report["cooldown_s"] = cooldown_s

            async def tick() -> dict:
                now = time.perf_counter()
                window = [r for r in results if now - (r["stamps"][-1] if r["stamps"]
                                                       else r["t0"]) <= 2.0]
                sample = sample_from_endpoints(aggregator.snapshot(),
                                               request_rate=len(window) / 2.0,
                                               avg_isl=16, avg_osl=PLANE_OSL)
                d = await planner.step(sample)
                rec = {"t": now - t0, "request_rate": sample.request_rate,
                       "replicas_seen": sample.num_decode_replicas,
                       "num_decode": d.num_decode, "reason": d.reason}
                decisions.append(rec)
                return rec

            while (await tick())["num_decode"] < 2:
                if time.perf_counter() - t0 > PLANE_LAUNCH_S:
                    raise AssertionError(f"plane: the planner never scaled up: {decisions}")
                await asyncio.sleep(PLANE_TICK_S)
            t_dec = time.perf_counter()
            before = [r for r in results if r["t0"] < t_dec]
            insts = await client.wait_for_instances(2, timeout=PLANE_LAUNCH_S)
            new = next(i for i in insts if i.instance_id != first.instance_id)
            while (await worker_stats(runtime, new))["custom"]["tokens_emitted_total"] <= 0:
                if time.perf_counter() - t_dec > PLANE_LAUNCH_S:
                    raise AssertionError("plane: the new replica served no token")
                await asyncio.sleep(0.05)
            t_first = time.perf_counter()
            report["decision_to_first_token_s"] = t_first - t_dec
            w1 = sup._replicas["worker"][1].process.pid
            env1 = worker_env(w1)
            report["worker1"] = {k: env1.get(k) for k in (
                "CUDA_VISIBLE_DEVICES", "DYN_DISABLE_AUTO_GPU_ALLOCATION", "DYN_REPLICA_INDEX")}
            log(f"[plane] scaled to 2 at {t_dec - t0:.1f}s; the new replica's first token "
                f"{report['decision_to_first_token_s']:.2f}s later: {report['worker1']}")
            # the burst goes on after the first token, inside the cooldown
            # (a start slower than the margin shortens it)
            deadline = min(t_first + PLANE_AFTER_S, t_dec + cooldown_s - PLANE_TICK_S)
            report["after_burst_s"] = max(0.0, deadline - t_first)
            while time.perf_counter() < deadline:
                await tick()
                await asyncio.sleep(PLANE_TICK_S)
            workers = {}
            if len(client.instances) != 2:
                raise AssertionError(f"plane: {len(client.instances)} workers in the burst "
                                     f"after the scale-up: {decisions}")
            for inst in client.instances:
                c = (await worker_stats(runtime, inst))["custom"]
                workers[f"{inst.instance_id:x}"] = {
                    "device_name": c["device_name"],
                    "launches": {k: c["kernel_launches"][k] for k in LLAMA_PATH},
                    **{k: c[k] for k in ("decode_windows_unified_total",
                                         "unified_graph_replays_total",
                                         "unified_graphs_captured",
                                         "decode_graph_replays_total",
                                         "tokens_emitted_total")}}
            report["workers"] = workers
            for name, w in workers.items():
                # warmup replays each captured graph once: replays past it
                # are served windows, each launching its rows (the CPU runs
                # the plain versions, eagerly)
                if w["decode_windows_unified_total"] <= 0 or on_card and (
                        min(w["launches"].values()) <= 0
                        or w["unified_graph_replays_total"] <= w["unified_graphs_captured"]
                        or w["decode_graph_replays_total"] <= 2):
                    raise AssertionError(f"plane: worker {name} did not serve through rows "
                                         f"1-2: {w}")
            # the ebb: one stream goes on, the planner shrinks the pool once
            # its cooldown has passed
            stop_burst.set()
            t_ebb = time.perf_counter()
            while (await tick())["num_decode"] > 1:
                if time.perf_counter() - t_dec > PLANE_LAUNCH_S:
                    raise AssertionError(f"plane: the planner never scaled down: {decisions}")
                await asyncio.sleep(PLANE_TICK_S)
            t_down = time.perf_counter()
            while len(client.instances) > 1:
                if time.perf_counter() - t_down > 120:
                    raise AssertionError("plane: the retired replica stayed registered")
                await asyncio.sleep(0.1)
            report["scale_down_s_after_up"] = t_down - t_dec
            n_down = len(results)
            while len(results) < n_down + 2:  # the one stream goes on on one worker
                await asyncio.sleep(0.1)
            stop_all.set()
            await asyncio.gather(*clients)
        e2e = traffic_e2e("plane", results, time.perf_counter() - t0)
        # the requests sent on two replicas: from the new one's first token
        # to the ebb (read once all are done, those still streaming at the
        # ebb too)
        after = [r for r in results if t_first <= r["t0"] < t_ebb]
        report.update(
            requests=len(results), lost=lost, e2e=e2e,
            ttft_ms_p50_before=pctile([r["stamps"][0] - r["t0"] for r in before], 0.5) * 1e3,
            ttft_ms_p50_after=pctile([r["stamps"][0] - r["t0"] for r in after], 0.5) * 1e3,
            decisions=decisions, replicas_end=sup.replica_count("worker"))
        if lost or sup.replica_count("worker") != 1:
            raise AssertionError(f"plane: lost {lost}, {sup.replica_count('worker')} replicas")
        pools = [d["num_decode"] for d in decisions]
        runs = [n for i, n in enumerate(pools) if i == 0 or n != pools[i - 1]]
        if runs not in ([2, 1], [1, 2, 1]):
            raise AssertionError(f"plane: the pool did not go 1 -> 2 -> 1 once: {pools}")
    finally:
        stop_burst.set()
        stop_all.set()
        await sup.stop()
        if aggregator is not None:
            await aggregator.stop()
        if runtime is not None:
            await runtime.close()
        await server.stop()
    report["perfgate"] = plane_perfgate(bench_lines)
    return report


def plane_perfgate(bench_lines: dict) -> dict:
    """Phase bench's headline lines through the port's perf gate in a
    temporary directory: ``--write-baseline`` then ``check`` pass, and a
    copy with configuration A's tok/s degraded past its band fails by that
    metric's name.  Skipped (and said so) where phase bench did not run."""
    import io
    import tempfile

    from dynamo_tpu_torch.bench import perfgate

    if set(bench_lines) != set(perfgate.CONFIGS):
        return {"skipped": f"phase bench gave {sorted(bench_lines)}, the gate reads "
                           f"{list(perfgate.CONFIGS)}"}
    root = Path(tempfile.mkdtemp(prefix="perfgate_"))
    for config, line in bench_lines.items():
        perfgate.write_artifact(root, config, line)

    def gate(*argv) -> tuple[int, str]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = perfgate.main(["--root", str(root), *argv])
        return rc, buf.getvalue()

    try:
        out = {"write_baseline": gate("--write-baseline"), "check": gate()}
        degraded = json.loads((root / "HEADLINE_A.json").read_text())
        degraded["value"] = degraded["value"] * 0.5
        (root / "HEADLINE_A.json").write_text(json.dumps(degraded))
        out["degraded"] = gate()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[plane] perf gate: {out}")
    if out["write_baseline"][0] != 0 or out["check"][0] != 0:
        raise AssertionError(f"plane: the perf gate did not pass its own baseline: {out}")
    if out["degraded"][0] != 1 or "[regression] headline_a.tok_s" not in out["degraded"][1]:
        raise AssertionError(f"plane: a degraded A did not fail by its name: {out}")
    return out


def phase_plane(torch, card: str, device: str = "cuda", **kw) -> dict:
    """The plane above the engine on the card: the agg example graph (a
    round-robin frontend, ``run in=http out=dyn``, and a worker, ``run
    in=none out=torch --warmup`` at phase dist's Llama-3-8B geometry, full
    width, 4 layers, random weights from seed 0, 512 blocks, 8 lanes, 2048
    positions) under the SDK's ``ProcessSupervisor`` over the port's
    control-plane server.  The worker service declares ``resources={"gpu":
    1}``: the allocator gives it ``CUDA_VISIBLE_DEVICES=0`` (read from the
    process) and it reports that card's name; a plan of two such replicas on
    this one-card host raises ``ResourceError``.  Eight request streams
    (chats of ~16 tokens, 48 out, greedy, one request a stream at a time)
    make a burst; the planner (a ``PerfProfile`` written here: one replica
    serves half the burst's measured output rate) observes
    ``sample_from_endpoints`` over the workers' load metrics every second
    and scales the worker watcher 1 -> 2 through ``LocalConnector``, the
    second replica run with ``DYN_DISABLE_AUTO_GPU_ALLOCATION=1`` so both
    time-slice the card; after the new replica's first token the burst runs
    5 s more, then seven streams stop and the planner, once its cooldown
    has passed (``plane_cooldown_s``: past the new replica's start and that
    burst, from the first replica's measured start), scales 2 -> 1 (the
    replica drains on SIGTERM; the pool must change exactly twice).  No request
    may be lost and every one must stream its 48 tokens; both workers must
    serve through rows 1-2.  Prints the seconds from the decision to the
    new replica's first token, TTFT p50 before and after the scale-up, each
    worker's rows 1-2 launches and the decisions.  Then phase bench's
    headline lines through the perf gate (``plane_perfgate``).  One
    ``smoke_plane`` line.  ``device`` "cpu" (with a small ``config`` and
    ``engine``, and ``DYN_GPU_COUNT=1`` for the allocator) rehearses it on
    the CPU, where the card-only checks are skipped."""
    report = asyncio.run(plane_async(torch, card, BENCH_LINES, device, **kw))
    print(json.dumps({"smoke_plane": report}, default=str), flush=True)
    return report


# ---------------------------------------------------------------------------
# phase soak: the scenario soak on TorchLlmEngine workers
# ---------------------------------------------------------------------------

SOAK_CONFIG = PLANE_CONFIG   # Llama-3-8B's width, 4 layers, random weights from seed 0
# worker_kill.json's kill_mid_stream at speedup 1, cut to 10 s with its kill at 3 s
SOAK_KILL = dict(duration_s=10.0, kill_at_s=3.0)
SOAK_MEMORY_SLACK = 64 * 2**20   # bytes the card may keep after the fleet's teardown
# the metrics service forgets a worker whose load metrics are older than this
# (4 of the spec's 0.5 s publish periods; its default, 10 s, would still list
# the killed worker at the kill phase's mid-phase dyn_top snapshot)
SOAK_METRICS_TTL_S = 2.0
# the kill waits (at most SOAK_KILL_WAIT_S past its time) for the worker it
# takes out to hold a stream that has streamed for SOAK_MID_STREAM_S, so that
# it lands mid-stream on any host: at 2 req/s each worker is idle most of the
# time, and a kill of an idle worker resumes nothing
SOAK_KILL_WAIT_S = 3.0
SOAK_MID_STREAM_S = 0.08
# the phase's settings: its flight dumps in the build directory, and a 5 s
# connect-back timeout (30 s by default), so that a request the router sent
# to the killed worker before it saw the instance go (its envelope finds no
# subscriber) fails over within the phase's 20 s drain instead of outlasting it
SOAK_ENV = {"DYN_FLIGHT_DIR": str(ROOT / "dynamo_tpu_torch" / "_build" / "flight"),
            "DYN_CONNECT_TIMEOUT_S": "5.0"}


def soak_spec():
    """The shipped ``torch_soak`` spec with worker_kill's ``kill_mid_stream``
    appended (the smoke's own copy; the shipped files stay as they are)."""
    from dynamo_tpu_torch.scenarios.spec import ScenarioSpec, builtin_spec_path

    spec = ScenarioSpec.load(builtin_spec_path("torch_soak"))
    kill = ScenarioSpec.load(builtin_spec_path("worker_kill")).phases[0]
    if kill.name != "kill_mid_stream" or kill.worker_kills[0].mode != "kill":
        raise AssertionError(f"worker_kill.json's first phase is not kill_mid_stream: {kill}")
    kill.duration_s = SOAK_KILL["duration_s"]
    kill.worker_kills[0].at_s = SOAK_KILL["kill_at_s"]
    kill.assertions.max_failed = 0
    spec.phases.append(kill)
    return spec.validate()


async def soak_async(torch, card: str, device: str, model_config) -> dict:
    import weakref

    from dynamo_tpu_torch.engine import TorchLlmEngine
    from dynamo_tpu_torch.robustness import counters
    from dynamo_tpu_torch.robustness.faults import FAULTS
    from dynamo_tpu_torch.scenarios import fleet as soak_fleet
    from dynamo_tpu_torch.scenarios.runner import run_scenario
    from dynamo_tpu_torch.scripts import check_metrics, dyn_top

    on_card = device == "cuda"
    spec = soak_spec()
    report: dict = {"card": card, "phases": {}}
    counters.reset()
    FAULTS.reset()
    # the launch counters are zeroed after each worker's warmup (every graph
    # is captured before traffic); the fleet's metrics surface and its
    # workers' stats are read just before its teardown
    marks, seen, engines = {}, {}, []
    real_warmup = TorchLlmEngine.warmup
    real_start, real_stop = soak_fleet.SoakFleet.start, soak_fleet.SoakFleet.stop
    real_kill = soak_fleet.SoakFleet.kill_worker

    async def warmup(self, *args, **kwargs):
        await real_warmup(self, *args, **kwargs)
        zero_counters()
        marks["launches"] = self.stats()["kernel_launches"]
        engines.append(weakref.ref(self))

    async def start(self):
        await real_start(self)
        self.metrics_service.aggregator.ttl_s = SOAK_METRICS_TTL_S

    async def kill_worker(self, pool: str, *, mode: str = "kill"):
        workers = self._pools.get(pool) or []
        t_wait = time.perf_counter()
        while workers and time.perf_counter() - t_wait < SOAK_KILL_WAIT_S:
            if workers[0].service._in_flight:  # the oldest, whom kill_worker takes out
                await asyncio.sleep(SOAK_MID_STREAM_S)
                if workers[0].service._in_flight:
                    break
            else:
                await asyncio.sleep(0.005)
        seen["kill_wait_s"] = time.perf_counter() - t_wait
        if workers:
            seen["killed_stats"] = [workers[0].engine.stats()]
        return await real_kill(self, pool, mode=mode)

    async def stop(self):
        url = f"{self.worker_url}/metrics"
        seen["missing"], seen["duplicated"] = await asyncio.to_thread(
            check_metrics.check_url, url, check_metrics.WORKER_FAMILIES)
        seen["top"] = await asyncio.to_thread(dyn_top.collect_snapshot, self.frontend_url,
                                              self.worker_url, 3.0)
        live = [w.engine for ws in self._pools.values() for w in ws]
        seen["stats"] = [e.stats() for e in live]
        del live
        await real_stop(self)

    def allocated_mb() -> float:
        # cuBLAS keeps a workspace for each stream it has run on (each
        # worker's engine thread one) until told to clear them: process
        # state, not a worker's cache or graphs
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated() / 2**20

    if on_card:
        gc.collect()
        report["memory_before_mb"] = allocated_mb()
    TorchLlmEngine.warmup = warmup
    soak_fleet.SoakFleet.start, soak_fleet.SoakFleet.stop = start, stop
    soak_fleet.SoakFleet.kill_worker = kill_worker
    t0 = time.perf_counter()
    try:
        artifact = await run_scenario(spec, name="chip-smoke-soak", fleet_options={
            "device": device, "model_config": model_config})
    finally:
        TorchLlmEngine.warmup = real_warmup
        soak_fleet.SoakFleet.start, soak_fleet.SoakFleet.stop = real_start, real_stop
        soak_fleet.SoakFleet.kill_worker = real_kill
    report["soak_s"] = time.perf_counter() - t0
    await asyncio.sleep(0.2)  # the stopped services' cancelled tasks run to their end
    gc.collect()
    report["engines_alive_after_teardown"] = sum(e() is not None for e in engines)
    if on_card:
        report["memory_after_with_cublas_workspaces_mb"] = torch.cuda.memory_allocated() / 2**20
        report["memory_after_mb"] = allocated_mb()

    end = seen["stats"][0]["kernel_launches"]
    report["launches"] = {k: end[k] - marks["launches"].get(k, 0) for k in end}
    report["plain_calls"] = sum(v for k, v in report["launches"].items()
                                if k.endswith("plain_calls"))
    report["graphs_captured_after_warmup"] = sum(
        st[f"{k}_graphs_captured_after_warmup"]
        for st in seen["stats"] + seen.get("killed_stats", [])
        for k in ("unified", "decode", "prefill", "verify"))
    report["metrics_missing"], report["metrics_duplicated"] = seen["missing"], seen["duplicated"]
    report["resumes_succeeded"] = counters.get("dyn_resume_success_total")
    report["kill_wait_s"] = seen.get("kill_wait_s")
    report["flight_dumps"] = artifact["flight"]["dumps"]
    snaps = artifact["dyn_top_snapshots"]
    # the runner's snapshots (mid-phase) and one at the end, before teardown
    report["dyn_top_workers"] = {**{s["phase"]: sorted(s["workers"]) for s in snaps},
                                 "end": sorted(seen["top"]["workers"])}
    report["fleet_mfu_perc_avg"] = snaps[-1].get("fleet", {}).get("mfu_perc_avg")
    for phase in artifact["phases"]:
        report["phases"][phase["name"]] = {
            "requests": phase["requests"], "outputs": phase["outputs"],
            "ttft_ms": phase["ttft_sim_ms"], "itl_ms": phase["itl_sim_ms"],
            "mfu_mean": phase["mfu_mean"], "resumes": phase["resumes"],
            "worker_kills": phase["worker_kills"], "failures": phase["assertions"]["failures"]}
    report["passed"] = artifact["passed"]
    report["wall_s"] = artifact["wall_s"]
    for name, ph in report["phases"].items():
        log(f"[soak] {name}: {ph['requests']['completed']}/{ph['requests']['submitted']} "
            f"completed, {ph['requests']['failed']} failed; TTFT p50 / p99 "
            f"{ph['ttft_ms']['p50']} / {ph['ttft_ms']['p99']} ms, ITL p50 / p99 "
            f"{ph['itl_ms']['p50']} / {ph['itl_ms']['p99']} ms")
    log(f"[soak] fleet MFU (last dyn_top snapshot) {report['fleet_mfu_perc_avg']}; resumes "
        f"{report['resumes_succeeded']}; memory {report.get('memory_before_mb')} -> "
        f"{report.get('memory_after_mb')} MB; launches "
        f"{ {k: report['launches'][k] for k in LLAMA_PATH} }")

    # the checks
    if not artifact["passed"]:
        raise AssertionError(f"phase soak: an assertion failed: {report['phases']}")
    names = [p.name for p in spec.phases]
    if list(report["phases"]) != names:
        raise AssertionError(f"phase soak: phases {list(report['phases'])}, want {names}")
    for name, ph in report["phases"].items():
        req, out = ph["requests"], ph["outputs"]
        if req["failed"] or req["completed"] != req["submitted"] or out["corrupt"] or \
                out["verified"] != req["completed"]:
            raise AssertionError(f"phase soak: {name} lost a request or a stream fell short "
                                 f"of its tokens: {ph}")
    kill = report["phases"]["kill_mid_stream"]
    if len(kill["worker_kills"]) != 1 or kill["worker_kills"][0]["worker"] is None:
        raise AssertionError(f"phase soak: the kill did not happen: {kill['worker_kills']}")
    if report["resumes_succeeded"] < 1:
        raise AssertionError("phase soak: no stream resumed on the peer after the kill")
    if not report["flight_dumps"]:
        raise AssertionError("phase soak: the soak left no flight dump")
    workers = report["dyn_top_workers"]
    killed = kill["worker_kills"][0]["worker"]
    if len(workers["real_engine_serve"]) != 2 or killed not in workers["real_engine_serve"] \
            or len(workers["end"]) != 1 or killed in workers["end"]:
        raise AssertionError(f"phase soak: dyn_top saw {workers}, want 2 workers before the "
                             f"kill of {killed} and one after")
    if report["metrics_missing"] or report["metrics_duplicated"]:
        raise AssertionError(f"phase soak: check_metrics on the fleet's metrics service: "
                             f"missing {report['metrics_missing']}, duplicated "
                             f"{report['metrics_duplicated']}")
    if report["graphs_captured_after_warmup"]:
        raise AssertionError(f"phase soak: a graph was captured after warmup: {report}")
    if report["engines_alive_after_teardown"]:
        raise AssertionError(f"phase soak: {report['engines_alive_after_teardown']} stopped "
                             f"workers' engines outlived the fleet")
    if on_card:
        if any(report["launches"][k] <= 0 for k in LLAMA_PATH) or report["plain_calls"]:
            raise AssertionError(f"phase soak: rows 1-2 did not launch on the card: "
                                 f"{report['launches']}")
        kept = (report["memory_after_mb"] - report["memory_before_mb"]) * 2**20
        if kept > SOAK_MEMORY_SLACK:
            raise AssertionError(f"phase soak: the card kept {kept / 2**20:.1f} MB after the "
                                 f"fleet's teardown (limit {SOAK_MEMORY_SLACK / 2**20:.0f} MB)")
    return report


def phase_soak(torch, card: str, device: str = "cuda", config: dict = SOAK_CONFIG) -> dict:
    """The scenario soak on TorchLlmEngine workers (``dynamo_tpu_torch.
    scenarios``): the shipped ``torch_soak`` spec (two decode workers under
    KV routing, real time, 8 requests at 2 req/s, ISL 32, OSL 8) with
    worker_kill's ``kill_mid_stream`` appended on the same fleet (constant 2
    req/s, ISL 64, OSL 48, 10 s, one worker killed abruptly at 3 s, once it
    has streamed a request for ``SOAK_MID_STREAM_S``), through
    ``run_scenario`` at ``config`` (phase plane's Llama-3-8B geometry: full
    width, 4 layers, random weights from seed 0).  Every assertion of both
    phases holds, every request completes (none fails, none is left to the
    drain), every stream has its OSL tokens, a
    stream resumes on the peer, a flight dump is written (under
    ``dynamo_tpu_torch/_build/flight``; ``SOAK_ENV``), dyn_top's snapshots list two workers
    before the kill (the first phase's, mid-phase) and one after (at the end,
    before teardown), the port's check_metrics finds every
    worker family on the fleet's metrics service (fed by the workers'
    ``stats()``; its staleness limit ``SOAK_METRICS_TTL_S``), rows 1-2 launch (the process-wide ``kernel_launches`` of
    ``stats()`` after the workers' warmup and before teardown), no graph is
    captured after warmup, and after teardown no engine outlives the fleet
    and ``torch.cuda.memory_allocated()`` is within ``SOAK_MEMORY_SLACK`` of
    its level before (cuBLAS's per-stream workspaces cleared before each
    reading; the reading with them is printed too).  Prints each phase's TTFT and ITL p50 / p99, the
    fleet's MFU from the last dyn_top snapshot, the resumes and the memory
    before and after.  One ``smoke_soak`` line.  ``device`` "cpu" (with a
    small ``config``) rehearses it; the card-only checks are skipped there."""
    from dynamo_tpu_torch.models.llama import LlamaConfig

    model_config = LlamaConfig.from_hf_config(config)
    if device == "cpu":
        model_config = dataclasses.replace(model_config, dtype=torch.float32)
    env0 = {k: os.environ.get(k) for k in SOAK_ENV}
    os.environ.update(SOAK_ENV)
    try:
        report = asyncio.run(soak_async(torch, card, device, model_config))
    finally:
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(json.dumps({"smoke_soak": report}, default=str), flush=True)
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}, or sweep, split")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    bad = set(phases) - set(PHASES) - {"sweep", "split"}
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
    kinfo = serve = dist = mla = families = overlap = spec = offload = quant = disagg = None
    mm = tp = pp = meshfeat = soak = None
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
            gc.collect()
            log(f"[{name}] phase done in {time.perf_counter() - t0:.1f}s; "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
            return out

        if "kernels" in phases:
            kinfo = run("kernels", phase_kernels, torch)
        if "tiny" in phases:
            run("tiny", phase_tiny)
        if "serve" in phases:
            serve = run("serve", lambda: phase_serve(card, "serve", "llama3-8b-smoke",
                                                     SERVE_LLAMA, LLAMA_PATH, probe=PROBE_PROMPT))
        if "dist" in phases:
            dist = run("dist", phase_dist, card, SERVE_LLAMA)
            if serve is not None:
                if serve["probe_ids"] != dist["probe_ids"]:
                    raise AssertionError(f"the workers' greedy ids {dist['probe_ids']} differ "
                                         f"from phase serve's {serve['probe_ids']}")
                log("[dist] the workers' greedy ids equal phase serve's")
        if "fleet" in phases:
            run("fleet", phase_fleet, card)
        if "prefetch" in phases:
            run("prefetch", phase_prefetch, card)
        if "guided" in phases:
            run("guided", phase_guided, torch, card)
        if "disagg" in phases:
            disagg = run("disagg", phase_disagg, torch, card)
        if "mla" in phases:
            mla = run("mla", phase_serve, card, "mla", "deepseek-v2-lite-smoke", SERVE_MLA,
                      MLA_PATH)
        if "families" in phases:
            families = run("families", phase_families, torch, card)
        if "overlap" in phases:
            overlap = run("overlap", phase_overlap_both, torch, card)
        if "spec" in phases:
            spec = run("spec", phase_spec, torch, card)
        if "longctx" in phases:
            run("longctx", phase_longctx, torch, card)
        if "offload" in phases:
            offload = run("offload", phase_offload, torch, card)
            run("offload", phase_offload, torch, card, DEEPSEEK_V2_LITE, "cuda",
                "deepseek-v2-lite-offload")
        if "kvbm" in phases:
            run("kvbm", phase_kvbm, torch, card)
        if "quant" in phases:
            quant = run("quant", phase_quant, torch, card)
        if "bench" in phases:
            run("bench", phase_bench, torch)
        if "mm" in phases:
            mm = run("mm", phase_mm, torch, card)
        if "tp" in phases or "meshfeat" in phases:
            # phase meshfeat's cases (c)-(e) run on phase tp's engine pairs
            tp = run("tp", lambda: phase_tp(torch, card, meshfeat="meshfeat" in phases))
        if "pp" in phases:
            pp = run("pp", phase_pp, torch, card)
        if "meshfeat" in phases:
            meshfeat = run("meshfeat", phase_meshfeat, torch, card, "cuda", tp["meshfeat"])
        if "autotune" in phases:
            run("autotune", phase_autotune, torch, card)
        if "plane" in phases:
            run("plane", phase_plane, torch, card)
        if "soak" in phases:
            soak = run("soak", phase_soak, torch, card)
        if "sweep" in phases:
            run("sweep", phase_sweep, torch)
        if "split" in phases:
            run("split", phase_split, torch, card)
    except Exception as exc:  # noqa: BLE001 — a failed phase fails the run
        import traceback

        traceback.print_exc()
        log(f"FAILED: {type(exc).__name__}: {exc}")
        return 1
    log(f"phases {phases} passed in {time.perf_counter() - t_all:.1f}s")
    if None not in (kinfo, serve, mla, families, overlap, spec, offload, quant, disagg, mm, tp,
                    pp, meshfeat, soak):
        cases = kinfo["cases"]
        # rows 6-7 at the engine's Llama leaf, and at a tp = 2 rank's shard of it
        for row in ("gather", "scatter"):
            for name, leaf in (("llama_leaf", "copy_llama_leaf"),
                               ("tp2_shard", "copy_llama_leaf_tp2")):
                case = cases[leaf]
                cases[f"{row}_{name}"] = {
                    "ms": case[f"{row}_ms"], "device_ms": case[f"{row}_device_ms"],
                    "plain_ms": case[f"{row}_plain_ms"],
                    "library_ms": case[f"{row}_library_ms"], "bound_ms": case["bound_ms"],
                    "bound_by": case["bound_by"]}
        mf_ranks = {key: meshfeat["spec_offload"][key]["ranks"] for key in ("spec", "offload")}
        mf_ranks["deepseek"] = meshfeat["deepseek_spec"]["ranks"]
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
            ("ragged_paged_attention (D=96, Phi-3)", "dynamo_tpu_torch/csrc/ragged_attention.cu",
             "dynamo_tpu/ops/pallas/ragged_attention.py:262", "ragged_mix_d96", "ragged_d96",
             families["phi3"]["counts"]["ragged_attention.launches"]),
            ("ragged_paged_attention (D=256, Gemma-2B)",
             "dynamo_tpu_torch/csrc/ragged_attention.cu",
             "dynamo_tpu/ops/pallas/ragged_attention.py:262", "ragged_mix_d256", "ragged_d256",
             families["gemma"]["counts"]["ragged_attention.launches"]),
            ("paged_window_attention_decode (D=96, Phi-3)",
             "dynamo_tpu_torch/csrc/paged_attention.cu",
             "dynamo_tpu/ops/pallas/paged_attention.py:141", "paged_decode_d96_b8", "paged_d96",
             families["phi3"]["counts"]["paged_attention.launches"]),
            ("paged_window_attention_decode (D=256, Gemma-2B)",
             "dynamo_tpu_torch/csrc/paged_attention.cu",
             "dynamo_tpu/ops/pallas/paged_attention.py:141", "paged_decode_d256_b8",
             "paged_d256", families["gemma"]["counts"]["paged_attention.launches"]),
            ("gather_blocks", "dynamo_tpu_torch/csrc/block_copy.cu",
             "dynamo_tpu/ops/pallas/block_copy.py:25", "gather_llama_leaf", "gather",
             offload["counts"]["block_copy.gather_launches"]),
            ("scatter_blocks", "dynamo_tpu_torch/csrc/block_copy.cu",
             "dynamo_tpu/ops/pallas/block_copy.py:56", "scatter_llama_leaf", "scatter",
             offload["counts"]["block_copy.scatter_launches"]),
            # rows 6-7 on the disaggregated path: every extract and inject
            ("gather_blocks (disagg extract)", "dynamo_tpu_torch/csrc/block_copy.cu",
             "dynamo_tpu/ops/pallas/block_copy.py:25", "gather_llama_leaf", "gather",
             disagg["launches"]["gather_blocks"]),
            ("scatter_blocks (disagg inject)", "dynamo_tpu_torch/csrc/block_copy.cu",
             "dynamo_tpu/ops/pallas/block_copy.py:56", "scatter_llama_leaf", "scatter",
             disagg["launches"]["scatter_blocks"]),
            # rows 1-2 on the multimodal path: the image and video lanes'
            # decode tokens in unified windows and decode graphs (LLaVA-7B)
            ("ragged_paged_attention (image lanes, MHA)",
             "dynamo_tpu_torch/csrc/ragged_attention.cu",
             "dynamo_tpu/ops/pallas/ragged_attention.py:262", "ragged_mix_mha", "ragged_mha",
             mm["counts"]["ragged_attention.launches"]),
            ("paged_window_attention_decode (image lanes, MHA)",
             "dynamo_tpu_torch/csrc/paged_attention.cu",
             "dynamo_tpu/ops/pallas/paged_attention.py:141", "decode_mha_b32", "paged_mha",
             mm["counts"]["paged_attention.launches"]),
            # rows 2 and 4 on each rank's head shard (phase tp): every rank's
            # launches summed
            ("paged_window_attention_decode (tp=2 head shard)",
             "dynamo_tpu_torch/csrc/paged_attention.cu",
             "dynamo_tpu/ops/pallas/paged_attention.py:141", "decode_tp2_b32", "paged_tp2",
             sum(r["paged_attention.launches"] for r in tp["llama"]["rank_launches"])),
            ("mla_paged_attention_decode (tp=2 head shard)",
             "dynamo_tpu_torch/csrc/mla_attention.cu",
             "dynamo_tpu/ops/pallas/mla_attention.py:237", "mla_decode_tp2_b32",
             "mla_decode_tp2",
             sum(r["mla_attention.decode_launches"] for r in tp["deepseek"]["rank_launches"])),
            # row 2 in every pp stage on each microbatch (phase pp): the
            # pp = 2 x tp = 2 ranks' launches summed, at that mesh's shape
            # (4 lanes a microbatch, 16 heads over 4 kv heads)
            ("paged_window_attention_decode (pp=2 x tp=2 stage, microbatch 4)",
             "dynamo_tpu_torch/csrc/paged_attention.cu",
             "dynamo_tpu/ops/pallas/paged_attention.py:141", "decode_pp2tp2_mb4", "paged_pp",
             sum(r["paged_attention.launches"]
                 for r in pp["llama3-8b"]["meshes"]["pp2tp2"]["rank_launches"])),
            # phase meshfeat: row 2 at W = 5 and row 5 on each tp rank's head
            # shard (the speculative cases), rows 6-7 on each rank's cache
            # shard (the offload case): every rank's launches summed
            ("paged_window_attention_decode (W=5, tp=2 head shard)",
             "dynamo_tpu_torch/csrc/paged_attention.cu",
             "dynamo_tpu/ops/pallas/paged_attention.py:141", "verify_tp2_w5", "paged_verify_tp2",
             sum(r["paged_attention.window_launches"] for r in mf_ranks["spec"])),
            ("mla_paged_window_attention_decode (tp=2 head shard)",
             "dynamo_tpu_torch/csrc/mla_attention.cu",
             "dynamo_tpu/ops/pallas/mla_attention.py:182", "mla_verify_tp2", "mla_verify_tp2",
             sum(r["mla_attention.window_launches"] for r in mf_ranks["deepseek"])),
            ("gather_blocks (tp=2 cache shard)", "dynamo_tpu_torch/csrc/block_copy.cu",
             "dynamo_tpu/ops/pallas/block_copy.py:25", "gather_tp2_shard", "gather_tp2",
             sum(r["block_copy.gather_launches"] for r in mf_ranks["offload"])),
            ("scatter_blocks (tp=2 cache shard)", "dynamo_tpu_torch/csrc/block_copy.cu",
             "dynamo_tpu/ops/pallas/block_copy.py:56", "scatter_tp2_shard", "scatter_tp2",
             sum(r["block_copy.scatter_launches"] for r in mf_ranks["offload"])),
            # rows 1-2 in the soak workers' unified and decode graphs (phase soak)
            ("ragged_paged_attention (soak workers)", "dynamo_tpu_torch/csrc/ragged_attention.cu",
             "dynamo_tpu/ops/pallas/ragged_attention.py:262", "ragged_mix", "ragged",
             soak["launches"]["ragged_attention.launches"]),
            ("paged_window_attention_decode (soak workers)",
             "dynamo_tpu_torch/csrc/paged_attention.cu",
             "dynamo_tpu/ops/pallas/paged_attention.py:141", "decode_b32", "paged",
             soak["launches"]["paged_attention.launches"]),
        ):
            c = cases[case]
            entries.append({
                "name": name, "route": "cuda", "source": src, "replaces": repl,
                "launches": launches, "max_abs_err": kinfo["errs"][err],
                "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                "device_ms": c.get("device_ms", "not measured"), "case": case,
            })
        # rows 6-7 at the disaggregated path's shapes (a prompt's blocks of
        # one cache leaf), beside the KVBM-leaf case's numbers above
        for entry in entries:
            if entry["name"].endswith("(disagg extract)"):
                entry["path_device_ms"] = disagg["row6_device_ms"]
            elif entry["name"].endswith("(disagg inject)"):
                entry["path_device_ms"] = disagg["row7_device_ms"]
        # rows 2 (W = 5) and 5 run inside the verify graph: their device ms
        # a launch there and in the eager step on the same buffers
        for entry in entries:
            spec_key = {"mla_paged_window_attention_decode": "mla",
                        "paged_window_attention_decode (W=5)": "llama"}.get(entry["name"])
            if spec_key:
                ms = spec[spec_key]["inspect"]["ms"]
                entry.update(path="inside the verify graph",
                             graph_device_ms=ms["verify_replay"]["window_kernel_device_ms"],
                             eager_step_device_ms=ms["verify_eager"]["window_kernel_device_ms"],
                             graph_bound_ms=ms["window_bound"]["bound_ms"],
                             graph_lens=ms["window_lens"])
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
