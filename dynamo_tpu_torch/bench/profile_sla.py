"""SLA profiler: measure prefill/decode performance over an (isl, osl) grid
to produce the planner's PerfProfile (reference:
benchmarks/profiler/profile_sla.py feeding the SLA planner's interpolators).

A copy of dynamo_tpu/bench/profile_sla.py over the port's sweep helper
(``_drive_one``) and performance profile.
"""

from __future__ import annotations

import asyncio
import math
import random
import time

from dynamo_tpu_torch.bench.sweep import _drive_one
from dynamo_tpu_torch.planner.perf_interpolation import PerfProfile, ProfilePoint


async def _profile_point(
    engine, isl: int, osl: int, concurrency: int, requests: int, vocab_size: int,
    rng: random.Random,
) -> ProfilePoint:
    ttfts, itls, prefill_rates = [], [], []
    total_tokens = 0
    t0 = time.monotonic()
    sem = asyncio.Semaphore(concurrency)
    # draw every request's tokens up front: with the semaphore, draw order
    # inside the tasks would depend on completion timing and break the
    # seed's run-to-run reproducibility
    prompts = [
        [rng.randrange(10, vocab_size) for _ in range(isl)] for _ in range(requests)
    ]

    async def one(tokens: list[int]) -> None:
        nonlocal total_tokens
        async with sem:
            count, ttft, stamps = await _drive_one(engine, tokens, osl)
            total_tokens += count
            if ttft > 0:
                ttfts.append(ttft)
                prefill_rates.append(isl / ttft)
            itls.extend(b - a for a, b in zip(stamps, stamps[1:]))

    # closed-loop load HELD at the target concurrency: a finished request's
    # slot is immediately refilled (batching into gather waves would decay
    # to concurrency 1 as stragglers finish; same pattern as sweep.py)
    await asyncio.gather(*[one(tokens) for tokens in prompts])
    wall = time.monotonic() - t0
    return ProfilePoint(
        isl=isl,
        osl=osl,
        concurrency=concurrency,
        prefill_tok_s=sum(prefill_rates) / len(prefill_rates) if prefill_rates else 0.0,
        decode_tok_s=total_tokens / wall,
        ttft_s=sum(ttfts) / len(ttfts) if ttfts else 0.0,
        itl_s=sum(itls) / len(itls) if itls else 0.0,
    )


async def profile_engine(
    engine,
    *,
    isl_grid=(128, 512, 2048),
    osl_grid=(32, 128),
    concurrency_grid=(1,),
    requests_per_point: int = 4,
    vocab_size: int = 32_000,
    seed: int = 0,
) -> PerfProfile:
    rng = random.Random(seed)
    points: list[ProfilePoint] = []
    for isl in isl_grid:
        for osl in osl_grid:
            for conc in concurrency_grid:
                points.append(
                    await _profile_point(
                        engine, isl, osl, conc,
                        max(requests_per_point, conc), vocab_size, rng,
                    )
                )
    return PerfProfile(points)


def plan_deployment(
    profile: PerfProfile,
    *,
    isl: int,
    osl: int,
    target_rps: float,
    ttft_sla_s: float,
    itl_sla_s: float,
) -> dict:
    """SLA planner (reference: benchmarks/profiler feeding the SLA planner):
    pick the highest profiled concurrency whose measured TTFT and ITL still
    meet the SLAs at this workload shape, derive per-worker request
    throughput from it, and size the worker fleet for the target load.

    Returns ``{status, concurrency, per_worker_rps, replicas, ttft_s,
    itl_s}``.  ``status`` distinguishes the two empty cases: "infeasible"
    (the shape WAS profiled but no concurrency meets the SLAs — scale the
    model or the slice) vs a ValueError for a shape that was never profiled
    (re-profile at the real workload shape before planning).
    """
    shape_points = [p for p in profile.points if p.isl == isl and p.osl == osl]
    if not shape_points:
        profiled = sorted({(p.isl, p.osl) for p in profile.points})
        raise ValueError(
            f"shape (isl={isl}, osl={osl}) was never profiled "
            f"(profiled shapes: {profiled}); re-run profile_engine on it"
        )
    candidates = [
        p for p in shape_points
        # decode_tok_s > 0 also excludes dead points whose zero-sentinel
        # latencies would trivially "meet" any SLA
        if p.decode_tok_s > 0 and p.ttft_s <= ttft_sla_s and p.itl_s <= itl_sla_s
    ]
    if not candidates:
        return {"status": "infeasible", "concurrency": 0, "per_worker_rps": 0.0,
                "replicas": 0, "ttft_s": None, "itl_s": None}
    best = max(candidates, key=lambda p: p.decode_tok_s)
    per_worker_rps = best.decode_tok_s / max(osl, 1)
    replicas = max(1, math.ceil(target_rps / per_worker_rps)) if target_rps > 0 else 1
    return {
        "status": "ok",
        "concurrency": best.concurrency,
        "per_worker_rps": per_worker_rps,
        "replicas": replicas,
        "ttft_s": best.ttft_s,
        "itl_s": best.itl_s,
    }
