"""Concurrency sweep harness (the genai-perf analog; reference:
benchmarks/llm/perf.sh concurrency 1,2,4,…,256 + plot_pareto.py).

Drives an engine (direct wire-dict interface or HTTP) at fixed concurrency
levels, measuring per-level: output tok/s (total and per-user), request
throughput, TTFT p50/p99, ITL mean.  Results feed the Pareto of
tok/s/user vs tok/s/chip.

A copy of dynamo_tpu/bench/sweep.py over the port's protocols and
engine interface.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Sequence

from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context


@dataclass
class SweepPoint:
    concurrency: int
    requests: int
    wall_s: float
    output_tokens: int
    tok_s_total: float          # tok/s/chip at 1 chip
    tok_s_per_user: float
    req_s: float
    ttft_p50_ms: float
    ttft_p99_ms: float
    itl_mean_ms: float


@dataclass
class SweepConfig:
    concurrencies: Sequence[int] = (1, 2, 4, 8, 16, 32)
    requests_per_level: int = 32
    isl: int = 128
    osl: int = 64
    vocab_size: int = 32_000
    seed: int = 0


async def _drive_one(engine, token_ids: list[int], osl: int) -> tuple[int, float, list[float]]:
    request = PreprocessedRequest(
        token_ids=token_ids,
        sampling=SamplingOptions(use_greedy=True),
        stop=StopConditions(max_tokens=osl, ignore_eos=True),
    ).to_wire()
    t0 = time.monotonic()
    stamps: list[float] = []
    count = 0
    stream = await engine.generate(Context(request))
    async for item in stream:
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is not None and ann.data.token_ids:
            stamps.append(time.monotonic() - t0)
            count += len(ann.data.token_ids)
    return count, stamps[0] if stamps else 0.0, stamps


async def run_sweep(engine, config: SweepConfig | None = None) -> list[SweepPoint]:
    import random

    config = config or SweepConfig()
    rng = random.Random(config.seed)
    points: list[SweepPoint] = []

    for concurrency in config.concurrencies:
        sem = asyncio.Semaphore(concurrency)
        ttfts: list[float] = []
        itls: list[float] = []
        total_tokens = 0

        async def one():
            nonlocal total_tokens
            tokens = [rng.randrange(10, config.vocab_size) for _ in range(config.isl)]
            async with sem:
                count, ttft, stamps = await _drive_one(engine, tokens, config.osl)
            total_tokens += count
            ttfts.append(ttft)
            itls.extend(b - a for a, b in zip(stamps, stamps[1:]))

        t0 = time.monotonic()
        await asyncio.gather(*[one() for _ in range(config.requests_per_level)])
        wall = time.monotonic() - t0

        ttfts.sort()
        points.append(
            SweepPoint(
                concurrency=concurrency,
                requests=config.requests_per_level,
                wall_s=round(wall, 3),
                output_tokens=total_tokens,
                tok_s_total=round(total_tokens / wall, 2),
                tok_s_per_user=round(total_tokens / wall / concurrency, 2),
                req_s=round(config.requests_per_level / wall, 3),
                ttft_p50_ms=round(ttfts[len(ttfts) // 2] * 1000, 2),
                ttft_p99_ms=round(ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))] * 1000, 2),
                itl_mean_ms=round(sum(itls) / len(itls) * 1000, 3) if itls else 0.0,
            )
        )
    return points


def pareto_frontier(points: list[SweepPoint]) -> list[SweepPoint]:
    """Non-dominated points in (tok_s_per_user, tok_s_total) space."""
    frontier = []
    for p in points:
        dominated = any(
            q.tok_s_per_user >= p.tok_s_per_user and q.tok_s_total > p.tok_s_total
            or q.tok_s_per_user > p.tok_s_per_user and q.tok_s_total >= p.tok_s_total
            for q in points
        )
        if not dominated:
            frontier.append(p)
    return sorted(frontier, key=lambda p: p.tok_s_per_user)


def write_results(points: list[SweepPoint], path) -> None:
    with open(path, "w") as f:
        for p in points:
            f.write(json.dumps(asdict(p)) + "\n")
