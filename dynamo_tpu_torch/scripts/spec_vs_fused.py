"""Speculative decoding × fused multi-step decode on the port's engine
(counterpart of scripts/spec_vs_fused.py).

Both features amortize per-launch dispatch: fused decode runs
``decode_steps`` plain iterations in one window; speculative decoding
verifies a ``spec_tokens`` draft window in one launch.  They compose:
iterations with enough drafting lanes run the verify graph, the rest
(sampled lanes, draft misses) the fused multi-step window.  This script
records tok/s for each mode on the same engine geometry:

  - baseline:   decode_steps=1
  - fused:      decode_steps=W
  - spec:       ngram, spec_tokens=W-1 (verify window = W tokens)
  - composed:   ngram + decode_steps=W

on three workloads: repetitive text (the drafter's best case), random
prompts, and SAMPLED decoding (temperature > 0: lanes are draft-ineligible,
so the spec engine's fallback path carries all traffic).

The engine is the reference's tiny Llama geometry with weights drawn from
``--seed`` on the device.  On the card the verify window is row 2 (the
paged GQA kernel) at W query positions inside the verify graph, and every
other window runs rows 1–2 inside the unified and decode graphs.  The
result, stamped with the card's name and power limit, goes to
``--out`` (default ``SPEC_VS_FUSED_CUDA.json`` at the repo root,
git-ignored).

Run: ``python -m dynamo_tpu_torch.scripts.spec_vs_fused [--window 4]
[--device cpu] [--out JSON]``
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import sys
import time
from pathlib import Path

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "SPEC_VS_FUSED_CUDA.json"
MODES = ("baseline", "fused", "spec", "composed")
WORKLOADS = ("repetitive", "random", "sampled")


async def measure(mode: str, window: int, workload: str, *, osl: int = 96,
                  num_requests: int = 6, device=None, params=None, seed: int = 0,
                  streams: list | None = None) -> dict:
    """One mode on one workload (the reference's ``measure``).  ``params``
    (port parameters of ``LlamaConfig.tiny()``) replace the weights drawn
    from ``seed``; ``streams``, when given, collects every request's
    (prompt, output token ids), the untimed warmup's first."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.device import resolve_device
    from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
    from dynamo_tpu_torch.llm.protocols.common import (
        Annotated,
        LLMEngineOutput,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.models.llama import LlamaConfig, init_params
    from dynamo_tpu_torch.runtime.engine import Context

    dev = resolve_device(device)
    cfg = LlamaConfig.tiny()
    kwargs = {}
    if mode == "fused":
        kwargs["decode_steps"] = window
    elif mode == "spec":
        kwargs.update(speculative="ngram", spec_tokens=window - 1, spec_ngram=2)
    elif mode == "composed":
        kwargs.update(speculative="ngram", spec_tokens=window - 1, spec_ngram=2,
                      decode_steps=window)
    if params is None:
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    engine = TorchLlmEngine(
        EngineConfig(
            model=cfg, num_blocks=256, block_size=4, max_batch_size=4,
            prefill_buckets=(32,), max_model_len=160, logit_bias_k=0, **kwargs,
        ),
        params=params,
        device=dev,
    )
    engine.start()
    rng = np.random.default_rng(0)

    def prompt() -> list[int]:
        if workload == "repetitive":
            # a short loop the greedy model tends to continue and the
            # ngram drafter locks onto
            pat = rng.integers(3, 40, size=4).tolist()
            return (pat * 8)[:32]
        return rng.integers(3, cfg.vocab_size - 3, size=32).tolist()

    async def drive(tokens: list[int], seed: int = 0) -> int:
        sampling = (
            SamplingOptions(temperature=0.9, seed=seed)
            if workload == "sampled"
            else SamplingOptions(use_greedy=True)
        )
        req = PreprocessedRequest(
            token_ids=tokens,
            sampling=sampling,
            stop=StopConditions(max_tokens=osl, ignore_eos=True),
            eos_token_ids=[],
        )
        out: list[int] = []
        if streams is not None:
            streams.append((list(tokens), out))
        stream = await engine.generate(Context(req.to_wire()))
        async for item in stream:
            ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
            if ann.data is not None:
                out.extend(ann.data.token_ids)
        return len(out)

    try:
        # the serving path's warmup (every graph of the engine captured),
        # then one untimed request
        await engine.warmup([32])
        await drive(prompt())
        warm = engine.stats()  # counters must exclude the untimed warmup
        t0 = time.monotonic()
        counts = await asyncio.gather(
            *[drive(prompt(), seed=i + 1) for i in range(num_requests)]
        )
        wall = time.monotonic() - t0
        stats = engine.stats()

        def delta(key: str) -> int:
            return stats.get(key, 0) - warm.get(key, 0)

        return {
            "mode": mode,
            "workload": workload,
            "tok_s": round(sum(counts) / wall, 1),
            "tokens": sum(counts),
            "wall_s": round(wall, 2),
            "spec_accepted": delta("spec_accepted_tokens_total"),
            "spec_drafted": delta("spec_drafted_tokens_total"),
        }
    finally:
        engine.stop()


def verdict(results: list[dict]) -> dict:
    """The reference's ratios of tok/s between modes."""
    rows = {(r["mode"], r["workload"]): r for r in results}

    def r(m: str, w: str, base: str) -> float:
        return round(rows[(m, w)]["tok_s"] / rows[(base, w)]["tok_s"], 2)

    return {
        "fused_vs_baseline_repetitive": r("fused", "repetitive", "baseline"),
        "spec_vs_baseline_repetitive": r("spec", "repetitive", "baseline"),
        "composed_vs_spec_repetitive": r("composed", "repetitive", "spec"),
        "spec_vs_baseline_random": r("spec", "random", "baseline"),
        "composed_vs_spec_random": r("composed", "random", "spec"),
        # draft-ineligible (sampled) traffic on a spec engine rides the
        # FUSED fallback when composed
        "composed_vs_spec_sampled": r("composed", "sampled", "spec"),
        "fused_vs_baseline_sampled": r("fused", "sampled", "baseline"),
    }


async def amain(window: int, *, device=None, workloads=WORKLOADS, **measure_kw) -> dict:
    """Every mode on each of ``workloads``, each row printed as it lands;
    the verdict when every workload ran."""
    from dynamo_tpu_torch.bench.headline import card_info
    from dynamo_tpu_torch.device import resolve_device

    card = card_info(resolve_device(device))
    out = {
        "platform": card["platform"],
        "device_kind": card["device_kind"],
        "power_limit_w": card["power_limit_w"],
        "window": window,
        "results": [],
    }
    for workload in workloads:
        for mode in MODES:
            row = await measure(mode, window, workload, device=device, **measure_kw)
            # the stopped engine's CUDA graph pool is freed here, not by a
            # collection on the next engine's thread mid-capture
            gc.collect()
            print(json.dumps(row))
            sys.stdout.flush()
            out["results"].append(row)
    if set(workloads) == set(WORKLOADS):
        out["verdict"] = verdict(out["results"])
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--window", type=int, default=4)
    parser.add_argument("--device", default=None, help="cuda (the default: the card) or cpu")
    parser.add_argument("--seed", type=int, default=0, help="the weights' seed")
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    args = parser.parse_args(argv)
    result = asyncio.run(amain(args.window, device=args.device, seed=args.seed))
    print(json.dumps(result["verdict"]))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
