"""Decode hot-loop phase profile on the card (counterpart of
scripts/profile_decode.py).

Builds a const-init ``TorchLlmEngine`` (the headline bench's construction:
0.01 in every float leaf, 1 in every integer one), drives a fixed batch of
greedy requests, and prints one JSON line with per-phase host wall time from
the engine's ``DYN_ENGINE_PHASE_TIMING`` accounting (``decode.schedule`` /
``upload`` / ``dispatch`` / ``readback`` / ``retire`` / ``post``) plus ITL and
throughput.

A/B mode (``--ab``) runs the same workload twice — synchronous decode
(``decode_overlap=False``) then the overlapped pipeline — and reports
steps/s plus each mode's per-phase share of decode wall.  Exits nonzero
when overlap regresses throughput below ``--ab-min-speedup`` (default: any
regression fails).  In overlap mode the synchronous ``decode.readback``
phase disappears by construction: the wait moves to ``decode.retire``,
which runs while the NEXT window computes on the card.

Mixed A/B mode (``--mixed``) drives a CONTINUOUS ARRIVAL stream — requests
land every ``--arrival-ms`` while earlier ones decode, with chunked prefill
on — twice: the split prefill/decode step, then the ragged unified-batch
step (``unified_batch=True``).  Reports steps/s, the admission-drain count
(pipeline drains forced by new-sequence admission — the sync point the
unified step removes; must stay 0 in unified mode), unified-window count,
and per-phase shares.  Exits nonzero when unified regresses steps/s below
``--mixed-min-speedup``.

``--family`` picks the model family for the mixed A/B: ``llama`` (the
``--model`` LlamaConfig geometry), ``moe`` (Mixtral ``tiny_moe``) or ``mla``
(DeepSeek ``tiny_mla``).  ``--decode-heavy`` switches the arrival pattern to
one burst plus a mid-decode straggler.

On the card every decode window is a CUDA graph replay of the decode graph
(the paged GQA kernel, or the MLA table walk under ``--family mla``) and
every mixed window one of the unified graph (the ragged GQA or ragged MLA
kernel).  Each engine is warmed as the serving path warms it
(``TorchLlmEngine.warmup``) before its warmup requests, so no graph is
captured mid-measurement.  The result carries the card's name and power
limit.

Usage: python -m dynamo_tpu_torch.scripts.profile_decode
           [--model llama32_1b|tiny] [--quant int8] [--isl 256] [--osl 64]
           [--batch 16] [--decode-steps 1] [--overlap 0|1] [--ab]
           [--mixed] [--family llama|moe|mla] [--decode-heavy]
           [--requests 12] [--arrival-ms 50] [--chunk 32]
           [--device cuda|cpu] [--out PROFILE_DECODE_CUDA.json]
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import gc
import json
import os
import sys
import time
from pathlib import Path

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "PROFILE_DECODE_CUDA.json"


@contextlib.contextmanager
def phase_timing():
    """``DYN_ENGINE_PHASE_TIMING=1`` for the engines built inside (the
    engine reads the knob at construction), restored after."""
    name = "DYN_ENGINE_PHASE_TIMING"
    before = os.environ.get(name)
    os.environ[name] = "1"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = before


def _family_setup(args: argparse.Namespace):
    """Resolve ``--family`` to (registry key, model config, model label)."""
    from dynamo_tpu_torch.models.llama import LlamaConfig

    family = getattr(args, "family", "llama") or "llama"
    if family == "llama":
        return "llama", getattr(LlamaConfig, args.model)(), args.model
    if family == "moe":
        from dynamo_tpu_torch.models.mixtral import MixtralConfig

        return "mixtral", MixtralConfig.tiny_moe(), "tiny_moe"
    if family == "mla":
        from dynamo_tpu_torch.models.deepseek import DeepseekConfig

        return "deepseek_v2", DeepseekConfig.tiny_mla(), "tiny_mla"
    raise SystemExit(f"unknown --family {family!r} (llama|moe|mla)")


def _decode_phase_shares(phase_ms: dict) -> dict:
    """Each decode.* phase's share of total decode wall (0..1)."""
    decode = {k: v["total_ms"] for k, v in phase_ms.items() if k.startswith("decode.")}
    total = sum(decode.values())
    if total <= 0:
        return {}
    return {k: round(v / total, 4) for k, v in decode.items()}


def _request_maker(cfg, args):
    import numpy as np

    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    rng = np.random.default_rng(0)

    def make_request() -> dict:
        tokens = rng.integers(10, cfg.vocab_size - 10, size=args.isl).tolist()
        return PreprocessedRequest(
            token_ids=tokens,
            sampling=SamplingOptions(use_greedy=True),
            stop=StopConditions(max_tokens=args.osl, ignore_eos=True),
            eos_token_ids=[],
        ).to_wire()

    return make_request


async def _stream(engine, req: dict, streams: list | None):
    """Yield each output item's token ids; record (prompt, tokens) in
    ``streams`` when given."""
    from dynamo_tpu_torch.llm.protocols.common import Annotated, LLMEngineOutput
    from dynamo_tpu_torch.runtime.engine import Context

    out: list[int] = []
    if streams is not None:
        streams.append((list(req["token_ids"]), out))
    stream = await engine.generate(Context(req))
    async for item in stream:
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is not None and ann.data.token_ids:
            out.extend(ann.data.token_ids)
            yield ann.data.token_ids


async def run(args: argparse.Namespace, *, overlap: bool | None = None,
              streams: list | None = None) -> dict:
    """One fixed-batch greedy run (the reference's ``run``).  ``streams``,
    when given, collects every request's (prompt, output token ids)."""
    from dynamo_tpu_torch.bench.headline import card_info, const_params
    from dynamo_tpu_torch.device import resolve_device
    from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
    from dynamo_tpu_torch.models.llama import LlamaConfig

    device = resolve_device(getattr(args, "device", None))
    cfg = getattr(LlamaConfig, args.model)()
    max_len = args.isl + args.osl + 16
    block_size = 16
    num_blocks = args.batch * ((max_len + block_size - 1) // block_size) + 8
    quant = None if args.quant in (None, "none") else args.quant
    with phase_timing():
        engine = TorchLlmEngine(
            EngineConfig(
                model=cfg,
                num_blocks=num_blocks,
                block_size=block_size,
                max_batch_size=args.batch,
                max_model_len=max_len,
                prefill_buckets=(args.isl,),
                decode_steps=args.decode_steps,
                logit_bias_k=0,
                quantize=quant,
                kv_cache_dtype=args.kv_dtype,
                decode_overlap=True if overlap is None else overlap,
            ),
            params=const_params(cfg, quant, device),
            device=device,
        )
    engine.start()
    mode = "overlap" if engine.decode_overlap else "sync"
    print(f"profile: engine up ({args.model}, {mode})", file=sys.stderr)
    make_request = _request_maker(cfg, args)
    itls: list[float] = []
    started = 0
    all_started = asyncio.Event()

    async def drive(req: dict) -> int:
        nonlocal started
        t0 = time.monotonic()
        ttft = t_last = None
        count = 0
        async for token_ids in _stream(engine, req, streams):
            t_last = time.monotonic()
            if ttft is None:
                ttft = t_last - t0
                started += 1
                if started == args.batch:
                    all_started.set()
            count += len(token_ids)
        if ttft is not None and count > 1:
            itls.append((t_last - t0 - ttft) / (count - 1))
        return count

    try:
        # the serving path's warmup: every graph of the run captured first
        await engine.warmup([args.isl])
        t0 = time.monotonic()
        await drive(make_request())  # warmup request
        print(f"profile: warmup {time.monotonic() - t0:.1f}s", file=sys.stderr)
        itls.clear()
        before = engine.stats()

        # steady-state isolation: phase stats restart once every lane has
        # produced a first token, so prefill interleave does not pollute the
        # decode-window attribution
        async def clear_at_steady():
            await all_started.wait()
            engine.phase_stats.clear()

        t0 = time.monotonic()
        results = await asyncio.gather(
            clear_at_steady(), *[drive(make_request()) for _ in range(args.batch)]
        )
        counts = results[1:]
        wall = time.monotonic() - t0
        stats = engine.stats()
    finally:
        engine.stop()
    card = card_info(device)
    phase_ms = stats.get("phase_ms", {})
    decode_steps = stats.get("decode_steps_total", 0) - before.get("decode_steps_total", 0)
    return {
        "platform": card["platform"],
        "device_kind": card["device_kind"],
        "model": args.model,
        "quant": args.quant,
        "batch": args.batch,
        "isl": args.isl,
        "osl": args.osl,
        "decode_steps": args.decode_steps,
        "overlap": engine.decode_overlap,
        "windows_overlapped": (stats.get("decode_windows_overlapped_total", 0)
                               - before.get("decode_windows_overlapped_total", 0)),
        "windows_sync": (stats.get("decode_windows_sync_total", 0)
                         - before.get("decode_windows_sync_total", 0)),
        "wall_s": round(wall, 2),
        "tok_s": round(sum(counts) / wall, 1),
        "steps_s": round(decode_steps / wall, 2),
        "itl_mean_ms": round(1e3 * sum(itls) / max(len(itls), 1), 2),
        "decode_phase_share": _decode_phase_shares(phase_ms),
        "phase_ms": phase_ms,
    }


async def run_mixed(args: argparse.Namespace, *, unified: bool,
                    streams: list | None = None) -> dict:
    """One continuous-arrival mixed prefill+decode run (chunked prefill on,
    overlap per ``--overlap`` / the engine default) on the split or the
    unified step (the reference's ``run_mixed``).  ``steps_s`` counts DECODE
    steps; raw scheduler iterations ride along as ``iterations``."""
    from dynamo_tpu_torch.bench.headline import card_info, const_params
    from dynamo_tpu_torch.device import resolve_device
    from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine

    device = resolve_device(getattr(args, "device", None))
    fam_name, cfg, model_label = _family_setup(args)
    max_len = args.isl + args.osl + 16
    block_size = 16
    num_blocks = args.batch * ((max_len + block_size - 1) // block_size) + 8
    overlap = True if args.overlap is None else bool(args.overlap)
    with phase_timing():
        engine = TorchLlmEngine(
            EngineConfig(
                model=cfg,
                model_family=fam_name,
                num_blocks=num_blocks,
                block_size=block_size,
                max_batch_size=args.batch,
                max_model_len=max_len,
                prefill_buckets=(args.isl,),
                prefill_chunk_tokens=args.chunk,
                logit_bias_k=0,
                # the model's cache dtype in BOTH modes: an A/B must not
                # compare different cache byte counts
                kv_cache_dtype=None,
                decode_overlap=overlap,
                unified_batch=unified,
            ),
            params=const_params(cfg, None, device, family=fam_name),
            device=device,
        )
    engine.start()
    mode = "unified" if engine.unified_batch else "split"
    print(f"profile: mixed engine up ({model_label}, {mode})", file=sys.stderr)
    make_request = _request_maker(cfg, args)

    async def drive(req: dict) -> int:
        count = 0
        async for token_ids in _stream(engine, req, streams):
            count += len(token_ids)
        return count

    try:
        await engine.warmup([args.isl])
        # warmup: two OVERLAPPING requests, as the reference warms its mixed
        # windows' programs
        warm = [asyncio.ensure_future(drive(make_request()))]
        await asyncio.sleep(args.arrival_ms / 1e3)
        warm.append(asyncio.ensure_future(drive(make_request())))
        await asyncio.gather(*warm)
        before = engine.stats()
        engine.phase_stats.clear()
        t0 = time.monotonic()
        tasks = []
        if getattr(args, "decode_heavy", False):
            # one burst packs the window with decode lanes, then a straggler
            # lands mid-decode: a chunk still rides a packed decode window
            for _ in range(args.requests - 1):
                tasks.append(asyncio.ensure_future(drive(make_request())))
            await asyncio.sleep(args.arrival_ms / 1e3)
            tasks.append(asyncio.ensure_future(drive(make_request())))
        else:
            for _ in range(args.requests):
                tasks.append(asyncio.ensure_future(drive(make_request())))
                await asyncio.sleep(args.arrival_ms / 1e3)
        counts = await asyncio.gather(*tasks)
        wall = time.monotonic() - t0
        stats = engine.stats()
    finally:
        engine.stop()
    card = card_info(device)

    def delta(key: str) -> int:
        return stats[key] - before[key]

    return {
        "platform": card["platform"],
        "device_kind": card["device_kind"],
        "model": model_label,
        "family": getattr(args, "family", "llama") or "llama",
        "mode": mode,
        "decode_heavy": bool(getattr(args, "decode_heavy", False)),
        "iterations": delta("iterations_total"),
        "batch": args.batch,
        "isl": args.isl,
        "osl": args.osl,
        "chunk": args.chunk,
        "requests": args.requests,
        "arrival_ms": args.arrival_ms,
        "overlap": engine.decode_overlap,
        "wall_s": round(wall, 2),
        "tok_s": round(sum(counts) / wall, 1),
        # decode-step cadence, not scheduler iterations: a unified iteration
        # serves prefill AND decode in one window
        "steps_s": round(delta("decode_steps_total") / wall, 2),
        "admission_drains": delta("admission_drains_total"),
        "windows_unified": delta("decode_windows_unified_total"),
        "windows_overlapped": delta("decode_windows_overlapped_total"),
        "windows_sync": delta("decode_windows_sync_total"),
        "decode_phase_share": _decode_phase_shares(stats.get("phase_ms", {})),
        "phase_ms": stats.get("phase_ms", {}),
    }


async def amain(args: argparse.Namespace, *, streams: dict | None = None) -> tuple[int, dict]:
    """Run the requested profile; returns (exit_code, result).  Importable
    so tests and the chip smoke drive the A/Bs in process.  ``streams``,
    when given, gets each run's (prompt, output token ids) under its mode
    (``sync`` / ``overlap`` / ``split`` / ``unified``)."""

    def rec(mode: str) -> list | None:
        return None if streams is None else streams.setdefault(mode, [])

    async def each(runner, **kw) -> dict:
        result = await runner(args, **kw)
        # the stopped engine (and its CUDA graphs' memory pool) is freed
        # here: a pool freed by a collection on another thread while the
        # next engine captures its graphs aborts the process
        gc.collect()
        return result

    if getattr(args, "mixed", False):
        split = await each(run_mixed, unified=False, streams=rec("split"))
        uni = await each(run_mixed, unified=True, streams=rec("unified"))
        speedup = uni["steps_s"] / split["steps_s"] if split["steps_s"] else 0.0
        result = {
            "mixed": True,
            "model": uni["model"],
            "family": uni["family"],
            "decode_heavy": uni["decode_heavy"],
            "batch": args.batch,
            "isl": args.isl,
            "osl": args.osl,
            "chunk": args.chunk,
            "requests": args.requests,
            "arrival_ms": args.arrival_ms,
            "unified_speedup_steps_s": round(speedup, 3),
            "unified_speedup_tok_s": round(
                uni["tok_s"] / split["tok_s"], 3
            ) if split["tok_s"] else 0.0,
            "admission_drains_split": split["admission_drains"],
            "admission_drains_unified": uni["admission_drains"],
            "windows_unified": uni["windows_unified"],
            "split": split,
            "unified": uni,
        }
        rc = 0
        if speedup < args.mixed_min_speedup:
            print(
                f"profile: unified REGRESSED steps/s ({speedup:.3f}x < "
                f"{args.mixed_min_speedup}x)", file=sys.stderr,
            )
            rc = 1
        if uni["windows_unified"] and uni["admission_drains"]:
            print(
                "profile: unified mode still drained on admission "
                f"({uni['admission_drains']} drains)", file=sys.stderr,
            )
            rc = 1
        return rc, result
    if not args.ab:
        overlap = None if args.overlap is None else bool(args.overlap)
        mode = "run" if overlap is None else ("overlap" if overlap else "sync")
        return 0, await each(run, overlap=overlap, streams=rec(mode))

    sync = await each(run, overlap=False, streams=rec("sync"))
    over = await each(run, overlap=True, streams=rec("overlap"))
    speedup = over["tok_s"] / sync["tok_s"] if sync["tok_s"] else 0.0
    result = {
        "ab": True,
        "model": args.model,
        "batch": args.batch,
        "isl": args.isl,
        "osl": args.osl,
        "decode_steps": args.decode_steps,
        "overlap_speedup_tok_s": round(speedup, 3),
        "overlap_speedup_steps_s": round(
            over["steps_s"] / sync["steps_s"], 3
        ) if sync["steps_s"] else 0.0,
        "readback_share_sync": sync["decode_phase_share"].get("decode.readback", 0.0),
        "readback_share_overlap": over["decode_phase_share"].get("decode.readback", 0.0),
        "retire_share_overlap": over["decode_phase_share"].get("decode.retire", 0.0),
        "sync": sync,
        "overlap": over,
    }
    rc = 0
    if speedup < args.ab_min_speedup:
        print(
            f"profile: overlap REGRESSED throughput ({speedup:.3f}x < "
            f"{args.ab_min_speedup}x)", file=sys.stderr,
        )
        rc = 1
    return rc, result


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="decode phase profile on the card")
    p.add_argument("--model", default="llama32_1b",
                   help="LlamaConfig classmethod name (llama32_1b, tiny, ...)")
    p.add_argument("--quant", default="none")
    p.add_argument("--kv-dtype", default="bf16")
    p.add_argument("--isl", type=int, default=256)
    p.add_argument("--osl", type=int, default=64)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--decode-steps", type=int, default=1)
    p.add_argument("--overlap", type=int, choices=(0, 1), default=None,
                   help="force the overlapped pipeline on/off (default: on, "
                        "the engine's default)")
    p.add_argument("--ab", action="store_true",
                   help="run sync AND overlap, report both + speedup; exit "
                        "nonzero if overlap regresses throughput")
    p.add_argument("--ab-min-speedup", type=float, default=1.0,
                   help="minimum overlap/sync tok_s ratio for --ab to exit 0 "
                        "(1.0 = fail on any regression)")
    p.add_argument("--mixed", action="store_true",
                   help="continuous-arrival mixed prefill+decode A/B: split "
                        "step vs ragged unified-batch step; exit nonzero if "
                        "unified regresses steps/s or still drains on admission")
    p.add_argument("--mixed-min-speedup", type=float, default=1.0,
                   help="minimum unified/split steps_s ratio for --mixed to exit 0")
    p.add_argument("--family", default="llama", choices=("llama", "moe", "mla"),
                   help="--mixed: model family (llama uses --model; moe/mla use "
                        "the tiny Mixtral/DeepSeek geometries)")
    p.add_argument("--decode-heavy", action="store_true",
                   help="--mixed: burst admission + one mid-decode straggler")
    p.add_argument("--requests", type=int, default=12,
                   help="--mixed: requests in the arrival stream")
    p.add_argument("--arrival-ms", type=int, default=50,
                   help="--mixed: inter-arrival gap")
    p.add_argument("--chunk", type=int, default=32,
                   help="--mixed: prefill_chunk_tokens for both modes")
    p.add_argument("--device", default=None,
                   help="cuda (the default: the card) or cpu")
    p.add_argument("--out", default=str(DEFAULT_OUT),
                   help="also write the JSON result here (git-ignored by default)")
    return p


def stamp(result: dict, device) -> dict:
    """The provenance header and the card's power limit (the card's name is
    each run's ``device_kind``)."""
    from dynamo_tpu_torch.bench.headline import card_info
    from dynamo_tpu_torch.bench.perfgate import provenance_stamp
    from dynamo_tpu_torch.device import resolve_device

    card = card_info(resolve_device(device))
    result["power_limit_w"] = card["power_limit_w"]
    result["provenance"] = provenance_stamp(card)
    return result


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    rc, result = asyncio.run(amain(args))
    stamp(result, args.device)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2) + "\n")
    print(json.dumps(result))
    return rc


if __name__ == "__main__":
    sys.exit(main())
