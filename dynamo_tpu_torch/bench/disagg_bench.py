"""Disaggregated prefill/decode throughput benchmark in one process (the
port of dynamo_tpu/bench/disagg_bench.py, on TorchLlmEngine pairs).

Req/s and decode-phase tok/s with prefill on a DIFFERENT engine than
decode, the KV blocks shipped through the transfer plane (extracted with
the block-gather kernel, injected with the block-scatter kernel), against
the same workload on one aggregated engine.  On one card both engines
share the device (and here one set of weights), so this is not two-card
disaggregation: it prices the disaggregation machinery in the serving path
(router decision, prefill queue, remote prefill, block-exact KV landing,
decode continuation): ``disagg_overhead_pct``.

- ``streamed_ab``: the same stack with a chunked prefill engine, streamed
  (``DYN_KV_STREAM``-style multi-part) against single-shot transfer: TTFT
  per mode, parts shipped and the transfer's share hidden behind prefill.
- ``fleet``: a second decode candidate behind an unequal link; requests
  share a prefix the "near" worker holds while the "far" one sits on
  another slice; the KV-locality and link-cost scorer routes each request
  over a topology map discovered from published cards.

Usage:
    python -m dynamo_tpu_torch.bench.disagg_bench                 # the card
    python -m dynamo_tpu_torch.bench.disagg_bench --model tiny --device cpu
Prints one JSON line; ``--out FILE`` also writes it (the reference's
``DISAGG_BENCH.json`` at the repository's root stays as it is).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

import numpy as np
import torch


def _build_engine(model: str, quant: str | None, kv_dtype: str | None, isl: int, osl: int,
                  batch: int, device, params=None, prefill_only: bool = False,
                  chunk: int | None | str = "auto"):
    """The reference's engine recipe: chunked prefill at ISL above 512,
    ``decode_steps`` 8 on the decode side (1 on a prefill engine), no
    logit-bias scatter."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
    from dynamo_tpu_torch.models.llama import LlamaConfig

    cfg = getattr(LlamaConfig, model)()
    max_len = isl + osl + 32
    block_size = 16 if model != "tiny" else 4
    num_blocks = batch * ((max_len + block_size - 1) // block_size) + 8
    engine = TorchLlmEngine(
        EngineConfig(
            model=cfg, num_blocks=num_blocks, block_size=block_size, max_batch_size=batch,
            max_model_len=max_len, prefill_buckets=(min(512, isl),),
            prefill_chunk_tokens=(
                (min(512, isl) if isl > 512 else None) if chunk == "auto" else chunk),
            decode_steps=1 if prefill_only else 8, logit_bias_k=0, quantize=quant,
            kv_cache_dtype=kv_dtype,
        ),
        params=params, device=device,
    )
    engine.start()
    return engine, cfg


def _pctile(xs: list[float], q: float) -> float | None:
    if not xs:
        return None
    s = sorted(xs)
    return s[min(len(s) - 1, round(q * (len(s) - 1)))]


async def run(args: argparse.Namespace) -> dict:
    from dynamo_tpu_torch.bench.headline import const_params
    from dynamo_tpu_torch.device import resolve_device
    from dynamo_tpu_torch.llm.disagg import (
        DisaggConfig,
        DisaggDecodeEngine,
        DisaggRouter,
        PrefillQueue,
        PrefillWorker,
    )
    from dynamo_tpu_torch.llm.kv_router import (
        KvScheduler,
        RadixTree,
        TransferCostModel,
        compute_block_hashes,
    )
    from dynamo_tpu_torch.llm.kv_router.protocols import KvCacheEvent, RouterEvent
    from dynamo_tpu_torch.llm.protocols.common import (
        Annotated,
        LLMEngineOutput,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.runtime import Context, DistributedRuntime
    from dynamo_tpu_torch.topology import TopologyWatcher, local_card
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    device = resolve_device(args.device)
    quant = None if args.quant in (None, "none") else args.quant
    kv_dtype = None if args.kv_dtype in (None, "", "none", "model") else args.kv_dtype
    # one set of weights, the reference's constant fill, shared by every
    # engine of the process
    params = const_params(getattr(LlamaConfig, args.model)(), quant, device)
    print(f"disagg-bench: building decode + prefill engines ({args.model}/"
          f"{quant or 'bf16'}) on {device}", file=sys.stderr)
    t0 = time.monotonic()
    decode_engine, cfg = _build_engine(args.model, quant, kv_dtype, args.isl, args.osl,
                                       args.batch, device, params)
    # the pump prefills one request at a time: blocks for ~1 sequence;
    # chunked even at a tiny ISL so the streamed transfer has parts
    prefill_engine, _ = _build_engine(args.model, quant, kv_dtype, args.isl, args.osl, 2,
                                      device, params, prefill_only=True,
                                      chunk=min(512, args.isl) if args.isl > 512 else 8)
    print(f"disagg-bench: engines up in {time.monotonic() - t0:.1f}s", file=sys.stderr)
    rt = await DistributedRuntime.create(RuntimeConfig(control_plane="memory://disagg-bench"))
    rng = np.random.default_rng(0)
    bs = decode_engine.config.block_size

    def make_request(tokens: list[int] | None = None) -> dict:
        if tokens is None:
            tokens = rng.integers(10, cfg.vocab_size - 10, size=args.isl).tolist()
        return PreprocessedRequest(
            token_ids=tokens, sampling=SamplingOptions(use_greedy=True),
            stop=StopConditions(max_tokens=args.osl, ignore_eos=True), eos_token_ids=[],
        ).to_wire()

    itls: list[float] = []
    ttfts: list[float] = []
    spans: list[tuple[float, float, int]] = []

    async def drive(gen, req: dict) -> int:
        t0 = time.monotonic()
        ttft = t_last = None
        count = 0
        async for item in await gen(Context(req)):
            ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
            if ann.data is None or not ann.data.token_ids:
                continue
            t_last = time.monotonic()
            if ttft is None:
                ttft = t_last - t0
                ttfts.append(ttft)
            count += len(ann.data.token_ids)
        if ttft is not None and count > 1:
            itls.append((t_last - t0 - ttft) / (count - 1))
            spans.append((t0 + ttft, t_last, count))
        return count

    def reset() -> None:
        itls.clear()
        spans.clear()
        ttfts.clear()

    def ttft_stats() -> dict:
        return {
            "ttft_p50_ms": round(1e3 * _pctile(ttfts, 0.5), 2) if ttfts else None,
            "ttft_p99_ms": round(1e3 * _pctile(ttfts, 0.99), 2) if ttfts else None,
        }

    def phase_stats() -> dict:
        if not spans:
            return {}
        t0g, t1g = min(s[0] for s in spans), max(s[1] for s in spans)
        toks = sum(s[2] - 1 for s in spans)
        return {"decode_phase_tok_s": round(toks / (t1g - t0g), 2) if t1g > t0g else None,
                "itl_mean_ms": round(1e3 * sum(itls) / len(itls), 2)}

    async def burst(gen) -> tuple[list[int], float]:
        reset()
        t0 = time.monotonic()
        counts = await asyncio.gather(*[drive(gen, make_request())
                                        for _ in range(args.requests)])
        return counts, time.monotonic() - t0

    result: dict = {"model": args.model, "quantize": quant, "kv_cache_dtype": kv_dtype,
                    "num_requests": args.requests, "isl": args.isl, "osl": args.osl,
                    "batch": args.batch}
    disagg = disagg2 = decode2 = prefill_worker = router = topo_watch = None
    try:
        # -- aggregated reference: one engine does both ----------------------
        await drive(decode_engine.generate, make_request())  # first launches
        counts, agg_wall = await burst(decode_engine.generate)
        result["aggregated"] = {"wall_s": round(agg_wall, 2),
                                "req_s": round(args.requests / agg_wall, 3),
                                "tok_s": round(sum(counts) / agg_wall, 2),
                                **ttft_stats(), **phase_stats()}

        # -- disaggregated: every prefill goes remote -------------------------
        router = DisaggRouter(rt, args.model, DisaggConfig(
            max_local_prefill_length=1, max_prefill_queue_size=args.requests + 1))
        queue = PrefillQueue(rt, "bench", "disagg")
        disagg = DisaggDecodeEngine(rt, decode_engine, router, queue)
        await disagg.start()
        prefill_worker = PrefillWorker(rt, prefill_engine, queue)
        prefill_worker.start()
        await drive(disagg.generate, make_request())  # the prefill engine's first launches
        warm_remote = disagg.remote_prefills
        counts, dis_wall = await burst(disagg.generate)
        remote = disagg.remote_prefills - warm_remote
        result["disagg"] = {"wall_s": round(dis_wall, 2),
                            "req_s": round(args.requests / dis_wall, 3),
                            "tok_s": round(sum(counts) / dis_wall, 2),
                            # a shortfall: a request fell back to a local prefill
                            "remote_prefills": remote,
                            "all_prefills_remote": remote == args.requests,
                            **ttft_stats(), **phase_stats()}
        result["disagg_overhead_pct"] = round((dis_wall - agg_wall) / agg_wall * 100, 1)

        # -- streamed against single-shot over the same stack ----------------
        ab: dict = {}
        for mode_name, mode in (("single_shot", False), ("streamed", True)):
            await prefill_worker.stop()
            prefill_worker = PrefillWorker(rt, prefill_engine, queue, stream=mode)
            prefill_worker.start()
            base = disagg.stats()
            _, wall = await burst(disagg.generate)
            cur = disagg.stats()
            xfer_s = (cur["disagg_kv_transfer_seconds_total"]
                      - base["disagg_kv_transfer_seconds_total"])
            hidden_s = (cur["disagg_kv_transfer_hidden_seconds_total"]
                        - base["disagg_kv_transfer_hidden_seconds_total"])
            ab[mode_name] = {
                "wall_s": round(wall, 2),
                "kv_parts": (cur["disagg_kv_transfer_parts_total"]
                             - base["disagg_kv_transfer_parts_total"]),
                "transfer_hidden_fraction": round(hidden_s / xfer_s, 3) if xfer_s > 0 else 0.0,
                **ttft_stats(),
            }
        if ab["streamed"]["ttft_p50_ms"] and ab["single_shot"]["ttft_p50_ms"]:
            ab["ttft_p50_speedup"] = round(
                ab["single_shot"]["ttft_p50_ms"] / ab["streamed"]["ttft_p50_ms"], 3)
        result["streamed_ab"] = ab

        # -- routed fleet: two decode candidates, unequal overlap and links ---
        decode2, _ = _build_engine(args.model, quant, kv_dtype, args.isl, args.osl,
                                   args.batch, device, params)
        disagg2 = DisaggDecodeEngine(rt, decode2, router, queue)
        await disagg2.start()
        shared = rng.integers(10, cfg.vocab_size - 10, size=args.isl // 2).tolist()
        tree = RadixTree()
        tree.apply(RouterEvent(worker_id=1, event=KvCacheEvent(
            kind="stored", block_hashes=compute_block_hashes(shared, bs))))
        # the prefill source shares slice s0 with decode worker 1; worker 2
        # reports s1, so the discovered map prices prefill→2 as dcn
        for wid, role, slice_label in ((17, "prefill", "s0"), (1, "decode", "s0"),
                                       (2, "decode", "s1")):
            card = local_card(wid, role=role, slice_label=slice_label)
            await rt.plane.kv.put(card.key(), card.to_json())
        topo_watch = TopologyWatcher(rt)
        await topo_watch.start()
        for _ in range(200):
            if len(topo_watch.map.nodes) >= 3:
                break
            await asyncio.sleep(0.01)
        cost_model = TransferCostModel()
        cost_model.attach_topology(topo_watch.map)
        sched = KvScheduler()
        fleet_engines = {1: disagg, 2: disagg2}
        picks = {1: 0, 2: 0}
        reset()

        async def fleet_one() -> None:
            tokens = shared + rng.integers(10, cfg.vocab_size - 10,
                                           size=args.isl - len(shared)).tolist()
            hashes = compute_block_hashes(tokens, bs)
            overlap = tree.find_matches(hashes)
            missing = {w: len(hashes) - overlap.scores.get(w, 0) for w in (1, 2)}
            wid, _ratio = sched.select_worker([1, 2], overlap, len(hashes),
                                              transfer_costs=cost_model.costs([1, 2], missing))
            picks[wid] += 1
            await drive(fleet_engines[wid].generate, make_request(tokens))

        t0 = time.monotonic()
        await asyncio.gather(*[fleet_one() for _ in range(args.requests)])
        topo = topo_watch.map
        result["fleet"] = {
            "decode_workers": 2,
            "topology_discovered": topo.informative(),
            "near": {"worker": 1, "hop": topo.inbound_hop(1),
                     "bandwidth_bps": topo.pair_bandwidth(17, 1),
                     "overlap_blocks": len(compute_block_hashes(shared, bs)),
                     "picks": picks[1]},
            "far": {"worker": 2, "hop": topo.inbound_hop(2),
                    "bandwidth_bps": topo.pair_bandwidth(17, 2), "overlap_blocks": 0,
                    "picks": picks[2]},
            "preferred_is_near": picks[1] > picks[2],
            "wall_s": round(time.monotonic() - t0, 2),
            **ttft_stats(),
        }
        result["extract_calls"] = prefill_engine.extract_calls
        result["inject_calls"] = decode_engine.inject_calls + decode2.inject_calls
        result["platform"] = device.type
        result["device_kind"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                                 else "cpu")
        result["note"] = (
            "one card: both engines share the device, so compute does not "
            "overlap; overhead_pct prices the disaggregation plumbing (router, "
            "queue, KV transfer, landing), not a two-card speedup")
    finally:
        if topo_watch is not None:
            await topo_watch.stop()
        if prefill_worker is not None:
            await prefill_worker.stop()
        for d in (disagg, disagg2):
            if d is not None:
                await d.stop()
        if router is not None:
            await router.stop()
        await rt.close()
        for e in (decode_engine, prefill_engine, decode2):
            if e is not None:
                e.stop()
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", default=None,
                        help="a LlamaConfig preset or 'tiny' (default: llama32_3b on the "
                        "card, tiny on the CPU)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--quant", default=None,
                        help="int8 or none (default: int8 for the llama3 presets)")
    parser.add_argument("--kv-dtype", default="bf16")
    parser.add_argument("--isl", type=int, default=None)
    parser.add_argument("--osl", type=int, default=None)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--requests", type=int, default=16)
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    cpu = args.device == "cpu"
    if args.model is None:
        args.model = "tiny" if cpu else "llama32_3b"
    if args.quant is None:
        args.quant = "int8" if args.model.startswith("llama3") else "none"
    if args.model == "tiny":
        args.kv_dtype = None if args.kv_dtype == "bf16" else args.kv_dtype
    if args.isl is None:
        args.isl = 3000 if args.model != "tiny" else 24
    if args.osl is None:
        args.osl = 150 if args.model != "tiny" else 8
    if args.model == "tiny":
        args.batch = min(args.batch, 4)
        args.requests = min(args.requests, 6)
    result = asyncio.run(run(args))
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
