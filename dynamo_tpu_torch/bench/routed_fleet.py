"""Routed-fleet TTFT benchmark: KV-aware routing vs random routing.

The reference's headline routing claim is ~3x TTFT from KV-aware routing on
multi-turn traffic (reference: docs/architecture/architecture.md:86-91);
this module measures the same effect end-to-end through the port's real
stack: N mocker workers (real BlockAllocator + Scheduler, reference cost
model) served on control-plane endpoints with real KV-event/load publishers,
a real KvRouter radix index fed from the bus, and dispatch through
PushRouter — the only simulated part is the device compute.

Workload: multi-turn sessions (bench.data_generator.generate_sessions).
Each session's growing history is its own prefix: sessions spread load
across the fleet, while an affine (KV-aware) router turns every follow-up
turn into a tail-only prefill.  Turn prompts embed the ACTUAL streamed
assistant tokens, exactly like a chat client echoing history.  Both
policies replay the same sessions against a fresh fleet; TTFT includes
queueing.  Times are simulation-compressed (speedup-scaled) wall seconds,
so absolute numbers are synthetic but the kv/random RATIO is scale-free —
the ratio is the result.

A copy of dynamo_tpu/bench/routed_fleet.py whose real-engine mode is
``engine="torch"``: ``TorchLlmEngine`` workers on one device (the CUDA card
unless ``device="cpu"``), serving one set of parameters made once on it,
each warmed (its graphs captured) before the measured replay.  Their model
is the port's Llama-3-8B preset on the card and the tiny test geometry on
the CPU, unless ``model_config`` names another.  Workers of one process
share the device: on one card their device loops contend for its SMs, so
the kv/random ratio there reads contention as well as routing.

Run: ``python -m dynamo_tpu_torch.bench.routed_fleet [--engine torch]
[--out FILE]`` (one JSON line on stdout; ``--out`` also writes it to FILE)
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, replace

from dynamo_tpu_torch.bench.data_generator import Session, SessionConfig, generate_sessions
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher, WorkerMetricsPublisher
from dynamo_tpu_torch.llm.kv_router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.llm.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    LLMEngineOutput,
    PreprocessedRequest,
    StopConditions,
)
from dynamo_tpu_torch.runtime.client import PushRouter, RouterMode
from dynamo_tpu_torch.runtime.controlplane.memory import MemoryControlPlane
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.utils.config import RuntimeConfig
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("bench.routed_fleet")


@dataclass
class FleetConfig:
    num_workers: int = 4
    block_size: int = 16
    num_blocks: int = 2048
    max_batch_size: int = 16
    # modest compression: at high speedups the wall-clock dispatch overhead
    # (TCP rendezvous, event loop) drowns the compressed compute deltas and
    # the measurement stops being about routing at all
    speedup: float = 10.0
    # load metrics cadence in SIMULATED seconds (production publishes at
    # ~1s against real traffic; a cadence much slower than the per-turn
    # service time leaves the router's load view stale and lets affine
    # traffic herd onto busy workers)
    metrics_period_sim_s: float = 0.25
    # "mocker" (reference-style cost-model sim — how the reference validates
    # routing, lib/llm/src/mocker/) or "torch": REAL TorchLlmEngine workers
    # whose TTFT deltas come from actual prefill compute saved by prefix
    # caching.  torch mode requires speedup=1.0 — service time is real, so
    # compressed arrivals would measure queue saturation, not routing.
    engine: str = "mocker"
    # torch mode: model config (None = LlamaConfig.llama3_8b on the card,
    # LlamaConfig.tiny on the CPU)
    model_config: object = None
    # torch mode: engine context window; size it to the workload's longest
    # history (main() computes this from the session config)
    max_model_len: int = 512
    # torch mode: the device every worker runs on (None = the CUDA card,
    # "cpu" for tests) and the parameters they all serve (None = one
    # seeded init on that device, made once per fleet)
    device: str | None = None
    params: object = None
    # parked-session mode (run_parked): host offload tier size in blocks —
    # 0 mounts no tier (the plain routing bench); the prefetch gate for the
    # engines (None = DYN_PREFETCH env); and an emulated per-block page-in
    # latency applied to EVERY tier read (demand and prefetch alike, so the
    # comparison is fair) — on this CPU container host-tier reads are
    # page-cache-fast, while production disk/DCN tiers pay real IO, and the
    # bench's point is WHERE that latency lands, not how big it is
    host_offload_blocks: int = 0
    prefetch: bool | None = None
    page_delay_ms: float = 0.0

    def __post_init__(self) -> None:
        if self.engine == "torch" and self.speedup != 1.0:
            raise ValueError(
                "engine='torch' requires speedup=1.0: real engines serve in "
                "real time, so compressed arrivals measure queue depth "
                "instead of routing"
            )


def _make_fleet_engine(cfg: FleetConfig, params_cache: dict):
    if cfg.engine == "mocker":
        return MockerEngine(
            MockerConfig(
                num_blocks=cfg.num_blocks,
                block_size=cfg.block_size,
                max_batch_size=cfg.max_batch_size,
                speedup=cfg.speedup,
            )
        )
    if cfg.engine == "torch":
        import torch

        from dynamo_tpu_torch.device import resolve_device
        from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
        from dynamo_tpu_torch.models.llama import LlamaConfig, init_params

        dev = resolve_device(cfg.device)
        mcfg = cfg.model_config or (
            LlamaConfig.llama3_8b() if dev.type == "cuda" else LlamaConfig.tiny()
        )
        if "params" not in params_cache:
            # one init on the device shared by every worker: engines never
            # mutate params, and N inits would hold N copies of the weights
            params_cache["params"] = cfg.params
            if cfg.params is None:
                gen = torch.Generator(device=dev)
                gen.manual_seed(0)
                params_cache["params"] = init_params(mcfg, gen, device=dev)
        # bucket ladder sized to the context window (the split prefill's
        # buckets): every serving graph is captured BEFORE the measured
        # replay (run_fleet), and the top bucket covers max_model_len
        buckets = tuple(
            b for b in (128, 256, 512, 1024, 2048) if b < cfg.max_model_len
        ) + (cfg.max_model_len,)
        engine = TorchLlmEngine(
            EngineConfig(
                model=mcfg,
                num_blocks=cfg.num_blocks,
                block_size=cfg.block_size,
                max_batch_size=cfg.max_batch_size,
                prefill_buckets=buckets,
                max_model_len=cfg.max_model_len,
                host_offload_blocks=cfg.host_offload_blocks,
                prefetch=cfg.prefetch,
            ),
            params=params_cache["params"],
            device=dev,
        )
        if cfg.page_delay_ms and engine.host_tier is not None:
            _emulate_tier_latency(engine.host_tier, cfg.page_delay_ms)
        return engine
    raise ValueError(f"unknown fleet engine {cfg.engine!r} (want mocker|torch)")


async def _serve_fleet(rt: DistributedRuntime, cfg: FleetConfig):
    comp = rt.namespace("fleet").component("backend")
    ep = comp.endpoint("generate")
    handles = []
    params_cache: dict = {}
    for _ in range(cfg.num_workers):
        engine = _make_fleet_engine(cfg, params_cache)
        service = await ep.serve(engine, stats_handler=engine.stats)
        kv_pub = KvEventPublisher(comp, worker_id=service.instance.instance_id)
        kv_pub.start()
        # sink attached before the engine loop starts (serve.py invariant):
        # no early request's stored-block events may be dropped
        engine._event_sink = kv_pub.sink
        # torch mode forces speedup=1.0 (FleetConfig.__post_init__), so this
        # division is the identity there and sim-compression for the mocker
        metrics_pub = WorkerMetricsPublisher(
            comp, service.instance.instance_id, engine.stats,
            period_s=cfg.metrics_period_sim_s / cfg.speedup,
        )
        metrics_pub.start()
        engine.start()
        handles.append((engine, service, kv_pub, metrics_pub))
    return comp, ep, handles


async def _teardown_fleet(handles) -> None:
    for engine, service, kv_pub, metrics_pub in handles:
        await metrics_pub.stop()
        await kv_pub.stop()
        await service.shutdown(drain_timeout=1)
        engine.stop()


def _pctile(xs: list[float], q: float) -> float | None:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else None


def _emulate_tier_latency(host_tier, page_delay_ms: float) -> None:
    """Give the offload tier a per-block read latency (sleep on the device
    thread, exactly where real disk/DCN IO would block).  Applies to every
    restore — demand paging pays it inside admission, prefetch pays it
    between steps before the request arrives — so only the PLACEMENT of
    the latency differs between the bench's modes."""
    orig = host_tier.read_pinned_many
    delay_s = page_delay_ms / 1000.0

    def slow_read(seq_hashes, _orig=orig, _d=delay_s):
        time.sleep(_d * len(seq_hashes))
        return _orig(seq_hashes)

    host_tier.read_pinned_many = slow_read


async def run_fleet(
    policy: str,
    sessions: list[Session],
    fleet_cfg: FleetConfig | None = None,
    *,
    control_plane: str | None = None,
) -> dict:
    """Replay multi-turn ``sessions`` against a fresh mocker fleet under
    ``policy`` ("kv" or "random"); returns TTFT percentiles (all turns and
    follow-up turns separately) and fleet counters."""
    assert policy in ("kv", "random"), policy
    cfg = fleet_cfg or FleetConfig()
    MemoryControlPlane.reset_named()
    rt = await DistributedRuntime.create(
        RuntimeConfig(control_plane=control_plane or f"memory://fleet-{policy}")
    )
    kv_router = push = None
    handles = []
    try:
        comp, ep, handles = await _serve_fleet(rt, cfg)
        push = await PushRouter.from_endpoint(ep, mode=RouterMode.RANDOM)
        if policy == "kv":
            kv_router = KvRouter(comp, block_size=cfg.block_size)
            await kv_router.start()
            dispatcher = KvPushRouter(push, kv_router)
        else:
            dispatcher = push
        await push.client.wait_for_instances(cfg.num_workers, timeout=10)
        if cfg.engine == "torch":
            # capture every serving graph before the clock starts: lazy
            # captures inside the replay would dominate first-turn TTFT and
            # drown the routing signal entirely
            for engine, *_ in handles:
                await engine.warmup()

        t_start = time.monotonic()
        first_ttfts: list[float] = []    # turn 0: cold for both policies
        follow_ttfts: list[float] = []   # turns 1+: where affinity matters
        streamed = [0, 0]                # tokens streamed; turns short of their osl

        async def one_session(sess: Session) -> None:
            delay = sess.start_s / cfg.speedup - (time.monotonic() - t_start)
            if delay > 0:
                await asyncio.sleep(delay)
            history = list(sess.system_tokens)
            for i, turn in enumerate(sess.turns):
                if turn.arrival_gap_s:
                    await asyncio.sleep(turn.arrival_gap_s / cfg.speedup)
                history.extend(turn.user_tokens)
                wire = PreprocessedRequest(
                    token_ids=list(history),
                    stop=StopConditions(max_tokens=turn.osl, ignore_eos=True),
                    eos_token_ids=[],
                ).to_wire()
                t0 = time.monotonic()
                stream = await dispatcher.generate(Context(wire))
                ttft = None
                n_tokens = 0
                async for item in stream:
                    ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
                    if ann.data is None:
                        continue
                    if ann.data.token_ids:
                        if ttft is None:
                            ttft = time.monotonic() - t0
                            (first_ttfts if i == 0 else follow_ttfts).append(ttft)
                        # chat clients echo history: the next turn's prompt
                        # embeds the ACTUAL assistant tokens so the cached
                        # blocks match exactly
                        history.extend(ann.data.token_ids)
                        n_tokens += len(ann.data.token_ids)
                streamed[0] += n_tokens
                streamed[1] += n_tokens < turn.osl

        await asyncio.gather(*[one_session(s) for s in sessions])
        wall = time.monotonic() - t_start

        all_ttfts = first_ttfts + follow_ttfts
        # both engine kinds expose the same allocator counter (the mocker
        # reuses the REAL BlockAllocator)
        prefix_hits = sum(h[0].allocator.prefix_hits_total for h in handles)
        ms = lambda x: None if x is None else round(x * 1000, 2)  # noqa: E731
        return {
            "policy": policy,
            "engine": cfg.engine,
            "num_workers": cfg.num_workers,
            "num_sessions": len(sessions),
            "num_turns": len(all_ttfts),
            "wall_s": round(wall, 3),
            # simulation-compressed milliseconds; ratios are scale-free
            "ttft_p50_ms": ms(_pctile(all_ttfts, 0.5)),
            "ttft_p99_ms": ms(_pctile(all_ttfts, 0.99)),
            "ttft_mean_ms": ms(sum(all_ttfts) / len(all_ttfts)),
            "followup_ttft_p50_ms": ms(_pctile(follow_ttfts, 0.5)),
            "followup_ttft_p99_ms": ms(_pctile(follow_ttfts, 0.99)),
            "prefix_hits_total": prefix_hits,
            # beside the reference's keys: every turn must stream its osl
            "tokens_streamed_total": streamed[0],
            "turns_short": streamed[1],
        }
    finally:
        if kv_router is not None:
            await kv_router.stop()
        if push is not None:
            # the dispatch client's instance watch (the reference leaves it
            # running past the runtime's close)
            await push.client.close()
        await _teardown_fleet(handles)
        await rt.close()


async def compare_policies(
    session_cfg: SessionConfig | None = None,
    fleet_cfg: FleetConfig | None = None,
) -> dict:
    """The artifact: same sessions, both policies, headline speedup ratios."""
    session_cfg = session_cfg or SessionConfig()
    fleet_cfg = fleet_cfg or FleetConfig()
    sessions = generate_sessions(session_cfg)
    random_result = await run_fleet("random", sessions, fleet_cfg)
    kv_result = await run_fleet("kv", sessions, fleet_cfg)
    ratio = lambda k: round(random_result[k] / kv_result[k], 2)  # noqa: E731
    out = {
        "workload": {
            "num_sessions": session_cfg.num_sessions,
            "turns_per_session": session_cfg.turns_per_session,
            "system_tokens": session_cfg.system_tokens,
            "user_tokens_per_turn": session_cfg.user_tokens_per_turn,
            "osl": session_cfg.osl,
        },
        "random": random_result,
        "kv": kv_result,
        "ttft_p50_speedup": ratio("ttft_p50_ms"),
        "ttft_p99_speedup": ratio("ttft_p99_ms"),
        "ttft_mean_speedup": ratio("ttft_mean_ms"),
        "followup_ttft_p50_speedup": ratio("followup_ttft_p50_ms"),
    }
    logger.info(
        "kv-routing TTFT speedup: p50 %.2fx p99 %.2fx follow-up-p50 %.2fx",
        out["ttft_p50_speedup"], out["ttft_p99_speedup"],
        out["followup_ttft_p50_speedup"],
    )
    return out


# ---------------------------------------------------------------------------
# Parked-session mode: predictive prefetch vs demand paging vs warm cache
# ---------------------------------------------------------------------------

PARKED_MODES = ("demand", "prefetch", "warm")


def parked_blocks_per_session(session_cfg: SessionConfig, block_size: int) -> int:
    """KV blocks one two-turn session holds after its returning turn —
    sizes the host tier and validates that the workload overflows HBM."""
    tokens = session_cfg.system_tokens + 2 * (
        session_cfg.user_tokens_per_turn + session_cfg.osl
    )
    return tokens // block_size + 2


async def run_parked(
    mode: str,
    sessions: list[Session],
    fleet_cfg: FleetConfig,
    *,
    hint_lead_s: float = 0.4,
    wave: int = 4,
) -> dict:
    """Park ``sessions`` (turn 1 runs, then the session goes idle and its KV
    pages out under HBM pressure), then bring every session back for turn 2
    and measure the RETURNING turn's TTFT.

    - ``demand``:   DYN_PREFETCH=0 semantics — the page-in runs inside
      admission, on the returning request's critical path.
    - ``prefetch``: an arrival hint fires ``hint_lead_s`` before the
      request (the frontend's admission-time hint), the router's forwarder
      targets the worker holding the prefix, and its pager pre-restores the
      blocks — the same page-in, off the critical path.
    - ``warm``:     reference ceiling — HBM sized to hold every session, so
      the returning turn is a pure device prefix hit (caller passes a big
      ``num_blocks``).

    Requires ``engine='torch'`` (the mocker has no KV content to offload)."""
    assert mode in PARKED_MODES, mode
    if fleet_cfg.engine != "torch":
        raise ValueError("parked-session mode needs engine='torch' (real KV)")
    from dynamo_tpu_torch.llm.kv_router.hashing import compute_block_hashes
    from dynamo_tpu_torch.prefetch.hints import PREFETCH_HINT_SUBJECT, PrefetchHint
    from dynamo_tpu_torch.prefetch.worker import PrefetchListener

    MemoryControlPlane.reset_named()
    rt = await DistributedRuntime.create(
        RuntimeConfig(control_plane=f"memory://park-{mode}")
    )
    kv_router = push = None
    handles = []
    listeners: list[PrefetchListener] = []
    try:
        comp, ep, handles = await _serve_fleet(rt, fleet_cfg)
        push = await PushRouter.from_endpoint(ep, mode=RouterMode.RANDOM)
        # KV-affine dispatch in every mode: the returning turn must land on
        # the worker holding the parked prefix for ANY policy to page it in
        kv_router = KvRouter(
            comp, block_size=fleet_cfg.block_size,
            enable_prefetch=(mode == "prefetch"),
        )
        await kv_router.start()
        dispatcher = KvPushRouter(push, kv_router)
        await push.client.wait_for_instances(fleet_cfg.num_workers, timeout=10)
        for engine, service, *_ in handles:
            if mode == "prefetch":
                assert engine.prefetch_pager is not None, (
                    "prefetch mode needs engines with prefetch enabled"
                )
                listener = PrefetchListener(
                    comp, engine, service.instance.instance_id
                )
                listener.start()
                listeners.append(listener)
            else:
                assert engine.prefetch_pager is None, (
                    f"{mode} mode must run fully demand-driven"
                )
            await engine.warmup()

        async def one_turn(history: list[int], osl: int) -> float:
            """Send one request; returns TTFT and extends history with the
            ACTUAL streamed tokens (chat clients echo history)."""
            wire = PreprocessedRequest(
                token_ids=list(history),
                stop=StopConditions(max_tokens=osl, ignore_eos=True),
                eos_token_ids=[],
            ).to_wire()
            t0 = time.monotonic()
            stream = await dispatcher.generate(Context(wire))
            ttft = None
            async for item in stream:
                ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
                if ann.data is None:
                    continue
                if ann.data.token_ids:
                    if ttft is None:
                        ttft = time.monotonic() - t0
                    history.extend(ann.data.token_ids)
            assert ttft is not None
            return ttft

        # -- park: turn 1 for every session, bounded concurrency so later
        # sessions steadily evict earlier ones' blocks to the offload tier
        histories: dict[int, list[int]] = {}
        park_sem = asyncio.Semaphore(wave)

        async def park_one(sess: Session) -> None:
            history = list(sess.system_tokens) + list(sess.turns[0].user_tokens)
            async with park_sem:
                await one_turn(history, sess.turns[0].osl)
            histories[sess.session_id] = history

        await asyncio.gather(*[park_one(s) for s in sessions])
        # let in-flight evictions offload before the fleet goes idle
        await asyncio.sleep(0.2)

        # -- return: turn 2 in waves, oldest (most-evicted) sessions first
        hint_subject = comp.event_subject(PREFETCH_HINT_SUBJECT)
        return_ttfts: list[float] = []

        async def return_one(sess: Session) -> None:
            history = histories[sess.session_id]
            history.extend(sess.turns[1].user_tokens)
            return_ttfts.append(await one_turn(history, sess.turns[1].osl))

        ordered = sorted(sessions, key=lambda s: s.session_id)
        for start in range(0, len(ordered), wave):
            group = ordered[start : start + wave]
            if mode == "prefetch":
                # the admission-time arrival hint, hint_lead_s of paging
                # window ahead of dispatch (frontend → forwarder → worker)
                for sess in group:
                    await rt.plane.bus.publish(
                        hint_subject,
                        PrefetchHint(
                            block_hashes=compute_block_hashes(
                                histories[sess.session_id],
                                fleet_cfg.block_size,
                            )
                        ).to_json(),
                    )
                await asyncio.sleep(hint_lead_s)
            await asyncio.gather(*[return_one(s) for s in group])

        stat_sum = lambda key: sum(  # noqa: E731
            h[0].stats().get(key, 0) for h in handles
        )
        ms = lambda x: None if x is None else round(x * 1000, 2)  # noqa: E731
        return {
            "mode": mode,
            "num_workers": fleet_cfg.num_workers,
            "num_sessions": len(sessions),
            "hbm_blocks_per_worker": fleet_cfg.num_blocks,
            "host_blocks_per_worker": fleet_cfg.host_offload_blocks,
            "emulated_page_delay_ms_per_block": fleet_cfg.page_delay_ms,
            "returning_ttft_p50_ms": ms(_pctile(return_ttfts, 0.5)),
            "returning_ttft_p99_ms": ms(_pctile(return_ttfts, 0.99)),
            "returning_ttft_mean_ms": ms(
                sum(return_ttfts) / len(return_ttfts)
            ),
            "prefix_hits_total": stat_sum("prefix_hits_total"),
            "host_restores_total": stat_sum("host_restores_total"),
            "preemptions_total": stat_sum("num_preemptions_total"),
            "prefetch_hits_total": stat_sum("prefetch_hits_total"),
            "prefetch_misses_total": stat_sum("prefetch_misses_total"),
            "prefetch_blocks_restored_total": stat_sum(
                "prefetch_blocks_restored_total"
            ),
            "prefetch_hidden_seconds_total": round(
                stat_sum("prefetch_hidden_seconds_total"), 4
            ),
        }
    finally:
        for listener in listeners:
            await listener.stop()
        if kv_router is not None:
            await kv_router.stop()
        if push is not None:
            # the dispatch client's instance watch (the reference leaves it
            # running past the runtime's close)
            await push.client.close()
        await _teardown_fleet(handles)
        await rt.close()


async def compare_parked(
    session_cfg: SessionConfig,
    fleet_cfg: FleetConfig,
    *,
    hint_lead_s: float = 0.4,
    wave: int = 4,
) -> dict:
    """The PREFETCH_BENCH artifact: same parked sessions replayed under
    demand paging, predictive prefetch, and a warm-cache ceiling."""
    sessions = generate_sessions(session_cfg)
    parked_blocks = len(sessions) * parked_blocks_per_session(
        session_cfg, fleet_cfg.block_size
    )
    if parked_blocks <= fleet_cfg.num_blocks * fleet_cfg.num_workers:
        raise ValueError(
            f"workload must overflow HBM: {parked_blocks} session blocks vs "
            f"{fleet_cfg.num_blocks * fleet_cfg.num_workers} fleet HBM blocks"
        )
    results = {}
    for mode in PARKED_MODES:
        cfg = replace(
            fleet_cfg,
            prefetch=(mode == "prefetch"),
            # warm ceiling: HBM holds the whole workload, nothing pages
            **(
                dict(
                    num_blocks=parked_blocks + 32 * fleet_cfg.max_batch_size,
                    host_offload_blocks=0,
                    page_delay_ms=0.0,
                )
                if mode == "warm"
                else {}
            ),
        )
        results[mode] = await run_parked(
            mode, sessions, cfg, hint_lead_s=hint_lead_s, wave=wave
        )
    ratio = lambda a, b, k: (  # noqa: E731
        None if not results[b][k] else round(results[a][k] / results[b][k], 2)
    )
    out = {
        "workload": {
            "num_sessions": session_cfg.num_sessions,
            "system_tokens": session_cfg.system_tokens,
            "user_tokens_per_turn": session_cfg.user_tokens_per_turn,
            "osl": session_cfg.osl,
            "parked_blocks": parked_blocks,
            "fleet_hbm_blocks": fleet_cfg.num_blocks * fleet_cfg.num_workers,
            "hint_lead_s": hint_lead_s,
        },
        **results,
        # the headline: how much returning-turn latency prefetch removes
        # vs demand paging, and how close it gets to the warm ceiling
        "demand_over_prefetch_ttft_p50": ratio(
            "demand", "prefetch", "returning_ttft_p50_ms"
        ),
        "demand_over_prefetch_ttft_mean": ratio(
            "demand", "prefetch", "returning_ttft_mean_ms"
        ),
        "prefetch_over_warm_ttft_p50": ratio(
            "prefetch", "warm", "returning_ttft_p50_ms"
        ),
    }
    logger.info(
        "parked-session returning-turn TTFT: demand/prefetch p50 %sx, "
        "prefetch/warm p50 %sx",
        out["demand_over_prefetch_ttft_p50"],
        out["prefetch_over_warm_ttft_p50"],
    )
    return out


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default=None,
                        help="also write the result here (default: stdout only)")
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument(
        "--sessions", "--num-sessions", dest="num_sessions", type=int,
        default=32,
    )
    parser.add_argument("--turns", type=int, default=4)
    parser.add_argument(
        "--engine", default="mocker", choices=["mocker", "torch"],
        help="mocker = cost-model sim (reference-style); torch = real engines"
    )
    parser.add_argument(
        "--device", default=None,
        help="torch mode: the workers' device (default: the CUDA card; "
        "'cpu' runs the tiny geometry on the CPU)",
    )
    parser.add_argument(
        "--park", action="store_true",
        help="parked-session prefetch bench: sessions >> HBM capacity, "
        "returning-turn TTFT under demand paging vs predictive prefetch vs "
        "a warm-cache ceiling (forces --engine torch, 2 turns)",
    )
    parser.add_argument(
        "--hbm-blocks", type=int, default=96,
        help="park mode: per-worker device blocks (the capacity sessions "
        "must overflow)",
    )
    parser.add_argument(
        "--page-delay-ms", type=float, default=2.0,
        help="park mode: emulated per-block tier read latency (0 = raw "
        "host-DRAM speed)",
    )
    parser.add_argument("--hint-lead", type=float, default=0.4)
    args = parser.parse_args(argv)
    if args.park:
        args.engine = "torch"
    session_cfg = replace(
        SessionConfig(), num_sessions=args.num_sessions,
        turns_per_session=2 if args.park else args.turns,
        # real engines prefill the real history: keep the workload inside
        # the tiny geometry's vocabulary and context (mocker scales are
        # unaffected)
        **(
            dict(system_tokens=160, user_tokens_per_turn=32, osl=8,
                 vocab_size=480)
            if args.park
            else dict(system_tokens=256, user_tokens_per_turn=48, osl=16,
                      vocab_size=480)
            if args.engine == "torch" else {}
        ),
    )
    # torch mode: real-time arrivals (FleetConfig enforces it) and a context
    # window sized to the longest session history so any --turns fits
    extra = {}
    if args.engine == "torch":
        turns = 2 if args.park else args.turns
        longest = (
            session_cfg.system_tokens
            + turns * (session_cfg.user_tokens_per_turn + session_cfg.osl)
            + 32
        )
        extra = {
            "speedup": 1.0,
            "max_model_len": (longest + 127) // 128 * 128,
            "device": args.device,
        }
    fleet_cfg = FleetConfig(
        num_workers=args.num_workers, engine=args.engine, **extra,
    )
    if args.park:
        blocks_per_session = parked_blocks_per_session(
            session_cfg, fleet_cfg.block_size
        )
        fleet_cfg = replace(
            fleet_cfg,
            num_blocks=args.hbm_blocks,
            # the host tier parks the whole fleet's overflow
            host_offload_blocks=args.num_sessions * blocks_per_session + 64,
            page_delay_ms=args.page_delay_ms,
        )
        result = asyncio.run(
            compare_parked(session_cfg, fleet_cfg, hint_lead_s=args.hint_lead)
        )
    else:
        result = asyncio.run(compare_policies(session_cfg, fleet_cfg))
    if args.engine == "torch":
        # stamp where the real engines actually ran
        import torch

        from dynamo_tpu_torch.device import resolve_device

        dev = resolve_device(args.device)
        result["platform"] = dev.type
        result["device_kind"] = (
            torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
