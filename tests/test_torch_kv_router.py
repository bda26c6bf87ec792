"""The port's KV router against the reference's: the radix indexer and the
scheduler on the same event streams, the engine's KV events against
``JaxLlmEngine``'s, the event plumbing over the bus, and the cost model.

The port's indexer runs its default tree (the native radix index where
``g++`` builds it), the reference's its pure-Python tree
(``KvIndexer(native=False)``).  Event
streams are drawn from a seed: stored chains (from the root and continued
from a parent), removals, clears and worker deaths; the overlap scores must
be equal after every event.
"""

import asyncio
import dataclasses
import random
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.llm import kv_router as ref_router
from dynamo_tpu.llm.kv_router import protocols as ref_protocols
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm import kv_router
from dynamo_tpu_torch.llm.kv_router import protocols
from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.runtime.engine import Context

BS = 4
WORKERS = [11, 22, 33, 44]


# ---------------------------------------------------------------------------
# indexer and scheduler on the same event streams
# ---------------------------------------------------------------------------


def draw_stream(seed: int, n_events: int = 120):
    """(events as plain tuples, query chains) from a seed: a few shared
    prefixes, each extended per request, so chains share and fork."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 500, size=int(rng.integers(4, 20))).tolist() for _ in range(4)]
    chains = []
    for _ in range(12):
        base = prefixes[int(rng.integers(len(prefixes)))]
        tail = rng.integers(0, 500, size=int(rng.integers(0, 16))).tolist()
        chains.append(kv_router.compute_block_hashes(base + tail, BS))
    chains = [c for c in chains if c]
    held: dict[int, list[int]] = {w: [] for w in WORKERS}
    events = []
    for _ in range(n_events):
        worker = WORKERS[int(rng.integers(len(WORKERS)))]
        roll = rng.random()
        if roll < 0.6:
            chain = chains[int(rng.integers(len(chains)))]
            start = int(rng.integers(len(chain)))
            parent = chain[start - 1] if start else None
            events.append(("stored", worker, chain[start:], parent))
            held[worker].extend(chain[start:])
        elif roll < 0.85 and held[worker]:
            k = int(rng.integers(1, min(4, len(held[worker])) + 1))
            picks = rng.choice(len(held[worker]), size=k, replace=False)
            events.append(("removed", worker, [held[worker][int(i)] for i in picks], None))
        elif roll < 0.93:
            events.append(("cleared", worker, [], None))
            held[worker] = []
        else:
            events.append(("dead", worker, [], None))
            held[worker] = []
    return events, chains


def apply(indexer, proto, event) -> None:
    kind, worker, hashes, parent = event
    if kind == "dead":
        indexer.remove_worker(worker)
        return
    indexer.tree.apply(proto.RouterEvent(
        worker_id=worker,
        event=proto.KvCacheEvent(kind=kind, block_hashes=list(hashes), parent_hash=parent),
    ))


@pytest.mark.parametrize("seed", range(6))
def test_indexer_scores_equal_the_reference_after_every_event(seed):
    events, chains = draw_stream(seed)
    ours, ref = kv_router.KvIndexer(), ref_router.KvIndexer(native=False)
    for i, event in enumerate(events):
        apply(ours, protocols, event)
        apply(ref, ref_protocols, event)
        for chain in chains:
            a, b = ours.find_matches(chain), ref.find_matches(chain)
            assert (a.scores, a.total_blocks) == (b.scores, b.total_blocks), (i, event)
        assert ours.tree.size() == ref.tree.size()
        assert [ours.tree.worker_block_count(w) for w in WORKERS] == \
            [ref.tree.worker_block_count(w) for w in WORKERS]


def test_hashes_and_wire_frames_equal_the_reference():
    tokens = list(range(7, 40))
    assert kv_router.compute_block_hashes(tokens, BS) == ref_router.compute_block_hashes(tokens, BS)
    event = protocols.RouterEvent(worker_id=5, event=protocols.KvCacheEvent(
        kind="stored", block_hashes=[1, 2], parent_hash=9, token_count=8))
    back = ref_protocols.RouterEvent.from_json(event.to_json())
    assert (back.worker_id, back.event.block_hashes, back.event.parent_hash,
            back.event.token_count) == (5, [1, 2], 9, 8)
    metrics = protocols.ForwardPassMetrics(worker_id=3, gpu_cache_usage_perc=0.25,
                                           num_requests_waiting=2, request_total_slots=8)
    assert ref_protocols.ForwardPassMetrics.from_json(metrics.to_json()) == \
        ref_protocols.ForwardPassMetrics(worker_id=3, gpu_cache_usage_perc=0.25,
                                         num_requests_waiting=2, request_total_slots=8)


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_picks_the_reference_worker(seed):
    """The same scores, load metrics and seeded tie-break give the same
    choices, ties included."""
    rng = np.random.default_rng(100 + seed)
    ours = kv_router.KvScheduler(rng=random.Random(seed))
    ref = ref_router.KvScheduler(rng=random.Random(seed))
    picks = []
    for step in range(80):
        if step % 10 == 0:
            for w in WORKERS:
                fields = dict(worker_id=w,
                              gpu_cache_usage_perc=float(rng.choice([0.0, 0.25, 0.5])),
                              num_requests_waiting=int(rng.integers(0, 3)),
                              request_total_slots=8)
                ours.update_metrics(protocols.ForwardPassMetrics(**fields))
                ref.update_metrics(ref_protocols.ForwardPassMetrics(**fields))
        total = int(rng.integers(1, 9))
        scores = {w: int(rng.integers(0, total + 1)) for w in WORKERS if rng.random() < 0.6}
        live = [w for w in WORKERS if rng.random() < 0.9] or WORKERS[:1]
        a = ours.select_worker(live, protocols.OverlapScores(scores=scores, total_blocks=total),
                               total)
        b = ref.select_worker(live, ref_protocols.OverlapScores(scores=scores,
                                                                total_blocks=total), total)
        assert a == b, step
        picks.append(a[0])
    assert len(set(picks)) > 1  # the stream exercised more than one winner


def test_transfer_cost_model_equals_the_reference():
    ours, ref = kv_router.TransferCostModel(), ref_router.TransferCostModel()
    for model, proto in ((ours, protocols), (ref, ref_protocols)):
        model.update_from_metrics(proto.ForwardPassMetrics(worker_id=1, transfer_hop="ici"))
        model.update_from_metrics(proto.ForwardPassMetrics(
            worker_id=2, transfer_hop="dcn", kv_transfer_bandwidth_bps=1e9))
    assert ours.known() == ref.known()
    assert ours.costs([1, 2, 3], {1: 4, 2: 4, 3: 4}) == ref.costs([1, 2, 3], {1: 4, 2: 4, 3: 4})


def test_refused_subsystems_are_named(monkeypatch):
    """Nothing of the router is refused any more: ``KvIndexer(native=True)``
    serves the native radix index (its scores equal the reference's native
    tree's), and the prefetch forwarder is served: ``enable_prefetch=True``
    builds one over the router's own index, ``False`` none, and ``None``
    reads ``DYN_PREFETCH`` as the reference's router does."""
    from dynamo_tpu.native.radix import NativeRadixTree as RefNativeRadixTree
    from dynamo_tpu_torch.native.radix import NativeRadixTree

    ours, ref = kv_router.KvIndexer(native=True), ref_router.KvIndexer(native=True)
    assert isinstance(ours.tree, NativeRadixTree) and isinstance(ref.tree, RefNativeRadixTree)
    events, chains = draw_stream(0)
    for event in events:
        apply(ours, protocols, event)
        apply(ref, ref_protocols, event)
    for chain in chains:
        a, b = ours.find_matches(chain), ref.find_matches(chain)
        assert (a.scores, a.total_blocks) == (b.scores, b.total_blocks)
    from dynamo_tpu_torch.prefetch.forwarder import PrefetchForwarder

    router = kv_router.KvRouter(component=None, enable_prefetch=True)
    assert isinstance(router.prefetch_forwarder, PrefetchForwarder)
    assert router.prefetch_forwarder.indexer is router.indexer
    assert kv_router.KvRouter(component=None, enable_prefetch=False).prefetch_forwarder is None
    for gate, want in (("0", False), ("1", True)):
        monkeypatch.setenv("DYN_PREFETCH", gate)
        ours = kv_router.KvRouter(component=None).prefetch_forwarder is not None
        ref = ref_router.KvRouter(component=None).prefetch_forwarder is not None
        assert ours == ref == want


# ---------------------------------------------------------------------------
# the engine's KV events against JaxLlmEngine's
# ---------------------------------------------------------------------------

MODEL_DIR = Path(__file__).parent / "data" / "tiny-chat-model"
CFG = dataclasses.replace(
    llama.LlamaConfig.from_hf_config(MODEL_DIR / "config.json"), dtype=torch.float32
)
JCFG = dataclasses.replace(
    jax_llama.LlamaConfig.from_hf_config(MODEL_DIR / "config.json"), dtype=jnp.float32
)
PARAMS = llama.load_hf_weights(CFG, MODEL_DIR, device="cpu")
JPARAMS = jax_llama.load_hf_weights(JCFG, MODEL_DIR)
BASE = dict(num_blocks=64, block_size=BS, max_batch_size=4, prefill_buckets=(16, 32, 64),
            max_model_len=128)


def request(tokens, max_tokens=8) -> dict:
    return PreprocessedRequest(
        token_ids=list(tokens),
        sampling=SamplingOptions(use_greedy=True),
        stop=StopConditions(max_tokens=max_tokens, ignore_eos=True),
        eos_token_ids=[1],
    ).to_wire()


async def collect(engine, req_wire, context_cls):
    stream = await engine.generate(context_cls(req_wire))
    tokens = []
    async for item in stream:
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is not None:
            tokens.extend(ann.data.token_ids)
    return tokens


class EventLog:
    """An engine's event sink: each event with, for a stored event, the
    cache rows of the blocks it names as they stand when it is emitted
    (read on the engine's thread, inside the allocator's call)."""

    def __init__(self, engine, to_numpy):
        self.engine, self.to_numpy = engine, to_numpy
        self.events, self.rows = [], []
        self.thread = None

    def __call__(self, event) -> None:
        self.thread = threading.current_thread()
        self.events.append((event.kind, list(event.block_hashes), event.parent_hash,
                            event.token_count))
        if event.kind != "stored":
            self.rows.append(None)
            return
        ids = [self.engine.allocator._hash_to_block.get(h) for h in event.block_hashes]
        self.rows.append({name: self.to_numpy(leaf)[:, [i for i in ids if i is not None]]
                          for name, leaf in self.engine.cache.items()})


async def drive(engine, ctx_cls, groups, clear_between: bool):
    """Each group's requests are submitted together and run to their end;
    the first group goes in before the engine starts, so its admission
    order is fixed.  ``clear_kv_blocks`` runs at the end (and between
    groups when asked)."""
    outs = []
    tasks = [asyncio.ensure_future(collect(engine, r, ctx_cls)) for r in groups[0]]
    await asyncio.sleep(0)
    engine.start()
    try:
        outs.append(await asyncio.gather(*tasks))
        for group in groups[1:]:
            if clear_between:
                await engine.clear_kv_blocks()
            outs.append(await asyncio.gather(*[collect(engine, r, ctx_cls) for r in group]))
        await engine.clear_kv_blocks()
    finally:
        engine.stop()
    return outs


SCENARIOS = {
    # a prompt, then one that extends it: the second hits the first's blocks
    "prefix_hit": (dict(), [[request(range(3, 23), 6)],
                            [request(list(range(3, 23)) + list(range(40, 47)), 5)]]),
    # three lanes in a ten-block pool: the newest is preempted, its cached
    # blocks evicted and re-stored
    "preemption": (dict(num_blocks=10, max_model_len=40, prefill_buckets=(16, 32)),
                   [[request(range(3 + i, 10 + i), 8) for i in range(3)]]),
    # a flush between two rounds of the same prompt: the second round
    # re-stores what the clear dropped
    "clear_between": (dict(), [[request(range(50, 70), 4)], [request(range(50, 70), 4)]]),
}


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
async def test_engine_kv_events_equal_the_jax_engine(scenario, overlap):
    overrides, groups = SCENARIOS[scenario]
    cfg = {**BASE, **overrides}
    jax_engine = JaxLlmEngine(
        JaxEngineConfig(model=JCFG, unified_batch=True, decode_overlap=overlap, **cfg),
        params=JPARAMS,
    )
    ours_engine = TorchLlmEngine(EngineConfig(model=CFG, decode_overlap=overlap, **cfg),
                                 params=PARAMS, device="cpu")
    ref_log = EventLog(jax_engine, np.asarray)
    our_log = EventLog(ours_engine, lambda t: t.numpy().copy())
    jax_engine._event_sink = ref_log
    ours_engine._event_sink = our_log
    clear_between = scenario == "clear_between"
    ref_out = await drive(jax_engine, JaxContext, groups, clear_between)
    our_out = await drive(ours_engine, Context, groups, clear_between)
    stats = ours_engine.stats()

    assert our_out == ref_out
    assert our_log.events == ref_log.events
    kinds = [e[0] for e in our_log.events]
    assert kinds[-1] == "cleared" and "stored" in kinds
    assert our_log.thread is not threading.main_thread()  # the engine's own thread
    if scenario == "prefix_hit":
        assert stats["prefix_hits_total"] == 1
    if scenario == "preemption":
        assert stats["num_preemptions_total"] > 0 and "removed" in kinds
    if scenario == "clear_between":
        assert kinds.count("cleared") == 2
        first_round = our_log.events[:kinds.index("cleared")]
        assert [e for e in our_log.events[kinds.index("cleared") + 1:-1]
                if e[0] == "stored"] == [e for e in first_round if e[0] == "stored"]
    # no stored event precedes its blocks' write: the rows each stored
    # event names hold, when it is emitted, what the reference's hold at
    # its own event (a block a decode step completes is published with
    # its newest token's row written by the next step, in both engines;
    # ROADMAP Queue 3 records it)
    for ours_rows, ref_rows in zip(our_log.rows, ref_log.rows):
        if ours_rows is None:
            continue
        for name in ours_rows:
            np.testing.assert_allclose(ours_rows[name], ref_rows[name], atol=2e-5, rtol=0)
    assert stats["kv_cached_blocks"] == 0


@pytest.mark.parametrize("overlap", [False, True])
async def test_decode_published_block_newest_row_fence(overlap):
    """Fence of the reference's order (ROADMAP Queue 3): a block that a
    decode step completes is published at once, and its newest token's row
    is written by the next step.  With decode overlap that step was already
    dispatched when the block publishes (every row written, on the CPU at
    once and on the card in stream order); without it the newest row is
    still empty.  Both engines alike, on a fresh pool."""

    def unwritten(log):
        return [[(b, slot) for b in range(rows["k"].shape[1])
                 for slot in range(rows["k"].shape[2]) if not np.any(rows["k"][:, b, slot])]
                for rows in log.rows if rows is not None]

    logs = []
    for engine, ctx_cls, to_numpy in (
        (JaxLlmEngine(JaxEngineConfig(model=JCFG, unified_batch=True, decode_overlap=overlap,
                                      **BASE), params=JPARAMS), JaxContext, np.asarray),
        (TorchLlmEngine(EngineConfig(model=CFG, decode_overlap=overlap, **BASE),
                        params=PARAMS, device="cpu"), Context, lambda t: t.numpy().copy()),
    ):
        log = EventLog(engine, to_numpy)
        engine._event_sink = log
        engine.start()
        try:
            await collect(engine, request(range(3, 13), 12), ctx_cls)
        finally:
            engine.stop()
        logs.append(log)
    ref, ours = (unwritten(log) for log in logs)
    assert ours == ref
    # the prompt's two blocks, then three a decode step completed
    assert ours == [[]] + [[] if overlap else [(0, BS - 1)]] * 3


async def test_clear_with_a_window_in_flight_frees_every_block():
    """``clear_kv_blocks`` while a lane decodes under overlap: the window
    in flight retires first, the lane keeps its blocks, and once it ends
    every block is free, none cached from before the clear."""
    engine = TorchLlmEngine(EngineConfig(model=CFG, decode_overlap=True, **BASE),
                            params=PARAMS, device="cpu")
    events = []
    engine._event_sink = events.append
    engine.start()
    try:
        await collect(engine, request(range(100, 120), 2), Context)
        stream = await engine.generate(Context(request(range(3, 20), 40)))
        got = []
        async for item in stream:
            ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
            if ann.data is None:
                continue
            got.extend(ann.data.token_ids)
            if len(got) == 5:
                await engine.clear_kv_blocks()
                mid = engine.stats()
        await engine.clear_kv_blocks()
        end = engine.stats()
    finally:
        engine.stop()
    assert len(got) == 40 and got[:5] == list(range(20, 25))
    assert mid["kv_cached_blocks"] == 0 and mid["kv_active_blocks"] > 0
    assert (end["kv_active_blocks"], end["kv_cached_blocks"]) == (0, 0)
    assert engine.allocator.free_blocks == BASE["num_blocks"]
    assert [e.kind for e in events].count("cleared") == 2


def test_engine_stats_carry_every_load_metric_the_publisher_reads():
    """Every key ``ForwardPassMetrics.from_stats`` reads that the
    reference's engine reports, the port's does too (both with a host tier
    and the prefetch pager, so its and the flight recorder's keys are
    read), but the subsystems later slices bring (disaggregation, disagg
    roles)."""
    class Recorder(dict):
        def __init__(self):
            super().__init__()
            self.read = set()

        def get(self, key, default=None):
            self.read.add(key)
            return default

    rec = Recorder()
    protocols.ForwardPassMetrics.from_stats(1, rec)
    tier = dict(host_offload_blocks=8, prefetch=True)
    ours = TorchLlmEngine(EngineConfig(model=CFG, **BASE, **tier), params=PARAMS,
                          device="cpu").stats()
    ref = JaxLlmEngine(JaxEngineConfig(model=JCFG, **BASE, **tier), params=JPARAMS).stats()
    later = {k for k in rec.read if k.startswith("disagg_")}
    later |= {"role", "transfer_hop", "kv_transfer_bandwidth_bps"}
    wanted = (rec.read & set(ref)) - later
    assert wanted and wanted <= set(ours), wanted - set(ours)
    assert {k for k in wanted if k.startswith(("prefetch_", "flight_"))}
    metrics = protocols.ForwardPassMetrics.from_stats(7, ours)
    assert (metrics.worker_id, metrics.kv_total_blocks, metrics.request_total_slots) == (
        7, BASE["num_blocks"], BASE["max_batch_size"])


# ---------------------------------------------------------------------------
# the event plumbing over the bus
# ---------------------------------------------------------------------------


async def test_publishers_feed_the_router_over_the_bus():
    """A worker's KvEventPublisher (its sink called from another thread, as
    the engine's device thread calls it) and WorkerMetricsPublisher reach a
    KvRouter on the same component; the router then picks the worker that
    holds the prefix."""
    from dynamo_tpu_torch.llm.kv_router.publisher import (
        KvEventPublisher,
        WorkerMetricsPublisher,
    )
    from dynamo_tpu_torch.engine.kv_manager import KvEvent
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    rt = await DistributedRuntime.create(RuntimeConfig(control_plane="memory://kv-router-bus"))
    try:
        comp = rt.namespace("ns").component("backend")
        router = kv_router.KvRouter(comp, block_size=BS)
        await router.start()
        pubs = [KvEventPublisher(comp, worker_id=w) for w in (1, 2)]
        metrics = WorkerMetricsPublisher(comp, 2, lambda: {"num_requests_waiting": 0,
                                                          "request_total_slots": 8},
                                         period_s=0.05)
        for p in pubs:
            p.start()
        metrics.start()
        tokens = list(range(10, 30))
        hashes = kv_router.compute_block_hashes(tokens, BS)
        thread = threading.Thread(target=pubs[1].sink, args=(KvEvent(
            kind="stored", block_hashes=hashes, token_count=len(hashes) * BS),))
        thread.start()
        thread.join()
        deadline = asyncio.get_running_loop().time() + 10
        while router.indexer.find_matches(hashes).scores.get(2) != len(hashes):
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.01)
        while 2 not in router.scheduler._metrics:
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.01)
        worker, matched = await router.schedule(tokens + [1, 2, 3], [1, 2])
        assert (worker, matched) == (2, len(hashes))
        pubs[1].sink(KvEvent(kind="cleared", block_hashes=[]))
        while router.indexer.tree.size():
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.01)
        for p in (*pubs, metrics):
            await p.stop()
        await router.stop()
    finally:
        await rt.close()
