"""The port's predictive prefetch (dynamo_tpu_torch.prefetch, the engine's
pager and the offload tier's pins) held against the JAX package, on the CPU.

- The pure modules (hints, session, pager, frontend, forwarder): the same
  inputs, drawn from a seed, through the port's copy and the reference's;
  wire messages cross between the two packages both ways.
- The engine: ``TorchLlmEngine(device="cpu", prefetch=True)`` against
  ``JaxLlmEngine(prefetch=True)`` on tiny-chat-model and ``tiny_mla``, the
  same G1/G2(/G3) sizes and the same hints, over the cases of
  tests/engine/test_prefetch_engine.py: the hinted hashes resident after
  the pager idles, the prefetch counts (not the wall-clock seconds) and the
  greedy and seeded streams equal on the two engines, and the streams equal
  to the port's own with ``prefetch=False``.
- The tier's hot-prefix pins on both tiers.
"""

import asyncio
import json
import random

import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.llm.kv_router.indexer import KvIndexer as JaxKvIndexer
from dynamo_tpu.llm.kv_router.protocols import KvCacheEvent as JaxKvCacheEvent
from dynamo_tpu.llm.kv_router.protocols import RouterEvent as JaxRouterEvent
from dynamo_tpu.prefetch import forwarder as jax_forwarder
from dynamo_tpu.prefetch import frontend as jax_frontend
from dynamo_tpu.prefetch import hints as jax_hints
from dynamo_tpu.prefetch import pager as jax_pager
from dynamo_tpu.prefetch import session as jax_session
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.engine.kv_manager import compute_block_hashes
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.llm.kv_router.protocols import KvCacheEvent, RouterEvent
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.prefetch import forwarder, frontend, hints, pager, session
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import collect, request
from tests.test_torch_offload import (
    GEOMETRY,
    PROMPT_A,
    _leaves,
    _torch_leaves,
    family_models,
    make_tiers,
)

# the two packages' modules, by name: a case run on each is parametrized
# over PKGS
PKGS = {
    "port": dict(hints=hints, pager=pager, session=session, frontend=frontend,
                 forwarder=forwarder),
    "ref": dict(hints=jax_hints, pager=jax_pager, session=jax_session,
                frontend=jax_frontend, forwarder=jax_forwarder),
}

# ---------------------------------------------------------------------------
# hints: the wire, both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dst", sorted(PKGS))
@pytest.mark.parametrize("src", sorted(PKGS))
def test_hint_wire_round_trips_both_ways(src, dst):
    rng = random.Random(3)
    a, b = PKGS[src]["hints"], PKGS[dst]["hints"]
    for source in (a.SOURCE_QUEUED, a.SOURCE_ARRIVAL, a.SOURCE_PREDICTED):
        hashes = [rng.getrandbits(64) for _ in range(rng.randint(1, 9))]
        hint = a.PrefetchHint(block_hashes=hashes, source=source, ts=rng.random())
        got = b.PrefetchHint.from_json(hint.to_json())
        assert (got.block_hashes, got.source, got.ts) == (hashes, source, hint.ts)
        worker = rng.getrandbits(63)
        targeted = b.TargetedPrefetchHint.from_json(
            a.TargetedPrefetchHint(worker_id=worker, hint=hint).to_json())
        assert targeted.worker_id == worker
        assert targeted.hint.block_hashes == hashes and targeted.hint.source == source
        assert a.TargetedPrefetchHint(worker, hint).to_json() == \
            b.TargetedPrefetchHint(worker, b.PrefetchHint(hashes, source, hint.ts)).to_json()
    assert (a.PREFETCH_HINT_SUBJECT, a.PREFETCH_TARGET_SUBJECT, a.SOURCE_PRIORITY) == \
        (b.PREFETCH_HINT_SUBJECT, b.PREFETCH_TARGET_SUBJECT, b.SOURCE_PRIORITY)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_hint_decoding_drops_unknown_keys(pkg):
    h = PKGS[pkg]["hints"]
    data = (b'{"worker_id": 5, "hint": {"block_hashes": [1], "source": '
            b'"arrival", "ts": 1.0, "lead_s": 2.0}}')
    t = h.TargetedPrefetchHint.from_json(data)
    assert (t.worker_id, t.hint.block_hashes) == (5, [1])
    assert h.PrefetchHint.from_json(b'{"block_hashes": [2], "new": 1}').block_hashes == [2]


@pytest.mark.parametrize("value", [None, "1", "0", "false", "off", "on", "bogus"])
def test_prefetch_gate_reads_the_same_knob(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("DYN_PREFETCH", raising=False)
    else:
        monkeypatch.setenv("DYN_PREFETCH", value)
    assert hints.prefetch_enabled() is jax_hints.prefetch_enabled()


# ---------------------------------------------------------------------------
# pager: the same random operations through both
# ---------------------------------------------------------------------------


class Clock:
    def __init__(self, now: float = 100.0):
        self.now = now

    def __call__(self) -> float:
        return self.now


def job_view(job):
    return None if job is None else (job.priority, job.hashes, job.enqueued)


@pytest.mark.parametrize("seed", range(4))
def test_pager_matches_reference_on_random_operations(seed):
    """Submits from every source (with overlapping hash sets: dedupe),
    pops (priority, FIFO, staleness under an injected clock), requeues
    with the original enqueue time, restores, hits, evictions and
    promotions: every return value and the stats after every operation
    equal."""
    rng = random.Random(seed)
    clocks = [Clock(), Clock()]
    budget = rng.randint(1, 64)
    pagers = [m.PrefetchPager(ttl_s=5.0, blocks_per_step=budget, clock=c)
              for m, c in zip((pager, jax_pager), clocks)]
    sources = ["queued", "arrival", "predicted", "elsewhere"]
    popped: list = []
    for _ in range(400):
        op = rng.choice(["submit", "submit", "pop", "requeue", "restored", "hit", "evict",
                         "onboard", "tick"])
        if op == "submit":
            args = ([rng.randrange(40) for _ in range(rng.randint(0, 6))],
                    rng.choice(sources))
            got = [p.submit(args[0], source=args[1]) for p in pagers]
        elif op == "pop":
            jobs = [p.next_job() for p in pagers]
            got = [job_view(j) for j in jobs]
            if jobs[0] is not None:
                popped.append(jobs[0])
        elif op == "requeue" and popped:
            job = popped.pop(rng.randrange(len(popped)))
            keep = job.hashes[: rng.randint(0, len(job.hashes))]
            got = [p.requeue(keep, enqueued=job.enqueued) for p in pagers]
        elif op == "restored":
            h, cost = rng.randrange(40), rng.random()
            got = [p.record_restored(h, cost) for p in pagers]
        elif op == "hit":
            h = rng.randrange(40)
            got = [p.on_block_hit(h) for p in pagers]
        elif op == "evict":
            h = rng.randrange(40)
            got = [p.on_block_evicted(h) for p in pagers]
        elif op == "onboard":
            n = rng.randint(0, 5)
            got = [p.record_onboarded(n) for p in pagers]
        else:
            dt = rng.random() * 3
            for c in clocks:
                c.now += dt
            got = [None, None]
        assert got[0] == got[1], op
        assert pagers[0].stats() == pagers[1].stats(), op
        assert pagers[0].has_work() == pagers[1].has_work()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_pager_priority_fifo_and_link_budget(pkg):
    m = PKGS[pkg]["pager"]
    p = m.PrefetchPager(clock=Clock(), blocks_per_step=64)
    assert p.submit([30], source="predicted")
    assert p.submit([10], source="queued")
    assert p.submit([20], source="arrival")
    assert p.submit([21], source="arrival")
    assert [p.next_job().hashes for _ in range(4)] == [[10], [20], [21], [30]]
    assert p.next_job() is None
    for hop, budget in (("", 64), ("local", 64), ("ici", 32), ("dcn", 16), ("??", 16)):
        p.set_link_hop(hop)
        assert p.effective_blocks_per_step() == budget


# ---------------------------------------------------------------------------
# session prediction with an injected clock
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_session_predictor_matches_reference(seed):
    """Interleaved multi-turn sessions (each turn's chain extends its
    last), unrelated chains and sessions that embed another's prefix, with
    an injected clock: every observe() verdict and every due() prediction
    equal, and the LRU bound evicts the same sessions."""
    rng = random.Random(seed)
    clocks = [Clock(1000.0), Clock(1000.0)]
    preds = [m.SessionPredictor(lead_s=1.0, alpha=0.5, max_sessions=6, clock=c)
             for m, c in zip((session, jax_session), clocks)]
    chains: list[list[int]] = []
    next_hash = iter(range(1, 10**6))
    for _ in range(300):
        op = rng.random()
        if op < 0.3 or not chains:
            base = list(rng.choice(chains)[: rng.randint(0, 3)]) if chains and rng.random() < 0.3 else []
            chains.append(base + [next(next_hash) for _ in range(rng.randint(1, 4))])
            hashes = chains[-1]
        elif op < 0.7:
            i = rng.randrange(len(chains))
            chains[i] = chains[i] + [next(next_hash) for _ in range(rng.randint(0, 3))]
            hashes = chains[i]
        else:
            dt = rng.random() * 4
            for c in clocks:
                c.now += dt
            due = [[(d.block_hashes, d.predicted_at) for d in p.due()] for p in preds]
            assert due[0] == due[1]
            continue
        assert preds[0].observe(list(hashes)) == preds[1].observe(list(hashes))
        assert (len(preds[0]), preds[0].turns_observed, preds[0].sessions_tracked) == \
            (len(preds[1]), preds[1].turns_observed, preds[1].sessions_tracked)
    assert preds[0].observe([]) is preds[1].observe([]) is False


# ---------------------------------------------------------------------------
# frontend hinter and forwarder targeting
# ---------------------------------------------------------------------------


def strip_ts(payload: bytes) -> dict:
    d = json.loads(payload)
    (d["hint"] if "hint" in d else d).pop("ts")
    return d


async def test_frontend_hinter_matches_reference():
    """The same requests (long, short, failing tokenizers, unknown models)
    through both hinters: the same hash chains published, the same
    emitted / skipped counts."""
    rng = random.Random(5)
    published: dict[str, list[bytes]] = {"port": [], "ref": []}
    hinters = {"port": frontend.FrontendHinter(), "ref": jax_frontend.FrontendHinter()}
    prompts = {i: [rng.randrange(500) for _ in range(rng.randint(0, 30))] for i in range(20)}

    def tokenize(req):
        if req % 7 == 6:
            raise RuntimeError("tokenizer broke")
        return prompts[req]

    for name, h in hinters.items():
        async def publish(payload: bytes, _name=name) -> None:
            published[_name].append(payload)

        h.register_model("m", tokenize, 4, publish)
        h.register_model("gone", tokenize, 4, publish)
        h.remove_model("gone")
        for req in prompts:
            h.on_request("m", req)
            h.on_request("gone", req)
    for _ in range(100):  # the publishes are background tasks
        if all(len(published[k]) == hinters[k].hints_emitted for k in hinters):
            break
        await asyncio.sleep(0.01)
    assert [strip_ts(p) for p in published["port"]] == [strip_ts(p) for p in published["ref"]]
    assert published["port"]
    assert (hinters["port"].hints_emitted, hinters["port"].hints_skipped) == \
        (hinters["ref"].hints_emitted, hinters["ref"].hints_skipped)
    want = [compute_block_hashes(p, 4) for i, p in prompts.items()
            if i % 7 != 6 and compute_block_hashes(p, 4)]
    assert [json.loads(p)["block_hashes"] for p in published["port"]] == want


class FakeBus:
    def __init__(self):
        self.sent: list[tuple[str, bytes]] = []

    async def publish(self, subject: str, payload: bytes) -> None:
        self.sent.append((subject, payload))


class FakeComponent:
    """What a forwarder reads of a component: its bus and event subjects."""

    def __init__(self):
        self.bus = FakeBus()
        self.runtime = type("Runtime", (), {"plane": type("Plane", (), {"bus": self.bus})})()

    def event_subject(self, name: str) -> str:
        return f"ns.backend.{name}"


@pytest.mark.parametrize("native", [False, True])
async def test_forwarder_targets_like_the_reference(native):
    """Two routers' indexes (the port's and the reference's, both on their
    Python trees or both on their native ones: the two trees list tied
    workers in different orders, and the forwarder's pick among ties
    follows that order in both packages) fed the same stored / removed
    events of three workers: the same hints (arrival, and the predictor's
    next-turn hints under an injected clock) reach the same worker,
    unroutable ones are dropped alike."""
    rng = random.Random(11)
    sides = []
    for fw_mod, index_cls, kv_event, router_event in (
        (forwarder, lambda: KvIndexer(native=native), KvCacheEvent, RouterEvent),
        (jax_forwarder, lambda: JaxKvIndexer(native=native), JaxKvCacheEvent, JaxRouterEvent),
    ):
        clock = Clock(50.0)
        comp = FakeComponent()
        predictor = PKGS["port" if fw_mod is forwarder else "ref"]["session"].SessionPredictor(
            clock=clock)
        sides.append((fw_mod.PrefetchForwarder(comp, index_cls(), predictor=predictor),
                      comp, clock, kv_event, router_event))
    chains = [compute_block_hashes([rng.randrange(400) for _ in range(40)], 4)
              for _ in range(8)]
    for _ in range(30):
        chain = rng.choice(chains)
        worker = rng.choice([101, 202, 303])
        kind = rng.choice(["stored", "stored", "removed"])
        n = rng.randint(1, len(chain))
        for fw, _comp, _clock, kv_event, router_event in sides:
            fw.indexer.tree.apply(router_event(
                worker_id=worker, event=kv_event(kind=kind, block_hashes=chain[:n])))
    hint_mods = (hints, jax_hints)
    for step in range(40):
        chain = rng.choice(chains + [compute_block_hashes(list(range(900, 940)), 4)])
        cut = chain[: rng.randint(1, len(chain))]
        for (fw, _comp, clock, *_), hm in zip(sides, hint_mods):
            fw.predictor.observe(cut)
            await fw._target(hm.PrefetchHint(block_hashes=cut))
            clock.now += 0.7
            for pred in fw.predictor.due():
                fw.predicted_total += 1
                await fw._target(hm.PrefetchHint(block_hashes=pred.block_hashes,
                                                 source=hm.SOURCE_PREDICTED))
    (fa, ca, *_), (fb, cb, *_) = sides
    assert [(s, strip_ts(p)) for s, p in ca.bus.sent] == [(s, strip_ts(p)) for s, p in cb.bus.sent]
    assert ca.bus.sent and fa.predicted_total
    assert (fa.forwarded_total, fa.unroutable_total, fa.predicted_total) == \
        (fb.forwarded_total, fb.unroutable_total, fb.predicted_total)


# ---------------------------------------------------------------------------
# the tier's hot-prefix pins, on both tiers
# ---------------------------------------------------------------------------


def test_hot_prefix_pins_hold_like_the_reference(tmp_path):
    """A hash restored ``pin_hits`` times is pinned host-resident: churn no
    longer cascades it to disk, the pin budget holds, an admin flush drops
    the pins; both tiers agree at every step."""
    tiers = make_tiers(n=2, tmp_path=tmp_path, disk_n=8)
    for tier in tiers:
        tier.pin_hits, tier.pin_max = 2, 1
    ours, ref = tiers
    steps = []
    for tier, leaves in ((ours, _torch_leaves), (ref, _leaves)):
        seen = []
        tier.put(1, leaves(1))
        for _ in range(2):
            assert tier.pin(1)
            tier.read_pinned(1)
        seen.append(tier.pin_hot())
        for i in range(2, 6):
            tier.put(i, leaves(i))
        seen.append((tier.pool.has_hash(1), tier.disk.has_hash(1), tier.locate(1), tier.locate(5)))
        tier._hot_pending.append(2)
        seen.append(tier.pin_hot())
        seen.append(dict(tier.stats()))
        seen.append(tier.tiers_snapshot())
        tier.clear()
        seen.append((tier.stats()["host_blocks_pinned"], tier.pool.has_hash(1)))
        steps.append(seen)
    assert steps[0] == steps[1]
    assert steps[0][0] == 1 and steps[0][1][:2] == (True, False)


def test_unpin_all_releases_blocks_like_the_reference(tmp_path):
    ours, ref = make_tiers(n=2, tmp_path=tmp_path, disk_n=4)
    out = []
    for tier, leaves in ((ours, _torch_leaves), (ref, _leaves)):
        tier.pin_hits = 1
        tier.put(1, leaves(1))
        assert tier.pin(1)
        tier.read_pinned(1)
        pinned = tier.pin_hot()
        tier.unpin_all()
        tier.put(2, leaves(2))
        tier.put(3, leaves(3))
        out.append((pinned, tier.stats()["host_blocks_pinned"], tier.disk.has_hash(1),
                    tier._hit_counts, tier._hot_pending))
    assert out[0] == out[1] == (1, 0, True, {}, [])


def test_promotion_to_host_matches_reference(tmp_path):
    """Blocks cascaded to disk come back up to the host tier through the
    block manager's onboard path, on both tiers alike."""
    ours, ref = make_tiers(n=2, tmp_path=tmp_path, disk_n=8)
    out = []
    for tier, leaves in ((ours, _torch_leaves), (ref, _leaves)):
        for i in range(1, 6):
            tier.put(i, leaves(i))
        where = [tier.locate(h) for h in range(1, 7)]
        moved = tier.promote_to_host([1, 2, 6])
        out.append((where, moved, [tier.locate(h) for h in range(1, 7)], tier.stats()))
    assert out[0] == out[1]
    assert out[0][1] == 2 and out[0][2][:2] == [0, 0]


# ---------------------------------------------------------------------------
# the engine's pager against JaxLlmEngine(prefetch=True)
# ---------------------------------------------------------------------------

BS = GEOMETRY["block_size"]
CHURN = [list(range(base, base + 16)) for base in (40, 60)]
SEEDED = SamplingOptions(temperature=0.8, top_k=20, seed=7)
# what must be equal on the two engines (wall-clock seconds are not)
COUNTS = ("prefetch_hints_total", "prefetch_hits_total", "prefetch_misses_total",
          "prefetch_stale_total", "prefetch_blocks_restored_total",
          "prefetch_blocks_onboarded_total", "prefetch_deferred_total", "host_blocks_pinned",
          "num_preemptions_total", "host_restores_total", "disk_restores_total",
          "prefix_hits_total", "prefix_cached_tokens_total")
TIER_KW = {"host": dict(host_offload_blocks=16),
           "disk": dict(host_offload_blocks=4, disk_offload_blocks=16)}


def build(kind: str, family: str, tmp_path, **kw):
    """(engine, context class): "ref" JaxLlmEngine(prefetch=True), "port"
    TorchLlmEngine(prefetch=True), "demand" TorchLlmEngine(prefetch=False),
    all three synchronous, and "overlap" the port's pager under its default
    overlapped decode (a finished request's lane is released a window late
    there, so a request that follows at once finds a backlog and self-hints:
    its streams are held, not its counts); ``prefetch`` in ``kw``
    overrides."""
    name, cfg, jcfg, params, jparams = family_models(family)
    kw = {**GEOMETRY, "model_family": name, "prefetch": kind != "demand",
          "decode_overlap": kind == "overlap", **kw}
    if "disk_offload_blocks" in kw:
        kw["disk_offload_path"] = str(tmp_path / f"g3.{kind}.blocks")
    if kind == "ref":
        # the reference synchronously, as tests/test_torch_offload.py runs it
        return JaxLlmEngine(JaxEngineConfig(model=jcfg, **kw), params=jparams), JaxContext
    return TorchLlmEngine(EngineConfig(model=cfg, **kw), params=params, device="cpu"), Context


async def wait_for(cond, what: str, timeout: float = 30.0) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not cond():
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


def pageable(engine, hashes) -> int:
    """Blocks the pager's walk would restore: the chain's blocks off the
    device up to the first one in no tier."""
    n = 0
    for h in hashes:
        if engine.allocator.is_registered(h):
            continue
        if not engine.host_tier.has(h):
            break
        n += 1
    return n


async def hint(engine, hashes) -> bool:
    """Hint ``hashes`` to an idle engine and wait until its pager has
    restored every pageable block and drained its queue."""
    if engine.prefetch_pager is None:
        return engine.prefetch_hint(hashes)
    restored = engine.stats()["prefetch_blocks_restored_total"]
    want = restored + pageable(engine, hashes)
    queued = engine.prefetch_hint(hashes)
    await wait_for(lambda: engine.stats()["prefetch_blocks_restored_total"] >= want
                   and engine.stats()["prefetch_queue_depth"] == 0, "the pager")
    return queued


def counts(engine) -> dict:
    stats = engine.stats()
    return {k: stats.get(k) for k in COUNTS}


async def run(engine, ctx, scenario):
    engine.start()
    try:
        return await scenario(engine, ctx)
    finally:
        engine.stop()


def go(engine, ctx, prompt, max_tokens=2, sampling=None):
    return collect(engine, request(prompt, max_tokens, sampling=sampling, ignore_eos=True), ctx)


async def scenario_hint(engine, ctx):
    """A, churn that evicts A's blocks to the tiers, the hint, a duplicate
    hint (every block resident: a free walk), then A greedy and seeded."""
    streams = [await go(engine, ctx, PROMPT_A)]
    for prompt in CHURN:
        streams.append(await go(engine, ctx, prompt))
    hashes = compute_block_hashes(PROMPT_A, BS)
    offloaded = pageable(engine, hashes)
    queued = [await hint(engine, hashes)]
    resident = [engine.allocator.is_registered(h) for h in hashes]
    restored = engine.stats().get("prefetch_blocks_restored_total")
    queued.append(await hint(engine, hashes))
    dup_free = engine.stats().get("prefetch_blocks_restored_total") == restored
    streams.append(await go(engine, ctx, PROMPT_A))
    streams.append(await go(engine, ctx, PROMPT_A, 6, SEEDED))
    return dict(streams=streams, resident=resident, offloaded=offloaded, queued=queued,
                dup_free=dup_free, counts=counts(engine))


@pytest.mark.parametrize(("family", "tier"),
                         [("llama", "host"), ("llama", "disk"), ("tiny_mla", "host")])
async def test_hint_pre_restores_evicted_blocks_and_credits_hits(family, tier, tmp_path):
    """The hint pages A's evicted blocks back before A returns (through G3
    into G2 first where G2 is small), A's prefix hit consumes them (hits),
    a duplicate hint restores nothing; equal on both engines, and the
    streams equal demand paging's."""
    out = {kind: await run(*build(kind, family, tmp_path, **TIER_KW[tier]), scenario_hint)
           for kind in ("ref", "port", "demand", "overlap")}
    ref, port, demand = out["ref"], out["port"], out["demand"]
    assert port["streams"] == ref["streams"] == demand["streams"] == out["overlap"]["streams"]
    assert port["streams"][-2] == port["streams"][0]
    for key in ("resident", "offloaded", "queued", "dup_free", "counts"):
        assert port[key] == ref[key], key
    assert port["offloaded"] > 0 and all(port["resident"]) and port["dup_free"]
    c = port["counts"]
    assert c["prefetch_hits_total"] >= 1 and c["prefetch_blocks_restored_total"] >= 1
    assert c["num_preemptions_total"] == 0
    if tier == "disk":
        assert c["prefetch_blocks_onboarded_total"] >= 1
    assert demand["queued"] == [False, False] and demand["counts"]["prefetch_hits_total"] is None


async def scenario_long(engine, ctx):
    engine.prefetch_pager.blocks_per_step = 1
    engine.prefetch_pager.idle_boost = 1
    await go(engine, ctx, PROMPT_A)
    for prompt in CHURN:
        await go(engine, ctx, prompt)
    hashes = compute_block_hashes(PROMPT_A, BS)
    offloaded = pageable(engine, hashes)
    await hint(engine, hashes)
    return dict(offloaded=offloaded, counts=counts(engine),
                resident=[engine.allocator.is_registered(h) for h in hashes])


async def test_long_prefix_finishes_across_budget_rounds(tmp_path):
    """One block a round and no idle boost: the chain's tail requeues
    (keeping its enqueue time) and every offloaded block still restores."""
    ref = await run(*build("ref", "llama", tmp_path, **TIER_KW["host"]), scenario_long)
    port = await run(*build("port", "llama", tmp_path, **TIER_KW["host"]), scenario_long)
    assert port == ref
    c = port["counts"]
    assert c["prefetch_blocks_restored_total"] == port["offloaded"] > 1
    assert c["prefetch_deferred_total"] >= port["offloaded"] - 1
    assert c["num_preemptions_total"] == 0


async def scenario_pins(engine, ctx):
    await go(engine, ctx, PROMPT_A)
    for prompt in CHURN:
        await go(engine, ctx, prompt)
    await hint(engine, compute_block_hashes(PROMPT_A, BS))
    await wait_for(lambda: engine.stats()["host_blocks_pinned"] > 0, "a pin")
    pinned = engine.stats()["host_blocks_pinned"]
    snapshot = engine.stats()["offload_tiers"]
    await engine.clear_kv_blocks()
    return dict(pinned=pinned, snapshot=snapshot, counts=counts(engine),
                after=engine.stats()["host_blocks_pinned"])


async def test_hot_prefix_pinning_and_unpin_all(tmp_path, monkeypatch):
    """With a pin threshold of one restore, the pager pins A's restored
    blocks host-resident (``pin_hot`` rides its loop) and an admin flush
    drops the pins (``unpin_all``); equal on both engines."""
    monkeypatch.setenv("DYN_PREFETCH_PIN_HITS", "1")
    ref = await run(*build("ref", "llama", tmp_path, **TIER_KW["host"]), scenario_pins)
    port = await run(*build("port", "llama", tmp_path, **TIER_KW["host"]), scenario_pins)
    assert port == ref
    assert port["pinned"] >= 1 and port["after"] == 0
    assert port["snapshot"]["g2"]["pinned"] == port["pinned"]


async def scenario_queued(engine, ctx):
    def idle():
        return not engine.scheduler.has_work()

    # each request is added to an idle engine (under the overlap a finished
    # lane is released a window late, and an add that finds it still held
    # would hint its own prompt too), so A's is the one queued hint
    streams = [await go(engine, ctx, PROMPT_A)]
    await wait_for(idle, "A released")
    streams.append(await go(engine, ctx, list(range(40, 68))))
    await wait_for(idle, "the churn released")
    # one lane: B decodes while A waits for admission, so A's add finds a
    # backlog and A hints its own offloaded prefix (source "queued")
    long_b = asyncio.ensure_future(go(engine, ctx, list(range(70, 78)), 24))
    # A is submitted only once the device thread has admitted B to the one
    # lane: A's add then finds the backlog whatever the thread's timing
    await wait_for(lambda: engine.scheduler.num_running >= 1, "B holding the lane")
    a = asyncio.ensure_future(go(engine, ctx, PROMPT_A))
    streams += [await long_b, await a]
    return dict(streams=streams, counts=counts(engine))


async def test_queued_sequence_self_hints_while_waiting(tmp_path):
    kw = dict(num_blocks=10, max_batch_size=1, max_model_len=40, prefill_buckets=(16, 32),
              host_offload_blocks=32, decode_steps=1)
    out = {kind: await run(*build(kind, "llama", tmp_path, **kw), scenario_queued)
           for kind in ("ref", "port", "demand", "overlap")}
    assert out["port"]["streams"] == out["ref"]["streams"] == out["demand"]["streams"] \
        == out["overlap"]["streams"]
    for kind in ("ref", "port", "overlap"):
        c = out[kind]["counts"]
        # where in B's decode the pager's round lands is the device loop's
        # timing: the hint and a hit are held, not their exact counts
        assert c["prefetch_hints_total"] >= 1 and c["prefetch_hits_total"] >= 1, (kind, c)
        assert c["num_preemptions_total"] == 0


async def scenario_storm(engine, ctx):
    parked = [list(range(3, 15)), list(range(40, 52))]
    streams = [await go(engine, ctx, p) for p in parked]
    streams.append(await go(engine, ctx, list(range(60, 76))))
    runner = asyncio.ensure_future(go(engine, ctx, list(range(80, 88)), 12))
    await asyncio.sleep(0)
    for p in parked:
        engine.prefetch_hint(compute_block_hashes(p, BS))
    streams.append(await runner)
    return dict(streams=streams, preempted=engine.stats()["num_preemptions_total"])


async def test_prefetch_never_preempts_a_running_sequence(tmp_path):
    """A storm of hints while a sequence decodes draws only free and cached
    capacity above the headroom: no preemption, and the same streams."""
    kw = dict(num_blocks=8, max_model_len=32, host_offload_blocks=32)
    out = {kind: await run(*build(kind, "llama", tmp_path, **kw), scenario_storm)
           for kind in ("ref", "port", "demand", "overlap")}
    assert out["port"]["streams"] == out["ref"]["streams"] == out["demand"]["streams"] \
        == out["overlap"]["streams"]
    assert out["port"]["preempted"] == out["ref"]["preempted"] == out["overlap"]["preempted"] == 0


async def scenario_plain(engine, ctx):
    streams = [await go(engine, ctx, PROMPT_A)]
    for prompt in CHURN:
        streams.append(await go(engine, ctx, prompt))
    streams.append(await go(engine, ctx, PROMPT_A))
    tier = engine.host_tier
    return dict(streams=streams, no_pager=engine.prefetch_pager is None,
                hint=engine.prefetch_hint([1, 2, 3]), pins=(tier._hot_pending, tier._hit_counts),
                restores=engine.stats()["host_restores_total"],
                keys=sorted(k for k in engine.stats() if k.startswith("prefetch_")))


async def test_gate_off_restores_demand_paging(tmp_path, monkeypatch):
    """``DYN_PREFETCH=0`` with ``prefetch=None``: no pager, an inert hint
    API, no pin bookkeeping, and demand restores, on both engines."""
    monkeypatch.setenv("DYN_PREFETCH", "0")
    out = [await run(*build(kind, "llama", tmp_path, prefetch=None, **TIER_KW["host"]),
                     scenario_plain) for kind in ("ref", "port")]
    assert out[0] == out[1]
    assert out[1]["no_pager"] and out[1]["hint"] is False and out[1]["pins"] == ([], {})
    assert out[1]["restores"] >= 1 and out[1]["keys"] == []


@pytest.mark.parametrize("family", ["llama", "tiny_mla"])
def test_no_offload_tier_means_no_pager(family, tmp_path):
    for kind in ("ref", "port"):
        engine, _ = build(kind, family, tmp_path)
        try:
            assert engine.host_tier is None and engine.prefetch_pager is None
            assert engine.prefetch_hint([1]) is False
        finally:
            engine.stop()
