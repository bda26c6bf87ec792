"""The unified (mixed prefill + decode) step at the reference's fixed
shapes, on the CPU in float32.

- TorchLlmEngine, every unified window driven the way a graph replay drives
  it (its inputs written into ``UnifiedGraph``'s persistent buffers in
  place, the step run from those buffers), against JaxLlmEngine byte for
  byte, with overlap on and off, for the llama family
  (tests/data/tiny-chat-model) and the DeepSeek MLA family (tiny_mla):
  prompts across several token buckets and two admissions a step against
  the step's one seed slot, so windows skip to the split step as
  ``seed_overflow`` exactly as often as the reference's do.
- The shape signature of every unified window, the counterpart of
  tests/engine/test_aot_precompile.py: over varied batch compositions each
  window's tensors carry exactly its token bucket's shapes (the worklist
  at the fixed width tb x max blocks, the work plan at the bucket's
  capacity), ``warmup()`` runs every reachable bucket, no window after it
  brings a new signature, and it leaves no cached block behind.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.models import deepseek as jax_ds
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.graphs import UnifiedGraph
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import deepseek
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.ops.kernels import ragged_attention
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import request
from tests.test_torch_llama import tree_to_numpy
from tests.test_torch_overlap import jax_engine, serve, torch_engine

SMS = 132  # an H100's streaming multiprocessors


def replay_probe(engine) -> dict:
    """Count the engine's unified windows that run from the graph's
    buffers, and check that each window's inputs sit at its bucket's
    persistent addresses (written in place, as a replay reads them)."""
    ug = engine._unified
    addrs = {b: {n: t.data_ptr() for n, t in ug.inputs.view(b).items()} for b in ug.buckets}
    seen = {"runs": 0, "buckets": set()}
    run = ug.run

    def probe(bucket, noise):
        assert {n: t.data_ptr() for n, t in ug.inputs.view(bucket).items()} == addrs[bucket]
        seen["runs"] += 1
        seen["buckets"].add(bucket)
        return run(bucket, noise)

    ug.run = probe
    return seen


def waves(vocab: int) -> list[list[dict]]:
    """Waves of requests, each queued whole before the engine starts (so
    both engines schedule the same steps): prompts of 5 to 100 tokens
    (buckets 16 to 128), a seeded sampled lane with penalties,
    single admissions (unified windows) and pairs (a step with two first
    windows: ``seed_overflow``)."""
    rng = np.random.default_rng(4)
    seeded = SamplingOptions(temperature=4.0, seed=9, frequency_penalty=0.7)

    def req(n, k, sampling=None):
        return request(rng.integers(3, vocab, n).tolist(), max_tokens=k, sampling=sampling,
                       ignore_eos=True)

    return [[req(27, 5)], [req(5, 6), req(40, 7, seeded)], [req(45, 5)],
            [req(100, 6), req(13, 5)], [req(61, 8), req(9, 6), req(13, 7)]]


async def serve_waves(engine, ctx_cls, batches) -> list:
    return [await serve(engine, ctx_cls, batch) for batch in batches]


def two_admissions(engine):
    """Two admissions a step, while the step's seed slots stay the one the
    engine sized from the scheduler's default cap."""
    engine.scheduler.max_prefills_per_step = 2
    return engine


@pytest.fixture(scope="module")
def mla_models():
    jcfg = jax_ds.DeepseekConfig.tiny_mla(vocab_size=481)
    cfg = deepseek.DeepseekConfig.tiny_mla(vocab_size=481)
    jparams = jax_ds.init_params(jcfg, jax.random.PRNGKey(3))
    return dict(jcfg=jcfg, jparams=jparams, cfg=cfg,
                params=params_from_jax(tree_to_numpy(jparams), device="cpu"))


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap_on", "overlap_off"])
@pytest.mark.parametrize("family", ["llama", "deepseek"])
async def test_replayed_unified_windows_match_reference(family, overlap, mla_models):
    ref_kw, ours_kw = {}, {}
    if family == "deepseek":
        ref_kw = dict(jcfg=mla_models["jcfg"], jparams=mla_models["jparams"],
                      model_family="deepseek_v2")
        ours_kw = dict(cfg=mla_models["cfg"], params=mla_models["params"],
                       model_family="deepseek_v2")
    ours_engine = two_admissions(torch_engine(decode_overlap=overlap, **ours_kw))
    batches = waves(ours_engine.config.model.vocab_size)
    ref_engine = two_admissions(jax_engine(overlap, **ref_kw))
    ref = await serve_waves(ref_engine, JaxContext, batches)
    seen = replay_probe(ours_engine)
    ours = await serve_waves(ours_engine, Context, batches)
    assert ours == ref
    stats, ref_stats = ours_engine.stats(), ref_engine.stats()
    # windows skipped for want of a seed slot, as many as the reference's
    overflow = stats["unified_fallbacks"].get("seed_overflow", 0)
    assert overflow > 0 and overflow == ref_stats["unified_fallbacks"].get("seed_overflow", 0)
    assert stats["decode_windows_unified_total"] == ref_stats["decode_windows_unified_total"]
    # every unified window ran from the graph's buffers, across buckets
    assert seen["runs"] == stats["decode_windows_unified_total"] > 0
    assert len(seen["buckets"]) >= 3


# ---------------------------------------------------------------------------
# shape signatures
# ---------------------------------------------------------------------------

def cpu_planner(monkeypatch):
    """Row 1's planner on the CPU too (the plain version reads no plan), so
    the engine packs every window's plan at its bucket's capacity."""
    from dynamo_tpu_torch.engine import engine as engine_mod

    def planner(cfg, *, block_size, tb_tokens, device, cache_dtype=None):
        rows = tb_tokens * (cfg.num_heads // cfg.num_kv_heads)
        return ragged_attention.ragged_planner(cfg.num_kv_heads, SMS, rows, cfg.head_dim)

    real = engine_mod.get_family
    monkeypatch.setattr(engine_mod, "get_family",
                        lambda name: dataclasses.replace(real(name), unified_planner=planner))


def record_signatures(engine) -> list:
    """Every unified forward's (token axis, worklist, plan buffer) shapes."""
    sigs = []
    forward = engine.family.forward_unified

    def spy(params, cfg, token_ids, cache, tables, ctx, pos, slot, lane, phys, plane, pord,
            pcount, rows, cos, sin, **kw):
        plan = kw.get("plan")
        sigs.append((tuple(token_ids.shape), tuple(pos.shape), tuple(slot.shape),
                     tuple(lane.shape), tuple(phys.shape), tuple(plane.shape),
                     tuple(pord.shape), tuple(pcount.shape), tuple(ctx.shape),
                     tuple(rows.shape), None if plan is None else tuple(plan.buffer.shape)))
        return forward(params, cfg, token_ids, cache, tables, ctx, pos, slot, lane, phys,
                       plane, pord, pcount, rows, cos, sin, **kw)

    engine.family = dataclasses.replace(engine.family, forward_unified=spy)
    return sigs


def bucket_signature(ug: UnifiedGraph, bucket: int) -> tuple:
    ntb, lanes = bucket // ug.tb, ug.lanes
    plan = (ug.caps[bucket].rows, 4) if ug.planner else None
    return ((bucket,),) * 4 + ((ntb, ug.page_slots),) * 3 + ((ntb,), (lanes,), (lanes,), plan)


@pytest.mark.parametrize("chunk,buckets,used", [
    (None, [16, 32, 64, 128], 3),
    # the chunk budget counts the decode lanes, so the mixed bucket is
    # warmed (as the reference warms it) but no window of these fills it
    (32, [16, 32, 40], 2),
], ids=["whole_prompts", "chunks_of_32"])
async def test_every_window_carries_its_bucket_shapes_and_warmup_covers_them(
        monkeypatch, chunk, buckets, used):
    cpu_planner(monkeypatch)
    engine = torch_engine(prefill_chunk_tokens=chunk)
    ug = engine._unified
    assert ug.planner is not None
    # the reference's reachable buckets (ucap): up to one chunk (the
    # engine's length, 128, or 32 with its mixed bucket of 32 + 4 lanes,
    # 40) plus four decode lanes; the worklist at 4 x 32 entries
    assert ug.buckets == buckets and ug.page_slots == 4 * 32
    sigs = record_signatures(engine)
    await engine.warmup()
    warmed = set(sigs)
    assert warmed == {bucket_signature(ug, b) for b in ug.buckets}
    assert engine.allocator.cached_blocks == 0 and engine.allocator.used_blocks == 0
    assert engine.stats()["unified_graphs_captured"] == 0  # no card: no graph
    assert engine.stats()["warmup_s"] > 0
    sigs.clear()
    # varied compositions: lone prompts, admissions under decode, a long
    # prompt beside decodes, a prefix hit
    vocab = engine.config.model.vocab_size
    rng = np.random.default_rng(8)
    shared = rng.integers(3, vocab, 20).tolist()
    waves = [
        [request(rng.integers(3, vocab, n).tolist(), max_tokens=5, ignore_eos=True)
         for n in (3, 17, 33)],
        [request(rng.integers(3, vocab, n).tolist(), max_tokens=9, ignore_eos=True)
         for n in (120, 4, 7, 50, 11)],
        [request(shared, max_tokens=3, ignore_eos=True)],
        [request(shared + [5, 6, 7], max_tokens=4, ignore_eos=True)],
    ]
    for wave in waves:
        await serve(engine, Context, wave)
    stats = engine.stats()
    assert stats["decode_windows_unified_total"] > 0 and stats["prefix_hits_total"] > 0
    seen = {s[0][0] for s in sigs}
    assert len(seen) >= used
    for sig in sigs:
        assert sig == bucket_signature(ug, sig[0][0])
    assert set(sigs) <= warmed  # no new signature after warmup
    assert stats["unified_graphs_captured_after_warmup"] == 0


async def test_warmup_runs_on_the_device_thread_and_flushes_prefixes():
    """Started, warmup runs on the device thread; a prefix published
    before it is flushed (no warmup or earlier state reaches serving)."""
    engine = torch_engine()
    vocab = engine.config.model.vocab_size
    prompt = np.random.default_rng(1).integers(3, vocab, 24).tolist()
    await serve(engine, Context, [request(prompt, max_tokens=2, ignore_eos=True)])
    assert engine.allocator.cached_blocks > 0
    engine.start()
    try:
        await engine.warmup()
        assert engine.allocator.cached_blocks == 0
    finally:
        engine.stop()
    again = await serve(engine, Context, [request(prompt, max_tokens=2, ignore_eos=True)])
    assert again[0][1] == "length"
    assert engine.stats()["prefix_hits_total"] == 0


def test_unified_graph_refuses_what_its_shapes_cannot_hold(monkeypatch):
    """Seeds past the seed slots, a plan past its bucket's capacity, a plan
    for a kernel that takes none, an array of another shape: each refused
    by name."""
    engine = torch_engine()
    ug = engine._unified
    b = ug.buckets[0]
    ntb = b // ug.tb
    arrays = {n: np.zeros(t.shape, t.numpy().dtype) for n, t in ug.inputs.view(b).items()
              if n != "seed_lanes"}
    row = np.zeros((engine.config.model.vocab_size,), np.int32)
    with pytest.raises(ValueError, match="seed slots"):
        ug.upload(b, arrays, None, [(0, row, row), (1, row, row)])
    plan = ragged_attention.plan_ragged_work(np.zeros(ntb, np.int32), kv_heads=1, sms=SMS)
    with pytest.raises(ValueError, match="takes none"):
        ug.upload(b, arrays, plan)
    with pytest.raises(ValueError, match="staged upload"):
        ug.upload(b, {**arrays, "token_ids": np.zeros((b + 1,), np.int32)})
    cpu_planner(monkeypatch)
    ug = torch_engine()._unified
    big = ragged_attention.plan_ragged_work(np.full(ntb, 4000, np.int32), kv_heads=1, sms=SMS)
    assert not big.fits(ug.caps[b])
    with pytest.raises(ValueError, match="does not fit"):
        ug.upload(b, arrays, big)


@pytest.mark.parametrize("noise", [False, True])
def test_an_idle_window_changes_nothing(noise):
    """The window warmup replays each graph on (every token a pad, no lane
    sampled or seeded) and the capture's warm-up step (the same through
    the idle tensors) leave the cache, the penalty counts and the feedback
    as they were."""
    engine = torch_engine()
    ug = engine._unified
    gen = torch.Generator().manual_seed(2)
    for leaf in engine.cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    engine._gen_counts.copy_(torch.randint(0, 3, engine._gen_counts.shape, generator=gen))
    engine._prompt_counts.copy_(torch.randint(0, 3, engine._prompt_counts.shape, generator=gen))
    engine._decode.feedback.copy_(torch.arange(engine.config.max_batch_size))
    before = ({k: v.clone() for k, v in engine.cache.items()}, engine._gen_counts.clone(),
              engine._prompt_counts.clone(), engine._decode.feedback.clone())
    b = ug.buckets[-1]
    ug.upload(b, ug._idle_arrays(b))
    ug.step(b, noise)
    ug.step(ug.buckets[0], noise, idle=True)
    after = (engine.cache, engine._gen_counts, engine._prompt_counts, engine._decode.feedback)
    # the caches' live slots (the dump row past each leaf takes the pads)
    assert all(torch.equal(after[0][k], before[0][k]) for k in before[0])
    for x, y in zip(after[1:], before[1:]):
        assert torch.equal(x, y)
