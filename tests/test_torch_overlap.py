"""The port's overlapped decode pipeline and fused decode_steps against the
JAX reference, on tests/data/tiny-chat-model in float32 on the CPU: the
scenarios of tests/engine/test_decode_overlap.py, each served by
TorchLlmEngine with overlap on (its default) and held byte for byte to
JaxLlmEngine's streams with decode_overlap True and False — single-step
windows, decode_steps=4 with stops mid-window, a stop token mid-window,
preemption at decode_steps 1 and 4, a LENGTH finish at the engine's max
length, seeded sampling, a top_logprobs lane falling back to the
synchronous path, and every block and lane released; decode_steps=4
against decode_steps=1; the stats() keys and phase names the reference
uses."""

import asyncio

import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import (
    BASE,
    CFG,
    JCFG,
    JPARAMS,
    PARAMS,
    collect,
    collect_logprobs,
    request,
)


async def serve(engine, ctx_cls, reqs, collector=collect):
    """Every request queued before the engine thread starts, so engines
    schedule the same steps; the streams in request order."""
    tasks = [asyncio.ensure_future(collector(engine, r, ctx_cls)) for r in reqs]
    await asyncio.sleep(0.05)
    engine.start()
    try:
        return await asyncio.gather(*tasks)
    finally:
        engine.stop()


def jax_engine(overlap: bool, jcfg=JCFG, jparams=JPARAMS, **kw):
    return JaxLlmEngine(JaxEngineConfig(model=jcfg, unified_batch=True, decode_overlap=overlap,
                                        **{**BASE, **kw}), params=jparams)


def torch_engine(cfg=CFG, params=PARAMS, **kw):
    return TorchLlmEngine(EngineConfig(model=cfg, **{**BASE, **kw}), params=params,
                          device="cpu")


async def run_matrix(reqs, *, jcfg=JCFG, jparams=JPARAMS, cfg=CFG, params=PARAMS, **kw):
    """The same requests through the reference with overlap off and on and
    through the port with its default overlap on.  Returns (reference
    sync, reference overlap, ours, our stats)."""
    ref_sync = await serve(jax_engine(False, jcfg, jparams, **kw), JaxContext, reqs)
    ref_over = await serve(jax_engine(True, jcfg, jparams, **kw), JaxContext, reqs)
    ours_engine = torch_engine(cfg, params, **kw)
    assert ours_engine.decode_overlap
    ours = await serve(ours_engine, Context, reqs)
    return ref_sync, ref_over, ours, ours_engine.stats()


def assert_same(ref_sync, ref_over, ours):
    assert ref_over == ref_sync
    assert ours == ref_sync


async def test_overlap_parity_single_step():
    prompts = [list(range(3 + i, 11 + i)) for i in range(3)]
    reqs = [request(p, max_tokens=6, ignore_eos=True) for p in prompts]
    ref_sync, ref_over, ours, stats = await run_matrix(reqs)
    assert_same(ref_sync, ref_over, ours)
    for p, (tokens, _) in zip(prompts, ours):
        assert tokens == list(range(p[-1] + 1, p[-1] + 7))  # the token counter
    # the pipeline ran: windows dispatched with token feedback
    assert stats["decode_windows_overlapped_total"] > 0
    assert stats["decode_windows_sync_total"] == 0


async def test_overlap_parity_multistep_midwindow_stop():
    """decode_steps=4 with max_tokens landing mid-window (3, 9, 6): the
    lagged window's extra steps are dropped exactly."""
    prompts = [list(range(3, 10)), list(range(5, 14)), list(range(2, 8))]
    reqs = [request(p, max_tokens=n, ignore_eos=True) for p, n in zip(prompts, (3, 9, 6))]
    ref_sync, ref_over, ours, stats = await run_matrix(reqs, decode_steps=4)
    assert_same(ref_sync, ref_over, ours)
    for (tokens, finish), n in zip(ours, (3, 9, 6)):
        assert (len(tokens), finish) == (n, "length")
    assert stats["decode_windows_overlapped_total"] > 0
    assert stats["unified_fallbacks"] == {"multi_step_decode": 1}
    assert stats["decode_windows_unified_total"] == 0


async def test_overlap_stop_token_midwindow():
    """A stop found one window late ends the stream at the stop (no
    trailing tokens)."""
    prompt = list(range(3, 12))
    base = await serve(torch_engine(decode_overlap=False, decode_steps=2), Context,
                       [request(prompt, max_tokens=8, ignore_eos=True)])
    stop_tok = base[0][0][4]  # a stop mid-stream, mid-window at steps=2
    reqs = [PreprocessedRequest(
        token_ids=prompt, sampling=SamplingOptions(use_greedy=True),
        stop=StopConditions(max_tokens=8, stop_token_ids=[stop_tok]), eos_token_ids=[],
    ).to_wire()]
    ref_sync, ref_over, ours, _ = await run_matrix(reqs, decode_steps=2)
    assert_same(ref_sync, ref_over, ours)
    tokens, finish = ours[0]
    assert finish == "stop"
    assert tokens[-1] == stop_tok and stop_tok not in tokens[:-1]


@pytest.mark.parametrize("steps,max_tokens", [(1, 8), (4, 12)])
async def test_overlap_parity_under_preemption(steps, max_tokens):
    """A tight block pool: the pipeline drains before any preemption (a
    lagged window must not write into freed blocks) and the recompute
    keeps greedy output exact.  (Fused windows finish 8 tokens before the
    pool runs dry: they take 12.)"""
    prompts = [list(range(3, 10)), list(range(5, 12)), list(range(2, 9))]
    reqs = [request(p, max_tokens=max_tokens, ignore_eos=True) for p in prompts]
    ref_sync, ref_over, ours, stats = await run_matrix(
        reqs, decode_steps=steps, num_blocks=10, max_model_len=40, prefill_buckets=(16, 32))
    assert_same(ref_sync, ref_over, ours)
    for p, (tokens, _) in zip(prompts, ours):
        assert tokens == list(range(p[-1] + 1, p[-1] + 1 + max_tokens))
    assert stats["num_preemptions_total"] > 0, "geometry failed to force preemption"


async def test_overlap_length_finish_at_engine_max_len():
    """Windows in flight past the engine's last position clamp their slots
    and their tokens are dropped."""
    prompts = [list(range(3, 10)), list(range(4, 11))]
    reqs = [request(p, max_tokens=64, ignore_eos=True) for p in prompts]
    ref_sync, ref_over, ours, _ = await run_matrix(
        reqs, decode_steps=4, max_model_len=24, num_blocks=16, max_batch_size=2)
    assert_same(ref_sync, ref_over, ours)
    for tokens, finish in ours:
        assert (len(tokens), finish) == (24 - 7, "length")


async def test_overlap_seeded_sampling_parity():
    """The device-side key fold advances identically in every mode, so
    sampled streams reproduce across them (and the reference's)."""
    prompt = list(range(3, 10))
    sampled = SamplingOptions(temperature=8.0, seed=1234)
    reqs = [request(prompt, 10, sampled, ignore_eos=True),
            request(range(20, 30), 10, SamplingOptions(temperature=3.0, top_k=20, top_p=0.9,
                                                       seed=7), ignore_eos=True),
            request(range(40, 45), 10, ignore_eos=True)]
    ref_sync, ref_over, ours, stats = await run_matrix(reqs)
    assert_same(ref_sync, ref_over, ours)
    assert ours[0][0] != list(range(10, 20))  # the noise moved the stream
    assert stats["decode_windows_overlapped_total"] > 0
    ref4 = await serve(jax_engine(True, decode_steps=4), JaxContext, reqs)
    ours4 = await serve(torch_engine(decode_steps=4), Context, reqs)
    assert ours4 == ref4


async def test_top_logprobs_falls_back_to_sync():
    """A top_logprobs lane needs K-wide rows a step: the batch serves
    synchronously (no overlapped window) with its rows intact."""
    prompt = list(range(3, 10))
    req = PreprocessedRequest(
        token_ids=prompt, sampling=SamplingOptions(use_greedy=True, top_logprobs=3),
        stop=StopConditions(max_tokens=4, ignore_eos=True), eos_token_ids=[],
    ).to_wire()
    (ref,) = await serve(jax_engine(True), JaxContext, [req], collect_logprobs)
    engine = torch_engine()
    ((tokens, lps, tops),) = await serve(engine, Context, [req], collect_logprobs)
    stats = engine.stats()
    assert tokens == ref[0] == list(range(10, 14))
    assert lps == pytest.approx(ref[1], abs=1e-4)
    assert [[i for i, _ in row] for row in tops] == [[i for i, _ in row] for row in ref[2]]
    assert len(tops) == len(tokens) and all(len(row) == 3 for row in tops)
    assert stats["decode_windows_overlapped_total"] == 0
    assert stats["decode_windows_sync_total"] > 0


async def test_overlap_releases_blocks_and_lanes():
    """Finishes deferred behind a window in flight still return every block
    and lane once the pipeline drains."""
    engine = torch_engine()
    reqs = [request(list(range(3 + i, 10 + i)), max_tokens=5) for i in range(3)]
    engine.start()
    try:
        await asyncio.gather(*(collect(engine, r, Context) for r in reqs))
        for _ in range(100):
            if engine.scheduler.num_running == 0 and engine.allocator.used_blocks == 0:
                break
            await asyncio.sleep(0.02)
        assert engine.scheduler.num_running == 0
        assert engine.allocator.used_blocks == 0
        assert sorted(engine.scheduler._free_lanes) == list(range(4))
        assert engine._inflight is None
    finally:
        engine.stop()


async def test_fused_steps_match_single_steps():
    reqs = [request(range(3 + 4 * i, 9 + 5 * i), max_tokens=11, ignore_eos=True)
            for i in range(4)]
    one = await serve(torch_engine(), Context, reqs)
    four = await serve(torch_engine(decode_steps=4), Context, reqs)
    four_sync = await serve(torch_engine(decode_steps=4, decode_overlap=False), Context, reqs)
    assert four == one == four_sync


async def test_stats_and_phases_carry_the_reference_names(monkeypatch):
    """The counters under the reference's keys, and with
    DYN_ENGINE_PHASE_TIMING=1 the phases the reference times, in
    stats()["phase_ms"]."""
    monkeypatch.setenv("DYN_ENGINE_PHASE_TIMING", "1")
    reqs = [request(range(3 + i, 10 + i), max_tokens=6, ignore_eos=True) for i in range(2)]
    ref_engine = jax_engine(True)
    await serve(ref_engine, JaxContext, reqs)
    ours_engine = torch_engine()
    await serve(ours_engine, Context, reqs)
    ref, ours = ref_engine.stats(), ours_engine.stats()
    for key in ("decode_windows_overlapped_total", "decode_windows_sync_total",
                "decode_windows_unified_total", "admission_drains_total",
                "decode_steps_total", "unified_fallbacks", "phase_ms"):
        assert key in ref and key in ours, key
    assert ours["decode_windows_overlapped_total"] == ref["decode_windows_overlapped_total"]
    phases = set(ours["phase_ms"])
    assert phases <= set(ref["phase_ms"]) | {"decode.readback"}
    assert {"decode.schedule", "decode.upload", "decode.dispatch", "decode.retire",
            "decode.post"} <= phases
    assert all(v["n"] > 0 and v["total_ms"] >= 0 for v in ours["phase_ms"].values())


def test_speculative_engines_turn_overlap_off():
    assert torch_engine().decode_overlap is True
    assert torch_engine(decode_overlap=False).decode_overlap is False
    spec = torch_engine(speculative="ngram")
    assert spec.decode_overlap is False
    with pytest.raises(ValueError, match="decode_steps"):
        torch_engine(decode_steps=0)
