"""TorchLlmEngine (device="cpu") against JaxLlmEngine (unified batching on,
overlap off in both) on tests/data/tiny-chat-model in float32: greedy token
streams must be identical over staggered admission, chunked prefill, stop
tokens, penalties and preemption at a small block pool, and both of the
port's routes (the unified ragged step and the decode-only step) must run.
Also: the engine's device and attention rules (no silent CPU, no fallback
from the kernels)."""

import asyncio
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops.kernels.build import KernelBuildError
from dynamo_tpu_torch.runtime.engine import Context

MODEL_DIR = Path(__file__).parent / "data" / "tiny-chat-model"
CFG = dataclasses.replace(
    llama.LlamaConfig.from_hf_config(MODEL_DIR / "config.json"), dtype=torch.float32
)
JCFG = dataclasses.replace(
    jax_llama.LlamaConfig.from_hf_config(MODEL_DIR / "config.json"), dtype=jnp.float32
)
PARAMS = llama.load_hf_weights(CFG, MODEL_DIR, device="cpu")
JPARAMS = jax_llama.load_hf_weights(JCFG, MODEL_DIR)
BASE = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32, 64),
            max_model_len=128)


def request(tokens, max_tokens=8, sampling=None, **stop) -> dict:
    return PreprocessedRequest(
        token_ids=list(tokens),
        sampling=sampling or SamplingOptions(use_greedy=True),
        stop=StopConditions(max_tokens=max_tokens, **stop),
        eos_token_ids=[1],
    ).to_wire()


async def collect(engine, req_wire, context_cls):
    stream = await engine.generate(context_cls(req_wire))
    tokens, finish = [], None
    async for item in stream:
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is None:
            continue
        tokens.extend(ann.data.token_ids)
        finish = ann.data.finish_reason or finish
    return tokens, (finish.value if finish is not None else None)


async def run_both(reqs, stagger_s=0.0, **overrides):
    """The same requests through both engines; returns (ours, ref, our stats)."""
    cfg = {**BASE, **overrides}
    jax_engine = JaxLlmEngine(
        JaxEngineConfig(model=JCFG, unified_batch=True, decode_overlap=False, **cfg),
        params=JPARAMS,
    )
    # like for like: the reference runs synchronously here, and so does
    # the port (tests/test_torch_overlap.py holds the overlapped pipeline)
    ours_engine = TorchLlmEngine(EngineConfig(model=CFG, decode_overlap=False, **cfg),
                                 params=PARAMS, device="cpu")
    out = []
    for engine, ctx_cls in ((jax_engine, JaxContext), (ours_engine, Context)):
        engine.start()
        try:
            tasks = []
            for r in reqs:
                tasks.append(asyncio.ensure_future(collect(engine, r, ctx_cls)))
                if stagger_s:
                    await asyncio.sleep(stagger_s)
            out.append(await asyncio.gather(*tasks))
        finally:
            engine.stop()
    return out[1], out[0], ours_engine.stats()


async def collect_logprobs(engine, req_wire, context_cls):
    stream = await engine.generate(context_cls(req_wire))
    tokens, lps, tops = [], [], []
    async for item in stream:
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is None:
            continue
        tokens.extend(ann.data.token_ids)
        lps.extend(ann.data.logprobs or [])
        tops.extend(ann.data.top_logprobs or [])
    return tokens, lps, tops


def assert_both_routes(stats):
    assert stats["decode_windows_unified_total"] > 0
    assert stats["decode_windows_sync_total"] > stats["decode_windows_unified_total"]


async def test_staggered_admission_matches_reference():
    reqs = [request(range(3 + 5 * i, 12 + 7 * i), max_tokens=10, ignore_eos=True)
            for i in range(5)]
    ours, ref, stats = await run_both(reqs, stagger_s=0.03)
    assert ours == ref
    assert_both_routes(stats)
    # the token-counter weights continue t with t+1, t+2, ...
    assert ours[0][0] == list(range(12, 22))


async def test_chunked_prefill_matches_reference():
    reqs = [request(range(5, 12), max_tokens=8, ignore_eos=True),
            request(range(3, 40), max_tokens=6, ignore_eos=True)]
    ours, ref, stats = await run_both(reqs, stagger_s=0.05, prefill_chunk_tokens=8)
    assert ours == ref
    assert_both_routes(stats)


async def test_stop_tokens_and_eos_match_reference():
    reqs = [
        request(range(3, 12), max_tokens=8, stop_token_ids=[15]),
        request([470, 471, 472], max_tokens=20),  # counts past the vocab toward eos
    ]
    ours, ref, _ = await run_both(reqs)
    assert ours == ref
    assert ours[0] == ([12, 13, 14, 15], "stop")


async def test_penalties_match_reference():
    sampling = SamplingOptions(
        use_greedy=True, frequency_penalty=1.5, presence_penalty=0.5,
        repetition_penalty=1.3,
    )
    reqs = [request([5, 6, 7, 8, 5, 6, 7, 8], max_tokens=12, sampling=sampling, ignore_eos=True),
            request(range(20, 30), max_tokens=12, ignore_eos=True)]
    ours, ref, _ = await run_both(reqs)
    assert ours == ref


async def test_logprobs_and_logit_bias_match_reference():
    sampling = SamplingOptions(use_greedy=True, top_logprobs=3,
                               logit_bias={"20": 40.0, "30": -100.0})
    req = request(range(10, 18), max_tokens=6, sampling=sampling, ignore_eos=True)
    out = []
    for engine, ctx_cls in (
        (JaxLlmEngine(JaxEngineConfig(model=JCFG, unified_batch=True, decode_overlap=False,
                                      **BASE), params=JPARAMS), JaxContext),
        (TorchLlmEngine(EngineConfig(model=CFG, **BASE), params=PARAMS, device="cpu"), Context),
    ):
        engine.start()
        try:
            out.append(await collect_logprobs(engine, req, ctx_cls))
        finally:
            engine.stop()
    (ref_tokens, ref_lps, ref_tops), (tokens, lps, tops) = out
    assert tokens == ref_tokens
    assert 20 in tokens  # the bias steered the stream
    assert lps == pytest.approx(ref_lps, abs=1e-4)
    assert [[i for i, _ in row] for row in tops] == [[i for i, _ in row] for row in ref_tops]
    assert [v for row in tops for _, v in row] == pytest.approx(
        [v for row in ref_tops for _, v in row], abs=1e-4)


async def test_preemption_matches_reference():
    reqs = [request(range(3 + i, 10 + i), max_tokens=8, ignore_eos=True) for i in range(3)]
    ours, ref, stats = await run_both(
        reqs, num_blocks=10, max_model_len=40, prefill_buckets=(16, 32),
    )
    assert ours == ref
    assert stats["num_preemptions_total"] > 0, "geometry failed to force preemption"


async def test_sampled_streams_match_reference():
    """Sampled lanes (seeded, and seeded from the engine stream) draw the
    reference's threefry noise at every position: the streams equal the
    JAX engine's, chunked prefill and penalties included."""
    seeded = SamplingOptions(temperature=8.0, seed=1234, frequency_penalty=2.0)
    unseeded = SamplingOptions(temperature=3.0, top_k=20, top_p=0.9)
    reqs = [request(range(3, 40), 10, seeded, ignore_eos=True),
            request(range(60, 70), 10, unseeded, ignore_eos=True),
            request(range(100, 108), 10, ignore_eos=True)]
    ours, ref, _ = await run_both(reqs, stagger_s=0.03, prefill_chunk_tokens=8)
    assert ours == ref
    assert ours[0][0] != list(range(40, 50))  # the noise really moved the stream


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchLlmEngine(EngineConfig(model=CFG, **BASE), params=PARAMS)


def test_forced_kernel_attention_raises_where_kernels_cannot_build(monkeypatch):
    from dynamo_tpu_torch.ops.kernels import build

    def no_nvcc():
        raise KernelBuildError("nvcc not found")

    # no library loaded or cached, and no compiler: what this CPU host is
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "source_hash", lambda: "no-such-build")
    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    with pytest.raises(KernelBuildError):
        TorchLlmEngine(
            EngineConfig(model=CFG, attention_impl="kernel", **BASE), params=PARAMS,
            device="cpu",
        )


def test_unknown_attention_impl_is_refused():
    with pytest.raises(ValueError, match="attention_impl"):
        TorchLlmEngine(EngineConfig(model=CFG, attention_impl="xla", **BASE), params=PARAMS,
                       device="cpu")
