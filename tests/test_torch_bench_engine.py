"""The port's benchmark toolkit driving TorchLlmEngine (device="cpu") against
the JAX package's driving JaxLlmEngine, tiny Llama in float32: the headline
bench's engine streams the reference engine's greedy tokens on the bench's
first prompts under bench.py's configuration (logit_bias_k 0, fused decode
steps, chunked prefill), and the copied sweep and SLA profiler stream the
same output tokens at every level and point."""

import asyncio
from collections import Counter

import jax
import numpy as np
import pytest

from dynamo_tpu.bench import profile_sla as jax_sla
from dynamo_tpu.bench import sweep as jax_sweep
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.bench import headline
from dynamo_tpu_torch.bench import profile_sla as sla
from dynamo_tpu_torch.bench import sweep
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import Annotated, LLMEngineOutput
from dynamo_tpu_torch.models.llama import LlamaConfig, params_from_jax
from dynamo_tpu_torch.runtime.engine import Context

JCFG = jax_llama.LlamaConfig.tiny()
JPARAMS = jax_llama.init_params(JCFG, jax.random.PRNGKey(0))
PARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), device="cpu")


async def stream_tokens(engine, req: dict, context_cls) -> list[int]:
    stream = await engine.generate(context_cls(req))
    tokens = []
    async for item in stream:
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is not None:
            tokens.extend(ann.data.token_ids)
    return tokens


async def serve(engine, reqs, context_cls):
    engine.start()
    try:
        return await asyncio.gather(*[stream_tokens(engine, r, context_cls) for r in reqs])
    finally:
        engine.stop()


@pytest.mark.parametrize("env", [{}, {"DYN_BENCH_CHUNK": "16"}], ids=["whole", "chunked"])
async def test_bench_engine_streams_the_reference_engine_tokens(env):
    s = headline.settings_from_env({"DYN_BENCH_DEVICE": "cpu", **env})
    config = headline.engine_config(s)
    assert (config.logit_bias_k, config.decode_steps, config.prefill_chunk_tokens) == (
        0, 4, 16 if env else None)
    reqs = [headline._request(p, s.osl)
            for p in headline.prompts(0, 2, s.isl, config.model.vocab_size)]
    ours = await serve(headline.build_engine(s, PARAMS), reqs, Context)
    ref_engine = JaxLlmEngine(JaxEngineConfig(
        model=JCFG, num_blocks=config.num_blocks, block_size=config.block_size,
        max_batch_size=config.max_batch_size, max_model_len=config.max_model_len,
        prefill_buckets=config.prefill_buckets, decode_steps=config.decode_steps,
        prefill_chunk_tokens=config.prefill_chunk_tokens, top_logprobs_k=0, logit_bias_k=0,
        quantize=config.quantize, kv_cache_dtype=config.kv_cache_dtype), params=JPARAMS)
    ref = await serve(ref_engine, reqs, JaxContext)
    assert ours == ref
    assert [len(t) for t in ours] == [s.osl] * 2


class CountingEngine:
    """Passes requests through and counts the output tokens streamed for
    each prompt length."""

    def __init__(self, engine):
        self.engine = engine
        self.tokens: Counter = Counter()

    async def generate(self, request):
        isl = len(request.data["token_ids"])
        stream = await self.engine.generate(request)

        async def counted():
            async for item in stream:
                self.tokens[isl] += len((item.get("data") or {}).get("token_ids") or [])
                yield item

        return counted()


BASE = dict(num_blocks=96, block_size=4, max_batch_size=4, prefill_buckets=(16, 32, 64),
            max_model_len=96)


async def drive_toolkit(engine, sweep_mod, sla_mod):
    counting = CountingEngine(engine)
    engine.start()
    try:
        points = await sweep_mod.run_sweep(counting, sweep_mod.SweepConfig(
            concurrencies=(1, 3), requests_per_level=3, isl=12, osl=5, vocab_size=512))
        profile = await sla_mod.profile_engine(
            counting, isl_grid=(16, 40), osl_grid=(3, 6), concurrency_grid=(2,),
            requests_per_point=2, vocab_size=512)
    finally:
        engine.stop()
    return points, profile, counting.tokens


async def test_sweep_and_profile_stream_the_reference_counts():
    ours = await drive_toolkit(
        TorchLlmEngine(EngineConfig(model=LlamaConfig.tiny(), **BASE), params=PARAMS,
                       device="cpu"), sweep, sla)
    ref = await drive_toolkit(
        JaxLlmEngine(JaxEngineConfig(model=JCFG, **BASE), params=JPARAMS), jax_sweep, jax_sla)
    (points, profile, tokens), (ref_points, ref_profile, ref_tokens) = ours, ref
    assert [(p.concurrency, p.requests, p.output_tokens) for p in points] == [
        (p.concurrency, p.requests, p.output_tokens) for p in ref_points] == [
        (1, 3, 15), (3, 3, 15)]
    key = lambda p: (p.isl, p.osl, p.concurrency)  # noqa: E731
    assert [key(p) for p in profile.points] == [key(p) for p in ref_profile.points]
    assert all(p.decode_tok_s > 0 and p.ttft_s > 0 for p in profile.points)
    # every point streams osl tokens a request: 2 requests a point, two osls
    assert tokens == ref_tokens == Counter({12: 30, 16: 18, 40: 18})
