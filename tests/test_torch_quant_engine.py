"""TorchLlmEngine on the quantized paths against JaxLlmEngine, in the
pattern of tests/engine/test_quantized_unified.py, for llama
(tests/data/tiny-chat-model, float32) and deepseek_v2 (tiny_mla), with
decode overlap on and off in both engines, on the CPU:

- int8 weight-only: greedy and seeded streams byte-identical (each engine
  quantizes the same float weights itself, bitwise alike);
- fp8 KV cache: greedy streams byte-identical; seeded sampling at a high
  temperature reproduces itself in each engine;
- int8 weights and an fp8 cache together: greedy byte-identical;
- the unified step keeps serving (no fallback) and the cache is fp8.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import deepseek as jax_ds
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.engine.engine import resolve_kv_cache_dtype
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import deepseek
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.ops.quant import is_quantized
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import BASE, CFG, JCFG, JPARAMS, PARAMS, collect, request

DS_CFG = deepseek.DeepseekConfig.tiny_mla(vocab_size=481)
DS_JCFG = jax_ds.DeepseekConfig.tiny_mla(vocab_size=481)
DS_JPARAMS = jax_ds.init_params(DS_JCFG, jax.random.PRNGKey(3))
DS_PARAMS = params_from_jax(jax.tree.map(np.asarray, DS_JPARAMS), device="cpu")
MODELS = {
    "llama": ("llama", CFG, PARAMS, JCFG, JPARAMS),
    "deepseek_v2": ("deepseek_v2", DS_CFG, DS_PARAMS, DS_JCFG, DS_JPARAMS),
}
PROMPTS = [list(range(3 + i, 13 + i)) for i in range(3)]


def sampled(tokens, max_tokens=8):
    return PreprocessedRequest(
        token_ids=list(tokens),
        sampling=SamplingOptions(temperature=8.0, seed=1234, frequency_penalty=2.0),
        stop=StopConditions(max_tokens=max_tokens, ignore_eos=True),
        eos_token_ids=[],
    ).to_wire()


async def serve(engine, ctx_cls, reqs):
    """Every request queued before the engine starts, so both engines run
    the same steps; the streams in request order."""
    tasks = [asyncio.ensure_future(collect(engine, r, ctx_cls)) for r in reqs]
    await asyncio.sleep(0.05)
    engine.start()
    try:
        return await asyncio.gather(*tasks)
    finally:
        engine.stop()


async def run_pair(family, reqs, overlap, *, reference=True, **kw):
    """The same requests through JaxLlmEngine and TorchLlmEngine, both with
    the unified step, chunked prefill of 8 tokens and ``overlap``."""
    name, cfg, params, jcfg, jparams = MODELS[family]
    conf = {**BASE, "prefill_chunk_tokens": 8, "decode_overlap": overlap, **kw}
    ours_engine = TorchLlmEngine(EngineConfig(model=cfg, model_family=name, **conf),
                                 params=params, device="cpu")
    ours = await serve(ours_engine, Context, reqs)
    ref = None
    if reference:
        jax_engine = JaxLlmEngine(JaxEngineConfig(model=jcfg, model_family=name,
                                                  unified_batch=True, **conf), params=jparams)
        ref = await serve(jax_engine, JaxContext, reqs)
    return ours, ref, ours_engine


def assert_unified(engine):
    stats = engine.stats()
    assert stats["decode_windows_unified_total"] > 0
    assert not stats["unified_fallbacks"]


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("family", sorted(MODELS))
async def test_int8_streams_match_the_reference(family, overlap):
    """int8 weights: greedy and seeded streams byte-identical."""
    reqs = [request(p, max_tokens=6, ignore_eos=True) for p in PROMPTS]
    reqs.append(sampled(range(3, 20)))
    ours, ref, engine = await run_pair(family, reqs, overlap, quantize="int8")
    assert ours == ref
    assert_unified(engine)
    assert is_quantized(engine.params)
    assert engine.stats()["quantize"] == "int8"


@pytest.mark.parametrize("cache", ["fp8", "float8_e5m2"])
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("family", sorted(MODELS))
async def test_fp8_cache_greedy_streams_match_the_reference(family, overlap, cache):
    """An fp8 cache (e4m3fn, e5m2): greedy streams byte-identical, the
    unified step serving (split prefill attends full-precision activations,
    the unified step reads the quantized cache back: argmax absorbs it)."""
    reqs = [request(p, max_tokens=6, ignore_eos=True) for p in PROMPTS]
    ours, ref, engine = await run_pair(family, reqs, overlap, kv_cache_dtype=cache)
    assert ours == ref
    assert_unified(engine)
    want = resolve_kv_cache_dtype(cache)
    assert {leaf.dtype for leaf in engine.cache.values()} == {want}
    assert engine.stats()["kv_cache_dtype"] == str(want).removeprefix("torch.")


@pytest.mark.parametrize("family", sorted(MODELS))
async def test_fp8_seeded_streams_reproduce_themselves(family):
    """Seeded high-temperature sampling over an fp8 cache: byte-identity with
    the reference is not the contract (the paths compute other floats); each
    engine reproduces its own stream."""
    reqs = [sampled(range(3, 20))]
    first, ref1, _ = await run_pair(family, reqs, True, kv_cache_dtype="fp8")
    second, ref2, _ = await run_pair(family, reqs, True, kv_cache_dtype="fp8")
    assert first == second
    assert ref1 == ref2
    assert len(first[0][0]) == 8


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("family", sorted(MODELS))
async def test_int8_weights_with_an_fp8_cache_match_the_reference(family, overlap):
    reqs = [request(p, max_tokens=5, ignore_eos=True) for p in PROMPTS[:2]]
    ours, ref, engine = await run_pair(family, reqs, overlap, quantize="int8",
                                       kv_cache_dtype="fp8")
    assert ours == ref
    assert_unified(engine)


def test_engine_config_takes_every_reference_cache_dtype_name():
    from dynamo_tpu.engine.engine import _KV_DTYPE_NAMES, resolve_kv_cache_dtype as jax_resolve

    for name in _KV_DTYPE_NAMES:
        ours = resolve_kv_cache_dtype(name)
        assert str(ours).removeprefix("torch.") == jax_resolve(name).name
        engine = TorchLlmEngine(EngineConfig(model=CFG, kv_cache_dtype=name, **BASE),
                                params=PARAMS, device="cpu")
        assert engine.cache["k"].dtype == ours
        assert engine.unified_batch
    assert resolve_kv_cache_dtype(None) is None
    assert resolve_kv_cache_dtype(torch.float16) is torch.float16
    with pytest.raises(ValueError, match="unknown kv_cache_dtype"):
        resolve_kv_cache_dtype("int4")
    with pytest.raises(ValueError, match="unknown quantize mode"):
        TorchLlmEngine(EngineConfig(model=CFG, quantize="int4", **BASE), params=PARAMS,
                       device="cpu")
    # a non-float cache keeps the split step, by its reason slug
    engine = TorchLlmEngine(EngineConfig(model=CFG, kv_cache_dtype=torch.int8, **BASE),
                            params=PARAMS, device="cpu")
    assert not engine.unified_batch
    assert engine.stats()["unified_fallbacks"] == {"unsupported_kv_dtype": 1}


def test_cli_flags_reach_the_engine_config():
    from dynamo_tpu_torch.cli.run import engine_overrides, parse_args

    args = parse_args(["run", "in=http", "out=torch", "--model-path", "x",
                       "--kv-cache-dtype", "fp8", "--quantize", "int8"])
    over = engine_overrides(args)
    assert over["kv_cache_dtype"] == "fp8" and over["quantize"] == "int8"
    assert "kv_cache_dtype" not in engine_overrides(parse_args(["run", "--model-path", "x"]))
