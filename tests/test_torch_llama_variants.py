"""The port's llama-geometry variants with checkpoint quirks, ``gemma``
(Gemma-1: GeGLU, sqrt(hidden) embedding scale, (1 + w) norms baked in at
load) and ``phi3`` (fused qkv / gate-up tensors, an always-on sliding
window, longrope refused), against the JAX reference in float32 on the
CPU:
- config parsing of the published Gemma-2B and Phi-3-mini-4k config.json
  (every field the reference has, ``mlp_activation`` and ``embed_scale``
  included), the refusals, the registry entries;
- the loaders on synthetic HF checkpoints read by both packages;
- the split prefill, unified and decode forwards at 2 layers with the
  gemma and phi3 deltas (Gemma's MQA, Phi-3's window), logits and caches
  within 1e-4 of the reference's forwards through its Pallas kernels in
  interpret mode;
- TorchLlmEngine against JaxLlmEngine: greedy and seeded streams
  byte-identical, unified step on, chunked prefill."""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.models.registry import get_family as jax_get_family
from dynamo_tpu.ops.pallas import pack_page_meta as jax_pack_page_meta
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.registry import get_family, known_families
from dynamo_tpu_torch.ops.kernels import pack_page_meta
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import collect, request
from tests.test_torch_llama import assert_trees_equal, tree_to_numpy

ATOL = 1e-4
LANES, BS, NUM_BLOCKS, TB = 3, 4, 16, 4

# google/gemma-2b config.json (the values the engine reads)
GEMMA_2B = {
    "model_type": "gemma", "vocab_size": 256000, "hidden_size": 2048,
    "intermediate_size": 16384, "num_hidden_layers": 18, "num_attention_heads": 8,
    "num_key_value_heads": 1, "head_dim": 256, "max_position_embeddings": 8192,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "rope_scaling": None,
    "hidden_act": "gelu", "hidden_activation": "gelu_pytorch_tanh",
}
# microsoft/Phi-3-mini-4k-instruct config.json
PHI3_MINI_4K = {
    "model_type": "phi3", "vocab_size": 32064, "hidden_size": 3072,
    "intermediate_size": 8192, "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "max_position_embeddings": 4096,
    "original_max_position_embeddings": 4096, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "rope_scaling": None, "sliding_window": 2047, "tie_word_embeddings": False,
    "hidden_act": "silu",
}
# the same families at test widths: Gemma's MQA, Phi-3's window of 7
TINY_HF = {
    "gemma": {**GEMMA_2B, "vocab_size": 481, "hidden_size": 64, "intermediate_size": 128,
              "num_hidden_layers": 2, "num_attention_heads": 4, "head_dim": 16,
              "max_position_embeddings": 2048},
    "phi3": {**PHI3_MINI_4K, "vocab_size": 481, "hidden_size": 64, "intermediate_size": 96,
             "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 4,
             "max_position_embeddings": 2048, "sliding_window": 7},
}
VARIANTS = sorted(TINY_HF)


def t(a):
    return torch.from_numpy(np.array(a))


def configs(variant: str):
    cfg = dataclasses.replace(get_family(variant).config_from_hf(TINY_HF[variant]),
                              dtype=torch.float32)
    jcfg = dataclasses.replace(jax_get_family(variant).config_from_hf(TINY_HF[variant]),
                               dtype=jnp.float32)
    return cfg, jcfg


def test_configs_from_published_files_match_reference():
    fields = {f.name for f in dataclasses.fields(llama.LlamaConfig)}
    assert fields == {f.name for f in dataclasses.fields(jax_llama.LlamaConfig)}
    for conf in (GEMMA_2B, PHI3_MINI_4K, *TINY_HF.values()):
        name = conf["model_type"]
        ours = get_family(name).config_from_hf(conf)
        ref = jax_get_family(name).config_from_hf(conf)
        for field in fields - {"dtype"}:
            assert getattr(ours, field) == getattr(ref, field), (name, field)
    gemma = get_family("gemma").config_from_hf(GEMMA_2B)
    assert (gemma.mlp_activation, gemma.embed_scale, gemma.tie_word_embeddings,
            gemma.head_dim, gemma.num_kv_heads) == ("gelu_tanh", 2048 ** 0.5, True, 256, 1)
    phi3 = get_family("phi3").config_from_hf(PHI3_MINI_4K)
    assert (phi3.sliding_window, phi3.head_dim, phi3.mlp_activation) == (2047, 96, "silu")
    for kind in ("longrope", "su"):
        with pytest.raises(NotImplementedError, match="longrope"):
            get_family("phi3").config_from_hf({**PHI3_MINI_4K, "rope_scaling": {
                "type": kind, "short_factor": [1.0], "long_factor": [1.0]}})
    with pytest.raises(ValueError, match="activation"):
        get_family("gemma").config_from_hf({**GEMMA_2B, "hidden_activation": "relu"})
    assert {"gemma", "phi3"} <= set(known_families())
    assert {get_family(n).name for n in ("gemma", "phi3")} == {"gemma", "phi3"}


def test_mlp_refuses_an_unknown_activation():
    x = torch.ones((2, 4))
    w = torch.ones((4, 4))
    with pytest.raises(ValueError, match="mlp_activation"):
        llama._mlp(x, w, w, w, "gelu_exact")


def export_hf(variant: str, cfg, params, path) -> None:
    """A synthetic HF checkpoint of ``params`` (numpy tree): Gemma's norms
    stored as w (the loader adds the 1), Phi-3's fused qkv and gate-up."""
    tr = lambda a: np.ascontiguousarray(np.asarray(a, np.float32).T)  # noqa: E731
    norm = (lambda a: np.asarray(a, np.float32) - 1.0) if variant == "gemma" else np.asarray
    out = {"model.embed_tokens.weight": params["embed"],
           "model.norm.weight": norm(params["final_norm"])}
    if "lm_head" in params:
        out["lm_head.weight"] = tr(params["lm_head"])
    for i in range(cfg.num_layers):
        src = {k: np.asarray(v[i], np.float32) for k, v in params["layers"].items()}
        p = f"model.layers.{i}"
        out[f"{p}.input_layernorm.weight"] = norm(src["attn_norm"])
        out[f"{p}.post_attention_layernorm.weight"] = norm(src["mlp_norm"])
        out[f"{p}.self_attn.o_proj.weight"] = tr(src["wo"])
        out[f"{p}.mlp.down_proj.weight"] = tr(src["w_down"])
        if variant == "phi3":
            out[f"{p}.self_attn.qkv_proj.weight"] = np.concatenate(
                [tr(src["wq"]), tr(src["wk"]), tr(src["wv"])])
            out[f"{p}.mlp.gate_up_proj.weight"] = np.concatenate(
                [tr(src["w_gate"]), tr(src["w_up"])])
        else:
            for proj in ("q", "k", "v"):
                out[f"{p}.self_attn.{proj}_proj.weight"] = tr(src[f"w{proj}"])
            out[f"{p}.mlp.gate_proj.weight"] = tr(src["w_gate"])
            out[f"{p}.mlp.up_proj.weight"] = tr(src["w_up"])
    save_file({k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in out.items()},
              str(path / "model.safetensors"))


@pytest.mark.parametrize("variant", VARIANTS)
def test_loaders_match_reference(variant, tmp_path):
    """Phi-3's fused tensors split at load; Gemma's (1 + w) baked in."""
    cfg, jcfg = configs(variant)
    params = tree_to_numpy(jax_llama.init_params(jcfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(0)
    for name in ("attn_norm", "mlp_norm"):  # norms that are not all ones
        params["layers"][name] = params["layers"][name] + rng.normal(
            0, 0.1, params["layers"][name].shape).astype(np.float32)
    export_hf(variant, jcfg, params, tmp_path)
    ours = get_family(variant).load_weights(cfg, tmp_path, "cpu")
    ref = tree_to_numpy(jax_get_family(variant).load_weights(jcfg, tmp_path))
    assert_trees_equal(ours, ref)
    assert_trees_equal(ours, params, atol=1e-6)  # the round trip (a float32 +1 - 1)


@pytest.fixture(scope="module", params=VARIANTS)
def forward_models(request):
    cfg, jcfg = configs(request.param)
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(1))
    return cfg, jcfg, llama.params_from_jax(tree_to_numpy(jparams), device="cpu"), jparams


def close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_forwards_match_reference_kernels(forward_models):
    """On one cache: a split prefill (14 tokens: past Phi-3's window), a
    unified window of decode tokens beside a continuing span and pads, and
    a decode batch, through the reference's Pallas kernels in interpret
    mode and the port's wrappers."""
    cfg, jcfg, params, jparams = forward_models
    tables = np.random.default_rng(0).permutation(NUM_BLOCKS).astype(np.int32).reshape(4, 4)[:LANES]
    cache = llama.init_kv_cache(cfg, NUM_BLOCKS, BS, device="cpu")
    jcache = jax_llama.init_kv_cache(jcfg, NUM_BLOCKS, BS)
    cos, sin = llama.make_rope_tables(cfg, device="cpu")
    jcos, jsin = jax_llama.make_rope_tables(jcfg)
    rng = np.random.default_rng(3)
    for lane, n in ((0, 14), (1, 5), (2, 9)):
        tokens = rng.integers(2, 480, 16).astype(np.int32)
        ref, jcache = jax_llama.llama_forward_prefill(
            jparams, jcfg, jnp.asarray(tokens), jcache, jnp.asarray(tables[lane]),
            jnp.int32(n), jnp.int32(0), jcos, jsin)
        ours, _ = llama.llama_forward_prefill(params, cfg, t(tokens), cache, t(tables[lane]),
                                              torch.tensor(n), 0, cos, sin)
        close(ours, ref)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)

    spans = [(0, 14, 1), (1, 5, 3), (2, 9, 1)]
    total = sum(n for _, _, n in spans)
    n_tok = -(-total // TB) * TB + TB
    token_ids = rng.integers(2, 480, n_tok).astype(np.int32)
    token_pos = np.full((n_tok,), -1, np.int32)
    token_slot = np.full((n_tok,), NUM_BLOCKS * BS, np.int32)
    token_lane = np.full((n_tok,), LANES, np.int32)
    ctx = np.zeros((LANES,), np.int32)
    rows = np.zeros((LANES,), np.int32)
    cur = 0
    for lane, start, n in spans:
        pos = np.arange(start, start + n)
        token_pos[cur: cur + n] = pos
        token_slot[cur: cur + n] = tables[lane, pos // BS] * BS + pos % BS
        token_lane[cur: cur + n] = lane
        ctx[lane], rows[lane] = start + n, cur + n - 1
        cur += n
    kw = dict(tb_tokens=TB, block_size=BS, sliding_window=cfg.sliding_window)
    meta = pack_page_meta(token_lane, token_pos, tables, **kw)
    jmeta = jax_pack_page_meta(token_lane, token_pos, tables, **kw)
    ref, jcache = jax_llama.llama_forward_unified(
        jparams, jcfg, jnp.asarray(token_ids), jcache,
        *(jnp.asarray(a) for a in (tables, ctx, token_pos, token_slot, token_lane)),
        *(jnp.asarray(a) for a in jmeta), jnp.asarray(rows), jcos, jsin,
        attention="pallas_interpret", tb_tokens=TB)
    ours, _ = llama.llama_forward_unified(
        params, cfg, t(token_ids), cache, t(tables), t(ctx), t(token_pos), t(token_slot),
        t(token_lane), *(t(a) for a in meta), t(rows), cos, sin, tb_tokens=TB)
    close(ours, ref)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)

    ctx = ctx + 1
    pos = ctx - 1
    slots = tables[np.arange(LANES), pos // BS] * BS + pos % BS
    token_ids = np.array([7, 300, 42], np.int32)
    ref, jcache = jax_llama.llama_forward_decode(
        jparams, jcfg, jnp.asarray(token_ids), jcache, jnp.asarray(tables), jnp.asarray(ctx),
        jnp.asarray(slots), jcos, jsin, attention="pallas_interpret")
    ours, _ = llama.llama_forward_decode(params, cfg, t(token_ids), cache, t(tables),
                                         t(ctx), t(slots), cos, sin)
    close(ours, ref)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)


@pytest.fixture(scope="module")
def engine_models():
    out = {}
    for variant in VARIANTS:
        cfg, jcfg = configs(variant)
        jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(3))
        out[variant] = (cfg, jcfg, llama.params_from_jax(tree_to_numpy(jparams), "cpu"),
                        jparams)
    return out


ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32, 64),
              max_model_len=128, decode_overlap=False, prefill_chunk_tokens=8)


@pytest.mark.parametrize("variant", VARIANTS)
async def test_engine_streams_match_reference(engine_models, variant):
    """Greedy and seeded lanes over staggered lengths (Phi-3's past its
    window), the unified step on and chunked prefill: byte-identical."""
    cfg, jcfg, params, jparams = engine_models[variant]
    seeded = SamplingOptions(temperature=6.0, seed=77, frequency_penalty=1.0)
    reqs = [request(range(3 + 5 * i, 12 + 9 * i), max_tokens=8, ignore_eos=True)
            for i in range(3)]
    reqs.append(request(range(100, 137), 8, seeded, ignore_eos=True))
    engines = (
        (JaxLlmEngine(JaxEngineConfig(model=jcfg, model_family=variant, unified_batch=True,
                                      **ENGINE), params=jparams), JaxContext),
        (TorchLlmEngine(EngineConfig(model=cfg, model_family=variant, **ENGINE),
                        params=params, device="cpu"), Context),
    )
    out = []
    for engine, ctx_cls in engines:
        tasks = [asyncio.ensure_future(collect(engine, r, ctx_cls)) for r in reqs]
        await asyncio.sleep(0.05)
        engine.start()
        try:
            out.append(await asyncio.gather(*tasks))
        finally:
            engine.stop()
    assert out[1] == out[0]
    stats = engines[1][0].stats()
    assert stats["decode_windows_unified_total"] > 0
    assert not stats["unified_fallbacks"]
