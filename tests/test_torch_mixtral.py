"""The port's Mixtral-class MoE families (dynamo_tpu_torch.models.mixtral:
``mixtral`` and ``qwen3_moe``) against the JAX reference, in float32 on the
CPU:
- config parsing of the published Mixtral-8x7B and Qwen3-30B-A3B
  config.json (qwen3_moe's q/k norm from its model_type, a windowed
  checkpoint refused), the presets, the registry entries;
- load_hf_weights on one synthetic HF checkpoint of each naming, read by
  both packages;
- the prefill, prefill-over-prefix, unified, decode and verify forwards:
  logits and updated caches within 1e-4, the reference's decode, unified
  and verify run through its Pallas kernels in interpret mode;
- TorchLlmEngine against JaxLlmEngine: greedy and seeded streams
  byte-identical with the unified step on (chunked prefill, a prefix-cache
  hit), with n-gram speculation, and with int8 weights."""

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
from dynamo_tpu.models import mixtral as jax_mixtral
from dynamo_tpu.ops.pallas import pack_page_meta as jax_pack_page_meta
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import mixtral
from dynamo_tpu_torch.models.registry import get_family, known_families
from dynamo_tpu_torch.ops.kernels import pack_page_meta
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import collect, request
from tests.test_torch_llama import assert_trees_equal, tree_to_numpy

ATOL = 1e-4
LANES, BS, NUM_BLOCKS, TB = 3, 4, 16, 4

# mistralai/Mixtral-8x7B-v0.1 config.json (the values the engine reads)
MIXTRAL_8X7B = {
    "model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_local_experts": 8, "num_experts_per_tok": 2,
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-5, "rope_theta": 1e6,
    "sliding_window": None, "tie_word_embeddings": False, "hidden_act": "silu",
}
# Qwen/Qwen3-30B-A3B config.json
QWEN3_30B_A3B = {
    "model_type": "qwen3_moe", "vocab_size": 151936, "hidden_size": 2048,
    "intermediate_size": 6144, "moe_intermediate_size": 768, "num_hidden_layers": 48,
    "num_attention_heads": 32, "num_key_value_heads": 4, "head_dim": 128,
    "num_experts": 128, "num_experts_per_tok": 8, "norm_topk_prob": True,
    "max_position_embeddings": 40960, "rms_norm_eps": 1e-6, "rope_theta": 1e6,
    "rope_scaling": None, "sliding_window": None, "use_sliding_window": False,
    "max_window_layers": 48, "tie_word_embeddings": False, "attention_bias": False,
}
# the same families cut to test widths
TINY_HF = {
    "mixtral": {**MIXTRAL_8X7B, "vocab_size": 481, "hidden_size": 64,
                "intermediate_size": 96, "num_hidden_layers": 2, "num_attention_heads": 4,
                "num_key_value_heads": 2, "num_local_experts": 4,
                "max_position_embeddings": 2048},
    "qwen3_moe": {**QWEN3_30B_A3B, "vocab_size": 481, "hidden_size": 64,
                  "intermediate_size": 128, "moe_intermediate_size": 48,
                  "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                  "head_dim": 16, "num_experts": 8, "num_experts_per_tok": 2,
                  "norm_topk_prob": False, "max_window_layers": 2,
                  "max_position_embeddings": 2048},
}
VARIANTS = sorted(TINY_HF)


def t(a):
    return torch.from_numpy(np.array(a))


def configs(variant: str):
    """(ours, reference) float32 configs of a test-width family, with a
    capacity factor that lets no token drop."""
    over = dict(dtype=torch.float32, capacity_factor=4.0)
    cfg = dataclasses.replace(mixtral.MixtralConfig.from_hf_config(TINY_HF[variant]), **over)
    jcfg = dataclasses.replace(jax_mixtral.MixtralConfig.from_hf_config(TINY_HF[variant]),
                               **{**over, "dtype": jnp.float32})
    return cfg, jcfg


def test_configs_from_published_files_match_reference():
    fields = {f.name for f in dataclasses.fields(mixtral.MixtralConfig)}
    assert fields == {f.name for f in dataclasses.fields(jax_mixtral.MixtralConfig)}
    for conf in (MIXTRAL_8X7B, QWEN3_30B_A3B, *TINY_HF.values()):
        ours = mixtral.MixtralConfig.from_hf_config(conf)
        ref = jax_mixtral.MixtralConfig.from_hf_config(conf)
        for name in fields - {"dtype"}:
            assert getattr(ours, name) == getattr(ref, name), (conf["model_type"], name)
        assert ours.expert_intermediate_size == ref.expert_intermediate_size
    # the published Mixtral file is the preset; Qwen3-MoE normalizes q and k
    assert mixtral.MixtralConfig.from_hf_config(MIXTRAL_8X7B) == dataclasses.replace(
        mixtral.MixtralConfig.mixtral_8x7b(), rms_norm_eps=1e-5)
    qwen = mixtral.MixtralConfig.from_hf_config(QWEN3_30B_A3B)
    assert (qwen.qk_norm, qwen.num_experts, qwen.experts_per_token,
            qwen.expert_intermediate_size, qwen.sliding_window) == (True, 128, 8, 768, None)
    for name in ("mixtral_8x7b", "tiny_moe"):
        a = getattr(mixtral.MixtralConfig, name)()
        b = getattr(jax_mixtral.MixtralConfig, name)()
        assert {f: getattr(a, f) for f in fields - {"dtype"}} == {
            f: getattr(b, f) for f in fields - {"dtype"}}
    # a windowed MoE checkpoint is refused by both, not served without its mask
    windowed = {**MIXTRAL_8X7B, "sliding_window": 4096}
    for cls in (mixtral.MixtralConfig, jax_mixtral.MixtralConfig):
        with pytest.raises(NotImplementedError, match="sliding-window"):
            cls.from_hf_config(windowed)
    assert {"mixtral", "qwen3_moe"} <= set(known_families())
    for name in ("mixtral", "qwen3_moe"):
        family = get_family(name)
        assert family.name == name and family.forward_unified is not None
        assert family.quant_leaves == (
            "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_params_shapes_follow_the_reference(variant):
    cfg, jcfg = configs(variant)
    ours = mixtral.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jax.eval_shape(lambda: jax_mixtral.init_params(jcfg, jax.random.PRNGKey(0)))
    shapes = lambda tree: {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)  # noqa: E731
                           for k, v in tree.items()}
    assert shapes(ours) == shapes(ref)
    assert ours["layers"]["w_gate"].dtype == torch.float32


def export_hf(cfg, params, path, naming: str) -> None:
    """A synthetic HF checkpoint holding ``params`` (numpy tree), with
    Mixtral's expert names (``block_sparse_moe.experts.{e}.w1/w3/w2``) or
    Qwen3-MoE's (``mlp.experts.{e}.gate/up/down_proj``)."""
    tr = lambda a: np.ascontiguousarray(np.asarray(a, np.float32).T)  # noqa: E731
    out = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]}
    if "lm_head" in params:
        out["lm_head.weight"] = tr(params["lm_head"])
    moe, names = (("block_sparse_moe", ("w1", "w3", "w2")) if naming == "mixtral"
                  else ("mlp", ("gate_proj", "up_proj", "down_proj")))
    for i in range(cfg.num_layers):
        src = {k: np.asarray(v[i], np.float32) for k, v in params["layers"].items()}
        p = f"model.layers.{i}"
        out[f"{p}.input_layernorm.weight"] = src["attn_norm"]
        out[f"{p}.post_attention_layernorm.weight"] = src["mlp_norm"]
        for proj in ("q", "k", "v", "o"):
            out[f"{p}.self_attn.{proj}_proj.weight"] = tr(src[f"w{proj}"])
        if cfg.qk_norm:
            out[f"{p}.self_attn.q_norm.weight"] = src["q_norm"]
            out[f"{p}.self_attn.k_norm.weight"] = src["k_norm"]
        out[f"{p}.{moe}.gate.weight"] = tr(src["w_router"])
        for ours, theirs in zip(("w_gate", "w_up", "w_down"), names):
            for e in range(cfg.num_experts):
                out[f"{p}.{moe}.experts.{e}.{theirs}.weight"] = tr(src[ours][e])
    save_file({k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in out.items()},
              str(path / "model.safetensors"))


@pytest.mark.parametrize("variant", VARIANTS)
def test_load_hf_weights_matches_reference_loader(variant, tmp_path):
    cfg, jcfg = configs(variant)
    params = tree_to_numpy(jax_mixtral.init_params(jcfg, jax.random.PRNGKey(2)))
    export_hf(jcfg, params, tmp_path, variant)
    ours = mixtral.load_hf_weights(cfg, tmp_path, device="cpu")
    ref = tree_to_numpy(jax_mixtral.load_hf_weights(jcfg, tmp_path))
    assert_trees_equal(ours, ref)
    assert_trees_equal(ours, params)  # the round trip is exact
    assert_trees_equal(get_family(variant).load_weights(cfg, tmp_path, "cpu"), ref)


def ragged_batch(spans, tables, seed):
    """(lane, start, length) spans packed densely, padded to whole TB
    blocks plus one block of pads."""
    total = sum(n for _, _, n in spans)
    n_tok = -(-total // TB) * TB + TB
    token_ids = np.zeros((n_tok,), np.int32)
    token_pos = np.full((n_tok,), -1, np.int32)
    token_slot = np.full((n_tok,), NUM_BLOCKS * BS, np.int32)
    token_lane = np.full((n_tok,), LANES, np.int32)
    ctx = np.zeros((LANES,), np.int32)
    rows = np.zeros((LANES,), np.int32)
    rng = np.random.default_rng(seed)
    cur = 0
    for lane, start, n in spans:
        pos = np.arange(start, start + n)
        token_ids[cur: cur + n] = rng.integers(2, 480, n)
        token_pos[cur: cur + n] = pos
        token_slot[cur: cur + n] = tables[lane, pos // BS] * BS + pos % BS
        token_lane[cur: cur + n] = lane
        ctx[lane] = start + n
        rows[lane] = cur + n - 1
        cur += n
    return token_ids, token_pos, token_slot, token_lane, ctx, rows


@pytest.fixture(scope="module", params=VARIANTS)
def forward_models(request):
    cfg, jcfg = configs(request.param)
    jparams = jax_mixtral.init_params(jcfg, jax.random.PRNGKey(1))
    return cfg, jcfg, mixtral.params_from_jax(tree_to_numpy(jparams), device="cpu"), jparams


def close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_split_prefill_forwards_match_reference(forward_models):
    """A whole prompt padded to its bucket, then a continued prefill over
    its resident prefix (block-aligned), on one cache."""
    cfg, jcfg, params, jparams = forward_models
    family = get_family("mixtral")
    cache = family.init_kv_cache(cfg, NUM_BLOCKS, BS, None, "cpu")
    jcache = jax_llama.init_kv_cache(jcfg, NUM_BLOCKS, BS)
    cos, sin = family.make_rope_tables(cfg, "cpu")
    jcos, jsin = jax_llama.make_rope_tables(jcfg)
    block_ids = np.array([5, 2, 9, 11, 0, 0, 0, 0], np.int32)
    tokens = np.random.default_rng(3).integers(2, 480, 16).astype(np.int32)
    ref, jcache = jax_mixtral.mixtral_forward_prefill(
        jparams, jcfg, jnp.asarray(tokens), jcache, jnp.asarray(block_ids),
        jnp.int32(11), jnp.int32(0), jcos, jsin)
    ours, _ = mixtral.mixtral_forward_prefill(params, cfg, t(tokens), cache, t(block_ids),
                                              torch.tensor(11), 0, cos, sin)
    close(ours, ref)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)
    tail = np.random.default_rng(4).integers(2, 480, 8).astype(np.int32)
    tail_ids = np.array([9, 11, 0, 0, 0, 0, 0, 0], np.int32)
    ref, jcache = jax_mixtral.mixtral_forward_prefill_with_prefix(
        jparams, jcfg, jnp.asarray(tail), jcache, jnp.asarray(block_ids),
        jnp.asarray(tail_ids), jnp.int32(5), jnp.int32(8), jcos, jsin)
    ours, _ = mixtral.mixtral_forward_prefill_with_prefix(
        params, cfg, t(tail), cache, t(block_ids), t(tail_ids), torch.tensor(5),
        torch.tensor(8), cos, sin)
    close(ours, ref)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)


def test_unified_decode_and_verify_match_reference_kernels(forward_models):
    """Three windows on one cache through the reference's Pallas kernels in
    interpret mode and the port's wrappers: a unified prefill of three
    lanes, a mixed unified window (decode tokens, a continuing span, pads),
    a decode batch, then a verify window of 3 positions a lane (one lane
    idle)."""
    cfg, jcfg, params, jparams = forward_models
    family = get_family("mixtral")
    tables = np.random.default_rng(0).permutation(NUM_BLOCKS).astype(np.int32).reshape(4, 4)[:LANES]
    cache = family.init_kv_cache(cfg, NUM_BLOCKS, BS, None, "cpu")
    jcache = jax_llama.init_kv_cache(jcfg, NUM_BLOCKS, BS)
    cos, sin = family.make_rope_tables(cfg, "cpu")
    jcos, jsin = jax_llama.make_rope_tables(jcfg)
    for seed, spans in enumerate(([(0, 0, 10), (1, 0, 5), (2, 0, 7)],
                                  [(0, 10, 1), (1, 5, 4), (2, 7, 1)])):
        token_ids, token_pos, token_slot, token_lane, ctx, rows = ragged_batch(spans, tables,
                                                                              seed)
        meta = pack_page_meta(token_lane, token_pos, tables, tb_tokens=TB, block_size=BS)
        jmeta = jax_pack_page_meta(token_lane, token_pos, tables, tb_tokens=TB, block_size=BS)
        ref, jcache = jax_mixtral.mixtral_forward_unified(
            jparams, jcfg, jnp.asarray(token_ids), jcache,
            *(jnp.asarray(a) for a in (tables, ctx, token_pos, token_slot, token_lane)),
            *(jnp.asarray(a) for a in jmeta), jnp.asarray(rows), jcos, jsin,
            attention="pallas_interpret", tb_tokens=TB)
        ours, out_cache = mixtral.mixtral_forward_unified(
            params, cfg, t(token_ids), cache, t(tables), t(ctx), t(token_pos), t(token_slot),
            t(token_lane), *(t(a) for a in meta), t(rows), cos, sin, tb_tokens=TB)
        assert out_cache is cache  # updated in place
        close(ours, ref)
        assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)

    ctx = np.array([12, 10, 9], np.int32)
    pos = ctx - 1
    slots = tables[np.arange(LANES), pos // BS] * BS + pos % BS
    token_ids = np.array([7, 300, 42], np.int32)
    ref, jcache = jax_mixtral.mixtral_forward_decode(
        jparams, jcfg, jnp.asarray(token_ids), jcache, jnp.asarray(tables), jnp.asarray(ctx),
        jnp.asarray(slots), jcos, jsin, attention="pallas_interpret")
    ours, _ = mixtral.mixtral_forward_decode(params, cfg, t(token_ids), cache, t(tables),
                                             t(ctx), t(slots), cos, sin)
    close(ours, ref)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)

    w = 3
    ctx = np.array([15, 13, 0], np.int32)  # lane 2 idle
    pos = np.maximum(ctx[:, None] - w + np.arange(w)[None, :], 0)
    slots = np.where(ctx[:, None] > 0, tables[np.arange(LANES)[:, None], pos // BS] * BS
                     + pos % BS, NUM_BLOCKS * BS).astype(np.int32)
    tokens = np.random.default_rng(9).integers(2, 480, (LANES, w)).astype(np.int32)
    ref, jcache = jax_mixtral.mixtral_forward_verify(
        jparams, jcfg, jnp.asarray(tokens), jcache, jnp.asarray(tables), jnp.asarray(ctx),
        jnp.asarray(slots), jcos, jsin, attention="pallas_interpret")
    ours, _ = mixtral.mixtral_forward_verify(params, cfg, t(tokens), cache, t(tables),
                                             t(ctx), t(slots), cos, sin)
    live = ctx > 0
    np.testing.assert_allclose(ours.numpy()[live], np.asarray(ref)[live], atol=ATOL, rtol=0)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)


def test_verify_dispatches_position_major():
    """At a capacity that drops tokens, the verify window's experts fill
    their slots position-major, as the reference's: the logits of the
    same window still match."""
    cfg, jcfg = configs("mixtral")
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    jcfg = dataclasses.replace(jcfg, capacity_factor=0.5)
    jparams = jax_mixtral.init_params(jcfg, jax.random.PRNGKey(5))
    params = mixtral.params_from_jax(tree_to_numpy(jparams), device="cpu")
    family = get_family("mixtral")
    tables = np.arange(12, dtype=np.int32).reshape(LANES, 4)
    ctx = np.array([9, 14, 6], np.int32)
    w = 4
    pos = ctx[:, None] - w + np.arange(w)[None, :]
    slots = (tables[np.arange(LANES)[:, None], pos // BS] * BS + pos % BS).astype(np.int32)
    tokens = np.random.default_rng(2).integers(2, 480, (LANES, w)).astype(np.int32)
    cache = family.init_kv_cache(cfg, NUM_BLOCKS, BS, None, "cpu")
    cos, sin = family.make_rope_tables(cfg, "cpu")
    jcos, jsin = jax_llama.make_rope_tables(jcfg)
    ref, _ = jax_mixtral.mixtral_forward_verify(
        jparams, jcfg, jnp.asarray(tokens), jax_llama.init_kv_cache(jcfg, NUM_BLOCKS, BS), jnp.asarray(tables),
        jnp.asarray(ctx), jnp.asarray(slots), jcos, jsin)
    ours, _ = mixtral.mixtral_forward_verify(params, cfg, t(tokens), cache, t(tables),
                                             t(ctx), t(slots), cos, sin)
    close(ours, ref)


# ---------------------------------------------------------------------------
# the engine: TorchLlmEngine against JaxLlmEngine
# ---------------------------------------------------------------------------

ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32, 64),
              max_model_len=128, decode_overlap=False)


@pytest.fixture(scope="module")
def engine_models():
    out = {}
    for variant in VARIANTS:
        cfg, jcfg = configs(variant)
        jparams = jax_mixtral.init_params(jcfg, jax.random.PRNGKey(3))
        out[variant] = (cfg, jcfg, mixtral.params_from_jax(tree_to_numpy(jparams), "cpu"),
                        jparams)
    return out


async def run_both(models, variant, reqs, jax_kw=None, **overrides):
    """The same requests through both engines, every request queued before
    the engine thread starts; (ours, ref, our stats, ref stats)."""
    cfg, jcfg, params, jparams = models[variant]
    kw = {**ENGINE, "model_family": variant, **overrides}
    engines = (
        (JaxLlmEngine(JaxEngineConfig(model=jcfg, **kw, **(jax_kw or {})), params=jparams),
         JaxContext),
        (TorchLlmEngine(EngineConfig(model=cfg, **kw), params=params, device="cpu"), Context),
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
    return out[1], out[0], engines[1][0].stats(), engines[0][0].stats()


SEEDED = SamplingOptions(temperature=6.0, seed=77, frequency_penalty=1.0)


@pytest.mark.parametrize("variant", VARIANTS)
async def test_engine_streams_match_reference(engine_models, variant):
    """Greedy and seeded lanes with the unified step on and chunked
    prefill, then a prompt that extends a served one (a prefix-cache hit)."""
    shared = list(range(40, 60))
    reqs = [request(range(3 + 5 * i, 12 + 9 * i), max_tokens=8, ignore_eos=True)
            for i in range(2)]
    reqs.append(request(range(100, 137), 8, SEEDED, ignore_eos=True))
    reqs.append(request(shared, max_tokens=4, ignore_eos=True))
    ours, ref, stats, _ = await run_both(engine_models, variant, reqs,
                                         jax_kw=dict(unified_batch=True),
                                         prefill_chunk_tokens=8)
    assert ours == ref
    assert stats["decode_windows_unified_total"] > 0
    assert not stats["unified_fallbacks"]
    again, ref_again, stats, _ = await run_both(
        engine_models, variant,
        [request(shared, max_tokens=4, ignore_eos=True),
         request(shared + [7, 8, 9], max_tokens=6, ignore_eos=True)],
        jax_kw=dict(unified_batch=True))
    assert again == ref_again


async def test_speculative_streams_match_reference(engine_models):
    """n-gram speculation on Mixtral: the verify window through the
    reference's Pallas window kernel in interpret mode and the port's
    wrapper; the same streams and draft counts."""
    pattern = [5, 6, 7, 8] * 5
    reqs = [request(pattern, max_tokens=12, ignore_eos=True),
            request(list(range(20, 32)), max_tokens=10, ignore_eos=True)]
    ours, ref, stats, ref_stats = await run_both(
        engine_models, "mixtral", reqs, jax_kw=dict(attention_impl="pallas_interpret"),
        speculative="ngram", spec_tokens=3)
    assert ours == ref
    for key in ("spec_drafted_tokens_total", "spec_accepted_tokens_total"):
        assert stats[key] == ref_stats[key], key
    assert stats["spec_drafted_tokens_total"] > 0
    assert stats["unified_fallbacks"] == {"speculative": 1}


async def test_int8_streams_match_reference(engine_models):
    """int8 expert banks and projections (per layer, expert and
    out-channel): greedy and seeded streams byte-identical."""
    reqs = [request(range(3 + i, 13 + i), max_tokens=6, ignore_eos=True) for i in range(2)]
    reqs.append(request(range(3, 20), 8, SEEDED, ignore_eos=True))
    ours, ref, stats, _ = await run_both(engine_models, "qwen3_moe", reqs,
                                         jax_kw=dict(unified_batch=True), quantize="int8",
                                         prefill_chunk_tokens=8)
    assert ours == ref
    assert stats["quantize"] == "int8"
    assert stats["decode_windows_unified_total"] > 0
