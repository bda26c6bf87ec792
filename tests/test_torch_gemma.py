"""The port's Gemma-2 and Gemma-3 text families (dynamo_tpu_torch.models.
gemma2 / gemma3: ``gemma2``, ``gemma3``, ``gemma3_text``) against the JAX
reference, in float32 on the CPU:
- config parsing of the published gemma-2-2b and gemma-3-4b (text_config)
  files and the multimodal wrapper, the presets, the registry entries
  (no unified forward);
- the reference's behaviours copied as they are, fenced here: Gemma-2's
  even/odd windows ignore ``layer_types``, Gemma-3's every-sixth fallback
  ignores ``sliding_window_pattern``, ``Gemma3Config()``'s defaults are not
  gemma-3-4b's published config;
- the loaders ((1 + w) baked into every norm, Gemma-3's multimodal
  prefixes, an untied lm_head refused) on synthetic checkpoints;
- the split prefill, prefill-over-prefix, decode and verify forwards:
  logits and caches within 1e-4 (windows per layer, soft-capping, query
  scale, the dual rope tables);
- TorchLlmEngine against JaxLlmEngine on the split step: greedy and seeded
  streams byte-identical (a prefix-cache hit, chunked prefill), the
  ``no_family_forward`` fallback counted as the reference counts it, with
  n-gram speculation, and with int8 weights."""

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
from dynamo_tpu.models import gemma2 as jax_gemma2
from dynamo_tpu.models import gemma3 as jax_gemma3
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import gemma2, gemma3
from dynamo_tpu_torch.models.registry import get_family, known_families
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import collect, request
from tests.test_torch_llama import assert_trees_equal, tree_to_numpy

ATOL = 1e-4
NUM_BLOCKS, BS = 16, 4

# google/gemma-2-2b config.json (the values the engine reads)
GEMMA2_2B = {
    "model_type": "gemma2", "vocab_size": 256000, "hidden_size": 2304,
    "intermediate_size": 9216, "num_hidden_layers": 26, "num_attention_heads": 8,
    "num_key_value_heads": 4, "head_dim": 256, "max_position_embeddings": 8192,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "sliding_window": 4096,
    "query_pre_attn_scalar": 256, "attn_logit_softcapping": 50.0,
    "final_logit_softcapping": 30.0, "hidden_activation": "gelu_pytorch_tanh",
}
# google/gemma-3-4b-it config.json's text_config
GEMMA3_4B_TEXT = {
    "model_type": "gemma3_text", "vocab_size": 262208, "hidden_size": 2560,
    "intermediate_size": 10240, "num_hidden_layers": 34, "num_attention_heads": 8,
    "num_key_value_heads": 4, "head_dim": 256, "max_position_embeddings": 131072,
    "rms_norm_eps": 1e-6, "rope_theta": 1000000.0, "rope_local_base_freq": 10000.0,
    "rope_scaling": {"factor": 8.0, "rope_type": "linear"}, "sliding_window": 1024,
    "sliding_window_pattern": 6, "query_pre_attn_scalar": 256,
    "hidden_activation": "gelu_pytorch_tanh",
}
GEMMA3_4B = {"model_type": "gemma3", "text_config": GEMMA3_4B_TEXT,
             "vision_config": {"model_type": "siglip_vision_model"}}
MODULES = {"gemma2": (gemma2, jax_gemma2), "gemma3": (gemma3, jax_gemma3)}
CONFIGS = {"gemma2": (gemma2.Gemma2Config, jax_gemma2.Gemma2Config),
           "gemma3": (gemma3.Gemma3Config, jax_gemma3.Gemma3Config)}
VARIANTS = sorted(MODULES)


def t(a):
    return torch.from_numpy(np.array(a))


def configs(variant: str, **over):
    ours, ref = CONFIGS[variant]
    return (dataclasses.replace(ours.tiny(), dtype=torch.float32, **over),
            dataclasses.replace(ref.tiny(), dtype=jnp.float32, **over))


def fields_equal(ours, ref) -> None:
    names = {f.name for f in dataclasses.fields(ours)}
    assert names == {f.name for f in dataclasses.fields(ref)}
    for name in names - {"dtype"}:
        assert getattr(ours, name) == getattr(ref, name), name
    assert list(ours.layer_windows()) == [int(w) for w in np.asarray(ref.layer_windows())]
    assert ours.embed_scale == ref.embed_scale


def test_configs_from_published_files_match_reference():
    for conf, (ours_cls, ref_cls) in ((GEMMA2_2B, CONFIGS["gemma2"]),
                                      (GEMMA3_4B_TEXT, CONFIGS["gemma3"]),
                                      (GEMMA3_4B, CONFIGS["gemma3"])):
        fields_equal(ours_cls.from_hf_config(conf), ref_cls.from_hf_config(conf))
    for name in ("tiny",):
        for ours_cls, ref_cls in CONFIGS.values():
            fields_equal(getattr(ours_cls, name)(), getattr(ref_cls, name)())
    # Gemma2Config()'s defaults are gemma-2-2b's published widths
    assert gemma2.Gemma2Config.from_hf_config(GEMMA2_2B) == gemma2.Gemma2Config()
    g3 = gemma3.Gemma3Config.from_hf_config(GEMMA3_4B)
    assert g3 == gemma3.Gemma3Config.from_hf_config(GEMMA3_4B_TEXT)
    assert g3.layer_windows()[:6] == (1024,) * 5 + (0,)
    assert {"gemma2", "gemma3", "gemma3_text"} <= set(known_families())
    for name in ("gemma2", "gemma3", "gemma3_text"):
        family = get_family(name)
        assert family.forward_unified is None and family.unified_planner is None
        assert family.name == ("gemma2" if name == "gemma2" else "gemma3")
        assert family.quant_leaves == (
            "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


def test_reference_quirks_are_copied_as_they_are():
    """Fences on the reference's behaviour, kept by the port: each is a
    known gap, not a target."""
    # Gemma-2's windows alternate by layer parity whatever layer_types say
    all_full = {**GEMMA2_2B, "num_hidden_layers": 4,
                "layer_types": ["full_attention"] * 4}
    for cls in CONFIGS["gemma2"]:
        assert [int(w) for w in np.asarray(cls.from_hf_config(all_full).layer_windows())] == [
            4096, 0, 4096, 0]
    # Gemma-3 without layer_types makes every sixth layer global, whatever
    # sliding_window_pattern says
    pattern3 = {**GEMMA3_4B_TEXT, "num_hidden_layers": 6, "sliding_window_pattern": 3}
    for cls in CONFIGS["gemma3"]:
        assert tuple(cls.from_hf_config(pattern3).global_layers) == (False,) * 5 + (True,)
    # Gemma3Config()'s class defaults are not gemma-3-4b's published config:
    # window 4096 against 1024, no global rope scaling against linear x8
    preset, published = gemma3.Gemma3Config(), gemma3.Gemma3Config.from_hf_config(GEMMA3_4B)
    assert (preset.sliding_window, published.sliding_window) == (4096, 1024)
    assert preset.rope_scaling is None
    assert published.rope_scaling == {"factor": 8.0, "rope_type": "linear"}
    assert jax_gemma3.Gemma3Config().sliding_window == 4096


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_params_and_rope_tables_follow_the_reference(variant):
    cfg, jcfg = configs(variant)
    ours_mod, ref_mod = MODULES[variant]
    ours = ours_mod.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jax.eval_shape(lambda: ref_mod.init_params(jcfg, jax.random.PRNGKey(0)))
    shapes = lambda tree: {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)  # noqa: E731
                           for k, v in tree.items()}
    assert shapes(ours) == shapes(ref)
    scaled = dataclasses.replace(cfg, rope_scaling={"rope_type": "linear", "factor": 8.0})
    jscaled = dataclasses.replace(jcfg, rope_scaling={"rope_type": "linear", "factor": 8.0})
    cos, sin = ours_mod.make_rope_tables(scaled, "cpu", 64)
    jcos, jsin = ref_mod.make_rope_tables(jscaled)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos)[:64], atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin)[:64], atol=1e-6)


def export_hf(variant: str, cfg, params, path, prefix: str = "model.") -> None:
    """A synthetic HF checkpoint of ``params`` (numpy tree), every norm
    stored as the w of (1 + w); ``prefix`` names the text model's tensors
    (a multimodal checkpoint's ``language_model.model.``)."""
    layer_map = (gemma3 if variant == "gemma3" else gemma2)._HF_LAYER_MAP
    norms = gemma3._NORM_LEAVES
    out = {f"{prefix}embed_tokens.weight": params["embed"],
           f"{prefix}norm.weight": np.asarray(params["final_norm"]) - 1.0}
    for i in range(cfg.num_layers):
        for ours, theirs in layer_map.items():
            a = np.asarray(params["layers"][ours][i], np.float32)
            a = a - 1.0 if ours in norms else a.T
            out[theirs.format(i=i).replace("model.", prefix, 1)] = a
    if prefix != "model.":  # a multimodal checkpoint's vision tower
        out["vision_tower.patch.weight"] = np.zeros((4, 4), np.float32)
    save_file({k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in out.items()},
              str(path / "model.safetensors"))


@pytest.mark.parametrize("variant,prefix", [
    ("gemma2", "model."), ("gemma3", "model."), ("gemma3", "language_model.model."),
    ("gemma3", "model.language_model."),
])
def test_loaders_match_reference(variant, prefix, tmp_path):
    cfg, jcfg = configs(variant)
    ours_mod, ref_mod = MODULES[variant]
    params = tree_to_numpy(ref_mod.init_params(jcfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(0)
    for name, leaf in params["layers"].items():  # norms that are not all ones
        if "norm" in name:
            params["layers"][name] = leaf + rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    export_hf(variant, jcfg, params, tmp_path, prefix)
    ours = ours_mod.load_hf_weights(cfg, tmp_path, device="cpu")
    ref = tree_to_numpy(ref_mod.load_hf_weights(jcfg, tmp_path))
    assert_trees_equal(ours, ref)
    assert_trees_equal(ours, params, atol=1e-6)


@pytest.mark.parametrize("variant", VARIANTS)
def test_untied_unembedding_is_refused(variant, tmp_path):
    cfg, _ = configs(variant)
    save_file({"lm_head.weight": np.zeros((4, 4), np.float32)},
              str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="untied"):
        MODULES[variant][0].load_hf_weights(cfg, tmp_path, device="cpu")


@pytest.fixture(scope="module", params=VARIANTS)
def forward_models(request):
    cfg, jcfg = configs(request.param)
    ours_mod, ref_mod = MODULES[request.param]
    jparams = ref_mod.init_params(jcfg, jax.random.PRNGKey(1))
    return request.param, cfg, jcfg, ours_mod.params_from_jax(tree_to_numpy(jparams), "cpu"), jparams


def close(ours, ref, rows=slice(None)):
    np.testing.assert_allclose(ours.numpy()[rows], np.asarray(ref)[rows], atol=ATOL, rtol=0)


def test_forwards_match_reference(forward_models):
    """On one cache: whole prompts of 14, 5 and 9 tokens (past the tiny
    window of 8), a continued prefill over a resident prefix, a decode
    batch, and a verify window of 3 positions a lane (one lane idle)."""
    variant, cfg, jcfg, params, jparams = forward_models
    ours_mod, ref_mod = MODULES[variant]
    name = "gemma2" if variant == "gemma2" else "gemma3"
    fwd = lambda mod, kind: getattr(mod, f"{name}_forward_{kind}")  # noqa: E731
    tables = np.random.default_rng(0).permutation(NUM_BLOCKS).astype(np.int32).reshape(4, 4)[:3]
    cache = get_family(variant).init_kv_cache(cfg, NUM_BLOCKS, BS, None, "cpu")
    jcache = jax_llama.init_kv_cache(jcfg, NUM_BLOCKS, BS)
    cos, sin = ours_mod.make_rope_tables(cfg, "cpu")
    jcos, jsin = ref_mod.make_rope_tables(jcfg)
    rng = np.random.default_rng(3)
    for lane, n in ((0, 14), (1, 5)):
        tokens = rng.integers(2, 480, 16).astype(np.int32)
        ref, jcache = fwd(ref_mod, "prefill")(
            jparams, jcfg, jnp.asarray(tokens), jcache, jnp.asarray(tables[lane]),
            jnp.int32(n), jnp.int32(0), jcos, jsin)
        ours, _ = fwd(ours_mod, "prefill")(params, cfg, t(tokens), cache, t(tables[lane]),
                                           torch.tensor(n), 0, cos, sin)
        close(ours, ref)
    # lane 2: an 8-token prefix, then a 5-token tail over it
    head = rng.integers(2, 480, 8).astype(np.int32)
    ref, jcache = fwd(ref_mod, "prefill")(jparams, jcfg, jnp.asarray(head), jcache,
                                          jnp.asarray(tables[2]), jnp.int32(8), jnp.int32(0),
                                          jcos, jsin)
    fwd(ours_mod, "prefill")(params, cfg, t(head), cache, t(tables[2]), torch.tensor(8), 0,
                             cos, sin)
    tail = rng.integers(2, 480, 8).astype(np.int32)
    tail_ids = np.r_[tables[2][2:], [0, 0]].astype(np.int32)
    ref, jcache = fwd(ref_mod, "prefill_with_prefix")(
        jparams, jcfg, jnp.asarray(tail), jcache, jnp.asarray(tables[2]),
        jnp.asarray(tail_ids), jnp.int32(5), jnp.int32(8), jcos, jsin)
    ours, _ = fwd(ours_mod, "prefill_with_prefix")(
        params, cfg, t(tail), cache, t(tables[2]), t(tail_ids), torch.tensor(5),
        torch.tensor(8), cos, sin)
    close(ours, ref)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)

    ctx = np.array([15, 6, 14], np.int32)
    pos = ctx - 1
    slots = tables[np.arange(3), pos // BS] * BS + pos % BS
    token_ids = np.array([7, 300, 42], np.int32)
    ref, jcache = fwd(ref_mod, "decode")(
        jparams, jcfg, jnp.asarray(token_ids), jcache, jnp.asarray(tables), jnp.asarray(ctx),
        jnp.asarray(slots), jcos, jsin)
    ours, _ = fwd(ours_mod, "decode")(params, cfg, t(token_ids), cache, t(tables), t(ctx),
                                      t(slots), cos, sin)
    close(ours, ref)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)

    w = 3
    ctx = np.array([16, 0, 16], np.int32)  # lane 1 idle
    pos = np.maximum(ctx[:, None] - w + np.arange(w)[None, :], 0)
    slots = np.where(ctx[:, None] > 0, tables[np.arange(3)[:, None], pos // BS] * BS
                     + pos % BS, NUM_BLOCKS * BS).astype(np.int32)
    tokens = rng.integers(2, 480, (3, w)).astype(np.int32)
    ref, jcache = fwd(ref_mod, "verify")(
        jparams, jcfg, jnp.asarray(tokens), jcache, jnp.asarray(tables), jnp.asarray(ctx),
        jnp.asarray(slots), jcos, jsin)
    ours, _ = fwd(ours_mod, "verify")(params, cfg, t(tokens), cache, t(tables), t(ctx),
                                      t(slots), cos, sin)
    close(ours, ref, ctx > 0)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)


def test_softcaps_and_query_scale_reach_the_plain_ops():
    """A config with no soft-capping (HF's null or 0) and another query
    scale still matches the reference: the plain ops take what the config
    says."""
    cfg, jcfg = configs("gemma2", attn_logit_softcap=0.0, final_logit_softcap=0.0,
                        query_pre_attn_scalar=9.0)
    jparams = jax_gemma2.init_params(jcfg, jax.random.PRNGKey(4))
    params = gemma2.params_from_jax(tree_to_numpy(jparams), "cpu")
    cache = get_family("gemma2").init_kv_cache(cfg, NUM_BLOCKS, BS, None, "cpu")
    tokens = np.arange(5, 17, dtype=np.int32)
    ids = np.arange(4, dtype=np.int32)
    ref, _ = jax_gemma2.gemma2_forward_prefill(
        jparams, jcfg, jnp.asarray(tokens), jax_llama.init_kv_cache(jcfg, NUM_BLOCKS, BS),
        jnp.asarray(ids), jnp.int32(12), jnp.int32(0), *jax_gemma2.make_rope_tables(jcfg))
    ours, _ = gemma2.gemma2_forward_prefill(params, cfg, t(tokens), cache, t(ids),
                                            torch.tensor(12), 0,
                                            *gemma2.make_rope_tables(cfg, "cpu"))
    close(ours, ref)
    assert float(ours.abs().max()) > 0


# ---------------------------------------------------------------------------
# the engine: TorchLlmEngine against JaxLlmEngine, on the split step
# ---------------------------------------------------------------------------

ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32, 64),
              max_model_len=128, decode_overlap=False)
SEEDED = SamplingOptions(temperature=6.0, seed=77, frequency_penalty=1.0)


@pytest.fixture(scope="module")
def engine_models():
    out = {}
    for variant in VARIANTS:
        cfg, jcfg = configs(variant)
        ours_mod, ref_mod = MODULES[variant]
        jparams = ref_mod.init_params(jcfg, jax.random.PRNGKey(3))
        out[variant] = (cfg, jcfg, ours_mod.params_from_jax(tree_to_numpy(jparams), "cpu"),
                        jparams)
    return out


async def run_both(models, family, batches, **overrides):
    """Each batch of requests through both engines (queued before the
    engine thread starts, the next batch after the last finished, on one
    engine); (ours, ref, our stats, ref stats)."""
    key = "gemma2" if family == "gemma2" else "gemma3"
    cfg, jcfg, params, jparams = models[key]
    kw = {**ENGINE, "model_family": family, **overrides}
    engines = (
        (JaxLlmEngine(JaxEngineConfig(model=jcfg, unified_batch=True, **kw), params=jparams),
         JaxContext),
        (TorchLlmEngine(EngineConfig(model=cfg, **kw), params=params, device="cpu"), Context),
    )
    out = []
    for engine, ctx_cls in engines:
        results = []
        first = [asyncio.ensure_future(collect(engine, r, ctx_cls)) for r in batches[0]]
        await asyncio.sleep(0.05)
        engine.start()
        try:
            results.append(await asyncio.gather(*first))
            for batch in batches[1:]:
                results.append(await asyncio.gather(
                    *(collect(engine, r, ctx_cls) for r in batch)))
        finally:
            engine.stop()
        out.append(results)
    return out[1], out[0], engines[1][0].stats(), engines[0][0].stats()


@pytest.mark.parametrize("family", ["gemma2", "gemma3", "gemma3_text"])
async def test_engine_streams_match_reference(engine_models, family):
    """Greedy and seeded lanes past the tiny window, chunked prefill, then a
    prompt that extends a served one (a prefix-cache hit); both engines on
    the split step, the fallback counted alike."""
    shared = list(range(40, 60))
    first = [request(range(3 + 5 * i, 12 + 9 * i), max_tokens=8, ignore_eos=True)
             for i in range(2)]
    first.append(request(range(100, 137), 8, SEEDED, ignore_eos=True))
    first.append(request(shared, max_tokens=4, ignore_eos=True))
    second = [request(shared + [7, 8, 9], max_tokens=6, ignore_eos=True)]
    ours, ref, stats, ref_stats = await run_both(engine_models, family, [first, second],
                                                 prefill_chunk_tokens=8)
    assert ours == ref
    assert stats["unified_fallbacks"] == ref_stats["unified_fallbacks"] == {
        "no_family_forward": 1}
    assert stats["decode_windows_unified_total"] == 0
    assert stats["prefix_hits_total"] > 0


@pytest.mark.parametrize("family", VARIANTS)
async def test_speculative_streams_match_reference(engine_models, family):
    pattern = [5, 6, 7, 8] * 5
    reqs = [request(pattern, max_tokens=12, ignore_eos=True),
            request(list(range(20, 32)), max_tokens=10, ignore_eos=True)]
    ours, ref, stats, ref_stats = await run_both(engine_models, family, [reqs],
                                                 speculative="ngram", spec_tokens=3)
    assert ours == ref
    for key in ("spec_drafted_tokens_total", "spec_accepted_tokens_total"):
        assert stats[key] == ref_stats[key], key
    assert stats["spec_drafted_tokens_total"] > 0


async def test_int8_streams_match_reference(engine_models):
    reqs = [request(range(3 + i, 13 + i), max_tokens=6, ignore_eos=True) for i in range(2)]
    reqs.append(request(range(3, 20), 8, SEEDED, ignore_eos=True))
    ours, ref, stats, _ = await run_both(engine_models, "gemma2", [reqs], quantize="int8")
    assert ours == ref
    assert stats["quantize"] == "int8"
