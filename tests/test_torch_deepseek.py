"""The port's DeepSeek MLA + MoE family (dynamo_tpu_torch.models.deepseek)
against the JAX reference, in float32 on the CPU:
- config parsing of the published DeepSeek-V2-Lite config.json, the
  presets, and the yarn softmax scale;
- the unified (mixed ragged batch) and decode forwards: logits and updated
  latent caches within 1e-4, at tiny_mla and a q_lora_rank=0 variant with
  yarn rope scaling;
- load_hf_weights on a synthetic safetensors checkpoint;
- TorchLlmEngine against JaxLlmEngine (unified on, overlap off in both): identical
  greedy and seeded streams over staggered admission, chunked prefill, a
  prefix-cache hit and preemption, through both of the port's routes — a
  family with no sliding window, which the engine must not assume;
- serve_http over a deepseek_v2 config.json answering chat."""

import asyncio
import dataclasses
import json
import math
import shutil
from pathlib import Path

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import deepseek as jax_ds
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import deepseek
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.models.registry import get_family, known_families
from dynamo_tpu_torch.ops.kernels import pack_page_meta
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.serve import serve_http

from tests.test_torch_engine import collect, request
from tests.test_torch_llama import assert_trees_equal, tree_to_numpy

ATOL = 1e-4
LANES, BS, NUM_BLOCKS, TB = 3, 4, 16, 4
TINY_CHAT = Path(__file__).parent / "data" / "tiny-chat-model"
# deepseek-ai/DeepSeek-V2-Lite config.json (the published values the
# engine reads)
V2_LITE = {
    "model_type": "deepseek_v2", "vocab_size": 102400, "hidden_size": 2048,
    "intermediate_size": 10944, "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "num_key_value_heads": 16, "n_shared_experts": 2,
    "n_routed_experts": 64, "num_experts_per_tok": 6, "first_k_dense_replace": 1,
    "routed_scaling_factor": 1.0, "norm_topk_prob": False, "scoring_func": "softmax",
    "topk_method": "greedy", "n_group": 1, "topk_group": 1, "q_lora_rank": None,
    "kv_lora_rank": 512, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "v_head_dim": 128, "max_position_embeddings": 163840, "rms_norm_eps": 1e-6,
    "rope_theta": 10000, "rope_scaling": {
        "type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096},
    "tie_word_embeddings": False, "bos_token_id": 100000, "eos_token_id": 100001,
}
YARN_TINY = {"type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64,
             "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}


def t(a):
    return torch.from_numpy(np.array(a))


def test_config_from_published_v2_lite_matches_reference():
    ours = deepseek.DeepseekConfig.from_hf_config(V2_LITE)
    ref = jax_ds.DeepseekConfig.from_hf_config(V2_LITE)
    fields = {f.name for f in dataclasses.fields(ours)}
    assert fields == {f.name for f in dataclasses.fields(ref)}
    for name in fields - {"dtype"}:
        assert getattr(ours, name) == getattr(ref, name), name
    m = 0.1 * 0.707 * math.log(40) + 1
    assert ours.attn_scale == pytest.approx(192 ** -0.5 * m * m)
    assert ours.attn_scale == pytest.approx(ref.attn_scale)
    # the reference's preset is copied as it is (no rope scaling, normalized
    # top-k weights), unlike the published config
    preset = deepseek.DeepseekConfig.deepseek_v2_lite()
    assert (preset.rope_scaling, preset.norm_topk_prob) == (None, True)
    for name in ("deepseek_v2_lite", "deepseek_v3", "tiny_mla"):
        a, b = getattr(deepseek.DeepseekConfig, name)(), getattr(jax_ds.DeepseekConfig, name)()
        assert {f: getattr(a, f) for f in fields - {"dtype"}} == {
            f: getattr(b, f) for f in fields - {"dtype"}}
    assert {"deepseek_v2", "deepseek_v3"} <= set(known_families())
    assert get_family("deepseek_v3").name == "deepseek"
    assert get_family("deepseek_v2").config_from_hf(V2_LITE).num_experts == 64


@pytest.mark.parametrize("variant", ["tiny_mla", "no_q_lora"])
def test_init_params_and_cache_shapes_follow_the_reference(variant):
    cfg, jcfg = configs(variant)
    gen = torch.Generator().manual_seed(0)
    ours = deepseek.init_params(cfg, gen, device="cpu")
    ref = jax.eval_shape(lambda: jax_ds.init_params(jcfg, jax.random.PRNGKey(0)))
    shapes = lambda tree: {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)  # noqa: E731
                           for k, v in tree.items()}
    assert shapes(ours) == shapes(ref)
    cache = deepseek.init_kv_cache(cfg, 8, 4, device="cpu")
    jcache = jax_ds.init_kv_cache(jcfg, 8, 4)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in jcache.items()}


def configs(variant: str):
    cfg, jcfg = deepseek.DeepseekConfig.tiny_mla(), jax_ds.DeepseekConfig.tiny_mla()
    if variant == "no_q_lora":
        cfg = dataclasses.replace(cfg, q_lora_rank=0, rope_scaling=YARN_TINY)
        jcfg = dataclasses.replace(jcfg, q_lora_rank=0, rope_scaling=YARN_TINY)
    return cfg, jcfg


def ragged_batch(spans, tables):
    """(lane, start, length) spans packed densely, padded to whole TB blocks."""
    total = sum(n for _, _, n in spans)
    n_tok = -(-total // TB) * TB + TB  # one extra block of pads
    token_ids = np.zeros((n_tok,), np.int32)
    token_pos = np.full((n_tok,), -1, np.int32)
    token_slot = np.full((n_tok,), NUM_BLOCKS * BS, np.int32)
    token_lane = np.full((n_tok,), LANES, np.int32)
    ctx = np.zeros((LANES,), np.int32)
    rows = np.zeros((LANES,), np.int32)
    rng = np.random.default_rng(total)
    cur = 0
    for lane, start, n in spans:
        pos = np.arange(start, start + n)
        token_ids[cur: cur + n] = rng.integers(2, 500, n)
        token_pos[cur: cur + n] = pos
        token_slot[cur: cur + n] = tables[lane, pos // BS] * BS + pos % BS
        token_lane[cur: cur + n] = lane
        ctx[lane] = start + n
        rows[lane] = cur + n - 1
        cur += n
    return token_ids, token_pos, token_slot, token_lane, ctx, rows


@pytest.mark.parametrize("variant", ["tiny_mla", "no_q_lora"])
def test_unified_then_decode_forwards_match_reference(variant):
    """Three windows on one latent cache: a prefill of three lanes, a mixed
    window (decode tokens, a continuing span, padding), then a decode batch."""
    cfg, jcfg = configs(variant)
    jparams = jax_ds.init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_jax(tree_to_numpy(jparams), device="cpu")
    tables = np.random.default_rng(0).permutation(NUM_BLOCKS).astype(np.int32).reshape(4, 4)[:LANES]
    jcache = jax_ds.init_kv_cache(jcfg, NUM_BLOCKS, BS)
    cache = deepseek.init_kv_cache(cfg, NUM_BLOCKS, BS, device="cpu")
    jcos, jsin = jax_ds.make_rope_tables(jcfg)
    cos, sin = deepseek.make_rope_tables(cfg, device="cpu")
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)

    for spans in ([(0, 0, 10), (1, 0, 5), (2, 0, 7)], [(0, 10, 1), (1, 5, 4), (2, 7, 1)]):
        token_ids, token_pos, token_slot, token_lane, ctx, rows = ragged_batch(spans, tables)
        meta = pack_page_meta(token_lane, token_pos, tables, tb_tokens=TB, block_size=BS)
        ref_logits, jcache = jax_ds.deepseek_forward_unified(
            jparams, jcfg, *(jnp.asarray(a) for a in (token_ids,)), jcache,
            *(jnp.asarray(a) for a in (tables, ctx, token_pos, token_slot, token_lane)),
            *(jnp.asarray(a) for a in meta), jnp.asarray(rows), jcos, jsin,
            attention="jax", tb_tokens=TB,
        )
        logits, out_cache = deepseek.deepseek_forward_unified(
            params, cfg, t(token_ids), cache, t(tables), t(ctx), t(token_pos),
            t(token_slot), t(token_lane), *(t(a) for a in meta), t(rows), cos, sin,
            tb_tokens=TB,
        )
        assert out_cache is cache  # updated in place
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL, rtol=0)
        assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)

    ctx = np.array([12, 10, 9], np.int32)
    pos = ctx - 1
    slots = tables[np.arange(LANES), pos // BS] * BS + pos % BS
    token_ids = np.array([7, 300, 42], np.int32)
    ref_logits, jcache = jax_ds.deepseek_forward_decode(
        jparams, jcfg, jnp.asarray(token_ids), jcache, jnp.asarray(tables),
        jnp.asarray(ctx), jnp.asarray(slots), jcos, jsin, attention="jax",
    )
    logits, _ = deepseek.deepseek_forward_decode(
        params, cfg, t(token_ids), cache, t(tables), t(ctx), t(slots), cos, sin,
    )
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL, rtol=0)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)


def interleave(cols):
    """HF's interleaved rope column order (the inverse of the loaders'
    de-interleave)."""
    out = np.empty_like(cols)
    half = cols.shape[-1] // 2
    out[..., 0::2] = cols[..., :half]
    out[..., 1::2] = cols[..., half:]
    return out


def export_hf(cfg, params, path: Path) -> None:
    """A synthetic HF DeepSeek checkpoint holding ``params`` (numpy tree)."""
    H, nope, vd, r, rope = (cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim,
                            cfg.kv_lora_rank, cfg.qk_rope_head_dim)
    out = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]}
    tr = lambda a: np.ascontiguousarray(np.asarray(a, np.float32).T)  # noqa: E731

    def q_cols(w):
        w = np.asarray(w, np.float32).reshape(w.shape[0], H, nope + rope).copy()
        w[..., nope:] = interleave(w[..., nope:])
        return tr(w.reshape(w.shape[0], -1))

    for i in range(cfg.num_layers):
        stack, j = (("dense_layers", i) if i < cfg.first_k_dense
                    else ("moe_layers", i - cfg.first_k_dense))
        src = {k: np.asarray(v[j], np.float32) for k, v in params[stack].items()}
        p, mlp = f"model.layers.{i}.self_attn", f"model.layers.{i}.mlp"
        out[f"model.layers.{i}.input_layernorm.weight"] = src["attn_norm"]
        out[f"model.layers.{i}.post_attention_layernorm.weight"] = src["mlp_norm"]
        w_dkv = src["w_dkv"].copy()
        w_dkv[:, r:] = interleave(w_dkv[:, r:])
        out[f"{p}.kv_a_proj_with_mqa.weight"] = tr(w_dkv)
        out[f"{p}.kv_a_layernorm.weight"] = src["kv_norm"]
        w_uk = src["w_uk"].reshape(r, H, nope).transpose(1, 2, 0)
        w_uv = src["w_uv"].reshape(r, H, vd).transpose(1, 2, 0)
        out[f"{p}.kv_b_proj.weight"] = np.ascontiguousarray(
            np.concatenate([w_uk, w_uv], axis=1).reshape(H * (nope + vd), r))
        out[f"{p}.o_proj.weight"] = tr(src["wo"])
        if cfg.q_lora_rank:
            out[f"{p}.q_a_proj.weight"] = tr(src["w_dq"])
            out[f"{p}.q_a_layernorm.weight"] = src["q_norm"]
            out[f"{p}.q_b_proj.weight"] = q_cols(src["w_uq"])
        else:
            out[f"{p}.q_proj.weight"] = q_cols(src["wq"])
        if stack == "dense_layers":
            for proj in ("gate", "up", "down"):
                out[f"{mlp}.{proj}_proj.weight"] = tr(src[f"w_{proj}"])
            continue
        out[f"{mlp}.gate.weight"] = tr(src["w_router"])
        for e in range(cfg.num_experts):
            for proj in ("gate", "up", "down"):
                out[f"{mlp}.experts.{e}.{proj}_proj.weight"] = tr(src[f"w_{proj}"][e])
        for proj in ("gate", "up", "down"):
            out[f"{mlp}.shared_experts.{proj}_proj.weight"] = tr(src[f"ws_{proj}"])
    save_file({k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in out.items()},
              str(path / "model.safetensors"))


@pytest.mark.parametrize("variant", ["tiny_mla", "no_q_lora"])
def test_load_hf_weights_matches_reference_loader(variant, tmp_path):
    cfg, jcfg = configs(variant)
    params = tree_to_numpy(jax_ds.init_params(jcfg, jax.random.PRNGKey(2)))
    export_hf(jcfg, params, tmp_path)
    ours = deepseek.load_hf_weights(cfg, tmp_path, device="cpu")
    ref = tree_to_numpy(jax_ds.load_hf_weights(jcfg, tmp_path))
    assert_trees_equal(ours, ref)
    assert_trees_equal(ours, params)  # the round trip is exact


# ---------------------------------------------------------------------------
# the engine: TorchLlmEngine against JaxLlmEngine
# ---------------------------------------------------------------------------

ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32, 64),
              max_model_len=128)


@pytest.fixture(scope="module")
def engine_models():
    jcfg = jax_ds.DeepseekConfig.tiny_mla(vocab_size=481)
    cfg = deepseek.DeepseekConfig.tiny_mla(vocab_size=481)
    jparams = jax_ds.init_params(jcfg, jax.random.PRNGKey(3))
    return cfg, jcfg, params_from_jax(tree_to_numpy(jparams), device="cpu"), jparams


async def run_both(models, batches, **overrides):
    """Each batch of requests (staggered by ``stagger_s``) through both
    engines, batch after batch on one engine; returns (ours, ref, stats)."""
    cfg, jcfg, params, jparams = models
    kw = {**ENGINE, **overrides}
    stagger = kw.pop("stagger_s", 0.0)
    engines = (
        (JaxLlmEngine(JaxEngineConfig(model=jcfg, model_family="deepseek_v2",
                                      unified_batch=True, decode_overlap=False, **kw),
                      params=jparams), JaxContext),
        (TorchLlmEngine(EngineConfig(model=cfg, model_family="deepseek_v2",
                                     decode_overlap=False, **kw),
                        params=params, device="cpu"), Context),
    )
    out = []
    for engine, ctx_cls in engines:
        engine.start()
        try:
            results = []
            for batch in batches:
                tasks = []
                for r in batch:
                    tasks.append(asyncio.ensure_future(collect(engine, r, ctx_cls)))
                    if stagger:
                        await asyncio.sleep(stagger)
                results.append(await asyncio.gather(*tasks))
            out.append(results)
        finally:
            engine.stop()
    return out[1], out[0], engines[1][0].stats()


async def test_engine_streams_match_reference(engine_models):
    """Staggered admission with chunked prefill, greedy and seeded lanes,
    then a request whose prompt extends a finished one (a prefix-cache
    hit)."""
    assert not hasattr(engine_models[0], "sliding_window")
    seeded = SamplingOptions(temperature=6.0, seed=77, frequency_penalty=1.0)
    shared = list(range(40, 60))
    first = [request(range(3 + 5 * i, 12 + 9 * i), max_tokens=8, ignore_eos=True)
             for i in range(3)]
    first.append(request(range(100, 137), 8, seeded, ignore_eos=True))
    first.append(request(shared, max_tokens=4, ignore_eos=True))
    second = [request(shared + [7, 8, 9], max_tokens=6, ignore_eos=True)]
    ours, ref, stats = await run_both(engine_models, [first, second], stagger_s=0.03,
                                      prefill_chunk_tokens=8)
    assert ours == ref
    assert stats["decode_windows_unified_total"] > 0
    assert stats["decode_windows_sync_total"] > stats["decode_windows_unified_total"]
    assert stats["prefix_hits_total"] > 0


async def test_engine_preemption_matches_reference(engine_models):
    reqs = [request(range(3 + i, 10 + i), max_tokens=8, ignore_eos=True) for i in range(3)]
    ours, ref, stats = await run_both(engine_models, [reqs], num_blocks=10,
                                      max_model_len=40, prefill_buckets=(16, 32))
    assert ours == ref
    assert stats["num_preemptions_total"] > 0, "geometry failed to force preemption"


async def test_serve_http_answers_chat_over_a_deepseek_config(tmp_path):
    config = {**V2_LITE, "vocab_size": 481, "hidden_size": 64, "intermediate_size": 128,
              "moe_intermediate_size": 48, "num_hidden_layers": 2, "num_attention_heads": 4,
              "n_routed_experts": 4, "num_experts_per_tok": 2, "n_shared_experts": 1,
              "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
              "v_head_dim": 16, "max_position_embeddings": 2048, "bos_token_id": 0,
              "eos_token_id": 1, "rope_scaling": YARN_TINY}
    (tmp_path / "config.json").write_text(json.dumps(config))
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(TINY_CHAT / name, tmp_path / name)
    handle = await serve_http(tmp_path, model_name="ds", host="127.0.0.1", port=0,
                              device="cpu", num_blocks=64, max_batch_size=4,
                              max_model_len=128, prefill_buckets=(32, 64))
    try:
        async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{handle.service.port}",
                                     timeout=120) as client:
            bodies = [{"model": "ds", "max_tokens": 6, "temperature": 0, "ext": {"ignore_eos": True},
                       "messages": [{"role": "user", "content": f"hello number {i}"}]}
                      for i in range(2)]
            replies = await asyncio.gather(*(client.post("/v1/chat/completions", json=b)
                                             for b in bodies))
        stats = handle.engine.stats()
        family = handle.engine.family.name
    finally:
        await handle.shutdown()
    for r in replies:
        assert r.status_code == 200, r.text
        assert r.json()["usage"]["completion_tokens"] == 6
    assert family == "deepseek"
    assert stats["decode_windows_unified_total"] > 0
    assert stats["decode_steps_total"] > 0
