"""The port's llama model (dynamo_tpu_torch.models.llama) against the JAX
reference: weight loading, and the unified (mixed ragged batch) and decode
forwards — logits and updated caches at atol 1e-4 in float32."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.ops.pallas import pack_page_meta as jax_pack_page_meta
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.registry import get_family, known_families
from dynamo_tpu_torch.ops.kernels import pack_page_meta

MODEL_DIR = Path(__file__).parent / "data" / "tiny-chat-model"
ATOL = 1e-4
LANES, BS, NUM_BLOCKS, TB = 3, 4, 16, 4


def tree_to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def assert_trees_equal(ours: dict, ref: dict, atol=0.0):
    assert set(ours) == set(ref)
    for key, val in ours.items():
        if isinstance(val, dict):
            assert_trees_equal(val, ref[key], atol)
        else:
            np.testing.assert_allclose(val.float().numpy(), np.asarray(ref[key]), atol=atol, rtol=0)


def test_config_from_hf_matches_reference():
    ours = llama.LlamaConfig.from_hf_config(MODEL_DIR / "config.json")
    ref = jax_llama.LlamaConfig.from_hf_config(MODEL_DIR / "config.json")
    ours_fields = {f.name for f in dataclasses.fields(ours)} - {"dtype"}
    # the reference's gemma-only fields (mlp_activation, embed_scale) come
    # with the gemma slice of the port
    assert {f.name for f in dataclasses.fields(ref)} - ours_fields == {
        "dtype", "mlp_activation", "embed_scale"}
    for name in ours_fields:
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.dtype == torch.bfloat16
    assert llama.LlamaConfig.llama3_8b().num_kv_heads == 8
    assert {"llama", "mistral", "qwen2", "qwen3"} <= set(known_families())
    assert get_family("qwen2").config_from_hf(MODEL_DIR / "config.json").attention_bias


def test_load_hf_weights_and_params_from_jax_agree():
    cfg = dataclasses.replace(
        llama.LlamaConfig.from_hf_config(MODEL_DIR / "config.json"), dtype=torch.float32
    )
    jcfg = dataclasses.replace(
        jax_llama.LlamaConfig.from_hf_config(MODEL_DIR / "config.json"), dtype=jnp.float32
    )
    ours = llama.load_hf_weights(cfg, MODEL_DIR, device="cpu")
    ref = tree_to_numpy(jax_llama.load_hf_weights(jcfg, MODEL_DIR))
    assert_trees_equal(ours, ref)
    assert_trees_equal(llama.params_from_jax(ref, device="cpu"), ref)
    # bf16 leaves cross over bit for bit
    bf = {"w": np.asarray(jnp.arange(6, dtype=jnp.bfloat16))}
    assert llama.params_from_jax(bf, device="cpu")["w"].dtype == torch.bfloat16
    assert llama.params_from_jax(bf, device="cpu")["w"].tolist() == list(range(6))


def test_init_params_shapes_follow_the_reference():
    cfg = llama.LlamaConfig.tiny()
    gen = torch.Generator()
    gen.manual_seed(0)
    ours = llama.init_params(cfg, gen, device="cpu")
    ref = jax_llama.init_params(jax_llama.LlamaConfig.tiny(), jax.random.PRNGKey(0))
    flat_ours = {k: v.shape for k, v in ours["layers"].items()}
    flat_ref = {k: tuple(v.shape) for k, v in ref["layers"].items()}
    assert {k: tuple(s) for k, s in flat_ours.items()} == flat_ref
    assert ours["embed"].shape == ref["embed"].shape
    again = torch.Generator()
    again.manual_seed(0)
    assert torch.equal(llama.init_params(cfg, again, device="cpu")["layers"]["wq"], ours["layers"]["wq"])


@pytest.fixture(scope="module")
def models():
    jcfg = jax_llama.LlamaConfig.tiny()
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(1))
    cfg = llama.LlamaConfig.tiny()
    params = llama.params_from_jax(tree_to_numpy(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def ragged_batch(spans, tables):
    """(lane, start, length) spans packed densely, padded to whole TB blocks."""
    total = sum(n for _, _, n in spans)
    t = -(-total // TB) * TB + TB  # one extra block of pads
    token_ids = np.zeros((t,), np.int32)
    token_pos = np.full((t,), -1, np.int32)
    token_slot = np.full((t,), NUM_BLOCKS * BS, np.int32)
    token_lane = np.full((t,), LANES, np.int32)
    ctx = np.zeros((LANES,), np.int32)
    sample_rows = np.zeros((LANES,), np.int32)
    rng = np.random.default_rng(sum(n for _, _, n in spans))
    cur = 0
    for lane, start, n in spans:
        pos = np.arange(start, start + n)
        token_ids[cur: cur + n] = rng.integers(2, 500, n)
        token_pos[cur: cur + n] = pos
        token_slot[cur: cur + n] = tables[lane, pos // BS] * BS + pos % BS
        token_lane[cur: cur + n] = lane
        ctx[lane] = start + n
        sample_rows[lane] = cur + n - 1
        cur += n
    return token_ids, token_pos, token_slot, token_lane, ctx, sample_rows


def test_unified_then_decode_forwards_match_reference(models):
    """Three windows on one cache: a prefill of three lanes, a mixed window
    (decode tokens + a continuing span + padding), then a decode batch."""
    jcfg, jparams, cfg, params = models
    tables = np.random.default_rng(0).permutation(NUM_BLOCKS).astype(np.int32).reshape(LANES + 1, 4)[:LANES]
    jcache = jax_llama.init_kv_cache(jcfg, NUM_BLOCKS, BS)
    cache = llama.init_kv_cache(cfg, NUM_BLOCKS, BS, device="cpu")
    jcos, jsin = jax_llama.make_rope_tables(jcfg)
    cos, sin = llama.make_rope_tables(cfg, device="cpu")
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731

    for spans in ([(0, 0, 10), (1, 0, 5), (2, 0, 7)],
                  [(0, 10, 1), (1, 5, 4), (2, 7, 1)]):
        token_ids, token_pos, token_slot, token_lane, ctx, rows = ragged_batch(spans, tables)
        meta = pack_page_meta(token_lane, token_pos, tables, tb_tokens=TB, block_size=BS)
        for a, b in zip(meta, jax_pack_page_meta(token_lane, token_pos, tables, tb_tokens=TB, block_size=BS)):
            np.testing.assert_array_equal(a, b)
        ref_logits, jcache = jax_llama.llama_forward_unified(
            jparams, jcfg, jnp.asarray(token_ids), jcache, jnp.asarray(tables),
            jnp.asarray(ctx), jnp.asarray(token_pos), jnp.asarray(token_slot),
            jnp.asarray(token_lane), *(jnp.asarray(a) for a in meta),
            jnp.asarray(rows), jcos, jsin, attention="jax", tb_tokens=TB,
        )
        logits, out_cache = llama.llama_forward_unified(
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
    ref_logits, jcache = jax_llama.llama_forward_decode(
        jparams, jcfg, jnp.asarray(token_ids), jcache, jnp.asarray(tables),
        jnp.asarray(ctx), jnp.asarray(slots), jcos, jsin, attention="jax",
    )
    logits, _ = llama.llama_forward_decode(
        params, cfg, t(token_ids), cache, t(tables), t(ctx), t(slots), cos, sin,
    )
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL, rtol=0)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)
