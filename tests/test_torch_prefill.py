"""The port's split prefill path against the JAX reference, in float32 on
the CPU:
- the plain ops (write_prefill_kv, dense_causal_attention with and without
  a sliding window, gather_prefix_kv, prefill_attention_with_prefix) on the
  same numpy inputs, atol 2e-5 (float32 summation order);
- the llama and DeepSeek prefill forwards (whole prompt, then a continued
  chunk over the resident prefix): logits and caches within 1e-4;
- TorchLlmEngine against JaxLlmEngine with the unified step off (every
  prefill runs the split step): greedy and seeded streams over chunked
  prefill and a prefix-cache hit, for both families; and with the unified
  step on, a degenerate prefill window, which both engines hand to the
  split step."""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import deepseek as jax_ds
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.ops import attention as jax_attn
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import deepseek, llama
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.ops import attention as attn
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import BASE, CFG, JCFG, JPARAMS, PARAMS, collect, request
from tests.test_torch_llama import assert_trees_equal, tree_to_numpy

OP_ATOL = 2e-5
ATOL = 1e-4
BS, NBLOCKS = 4, 16


def t(a):
    return torch.from_numpy(np.array(a))


def close(ours, ref, atol=OP_ATOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=atol, rtol=atol)


# ---------------------------------------------------------------------------
# plain ops
# ---------------------------------------------------------------------------


def test_write_prefill_kv_and_gather_prefix_match_reference():
    rng = np.random.default_rng(0)
    k_cache = rng.standard_normal((NBLOCKS, BS, 2, 8)).astype(np.float32)
    v_cache = rng.standard_normal((NBLOCKS, BS, 2, 8)).astype(np.float32)
    k_new = rng.standard_normal((12, 2, 8)).astype(np.float32)
    v_new = rng.standard_normal((12, 2, 8)).astype(np.float32)
    block_ids = np.array([5, 2, 9, 0, 0], np.int32)  # padded table
    ref_k, ref_v = jax_attn.write_prefill_kv(
        *(jnp.asarray(a) for a in (k_cache, v_cache, k_new, v_new, block_ids)), jnp.int32(9))
    # the port's leaves carry the dump row its pad rows write
    ours_k, ours_v = (attn.alloc_cache_leaf((1, *a.shape), torch.float32, "cpu")[0].copy_(t(a))
                      for a in (k_cache, v_cache))
    out = attn.write_prefill_kv(ours_k, ours_v, t(k_new), t(v_new), t(block_ids), 9)
    assert out[0] is ours_k  # in place
    np.testing.assert_array_equal(ours_k.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(ours_v.numpy(), np.asarray(ref_v))
    gk, gv = attn.gather_prefix_kv(ours_k, ours_v, t(block_ids[:3]))
    rk, rv = jax_attn.gather_prefix_kv(ref_k, ref_v, jnp.asarray(block_ids[:3]))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("window", [None, 5], ids=["full", "sliding5"])
def test_dense_causal_attention_matches_reference(window):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 11, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    lens = np.array([11, 7], np.int32)
    ref = jax_attn.dense_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        sliding_window=window)
    ours = attn.dense_causal_attention(t(q), t(k), t(v), t(lens), sliding_window=window)
    close(ours, ref)


@pytest.mark.parametrize("window", [None, 6], ids=["full", "sliding6"])
def test_prefill_attention_with_prefix_matches_reference(window):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((8, 4, 16)).astype(np.float32)
    k_new = rng.standard_normal((8, 2, 16)).astype(np.float32)
    v_new = rng.standard_normal((8, 2, 16)).astype(np.float32)
    k_pre = rng.standard_normal((12, 2, 16)).astype(np.float32)
    v_pre = rng.standard_normal((12, 2, 16)).astype(np.float32)
    ref = jax_attn.prefill_attention_with_prefix(
        *(jnp.asarray(a) for a in (q, k_new, v_new, k_pre, v_pre)), jnp.int32(8),
        jnp.int32(5), sliding_window=window)
    ours = attn.prefill_attention_with_prefix(
        t(q), t(k_new), t(v_new), t(k_pre), t(v_pre), 8, 5, sliding_window=window)
    # rows past the 5 valid tail tokens attend real keys too: compare all
    close(ours, ref)


# ---------------------------------------------------------------------------
# prefill forwards
# ---------------------------------------------------------------------------


def prefill_both(fam_ours, fam_ref, params, jparams, cfg, jcfg, cache, jcache, cos, sin,
                 jcos, jsin, tokens, table):
    """A 13-token prompt: the first 8 tokens as a whole-prompt prefill (bucket
    16 with padding), then the last 5 as a continued chunk over the resident
    prefix (bucket 8).  Returns nothing; asserts logits and caches."""
    ids = np.zeros((16,), np.int32)
    ids[:8] = tokens[:8]
    block_ids = np.zeros((6,), np.int32)
    block_ids[: len(table)] = table
    ref, jcache = fam_ref[0](jparams, jcfg, jnp.asarray(ids), jcache, jnp.asarray(block_ids),
                             jnp.int32(8), jnp.int32(0), jcos, jsin)
    ours, out = fam_ours[0](params, cfg, t(ids), cache, t(block_ids), 8, 0, cos, sin)
    assert out is cache
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)

    tail = np.zeros((8,), np.int32)
    tail[:5] = tokens[8:13]
    full = np.zeros((6,), np.int32)
    full[: len(table)] = table
    tail_ids = np.zeros((6,), np.int32)
    tail_ids[: len(table) - 2] = table[2:]
    ref, jcache = fam_ref[1](jparams, jcfg, jnp.asarray(tail), jcache, jnp.asarray(full),
                             jnp.asarray(tail_ids), jnp.int32(5), jnp.int32(8), jcos, jsin)
    ours, _ = fam_ours[1](params, cfg, t(tail), cache, t(full), t(tail_ids), 5, 8, cos, sin)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)


@pytest.mark.parametrize("window", [None, 6], ids=["full", "sliding6"])
def test_llama_prefill_forwards_match_reference(window):
    jcfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(), sliding_window=window)
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), sliding_window=window)
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(4))
    params = params_from_jax(tree_to_numpy(jparams), device="cpu")
    jcos, jsin = jax_llama.make_rope_tables(jcfg)
    cos, sin = llama.make_rope_tables(cfg, device="cpu")
    tokens = np.random.default_rng(3).integers(2, 500, 13)
    prefill_both(
        (llama.llama_forward_prefill, llama.llama_forward_prefill_with_prefix),
        (jax_llama.llama_forward_prefill, jax_llama.llama_forward_prefill_with_prefix),
        params, jparams, cfg, jcfg, llama.init_kv_cache(cfg, NBLOCKS, BS, device="cpu"),
        jax_llama.init_kv_cache(jcfg, NBLOCKS, BS), cos, sin, jcos, jsin, tokens,
        np.array([7, 3, 11, 1], np.int32),
    )


@pytest.mark.parametrize("capacity", [4.0, 0.5], ids=["no_drops", "drops"])
def test_deepseek_prefill_forwards_match_reference(capacity):
    """tiny_mla, and a capacity factor that drops routed pairs (the padded
    bucket's pad tokens are routed too, as in the reference)."""
    jcfg = dataclasses.replace(jax_ds.DeepseekConfig.tiny_mla(), capacity_factor=capacity)
    cfg = dataclasses.replace(deepseek.DeepseekConfig.tiny_mla(), capacity_factor=capacity)
    jparams = jax_ds.init_params(jcfg, jax.random.PRNGKey(5))
    params = params_from_jax(tree_to_numpy(jparams), device="cpu")
    jcos, jsin = jax_ds.make_rope_tables(jcfg)
    cos, sin = deepseek.make_rope_tables(cfg, device="cpu")
    tokens = np.random.default_rng(4).integers(2, 500, 13)
    prefill_both(
        (deepseek.deepseek_forward_prefill, deepseek.deepseek_forward_prefill_with_prefix),
        (jax_ds.deepseek_forward_prefill, jax_ds.deepseek_forward_prefill_with_prefix),
        params, jparams, cfg, jcfg, deepseek.init_kv_cache(cfg, NBLOCKS, BS, device="cpu"),
        jax_ds.init_kv_cache(jcfg, NBLOCKS, BS), cos, sin, jcos, jsin, tokens,
        np.array([2, 14, 6, 9], np.int32),
    )


# ---------------------------------------------------------------------------
# the engine's split step against JaxLlmEngine
# ---------------------------------------------------------------------------


async def run_pair(jax_engine, ours_engine, batches, stagger_s=0.03):
    """Each batch of requests (staggered) through both engines, batch after
    batch on one engine; returns (ours, ref)."""
    out = []
    for engine, ctx_cls in ((jax_engine, JaxContext), (ours_engine, Context)):
        engine.start()
        try:
            results = []
            for batch in batches:
                tasks = []
                for r in batch:
                    tasks.append(asyncio.ensure_future(collect(engine, r, ctx_cls)))
                    await asyncio.sleep(stagger_s)
                results.append(await asyncio.gather(*tasks))
            out.append(results)
        finally:
            engine.stop()
    return out[1], out[0]


def split_batches():
    """Chunked prefills beside decoding lanes, a seeded lane with a
    penalty, then a prompt that extends a finished one (a prefix hit)."""
    seeded = SamplingOptions(temperature=6.0, seed=91, frequency_penalty=1.0)
    shared = list(range(40, 61))
    first = [request(range(3, 12), max_tokens=8, ignore_eos=True),
             request(range(100, 131), 8, seeded, ignore_eos=True),
             request(shared, max_tokens=4, ignore_eos=True)]
    second = [request(shared + [7, 8, 9], max_tokens=6, ignore_eos=True)]
    return [first, second]


async def test_split_step_streams_match_reference_llama():
    kw = dict(BASE, prefill_chunk_tokens=8, unified_batch=False)
    jax_engine = JaxLlmEngine(JaxEngineConfig(model=JCFG, decode_overlap=False, **kw),
                              params=JPARAMS)
    ours_engine = TorchLlmEngine(EngineConfig(model=CFG, **kw), params=PARAMS, device="cpu")
    ours, ref = await run_pair(jax_engine, ours_engine, split_batches())
    assert ours == ref
    assert ours[0][0][0] == list(range(12, 20))  # the token-counter weights
    stats = ours_engine.stats()
    assert stats["decode_windows_unified_total"] == 0
    assert stats["prefix_hits_total"] > 0
    assert ours_engine.chunk_tokens == 8 and not ours_engine.unified_batch


async def test_split_step_streams_match_reference_deepseek():
    jcfg = jax_ds.DeepseekConfig.tiny_mla(vocab_size=481)
    cfg = deepseek.DeepseekConfig.tiny_mla(vocab_size=481)
    jparams = jax_ds.init_params(jcfg, jax.random.PRNGKey(6))
    params = params_from_jax(tree_to_numpy(jparams), device="cpu")
    kw = dict(BASE, prefill_chunk_tokens=8, unified_batch=False, model_family="deepseek_v2")
    jax_engine = JaxLlmEngine(JaxEngineConfig(model=jcfg, decode_overlap=False, **kw),
                              params=jparams)
    ours_engine = TorchLlmEngine(EngineConfig(model=cfg, **kw), params=params, device="cpu")
    ours, ref = await run_pair(jax_engine, ours_engine, split_batches())
    assert ours == ref
    assert ours_engine.stats()["prefix_hits_total"] > 0


def force_degenerate_window(engine):
    """Wrap the engine's scheduler so that the first continuing chunk it
    plans is replaced by an empty one (end == start): a window the unified
    step cannot serve.  The scheduler never plans one itself."""
    scheduler = engine.scheduler
    plan = scheduler.schedule
    forced = []

    def schedule():
        decision = plan()
        for seq in decision.prefills:
            if not forced and seq.prefilled_tokens > seq.cached_tokens:
                seq.chunk_target = seq.prefilled_tokens
                forced.append(seq.seq_id)
        return decision

    scheduler.schedule = schedule
    return forced


async def test_degenerate_window_falls_back_to_split_step():
    kw = dict(BASE, prefill_chunk_tokens=8)
    jax_engine = JaxLlmEngine(
        JaxEngineConfig(model=JCFG, unified_batch=True, decode_overlap=False, **kw),
        params=JPARAMS)
    ours_engine = TorchLlmEngine(EngineConfig(model=CFG, **kw), params=PARAMS, device="cpu")
    forced = [force_degenerate_window(e) for e in (jax_engine, ours_engine)]
    reqs = [request(range(5, 9), max_tokens=10, ignore_eos=True),
            request(range(200, 230), max_tokens=6, ignore_eos=True)]
    ours, ref = await run_pair(jax_engine, ours_engine, [reqs])
    assert all(forced)
    assert ours == ref
    assert ours[0][1][0] == list(range(230, 236))
    stats = ours_engine.stats()
    assert stats["unified_fallbacks"] == {"degenerate_span": 1}
    assert stats["unified_fallbacks"] == jax_engine.stats()["unified_fallbacks"]
    assert stats["decode_windows_unified_total"] > 0
