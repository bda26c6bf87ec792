"""Prompt ids outside the vocabulary look up what the reference looks up.

The JAX package embeds with ``params["embed"][token_ids]``, and JAX's gather
counts a negative index from the end and clamps the result into the table;
torch's indexing raises there (on the card, a device-side assert).  The
port's lookups (``parallel/mesh.py`` ``embed_rows`` and
``vocab_parallel_embed``) take the reference's semantics.  Held here in
float32 on the CPU: the ids ``{-1, V, V+7, 7999}`` (and ``-V-3``) through the
llama, Mixtral and DeepSeek prefill and decode forwards against the JAX
package's within 1e-5 (and 1e-6 of the value), through a tp = 2 mesh's vocab-sharded embedding
against the reference's sharded forwards, and ``TorchLlmEngine``'s greedy
stream for a prompt holding ids >= V against ``JaxLlmEngine``'s."""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import deepseek as jax_ds
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.models import mixtral as jax_mixtral
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.models import deepseek, llama, mixtral
from dynamo_tpu_torch.models.registry import get_family
from dynamo_tpu_torch.parallel.mesh import clamp_token_ids, embed_rows
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_engine import collect, request
from tests.test_torch_llama import tree_to_numpy
from tests.torch_ranks import RankPool, plain_tree

V = 512
# float32: 1e-5, plus a millionth of the value (Mixtral's logits reach ~40,
# where one float32 step is 4e-6)
ATOL, RTOL = 1e-5, 1e-6
NUM_BLOCKS, BS = 16, 4
OOV = np.array([-1, V, V + 7, 7999], np.int32)


def t(a):
    return torch.from_numpy(np.array(a))


def test_clamp_follows_the_jax_gather():
    """A negative id counts from the end, then every id is clamped into
    the table; the same rows as JAX's gather, from a tensor op (no host
    check)."""
    table = np.arange(10.0, dtype=np.float32).reshape(5, 2)
    ids = np.array([1, 7, -1, -5, -7, 0, 4, 5, 100, -100], np.int32)
    ref = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    np.testing.assert_array_equal(embed_rows(t(table), t(ids)).numpy(), ref)
    assert clamp_token_ids(t(ids), 5).tolist() == [1, 4, 4, 0, 0, 0, 4, 4, 4, 0]
    assert clamp_token_ids(t(ids), 5).dtype == torch.int32


def prompt() -> np.ndarray:
    tokens = np.zeros(16, np.int32)
    tokens[:9] = [5, *OOV, 100, -V - 3, 3, V - 1]
    return tokens


def family_case(name: str):
    """(family module, reference module, cfg, jcfg, params, jparams, a
    fresh port cache and rope tables, reference cache and rope tables)."""
    if name == "deepseek":
        cfg, jcfg = deepseek.DeepseekConfig.tiny_mla(V), jax_ds.DeepseekConfig.tiny_mla(V)
        jparams = jax_ds.init_params(jcfg, jax.random.PRNGKey(1))
        params = llama.params_from_jax(tree_to_numpy(jparams), device="cpu")
        return (deepseek, jax_ds, cfg, jcfg, params, jparams,
                lambda: deepseek.init_kv_cache(cfg, NUM_BLOCKS, BS, device="cpu"),
                deepseek.make_rope_tables(cfg, device="cpu"),
                jax_ds.init_kv_cache(jcfg, NUM_BLOCKS, BS), jax_ds.make_rope_tables(jcfg))
    if name == "mixtral":
        over = dict(capacity_factor=4.0)
        cfg = dataclasses.replace(mixtral.MixtralConfig.tiny_moe(V), **over, dtype=torch.float32)
        jcfg = dataclasses.replace(jax_mixtral.MixtralConfig.tiny_moe(V), **over,
                                   dtype=jnp.float32)
        mod, ref = mixtral, jax_mixtral
    else:
        cfg = dataclasses.replace(llama.LlamaConfig.tiny(V), dtype=torch.float32)
        jcfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(V), dtype=jnp.float32)
        mod, ref = llama, jax_llama
    jparams = ref.init_params(jcfg, jax.random.PRNGKey(1))
    params = mod.params_from_jax(tree_to_numpy(jparams), device="cpu")
    fam = get_family(name)
    return (mod, ref, cfg, jcfg, params, jparams,
            lambda: fam.init_kv_cache(cfg, NUM_BLOCKS, BS, None, "cpu"),
            fam.make_rope_tables(cfg, "cpu"),
            jax_llama.init_kv_cache(jcfg, NUM_BLOCKS, BS), jax_llama.make_rope_tables(jcfg))


TABLES = np.array([[5, 2, 9, 0], [3, 4, 6, 7], [8, 10, 11, 12], [13, 14, 15, 1]], np.int32)
CTX = np.array([10, 1, 1, 1], np.int32)
SLOTS = np.array([9 * BS + 1, 3 * BS, 8 * BS, 13 * BS], np.int32)


@pytest.mark.parametrize("name", ["llama", "mixtral", "deepseek"])
def test_prefill_and_decode_logits_match_the_reference(name):
    """A prompt holding out-of-vocab ids through the prefill forward, then a
    decode batch of nothing but out-of-vocab ids, on one cache: logits (and
    so every row the ids read) are the reference's; the port's logits on
    the out-of-vocab ids equal its own on the clamped ids bitwise."""
    mod, ref, cfg, jcfg, params, jparams, new_cache, (cos, sin), jcache, (jcos, jsin) = \
        family_case(name)
    block_ids = np.array([5, 2, 9, 0], np.int32)

    def ours(tokens, decode_ids):
        cache = new_cache()
        first, cache = getattr(mod, f"{name}_forward_prefill")(
            params, cfg, t(tokens), cache, t(block_ids), torch.tensor(9), 0, cos, sin)
        second, _ = getattr(mod, f"{name}_forward_decode")(
            params, cfg, t(decode_ids), cache, t(TABLES), t(CTX), t(SLOTS), cos, sin)
        return first, second

    expected, jcache = getattr(ref, f"{name}_forward_prefill")(
        jparams, jcfg, jnp.asarray(prompt()), jcache, jnp.asarray(block_ids), jnp.int32(9),
        jnp.int32(0), jcos, jsin)
    expected_decode, _ = getattr(ref, f"{name}_forward_decode")(
        jparams, jcfg, jnp.asarray(OOV), jcache, jnp.asarray(TABLES), jnp.asarray(CTX),
        jnp.asarray(SLOTS), jcos, jsin)
    first, second = ours(prompt(), OOV)
    np.testing.assert_allclose(first.numpy(), np.asarray(expected), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(second.numpy(), np.asarray(expected_decode), atol=ATOL,
                               rtol=RTOL)
    clamped = ours(clamp_token_ids(t(prompt()), V).numpy(), clamp_token_ids(t(OOV), V).numpy())
    assert torch.equal(first, clamped[0]) and torch.equal(second, clamped[1])


GEOMETRY = dict(vocab_size=V, hidden_size=64, intermediate_size=128, num_layers=2,
                num_heads=8, num_kv_heads=4, head_dim=16, max_position_embeddings=256,
                rope_theta=10000.0, tie_word_embeddings=False)


def test_vocab_sharded_embedding_matches_the_reference_mesh(tmp_path):
    """tp = 2: each rank holds half of the vocabulary; an out-of-vocab id is
    clamped over the whole vocabulary before a rank tests its slice, so
    exactly one rank holds its row, the row the reference's sharded gather
    reads."""
    jcfg = jax_llama.LlamaConfig(**GEOMETRY, dtype=jnp.float32)
    cfg = llama.LlamaConfig(**GEOMETRY, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(3)))
    specs = jax_llama.param_specs(jcfg)
    assert specs["embed"][0] == "tp"  # the table is vocab-sharded
    ids = np.arange(8, dtype=np.int32)
    steps = [("prefill", [prompt(), ids, np.int32(9), np.int32(0)]),
             ("decode", [OOV, np.stack([ids, ids + 8, ids, ids + 8]).astype(np.int32),
                         np.array([10, 1, 11, 2], np.int32),
                         np.array([9, 32, 10, 33], np.int32)])]

    mesh = jmesh.make_mesh(jmesh.MeshConfig(tp=2), devices=jax.devices()[:2])
    params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)
    jcache = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, jax_llama.kv_cache_spec())),
        jax_llama.init_kv_cache(jcfg, 32, 4))
    jcos, jsin = jax_llama.make_rope_tables(jcfg)
    fns = {"prefill": jax.jit(lambda p, c, *a: jax_llama.llama_forward_prefill(
               p, jcfg, a[0], c, *a[1:], jcos, jsin)),
           "decode": jax.jit(lambda p, c, *a: jax_llama.llama_forward_decode(
               p, jcfg, a[0], c, *a[1:], jcos, jsin))}
    expected = []
    for kind, inputs in steps:
        logits, jcache = fns[kind](params, jcache, *[jnp.asarray(a) for a in inputs])
        expected.append(np.asarray(logits))

    pool = RankPool(2, tmp_path)
    try:
        ours = pool.run(2, dict(tp=2), "forwards", family="llama", cfg=cfg,
                        params=plain_tree(tree), blocks=(32, 4), steps=steps)
    finally:
        pool.close()
    for (kind, _), a, b in zip(steps, ours, expected):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=kind)


def test_engine_streams_match_the_reference_on_out_of_vocab_prompts():
    """``LlamaConfig.tiny()`` (vocab 512) with carried parameters: a prompt
    holding ids >= 512 (the scenario traffic draws from [10, 8000)) streams
    what ``JaxLlmEngine`` streams, where the port raised before."""
    jcfg = jax_llama.LlamaConfig.tiny()
    cfg = llama.LlamaConfig.tiny()
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    params = llama.params_from_jax(tree_to_numpy(jparams), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [request(rng.integers(10, 8000, 32).tolist(), 8, ignore_eos=True),
            request([3, 600, 7999, 511, 512, 40], 8, ignore_eos=True)]
    base = dict(num_blocks=64, block_size=16, max_batch_size=4, prefill_buckets=(64, 128),
                max_model_len=128)

    async def serve(engine, ctx_cls):
        engine.start()
        try:
            return await asyncio.gather(*[collect(engine, r, ctx_cls) for r in reqs])
        finally:
            engine.stop()

    ref = asyncio.run(serve(JaxLlmEngine(JaxEngineConfig(model=jcfg, **base), params=jparams),
                            JaxContext))
    ours = asyncio.run(serve(TorchLlmEngine(EngineConfig(model=cfg, **base), params=params,
                                            device="cpu"), Context))
    assert ours == ref
    assert all(len(tokens) == 8 for tokens, _ in ours)
