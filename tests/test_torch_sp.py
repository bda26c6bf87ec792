"""Sequence parallelism: the ring prefill against the reference's.

``ring_attention`` and ``ring_attention_with_prefix`` with the ring rotated
in one process (``ring_attention_local``) against the reference's functions
on an sp mesh of the 8 virtual CPU devices, at sp = 2 and 4 with padding,
float32 within 1e-5.  On gloo ranks (``tests/torch_ranks.py``): the llama
prefill, continued prefill and decode at sp = 2, 4 and sp x tp = 2 x 2
against the reference's forwards with ``sp_mesh``, logits within 1e-4, and
every rank's cache whole (replicated over sp) within 1e-5 of the
reference's.  The sp = 2 engine with a prefix hit and 16-token chunks, its
greedy and seeded streams against ``JaxLlmEngine`` on the same mesh; the
reference's sp construction checks, message for message, and its rule for
prefix caching under sp (kept for llama, turned off with its warning for a
family whose continued prefill does not ring)."""

import asyncio
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import mixtral as jmx
from dynamo_tpu.ops import ring_attention as jring
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import llama, mixtral
from dynamo_tpu_torch.ops.ring_attention import ring_attention_local, sequence_chunk
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_engine import collect, request
from tests.torch_ranks import RankPool

RING_ATOL = 1e-5
ATOL = 1e-4
CACHE_ATOL = 1e-5
GEOMETRY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                num_heads=8, num_kv_heads=4, head_dim=16, max_position_embeddings=256,
                rope_theta=10000.0, tie_word_embeddings=False)
JCFG = jl.LlamaConfig(**GEOMETRY, dtype=jnp.float32)
CFG = llama.LlamaConfig(**GEOMETRY, dtype=torch.float32)
BLOCKS = (32, 4)


def _sp_mesh(n: int):
    return jmesh.make_mesh(jmesh.MeshConfig(sp=n), devices=jax.devices()[:n])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("valid", [16, 11, 1])
def test_ring_attention_matches_the_reference(n, valid):
    rng = np.random.default_rng(n * 100 + valid)
    q = rng.normal(size=(1, 16, 4, 8)).astype(np.float32)
    k = rng.normal(size=(1, 16, 2, 8)).astype(np.float32)
    v = rng.normal(size=(1, 16, 2, 8)).astype(np.float32)
    ref = np.asarray(jring.ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.int32(valid), _sp_mesh(n)))
    ours = ring_attention_local(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                torch.tensor(valid), n).numpy()
    np.testing.assert_allclose(ours, ref, atol=RING_ATOL, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("prefix_len,tail_len", [(8, 11), (4, 16), (12, 3)])
def test_ring_attention_with_prefix_matches_the_reference(n, prefix_len, tail_len):
    rng = np.random.default_rng(n * 10 + prefix_len)
    q = rng.normal(size=(1, 16, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(1, 16, 2, 8)).astype(np.float32) for _ in range(2))
    kp, vp = (rng.normal(size=(1, 12, 2, 8)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jring.ring_attention_with_prefix(
        *(jnp.asarray(a) for a in (q, k, v, kp, vp)), jnp.int32(prefix_len), jnp.int32(tail_len),
        _sp_mesh(n)))
    ours = ring_attention_local(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.tensor(tail_len), n, k_prefix=torch.from_numpy(kp),
                                v_prefix=torch.from_numpy(vp),
                                prefix_len=torch.tensor(prefix_len)).numpy()
    np.testing.assert_allclose(ours, ref, atol=RING_ATOL, rtol=0)


def test_uneven_sequence_refused_like_the_reference():
    with pytest.raises(ValueError) as ref:
        jring.ring_attention(jnp.zeros((1, 6, 2, 8)), jnp.zeros((1, 6, 2, 8)),
                             jnp.zeros((1, 6, 2, 8)), jnp.int32(6), _sp_mesh(4))
    with pytest.raises(ValueError) as ours:
        sequence_chunk(6, 4)
    assert str(ours.value) == str(ref.value)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def steps():
    """A prompt of 13 tokens in a bucket of 16, a continued window of 7 over
    its 12 resident tokens, then a decode batch of two lanes."""
    rng = np.random.default_rng(1)
    prompt = np.zeros(16, np.int32)
    prompt[:13] = rng.integers(0, 512, 13)
    tail = np.zeros(16, np.int32)
    tail[:7] = rng.integers(0, 512, 7)
    ids = np.arange(8, dtype=np.int32)
    tail_ids = np.zeros(8, np.int32)
    tail_ids[:5] = ids[3:]
    tables = np.stack([ids, ids + 8]).astype(np.int32)
    return [
        ("prefill", [prompt, ids, np.int32(13), np.int32(0)]),
        ("prefix", [tail, ids, tail_ids, np.int32(7), np.int32(12)]),
        ("decode", [rng.integers(0, 512, 2).astype(np.int32), tables,
                    np.array([20, 1], np.int32), np.array([19, 32], np.int32)]),
    ]


def reference(sizes: dict, tree):
    cfg = jmesh.MeshConfig(**sizes)
    mesh = jmesh.make_mesh(cfg, devices=jax.devices()[:cfg.total()])
    params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree,
                          jl.param_specs(JCFG))
    cache = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, jl.kv_cache_spec())),
                         jl.init_kv_cache(JCFG, *BLOCKS))
    cos, sin = jl.make_rope_tables(JCFG)
    fns = {
        "prefill": jax.jit(lambda p, c, *a: jl.llama_forward_prefill(
            p, JCFG, a[0], c, *a[1:], cos, sin, sp_mesh=mesh)),
        "prefix": jax.jit(lambda p, c, *a: jl.llama_forward_prefill_with_prefix(
            p, JCFG, a[0], c, *a[1:], cos, sin, sp_mesh=mesh)),
        "decode": jax.jit(lambda p, c, *a: jl.llama_forward_decode(p, JCFG, a[0], c, *a[1:],
                                                                   cos, sin)),
    }
    out = []
    for kind, inputs in steps():
        logits, cache = fns[kind](params, cache, *[jnp.asarray(a) for a in inputs])
        out.append(np.asarray(logits))
    return out, jax.tree.map(np.asarray, cache)


@pytest.mark.parametrize("sizes", [dict(sp=2), dict(sp=4), dict(sp=2, tp=2)])
def test_ring_prefill_matches_the_reference_mesh(pool, sizes):
    tree = jax.tree.map(np.asarray, jl.init_params(JCFG, jax.random.PRNGKey(4)))
    ref, ref_cache = reference(sizes, tree)
    ours, caches = pool.run(MeshConfig(**sizes).total(), sizes, "forwards", family="llama",
                            cfg=CFG, params=tree, blocks=BLOCKS, steps=steps(), caches=True)
    for (kind, _), a, b in zip(steps(), ours, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=kind)
    tp = sizes.get("tp", 1)
    for rank, mine in enumerate(caches):
        j = rank // sizes["sp"] if tp > 1 else 0  # the rank's tp index (sp innermost)
        kvh = GEOMETRY["num_kv_heads"] // tp
        for leaf in ("k", "v"):
            theirs = ref_cache[leaf][:, :, :, j * kvh:(j + 1) * kvh]
            np.testing.assert_allclose(mine[leaf], theirs, atol=CACHE_ATOL, rtol=0,
                                       err_msg=f"rank {rank} {leaf}")


SP_ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32),
                 max_model_len=64, decode_overlap=False, prefill_chunk_tokens=16)


async def _serve(engine, ctx_cls, reqs):
    engine.start()
    try:
        out = [await collect(engine, reqs[0], ctx_cls)]
        # then the same prompt again (a prefix hit) beside the others
        out += await asyncio.gather(*[collect(engine, r, ctx_cls) for r in reqs[1:]])
        return out, engine.stats()
    finally:
        engine.stop()


def test_sp_engine_streams_match_the_reference_mesh_engine():
    """The sp = 2 engine (prefix caching on, as the reference keeps it for
    llama): a 24-token prompt in chunks of 16 through the ring's continued
    prefill, the same prompt again as a prefix hit, a seeded request and a
    short one; every stream equal to the reference engine's on sp = 2."""
    tree = jax.tree.map(np.asarray, jl.init_params(JCFG, jax.random.PRNGKey(6)))
    prompt = list(range(3, 27))
    reqs = [request(prompt, 4, ignore_eos=True),
            request(prompt + [40, 41, 42, 43, 44], 6, ignore_eos=True),
            request(range(100, 110), 6, SamplingOptions(temperature=1.5, seed=9),
                    ignore_eos=True),
            request(range(200, 203), 4, ignore_eos=True)]
    jax_engine = JaxLlmEngine(JaxEngineConfig(model=JCFG, mesh=jmesh.MeshConfig(sp=2),
                                              **SP_ENGINE), params=tree)
    assert jax_engine.prefix_caching
    ref, _ = asyncio.run(_serve(jax_engine, JaxContext, reqs))
    engine = TorchLlmEngine(EngineConfig(model=CFG, mesh=MeshConfig(sp=2), **SP_ENGINE),
                            params=llama.params_from_jax(tree, "cpu"), device="cpu")
    assert engine.prefix_caching and engine.chunk_tokens == 16
    ours, stats = asyncio.run(_serve(engine, Context, reqs))
    assert ours == ref
    assert stats["mesh"]["sp"] == 2 and stats["prefix_hits_total"] >= 1


MOE = dict(GEOMETRY, intermediate_size=96, num_experts=4, experts_per_token=2)


def _refusals():
    """(mesh sizes, engine overrides, family, geometry): each trips one of
    the reference's sp checks."""
    return [
        (dict(sp=2), {}, "llama", dict(GEOMETRY, sliding_window=8)),
        (dict(sp=2), dict(num_blocks=32, block_size=4, max_batch_size=2,
                          prefill_buckets=(16, 33), max_model_len=33), "llama", GEOMETRY),
        (dict(sp=8), dict(block_size=4, prefill_buckets=(16, 32, 64), max_model_len=64,
                          prefill_chunk_tokens=10), "llama", GEOMETRY),
        (dict(sp=2), dict(prefill_chunk_tokens=16), "mixtral", MOE),
    ]


@pytest.mark.parametrize("sizes,over,family,geometry", _refusals())
def test_engine_refuses_sp_like_the_reference(sizes, over, family, geometry):
    mods = {"llama": (jl.LlamaConfig, llama.LlamaConfig),
            "mixtral": (jmx.MixtralConfig, mixtral.MixtralConfig)}[family]
    with pytest.raises(ValueError) as ref:
        JaxLlmEngine(JaxEngineConfig(model=mods[0](**geometry, dtype=jnp.float32),
                                     model_family=family, mesh=jmesh.MeshConfig(**sizes),
                                     **over))
    with pytest.raises(ValueError) as ours:
        TorchLlmEngine(EngineConfig(model=mods[1](**geometry, dtype=torch.float32),
                                    model_family=family, mesh=MeshConfig(**sizes), **over),
                       device="cpu")
    assert str(ours.value) == str(ref.value)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _warnings_of(name: str, build):
    """``build()``'s result and the warnings logger ``name`` logged."""
    handler, logger = _Records(), logging.getLogger(name)
    logger.addHandler(handler)
    try:
        return build(), handler.lines
    finally:
        logger.removeHandler(handler)


def test_sp_turns_prefix_caching_off_where_the_reference_does():
    """Mixtral's continued prefill has no ring: on an sp mesh the reference
    turns prefix caching off with a warning, and so does the port (whose
    prefix caching is otherwise always on); its prefills then run whole on
    every sp rank."""
    jcfg = jmx.MixtralConfig(**MOE, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jmx.init_params(jcfg, jax.random.PRNGKey(8)))
    over = dict(SP_ENGINE, prefill_chunk_tokens=None)
    ref, ref_said = _warnings_of("dynamo_tpu.engine", lambda: JaxLlmEngine(JaxEngineConfig(
        model=jcfg, model_family="mixtral", mesh=jmesh.MeshConfig(sp=2), **over), params=tree))
    engine, said = _warnings_of("dynamo_tpu_torch.engine", lambda: TorchLlmEngine(EngineConfig(
        model=mixtral.MixtralConfig(**MOE, dtype=torch.float32), model_family="mixtral",
        mesh=MeshConfig(sp=2), **over), params=llama.params_from_jax(tree, "cpu"),
        device="cpu"))
    assert not ref.prefix_caching
    assert not engine.prefix_caching and not engine.allocator.enable_prefix_caching
    words = ("sp mesh: disabling prefix caching (family 'mixtral''s continued-prefill path "
             "does not run ring attention)")
    assert words in ref_said and words in said
    reqs = [request(range(5, 25), 4, ignore_eos=True), request(range(5, 25), 4, ignore_eos=True)]
    ours, stats = asyncio.run(_serve(engine, Context, reqs))
    theirs, _ = asyncio.run(_serve(ref, JaxContext, reqs))
    assert ours == theirs and stats["prefix_hits_total"] == 0
