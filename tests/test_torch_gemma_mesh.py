"""Gemma-2 and Gemma-3 text on a mesh, against the reference's.

Each rank's ``shard_params`` slice bitwise the reference's ``NamedSharding``
shard of the same leaf (``param_specs`` at tp = 2 and pp = 2, and int8 at
tp = 2); the prefill, continued prefill and decode forwards on gloo ranks
(``tests/torch_ranks.py``) at tp = 2 and pp = 2 (a stage's layers keeping
their windows and, on Gemma-3, their rope tables by their place in the
model) against the reference's jitted forwards on the same mesh, logits
within f32 1e-4; and the port's engines at tp = 2 and pp = 2, their greedy
and seeded streams equal to ``JaxLlmEngine``'s on the same mesh."""

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
from dynamo_tpu.models import gemma2 as jg2
from dynamo_tpu.models import gemma3 as jg3
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.registry import get_family as jax_family
from dynamo_tpu.ops.quant import quantize_params as jax_quantize
from dynamo_tpu.ops.quant import quantize_specs as jax_quantize_specs
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import gemma2, gemma3
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_engine import collect, request
from tests.test_torch_mesh import assert_bitwise, port_meshes, ref_shards
from tests.torch_ranks import RankPool, plain_tree

ATOL = 1e-4
BLOCKS = (32, 4)
MODULES = {"gemma2": (gemma2, jg2), "gemma3": (gemma3, jg3)}


def configs(family: str):
    """(port cfg, reference cfg): the tiny geometry in float32; Gemma-3 at
    six layers (two stages of three, its global layer 5 on stage 1)."""
    ours, ref = (m.Gemma2Config if family == "gemma2" else m.Gemma3Config
                 for m in MODULES[family])
    over = {} if family == "gemma2" else dict(num_layers=6, global_layers=())
    return (dataclasses.replace(ours.tiny(), dtype=torch.float32, **over),
            dataclasses.replace(ref.tiny(), dtype=jnp.float32, **over))


def reference_tree(family: str, seed: int = 0):
    _, jcfg = configs(family)
    return jax.tree.map(np.asarray, MODULES[family][1].init_params(jcfg, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("family", sorted(MODULES))
@pytest.mark.parametrize("sizes,int8", [(dict(tp=2), False), (dict(pp=2), False),
                                        (dict(tp=2), True)])
def test_shards_are_the_reference_shards(family, sizes, int8):
    mod, jmod = MODULES[family]
    cfg, jcfg = configs(family)
    tree, specs = reference_tree(family), jmod.param_specs(jcfg)
    assert jax.tree.map(tuple, specs) == mod.param_specs(cfg)
    if int8:
        leaves = jax_family(family).quant_leaves
        tree, specs = jax_quantize(tree, leaves), jax_quantize_specs(specs, leaves)
    ref = ref_shards(tree, specs, sizes)
    full = params_from_jax(plain_tree(jax.tree.map(np.asarray, tree)), "cpu")
    for rank, mesh in enumerate(port_meshes(sizes)):
        assert_bitwise(mod.shard_params(full, cfg, mesh), ref[rank])


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def steps():
    """A prompt of 12 tokens (past the tiny sliding window of 8), a
    continued window of 5 over it, then a decode batch of two lanes."""
    rng = np.random.default_rng(2)
    prompt = np.zeros(16, np.int32)
    prompt[:12] = rng.integers(0, 480, 12)
    tail = np.zeros(16, np.int32)
    tail[:5] = rng.integers(0, 480, 5)
    ids = np.arange(8, dtype=np.int32)
    tail_ids = np.zeros(8, np.int32)
    tail_ids[:5] = ids[3:]
    tables = np.stack([ids, ids + 8]).astype(np.int32)
    return [
        ("prefill", [prompt, ids, np.int32(12), np.int32(0)]),
        ("prefix", [tail, ids, tail_ids, np.int32(5), np.int32(12)]),
        ("decode", [rng.integers(0, 480, 2).astype(np.int32), tables,
                    np.array([18, 1], np.int32), np.array([17, 32], np.int32)]),
    ]


def reference_logits(family: str, tree, sizes: dict) -> list:
    jmod = MODULES[family][1]
    _, jcfg = configs(family)
    mesh = jmesh.make_mesh(jmesh.MeshConfig(**sizes), devices=jax.devices()[:2])
    params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree,
                          jmod.param_specs(jcfg))
    cache = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, jl.kv_cache_spec())),
                         jl.init_kv_cache(jcfg, *BLOCKS))
    cos, sin = jmod.make_rope_tables(jcfg)
    fwd = getattr(jmod, f"{family}_forward_prefill")
    pre = getattr(jmod, f"{family}_forward_prefill_with_prefix")
    dec = getattr(jmod, f"{family}_forward_decode")
    fns = {"prefill": jax.jit(lambda p, c, *a: fwd(p, jcfg, a[0], c, *a[1:], cos, sin)),
           "prefix": jax.jit(lambda p, c, *a: pre(p, jcfg, a[0], c, *a[1:], cos, sin)),
           "decode": jax.jit(lambda p, c, *a: dec(p, jcfg, a[0], c, *a[1:], cos, sin))}
    out = []
    for kind, inputs in steps():
        logits, cache = fns[kind](params, cache, *[jnp.asarray(a) for a in inputs])
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("family", sorted(MODULES))
@pytest.mark.parametrize("sizes", [dict(tp=2), dict(pp=2)])
def test_forwards_match_the_reference_mesh(pool, family, sizes):
    cfg, _ = configs(family)
    tree = reference_tree(family, 1)
    ref = reference_logits(family, tree, sizes)
    ours = pool.run(2, sizes, "forwards", family=family, cfg=cfg, params=tree, blocks=BLOCKS,
                    steps=steps())
    for (kind, _), a, b in zip(steps(), ours, ref):
        assert a.shape == b.shape, kind
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=kind)


ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32, 64),
              max_model_len=96, decode_overlap=False, prefill_chunk_tokens=8)


async def _serve(engine, ctx_cls, reqs):
    engine.start()
    try:
        first = await asyncio.gather(*[collect(engine, r, ctx_cls) for r in reqs[:2]])
        rest = await asyncio.gather(*[collect(engine, r, ctx_cls) for r in reqs[2:]])
        return first + rest, engine.stats()
    finally:
        engine.stop()


@pytest.mark.parametrize("family", sorted(MODULES))
@pytest.mark.parametrize("sizes", [dict(tp=2), dict(pp=2)])
def test_engine_streams_match_the_reference_mesh_engine(family, sizes):
    """Greedy and seeded streams of the port's Gemma engines on the mesh
    (the split step: no unified forward; on pp the stages in turn) equal the
    reference engine's on the same mesh, a prefix hit and chunked prefill
    included."""
    cfg, jcfg = configs(family)
    tree = reference_tree(family, 2)
    shared = list(range(3, 23))
    reqs = [request(shared + [30], 6, SamplingOptions(temperature=1.5, seed=5),
                    ignore_eos=True),
            request(range(100, 106), 6, ignore_eos=True),
            request(shared + [40], 5, ignore_eos=True)]
    ref, _ = asyncio.run(_serve(JaxLlmEngine(JaxEngineConfig(
        model=jcfg, model_family=family, mesh=jmesh.MeshConfig(**sizes), **ENGINE),
        params=tree), JaxContext, reqs))
    ours, stats = asyncio.run(_serve(TorchLlmEngine(EngineConfig(
        model=cfg, model_family=family, mesh=MeshConfig(**sizes), **ENGINE),
        params=params_from_jax(tree, "cpu"), device="cpu"), Context, reqs))
    assert ours == ref
    assert stats["mesh"]["ranks"] == 2 and stats["prefix_hits_total"] >= 1
