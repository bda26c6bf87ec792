"""Pipeline parallelism on gloo ranks against the reference's pp mesh.

The ranks are processes of their own (``tests/torch_ranks.py``: torch and
the port, no JAX); the reference runs here on the 8 virtual CPU devices.
Held: the llama forwards on a pp mesh (the prefill and continued prefill
stage by stage, the decode through ``pipeline_layer_stack`` in 2 and 4
microbatches, and pp x tp) against the reference's forwards and its
``llama_forward_decode_pp`` on the same ``MeshConfig``, logits within f32
1e-4, and every rank's cache shard (its stage's layers, its tp heads)
within 1e-5 of the reference's ``NamedSharding`` shard; the reference's pp
construction checks, message for message; and the mesh's point-to-point
helpers on three ranks.  The pp engines: ``tests/test_torch_pp_engine.py``."""


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
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.models import llama, mixtral
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from tests.test_torch_mesh import ref_shards
from tests.torch_ranks import RankPool

GEOMETRY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=4,
                num_heads=8, num_kv_heads=4, head_dim=16, max_position_embeddings=256,
                rope_theta=10000.0, tie_word_embeddings=False)
BLOCKS = (32, 4)   # num_blocks, block_size
ATOL = 1e-4        # logits, float32: row-parallel partial sums add in another order
CACHE_ATOL = 1e-5  # cache rows: one layer's K/V projections, no sum across ranks
JCFG = jl.LlamaConfig(**GEOMETRY, dtype=jnp.float32)
CFG = llama.LlamaConfig(**GEOMETRY, dtype=torch.float32)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def steps():
    """A prompt of 12 tokens, a continued window of 5 over it, then a
    decode batch of four lanes: that sequence's next token, a lane on other
    blocks, an idle lane (its slot out of range) and a short lane."""
    rng = np.random.default_rng(0)
    prompt = np.zeros(16, np.int32)
    prompt[:12] = rng.integers(0, 512, 12)
    tail = np.zeros(16, np.int32)
    tail[:5] = rng.integers(0, 512, 5)
    ids = np.arange(8, dtype=np.int32)
    tail_ids = np.zeros(8, np.int32)
    tail_ids[:5] = ids[3:]
    tables = np.stack([ids, ids + 8, ids + 16, ids + 24]).astype(np.int32)
    return [
        ("prefill", [prompt, ids, np.int32(12), np.int32(0)]),
        ("prefix", [tail, ids, tail_ids, np.int32(5), np.int32(12)]),
        ("decode", [rng.integers(0, 512, 4).astype(np.int32), tables,
                    np.array([18, 1, 0, 3], np.int32), np.array([17, 32, 128, 98], np.int32)]),
    ]


def reference(jcfg, tree, sizes: dict, microbatches=None):
    """The reference's prefill and continued prefill jitted over the mesh
    (its plain forwards, GSPMD over the pp-sharded layers), then its
    ``llama_forward_decode_pp``; the logits and the final cache (numpy)."""
    mesh = jmesh.make_mesh(jmesh.MeshConfig(**sizes),
                           devices=jax.devices()[:jmesh.MeshConfig(**sizes).total()])
    params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree,
                          jl.param_specs(jcfg))
    cache = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, jl.kv_cache_spec())),
                         jl.init_kv_cache(jcfg, *BLOCKS))
    cos, sin = jl.make_rope_tables(jcfg)
    fns = {
        "prefill": jax.jit(lambda p, c, *a: jl.llama_forward_prefill(p, jcfg, a[0], c, *a[1:],
                                                                     cos, sin)),
        "prefix": jax.jit(lambda p, c, *a: jl.llama_forward_prefill_with_prefix(
            p, jcfg, a[0], c, *a[1:], cos, sin)),
        "decode": jax.jit(lambda p, c, *a: jl.llama_forward_decode_pp(
            p, jcfg, a[0], c, *a[1:], cos, sin, pp_mesh=mesh, microbatches=microbatches)),
    }
    out = []
    for kind, inputs in steps():
        logits, cache = fns[kind](params, cache, *[jnp.asarray(a) for a in inputs])
        out.append(np.asarray(logits))
    return out, jax.tree.map(np.asarray, cache)


@pytest.mark.parametrize("sizes,microbatches", [(dict(pp=2), 2), (dict(pp=2), 4),
                                                (dict(pp=2, tp=2), None)])
def test_pipelined_forwards_match_the_reference_mesh(pool, sizes, microbatches):
    tree = jax.tree.map(np.asarray, jl.init_params(JCFG, jax.random.PRNGKey(3)))
    ref, ref_cache = reference(JCFG, tree, sizes, microbatches)
    world = MeshConfig(**sizes).total()
    ours, caches = pool.run(world, sizes, "forwards", family="llama", cfg=CFG, params=tree,
                            blocks=BLOCKS, steps=steps(), microbatches=microbatches,
                            caches=True)
    for (kind, _), a, b in zip(steps(), ours, ref):
        assert a.shape == b.shape, kind
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=kind)
    shards = ref_shards(ref_cache, {"k": jl.kv_cache_spec(), "v": jl.kv_cache_spec()}, sizes)
    for rank, (mine, theirs) in enumerate(zip(caches, shards)):
        for leaf in ("k", "v"):
            assert mine[leaf].shape == theirs[leaf].shape, (rank, leaf)
            np.testing.assert_allclose(mine[leaf], theirs[leaf], atol=CACHE_ATOL, rtol=0,
                                       err_msg=f"rank {rank} {leaf}")


def test_microbatches_must_divide_the_batch(pool):
    with pytest.raises(RuntimeError, match="batch 4 not divisible by 3 microbatches"):
        pool.run(2, dict(pp=2), "forwards", family="llama", cfg=CFG,
                 params=jax.tree.map(np.asarray, jl.init_params(JCFG, jax.random.PRNGKey(3))),
                 blocks=BLOCKS, steps=steps()[2:], microbatches=3)


def test_point_to_point_helpers_on_three_ranks(pool):
    """``ring_shift`` over a ring of three, and stage hand-offs at pp = 3,
    bit for bit in bf16 and counted."""
    out = pool.run(3, dict(sp=3), "ring_probe")
    assert out["ring"] == [2.0, 0.0, 1.0]
    out = pool.run(3, dict(pp=3), "stage_probe")
    assert out["stages"] == [[3.0, 3.0], [3.0, 3.0], [3.0, 3.0]]
    assert out["handoff_calls"] > 0


LLAMA_TINY = dict(GEOMETRY, num_layers=2)


def _refusals():
    """(mesh sizes, engine overrides, model family, model geometry): each
    trips one of the reference's pp checks."""
    moe = dict(LLAMA_TINY, intermediate_size=96, num_experts=4, experts_per_token=2)
    return [
        (dict(pp=2, sp=2), {}, "llama", LLAMA_TINY),
        (dict(pp=2, ep=2), {}, "llama", LLAMA_TINY),
        (dict(pp=2, ep=2, sp=2), {}, "llama", LLAMA_TINY),
        (dict(pp=2, ep=2, sp=2), {}, "mixtral", moe),
        (dict(pp=2), dict(max_batch_size=3), "llama", LLAMA_TINY),
        (dict(pp=4), dict(max_batch_size=4), "llama", dict(LLAMA_TINY, num_layers=6)),
    ]


@pytest.mark.parametrize("sizes,over,family,geometry", _refusals())
def test_engine_refuses_pp_like_the_reference(sizes, over, family, geometry):
    if family == "mixtral":
        jcfg = jmx.MixtralConfig(**geometry, dtype=jnp.float32)
        cfg = mixtral.MixtralConfig(**geometry, dtype=torch.float32)
    else:
        jcfg = jl.LlamaConfig(**geometry, dtype=jnp.float32)
        cfg = llama.LlamaConfig(**geometry, dtype=torch.float32)
    with pytest.raises(ValueError) as ref:
        JaxLlmEngine(JaxEngineConfig(model=jcfg, model_family=family,
                                     mesh=jmesh.MeshConfig(**sizes), **over))
    with pytest.raises(ValueError) as ours:
        TorchLlmEngine(EngineConfig(model=cfg, model_family=family, mesh=MeshConfig(**sizes),
                                    **over), device="cpu")
    assert str(ours.value) == str(ref.value)
