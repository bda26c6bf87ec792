"""Tensor parallelism on gloo ranks against the reference's mesh.

The ranks are processes of their own (``tests/torch_ranks.py``: torch and
the port, no JAX), one pool for the file; the JAX reference runs here on the
8 virtual CPU devices.  Held: llama prefill, continued prefill and decode
logits at tp = 2 and 4 (and Qwen2's biased projections, and int8 weights at
tp = 2) against the reference's forwards on a ``MeshConfig(tp=...)`` mesh
with ``NamedSharding`` parameters and cache, float32 within 1e-4; the
greedy and seeded streams of the port's tp = 2 engine (rank 0 here, its
shard worker a child process) against ``JaxLlmEngine(mesh=MeshConfig(tp=2))``
with prefix caching and chunked prefill; each rank's topology card
identity.  The mesh engine's lifecycle and the dryrun:
``tests/test_torch_mesh_engine.py``."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.registry import get_family as jax_family
from dynamo_tpu.ops.quant import quantize_params as jax_quantize
from dynamo_tpu.ops.quant import quantize_specs as jax_quantize_specs
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_engine import collect, request
from tests.torch_ranks import RankPool, plain_tree

GEOMETRY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                num_heads=8, num_kv_heads=4, head_dim=16, max_position_embeddings=256,
                rope_theta=10000.0, tie_word_embeddings=False)
BLOCKS = (32, 4)  # num_blocks, block_size
ATOL = 1e-4       # float32: the row-parallel partial sums add in another order


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def steps():
    """A prompt of 12 tokens, a continued window of 5 over it, then a
    decode batch (that sequence's next token, and a lane on other blocks)."""
    rng = np.random.default_rng(0)
    prompt = np.zeros(16, np.int32)
    prompt[:12] = rng.integers(0, 512, 12)
    tail = np.zeros(16, np.int32)
    tail[:5] = rng.integers(0, 512, 5)
    ids = np.arange(8, dtype=np.int32)
    tail_ids = np.zeros(8, np.int32)
    tail_ids[:5] = ids[3:]
    tables = np.stack([ids, ids + 8]).astype(np.int32)
    return [
        ("prefill", [prompt, ids, np.int32(12), np.int32(0)]),
        ("prefix", [tail, ids, tail_ids, np.int32(5), np.int32(12)]),
        ("decode", [rng.integers(0, 512, 2).astype(np.int32), tables,
                    np.array([18, 1], np.int32), np.array([17, 32], np.int32)]),
    ]


def reference_logits(jcfg, tree, specs, tp: int) -> list[np.ndarray]:
    """The reference's forwards jitted over a tp mesh, parameters and cache
    placed by its specs."""
    mesh = jmesh.make_mesh(jmesh.MeshConfig(tp=tp), devices=jax.devices()[:tp])
    params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)
    cache = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, jl.kv_cache_spec())),
                         jl.init_kv_cache(jcfg, *BLOCKS))
    cos, sin = jl.make_rope_tables(jcfg)
    fns = {
        "prefill": jax.jit(lambda p, c, *a: jl.llama_forward_prefill(p, jcfg, a[0], c, *a[1:],
                                                                     cos, sin)),
        "prefix": jax.jit(lambda p, c, *a: jl.llama_forward_prefill_with_prefix(
            p, jcfg, a[0], c, *a[1:], cos, sin)),
        "decode": jax.jit(lambda p, c, *a: jl.llama_forward_decode(p, jcfg, a[0], c, *a[1:],
                                                                   cos, sin)),
    }
    out = []
    for kind, inputs in steps():
        logits, cache = fns[kind](params, cache, *[jnp.asarray(a) for a in inputs])
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("tp,variant", [(2, "llama"), (4, "llama"), (2, "qwen2"), (2, "int8")])
def test_logits_match_the_reference_mesh(pool, tp, variant):
    over = dict(attention_bias=True) if variant == "qwen2" else {}
    jcfg = jl.LlamaConfig(**GEOMETRY, **over, dtype=jnp.float32)
    cfg = llama.LlamaConfig(**GEOMETRY, **over, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(3)))
    if variant == "qwen2":  # the biases are zeros at init: give them values
        rng = np.random.default_rng(1)
        for name in ("bq", "bk", "bv"):
            tree["layers"][name] = rng.normal(size=tree["layers"][name].shape).astype(np.float32)
    specs = jl.param_specs(jcfg)
    if variant == "int8":
        leaves = jax_family("llama").quant_leaves
        tree, specs = jax_quantize(tree, leaves), jax_quantize_specs(specs, leaves)
    ref = reference_logits(jcfg, tree, specs, tp)
    ours = pool.run(tp, dict(tp=tp), "forwards", family="llama", cfg=cfg,
                    params=plain_tree(tree), blocks=BLOCKS, steps=steps())
    for (kind, _), a, b in zip(steps(), ours, ref):
        assert a.shape == b.shape, kind
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=kind)


def test_topology_card_carries_each_rank(pool):
    """A rank's topology card names it by its rank (the CPU ranks have no
    card coordinates)."""
    assert pool.run(2, dict(tp=2), "card_identity") == [(0, []), (1, [])]


JCFG = jl.LlamaConfig(**GEOMETRY, dtype=jnp.float32)
CFG = llama.LlamaConfig(**GEOMETRY, dtype=torch.float32)
ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32, 64),
              max_model_len=128, decode_overlap=False, prefill_chunk_tokens=8)


def stream_requests():
    seeded = SamplingOptions(temperature=1.5, seed=1234, frequency_penalty=0.5)
    shared = list(range(3, 35))
    return [request(shared + [40, 41], 10, seeded, ignore_eos=True),
            request(range(100, 108), 10, ignore_eos=True),
            request(shared + [50], 10, ignore_eos=True),          # a prefix hit
            request(range(200, 230), 8, SamplingOptions(temperature=3.0, top_k=20, top_p=0.9),
                    ignore_eos=True)]


async def _serve(engine, ctx_cls, reqs):
    engine.start()
    try:
        first = await asyncio.gather(*[collect(engine, r, ctx_cls) for r in reqs[:2]])
        # the rest after the first two have finished: the prefix is resident
        rest = await asyncio.gather(*[collect(engine, r, ctx_cls) for r in reqs[2:]])
        return first + rest, engine.stats()
    finally:
        engine.stop()


def test_engine_streams_match_the_reference_mesh_engine():
    """Greedy and seeded streams of the port's tp = 2 engine equal the
    reference engine's on a tp = 2 mesh, chunked prefill and a prefix hit
    included, every step run on both ranks."""
    tree = jax.tree.map(np.asarray, jl.init_params(JCFG, jax.random.PRNGKey(5)))
    reqs = stream_requests()
    ref, _ = asyncio.run(_serve(
        JaxLlmEngine(JaxEngineConfig(model=JCFG, mesh=jmesh.MeshConfig(tp=2), **ENGINE),
                     params=tree), JaxContext, reqs))
    ours, stats = asyncio.run(_serve(
        TorchLlmEngine(EngineConfig(model=CFG, mesh=MeshConfig(tp=2), **ENGINE),
                       params=llama.params_from_jax(tree, "cpu"), device="cpu"), Context, reqs))
    assert ours == ref
    assert stats["mesh"] == {"tp": 2, "ep": 1, "ranks": 2, "backend": "gloo"}
    assert stats["mesh_steps_total"] > 0 and stats["prefix_hits_total"] >= 1
    assert stats["unified_fallbacks"] == {"mesh": 1}
    assert stats["decode_graph_replays_total"] == 0
