"""Expert parallelism (and tp x ep) on gloo ranks against the reference's
mesh.

Held, on Mixtral's ``tiny_moe`` at ep = 2 and ep x tp = 2 x 2 and the tiny
DeepSeek (MLA, a dense layer, routed and shared experts) at tp = 2 and
tp x ep = 2 x 2: prefill, continued prefill and decode logits against the
reference's forwards jitted on the same ``MeshConfig`` (float32, 1e-4) at a
capacity factor that drops (token, expert) pairs; and the drops
themselves: every ep rank sizes the capacity from the global token and
expert counts, so the pairs its experts drop, summed over ep, are the
reference's count over its router's choices.  The engines' streams:
``tests/test_torch_ep_engine.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from dynamo_tpu.models import deepseek as jds
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import mixtral as jmx
from dynamo_tpu.ops.moe import moe_router
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu_torch.models import deepseek, mixtral
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from tests.test_torch_tp import steps
from tests.torch_ranks import RankPool

MOE = dict(vocab_size=512, hidden_size=64, intermediate_size=96, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, max_position_embeddings=256, rope_theta=10000.0,
           tie_word_embeddings=False, num_experts=4, experts_per_token=2, capacity_factor=4.0)
MLA = dict(vocab_size=512, hidden_size=64, num_layers=3, num_heads=4, q_lora_rank=32,
           kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
           intermediate_size=128, first_k_dense=1, moe_intermediate_size=48, num_experts=4,
           experts_per_token=2, n_shared_experts=1, capacity_factor=4.0,
           max_position_embeddings=256, tie_word_embeddings=False)
BLOCKS = (32, 4)
ATOL = 1e-4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def family(name: str, **over):
    """(reference module, reference cfg, port cfg)."""
    if name == "mixtral":
        return (jmx, jmx.MixtralConfig(**{**MOE, **over}, dtype=jnp.float32),
                mixtral.MixtralConfig(**{**MOE, **over}, dtype=torch.float32))
    return (jds, jds.DeepseekConfig(**{**MLA, **over}, dtype=jnp.float32),
            deepseek.DeepseekConfig(**{**MLA, **over}, dtype=torch.float32))


def reference_logits(mod, jcfg, tree, sizes: dict) -> list[np.ndarray]:
    cfg = jmesh.MeshConfig(**sizes)
    mesh = jmesh.make_mesh(cfg, devices=jax.devices()[: cfg.total()])
    params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree,
                          mod.param_specs(jcfg))
    if mod is jds:
        cache, cache_specs = jds.init_kv_cache(jcfg, *BLOCKS), jds.kv_cache_specs(jcfg)
        cos, sin = jds.make_rope_tables(jcfg)
    else:
        cache = jl.init_kv_cache(jcfg, *BLOCKS)
        cache_specs = {"k": jl.kv_cache_spec(), "v": jl.kv_cache_spec()}
        cos, sin = jl.make_rope_tables(jcfg)
    cache = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), cache,
                         cache_specs)
    name = "deepseek" if mod is jds else "mixtral"
    fns = {kind: jax.jit(lambda p, c, *a, f=getattr(mod, f"{name}_forward_{suffix}"):
                         f(p, jcfg, a[0], c, *a[1:], cos, sin))
           for kind, suffix in (("prefill", "prefill"), ("prefix", "prefill_with_prefix"),
                                ("decode", "decode"))}
    out = []
    for kind, inputs in steps():
        logits, cache = fns[kind](params, cache, *[jnp.asarray(a) for a in inputs])
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("name,sizes", [("mixtral", dict(ep=2)), ("mixtral", dict(ep=2, tp=2)),
                                        ("deepseek", dict(tp=2)),
                                        ("deepseek", dict(ep=2, tp=2))])
def test_logits_match_the_reference_mesh(pool, name, sizes):
    mod, jcfg, cfg = family(name, capacity_factor=1.0)  # a capacity that drops pairs
    tree = jax.tree.map(np.asarray, mod.init_params(jcfg, jax.random.PRNGKey(7)))
    ref = reference_logits(mod, jcfg, tree, sizes)
    world = MeshConfig(**sizes).total()
    ours = pool.run(world, sizes, "forwards", family=name, cfg=cfg, params=tree,
                    blocks=BLOCKS, steps=steps())
    for (kind, _), a, b in zip(steps(), ours, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=kind)


def reference_drops(ids, capacity: int, num_experts: int) -> int:
    """The reference's slot rule (dynamo_tpu/ops/moe.py:97-103) over its
    router's choices: the (token, k) pairs at or past capacity."""
    flat = ids.reshape(-1)
    onehot = jax.nn.one_hot(flat, num_experts, dtype=jnp.int32)
    slots = jnp.max(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1
    return int(jnp.sum(~((slots >= 0) & (slots < capacity))))


@pytest.mark.parametrize("ep", [2, 4])
def test_drops_counted_as_the_reference(pool, ep):
    rng = np.random.default_rng(11)
    t, e, k, factor = 24, 8, 2, 1.0
    x = rng.normal(size=(t, 64)).astype(np.float32)
    w = rng.normal(size=(64, e)).astype(np.float32)
    ids, _ = moe_router(jnp.asarray(x), jnp.asarray(w), k)
    ids = np.asarray(ids)
    capacity = max(1, int(t * k / e * factor))
    want = reference_drops(ids, capacity, e)
    _, total = pool.run(ep, dict(ep=ep), "moe_drops", ids=ids, capacity=capacity,
                        num_experts=e)
    assert want > 0 and total == want
