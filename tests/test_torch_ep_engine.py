"""Expert parallelism (and tp x ep) in the engine: the port's Mixtral
``tiny_moe`` engine at ep = 2 and tiny DeepSeek engine at tp x ep = 2 x 2
(rank 0 here, the shard workers child processes) against ``JaxLlmEngine``
on the same mesh, greedy and seeded streams equal at a capacity factor
that drops (token, expert) pairs."""

import asyncio

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_engine import collect, request
from tests.test_torch_ep import family


ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32),
              max_model_len=64, decode_overlap=False, prefill_chunk_tokens=8)


async def _serve(engine, ctx_cls, reqs):
    engine.start()
    try:
        out = await asyncio.gather(*[collect(engine, r, ctx_cls) for r in reqs])
        return out, engine.stats()
    finally:
        engine.stop()


@pytest.mark.parametrize("name,sizes", [("mixtral", dict(ep=2)), ("deepseek", dict(tp=2, ep=2))])
def test_engine_streams_match_the_reference_mesh_engine(name, sizes):
    mod, jcfg, cfg = family(name, capacity_factor=1.0)
    tree = jax.tree.map(np.asarray, mod.init_params(jcfg, jax.random.PRNGKey(9)))
    model_family = "mixtral" if name == "mixtral" else "deepseek_v2"
    seeded = SamplingOptions(temperature=1.5, seed=77)
    reqs = [request(range(3, 25), 8, seeded, ignore_eos=True),
            request(range(40, 46), 8, ignore_eos=True),
            request(range(60, 80), 6, ignore_eos=True)]
    ref, _ = asyncio.run(_serve(JaxLlmEngine(JaxEngineConfig(
        model=jcfg, model_family=model_family, mesh=jmesh.MeshConfig(**sizes), **ENGINE),
        params=tree), JaxContext, reqs))
    ours, stats = asyncio.run(_serve(TorchLlmEngine(EngineConfig(
        model=cfg, model_family=model_family, mesh=MeshConfig(**sizes), **ENGINE),
        params=params_from_jax(tree, "cpu"), device="cpu"), Context, reqs))
    assert ours == ref
    assert stats["mesh"]["ranks"] == MeshConfig(**sizes).total()
    assert stats["mesh_steps_total"] > 0
