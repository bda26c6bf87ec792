"""The pipeline-parallel engines against the reference's on the same mesh.

The port's pp = 2, pp x tp, pp x ep (Mixtral ``tiny_moe`` geometry) and
DeepSeek pp = 2 engines (rank 0 here, the shard workers child processes):
greedy and seeded streams equal to ``JaxLlmEngine``'s on the same mesh,
chunked prefill and a prefix hit included; and a stage peer (or an sp
ring's peer) killed between steps failing rank 0 within the mesh timeout
with no child left behind.  The forwards and the checks: ``tests/test_torch_pp.py``."""

import asyncio
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import deepseek as jds
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import mixtral as jmx
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import deepseek, llama, mixtral
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_engine import collect, request
from tests.test_torch_mesh import MLA
from tests.test_torch_mesh_engine import _children
from tests.test_torch_pp import CFG, GEOMETRY, JCFG, LLAMA_TINY

ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32, 64),
              max_model_len=128, decode_overlap=False, prefill_chunk_tokens=8)


def stream_requests(vocab: int = 512):
    seeded = SamplingOptions(temperature=1.5, seed=1234, frequency_penalty=0.5)
    shared = list(range(3, 35))
    return [request(shared + [40, 41], 8, seeded, ignore_eos=True),
            request(range(100, 108), 8, ignore_eos=True),
            request(shared + [50], 6, ignore_eos=True),          # a prefix hit
            request(range(200, 230), 6, SamplingOptions(temperature=3.0, top_k=20,
                                                        top_p=0.9), ignore_eos=True)]


async def _serve(engine, ctx_cls, reqs):
    engine.start()
    try:
        first = await asyncio.gather(*[collect(engine, r, ctx_cls) for r in reqs[:2]])
        # the rest after the first two have finished: the prefix is resident
        rest = await asyncio.gather(*[collect(engine, r, ctx_cls) for r in reqs[2:]])
        return first + rest, engine.stats()
    finally:
        engine.stop()


def _family(name: str):
    """(reference module, reference cfg, port cfg, registry key)."""
    if name == "llama":
        return jl, JCFG, CFG, "llama"
    if name == "mixtral":
        over = dict(GEOMETRY, intermediate_size=96, num_experts=4, experts_per_token=2,
                    capacity_factor=1.0)
        return (jmx, jmx.MixtralConfig(**over, dtype=jnp.float32),
                mixtral.MixtralConfig(**over, dtype=torch.float32), "mixtral")
    mla = dict(MLA, num_layers=4)  # layers split evenly into two stages
    return (jds, jds.DeepseekConfig(**mla, dtype=jnp.float32),
            deepseek.DeepseekConfig(**mla, dtype=torch.float32), "deepseek_v2")


@pytest.mark.parametrize("name,sizes", [("llama", dict(pp=2)), ("llama", dict(pp=2, tp=2)),
                                        ("mixtral", dict(pp=2, ep=2)),
                                        ("deepseek", dict(pp=2))])
def test_engine_streams_match_the_reference_mesh_engine(name, sizes):
    """Greedy and seeded streams of the port's pp engines (the decode
    pipelined where the family has a pipelined one, the prefills stage by
    stage; DeepSeek whole on both stages) equal the reference engine's on
    the same mesh, chunked prefill and a prefix hit included.  Mixtral
    routes each microbatch at a capacity factor that drops pairs."""
    mod, jcfg, cfg, family = _family(name)
    tree = jax.tree.map(np.asarray, mod.init_params(jcfg, jax.random.PRNGKey(5)))
    reqs = stream_requests()
    ref, _ = asyncio.run(_serve(
        JaxLlmEngine(JaxEngineConfig(model=jcfg, model_family=family,
                                     mesh=jmesh.MeshConfig(**sizes), **ENGINE),
                     params=tree), JaxContext, reqs))
    ours, stats = asyncio.run(_serve(
        TorchLlmEngine(EngineConfig(model=cfg, model_family=family, mesh=MeshConfig(**sizes),
                                    **ENGINE),
                       params=llama.params_from_jax(tree, "cpu"), device="cpu"), Context, reqs))
    assert ours == ref
    assert stats["mesh"]["pp"] == 2 and stats["mesh"]["ranks"] == MeshConfig(**sizes).total()
    assert stats["mesh_steps_total"] > 0 and stats["prefix_hits_total"] >= 1


@pytest.mark.parametrize("sizes", [dict(pp=2), dict(sp=2)])
def test_killed_peer_fails_rank_zero_within_the_timeout(monkeypatch, sizes):
    """A stage-1 rank (or the sp ring's other rank) killed between steps:
    rank 0's next step (which waits on that rank's hand-off or rotation)
    fails within the mesh timeout, the request ends in error, and stop()
    leaves no child process."""
    monkeypatch.setenv("DYN_MESH_TIMEOUT_S", "20")
    engine = TorchLlmEngine(EngineConfig(model=llama.LlamaConfig(**LLAMA_TINY,
                                                                 dtype=torch.float32),
                                         mesh=MeshConfig(**sizes), **ENGINE), device="cpu")
    procs = list(engine._mesh_leader.procs)

    async def run():
        engine.start()
        tokens, finish = await collect(engine, request(range(10, 20), 4), Context)
        assert finish == "length" and len(tokens) == 4
        os.kill(procs[0].pid, signal.SIGKILL)
        procs[0].wait()
        t0 = time.monotonic()
        tokens, finish = await asyncio.wait_for(
            collect(engine, request(range(30, 40), 4), Context), timeout=30)
        return finish, time.monotonic() - t0

    try:
        finish, waited = asyncio.run(run())
        assert finish == "error" and waited < 25
        assert engine._mesh_leader.broken is not None
    finally:
        engine.stop()
    assert _children() == []
