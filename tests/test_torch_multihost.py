"""Multi-host bring-up of the port: two OS processes rendezvous through the
port's control plane (``LeaderBarrier`` / ``WorkerBarrier``), join one
``torch.distributed`` process group over the leader's TCPStore, build the
mesh on it, and an all-reduce gives every rank the reference test's value
(tests/parallel/test_multihost.py: 224.0)."""

import asyncio
import os
import sys
from pathlib import Path

from dynamo_tpu_torch.runtime.controlplane.server import ControlPlaneServer
from tests.conftest import free_port

ROOT = Path(__file__).resolve().parent.parent


async def test_two_process_multihost_all_reduce():
    server = ControlPlaneServer(port=0)
    await server.start()
    address = f"127.0.0.1:{server.port}"
    coordinator = f"127.0.0.1:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    try:
        for rank in range(2):
            procs.append(await asyncio.create_subprocess_exec(
                sys.executable, "-m", "tests.torch_ranks", "multihost", address, str(rank),
                coordinator, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE,
                env=env, cwd=str(ROOT)))
        outs = await asyncio.wait_for(asyncio.gather(*[p.communicate() for p in procs]),
                                      timeout=50)
        for rank, (out, err) in enumerate(outs):
            assert f"RANK_OK {rank} 224.0".encode() in out, (
                f"rank {rank} failed:\nstdout={out.decode(errors='replace')}\n"
                f"stderr={err.decode(errors='replace')[-3000:]}")
    finally:
        for p in procs:
            if p.returncode is None:
                p.kill()
                await p.wait()
        await server.stop()


async def test_engine_mesh_with_a_worker_joined_through_the_control_plane():
    """The multihost route of an engine mesh: a shard worker started on its
    own (``python -m dynamo_tpu_torch.engine.shard_worker --control-plane``)
    and this process (rank 0) bootstrap through the control plane; the
    engine finds the group joined, starts no worker of its own, and serves
    the tp = 1 engine's greedy stream on the same seed's weights."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.parallel.mesh import MeshConfig
    from dynamo_tpu_torch.parallel.multihost import MultiNodeConfig, bootstrap_multihost
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.utils.config import RuntimeConfig
    from tests.test_torch_engine import collect, request

    cfg = dataclasses.replace(LlamaConfig.tiny(), num_heads=8, num_kv_heads=4)
    engine_cfg = dict(model=cfg, num_blocks=64, block_size=4, max_batch_size=2,
                      prefill_buckets=(16, 32), max_model_len=64, decode_overlap=False)
    ref_engine = TorchLlmEngine(EngineConfig(**engine_cfg), device="cpu")
    ref_engine.start()
    try:
        want = await collect(ref_engine, request(range(5, 25), 6), Context)
    finally:
        ref_engine.stop()

    server = ControlPlaneServer(port=0)
    await server.start()
    address = f"127.0.0.1:{server.port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    worker = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_tpu_torch.engine.shard_worker", "--control-plane",
        address, "--rank", "1", "--world-size", "2", "--mesh", "1,1,1,2,1",
        "--device-type", "cpu", "--timeout-s", "40", env=env, cwd=str(ROOT))
    rt = await DistributedRuntime.create(RuntimeConfig(control_plane=address))
    try:
        await bootstrap_multihost(rt.plane.kv, MultiNodeConfig(
            num_nodes=2, node_rank=0, leader_addr=f"127.0.0.1:{free_port()}"), timeout=40)
        engine = await asyncio.to_thread(
            TorchLlmEngine, EngineConfig(**engine_cfg, mesh=MeshConfig(tp=2)), device="cpu")
        assert engine._mesh_leader.procs == []  # the worker joined on its own
        engine.start()
        try:
            got = await collect(engine, request(range(5, 25), 6), Context)
        finally:
            await asyncio.to_thread(engine.stop)
        assert got == want
        assert await asyncio.wait_for(worker.wait(), timeout=20) == 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if worker.returncode is None:
            worker.kill()
            await worker.wait()
        await rt.close()
        await server.stop()
    assert torch.distributed.is_initialized() is False
