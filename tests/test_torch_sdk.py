"""The port's SDK (dynamo_tpu_torch/sdk): the cases of tests/sdk/
test_allocator.py and test_graph.py on GPU names.

- The GPU allocator hands replicas disjoint, contiguous index runs, falls
  back to the lowest free indices when fragmented, refuses fractional
  requests and over-subscription by name, skips when disabled
  (``DYN_DISABLE_AUTO_GPU_ALLOCATION``) or when no card is visible, and
  detects its inventory from ``CUDA_VISIBLE_DEVICES``, then
  ``DYN_GPU_COUNT``, never initializing CUDA; its assignments are the
  reference's chip assignments on the same indices.
- ``to_process_specs`` carries the per-replica ``CUDA_VISIBLE_DEVICES`` /
  ``DYN_GPUS`` overlays and the ``workers`` count; the supervisor refuses
  a scale-up past the planned overlays, gives each replica its overlay and
  ``DYN_REPLICA_INDEX``, and a restarted replica gets its own again.
- The graph DSL: declarations, the dependency closure, an in-process
  deployment over the memory control plane, and the supervisor's scale,
  restart and scale-down.

Each child process reports its environment over a localhost socket the
test listens on, so every wait is on an event (a report, a process exit).
"""

import asyncio
import json
import subprocess
import sys

import pytest

from dynamo_tpu.sdk import allocator as ref_allocator
from dynamo_tpu_torch.runtime import Context, DistributedRuntime
from dynamo_tpu_torch.runtime.client import PushRouter
from dynamo_tpu_torch.runtime.controlplane.memory import MemoryControlPlane
from dynamo_tpu_torch.sdk import ProcessSpec, ProcessSupervisor
from dynamo_tpu_torch.sdk.allocator import (
    GpuInventory,
    ResourceAllocator,
    ResourceError,
    plan_resource_envs,
)
from dynamo_tpu_torch.sdk.graph import (
    Depends,
    dependency_closure,
    deploy_inprocess,
    depends,
    endpoint,
    service,
    to_process_specs,
)
from dynamo_tpu_torch.utils.config import RuntimeConfig


class EnvReports:
    """A localhost listener: each child sends one JSON line (its
    environment) and keeps the connection open; ``next()`` awaits the next
    report."""

    def __init__(self):
        self.reports: asyncio.Queue = asyncio.Queue()
        self.server = None

    async def __aenter__(self):
        async def on_conn(reader, writer):
            line = await reader.readline()
            await self.reports.put(json.loads(line))
            await reader.read()  # held until the child exits
            writer.close()

        self.server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        self.port = self.server.sockets[0].getsockname()[1]
        return self

    async def __aexit__(self, *exc):
        self.server.close()

    def child(self) -> list[str]:
        code = ("import json, os, socket, time\n"
                f"s = socket.create_connection(('127.0.0.1', {self.port}))\n"
                "s.sendall((json.dumps(dict(os.environ)) + '\\n').encode())\n"
                "time.sleep(120)\n")
        return [sys.executable, "-c", code]

    async def next(self, timeout: float = 30.0) -> dict:
        return await asyncio.wait_for(self.reports.get(), timeout)


def sleeper() -> list[str]:
    return [sys.executable, "-c", "import time; time.sleep(120)"]


# ---------------------------------------------------------------- allocator


def test_assign_gpus_disjoint_and_contiguous():
    alloc = ResourceAllocator(GpuInventory(gpus=(0, 1, 2, 3)))
    a = alloc.assign_gpus(2, "prefill")
    b = alloc.assign_gpus(2, "decode")
    assert sorted(a + b) == [0, 1, 2, 3]
    assert set(a).isdisjoint(b)
    assert a[-1] - a[0] == 1 and b[-1] - b[0] == 1
    assert alloc.assignments == {"prefill": [a], "decode": [b]}


@pytest.mark.parametrize("requests", [(1, 2, 1), (2, 2), (1, 1, 1, 1), (3, 1), (1, 3)])
def test_assignments_equal_the_reference_chip_assignments(requests):
    ours = ResourceAllocator(GpuInventory(gpus=(0, 1, 2, 3)))
    ref = ref_allocator.ResourceAllocator(ref_allocator.ChipInventory(chips=(0, 1, 2, 3)))
    for n in requests:
        assert ours.assign_gpus(n) == ref.assign_chips(n)
    assert ours.remaining == ref.remaining


def test_assign_gpus_fragmented_falls_back_to_lowest_free():
    alloc = ResourceAllocator(GpuInventory(gpus=(0, 1, 2, 3)))
    alloc.assign_gpus(1)  # 0
    alloc.assign_gpus(2)  # 1, 2 (contiguous)
    assert alloc.assign_gpus(1) == [3]
    alloc = ResourceAllocator(GpuInventory(gpus=(0, 2, 3, 5)))
    assert alloc.assign_gpus(2) == [2, 3]      # the contiguous run
    assert alloc.assign_gpus(2) == [0, 5]      # none left: the lowest free


def test_fractional_and_oversubscription_raise():
    alloc = ResourceAllocator(GpuInventory(gpus=(0, 1)))
    with pytest.raises(ResourceError, match="assigned whole"):
        alloc.assign_gpus(0.5, "frac")
    with pytest.raises(ResourceError, match="remain unassigned"):
        alloc.assign_gpus(4, "big")
    with pytest.raises(ResourceError, match="DYN_DISABLE_AUTO_GPU_ALLOCATION=1"):
        alloc.assign_gpus(3, "big")


def test_two_worker2_services_get_disjoint_gpus():
    @service(name="alloc-prefill", workers=2, resources={"gpu": 1})
    class Prefill:
        @endpoint()
        async def generate(self, request, ctx):
            yield {}

    @service(name="alloc-decode", workers=2, resources={"gpu": 1})
    class Decode:
        @endpoint()
        async def generate(self, request, ctx):
            yield {}

    envs = plan_resource_envs([Prefill, Decode], inventory=GpuInventory(gpus=(0, 1, 2, 3)))
    assert len(envs["alloc-prefill"]) == 2 and len(envs["alloc-decode"]) == 2
    claimed = [e["CUDA_VISIBLE_DEVICES"] for per in envs.values() for e in per]
    assert sorted(claimed) == ["0", "1", "2", "3"]
    assert all(e["DYN_GPUS"] == e["CUDA_VISIBLE_DEVICES"] for per in envs.values()
               for e in per)


def test_plan_skips_when_disabled_no_gpus_or_no_request(monkeypatch):
    @service(name="alloc-w", workers=1, resources={"gpu": 1})
    class W:
        @endpoint()
        async def generate(self, request, ctx):
            yield {}

    @service(name="alloc-cpu", workers=1)
    class Cpu:
        @endpoint()
        async def generate(self, request, ctx):
            yield {}

    monkeypatch.setenv("DYN_DISABLE_AUTO_GPU_ALLOCATION", "1")
    assert plan_resource_envs([W], inventory=GpuInventory(gpus=(0,))) == {}
    monkeypatch.delenv("DYN_DISABLE_AUTO_GPU_ALLOCATION")
    # no card visible: warn and skip, never fail the plan
    assert plan_resource_envs([W], inventory=GpuInventory(gpus=())) == {}
    assert plan_resource_envs([Cpu], inventory=GpuInventory(gpus=(0,))) == {}
    # one card, two replicas that each want it: refused at plan time
    W._dyn_service.workers = 2
    with pytest.raises(ResourceError, match="requested 1 GPUs but only 0 of 1"):
        plan_resource_envs([W], inventory=GpuInventory(gpus=(0,)))


def test_inventory_detect_takes_the_cheapest_signal_first():
    assert GpuInventory.detect(env={"CUDA_VISIBLE_DEVICES": "2,3"}).gpus == (2, 3)
    assert GpuInventory.detect(env={"DYN_GPU_COUNT": "4"}).gpus == (0, 1, 2, 3)
    assert GpuInventory.detect(env={"CUDA_VISIBLE_DEVICES": "1",
                                    "DYN_GPU_COUNT": "4"}).gpus == (1,)
    assert GpuInventory.detect(env={}).gpus == ()  # the CPU test host


def test_inventory_detect_never_initializes_cuda():
    code = ("import torch\n"
            "from dynamo_tpu_torch.sdk.allocator import GpuInventory\n"
            "inv = GpuInventory.detect(env={})\n"
            "print(inv.gpus, torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "() False"


def test_to_process_specs_carries_gpu_envs_and_workers():
    @service(name="alloc-spec-w", workers=2, resources={"gpu": 2})
    class W:
        @endpoint()
        async def generate(self, request, ctx):
            yield {}

    (spec,) = to_process_specs(W, control_plane="127.0.0.1:1",
                               gpu_inventory=GpuInventory(gpus=(0, 1, 2, 3)))
    assert spec.replicas == 2
    assert [e["CUDA_VISIBLE_DEVICES"] for e in spec.replica_env] == ["0,1", "2,3"]
    assert spec.cmd[1:3] == ["-m", "dynamo_tpu_torch.sdk.runner"]
    assert spec.cmd[3] == f"{W.__module__}:{W.__qualname__}"
    assert spec.cmd[-2:] == ["--control-plane", "127.0.0.1:1"]


# ---------------------------------------------------------------- supervisor


async def test_supervisor_refuses_scaleup_past_planned_overlays():
    sup = ProcessSupervisor()
    sup.add_watcher(ProcessSpec(name="capped", cmd=sleeper(),
                                replica_env=[{"CUDA_VISIBLE_DEVICES": "0"}], replicas=1))
    await sup.start()
    try:
        with pytest.raises(RuntimeError, match="no GPU-env overlay"):
            await sup.set_replicas("capped", 2)
    finally:
        await sup.stop()


async def test_supervisor_applies_replica_env_and_restores_on_restart():
    """Each replica sees its overlay and its DYN_REPLICA_INDEX; a restarted
    replica reclaims the same cards."""
    async with EnvReports() as reports:
        sup = ProcessSupervisor()
        sup.add_watcher(ProcessSpec(
            name="gpu-child", cmd=reports.child(),
            replica_env=[{"CUDA_VISIBLE_DEVICES": "0", "DYN_GPUS": "0"},
                         {"CUDA_VISIBLE_DEVICES": "1", "DYN_GPUS": "1"}],
            replicas=2))
        await sup.start()
        try:
            assert sup.replica_count("gpu-child") == 2
            seen = {}
            for _ in range(2):
                env = await reports.next()
                seen[env["DYN_REPLICA_INDEX"]] = env["CUDA_VISIBLE_DEVICES"], env["DYN_GPUS"]
            assert seen == {"0": ("0", "0"), "1": ("1", "1")}
            # crash replica 1: its restart re-applies overlay 1
            victim = sup._replicas["gpu-child"][1]
            victim.process.kill()
            await victim.process.wait()
            env = await reports.next()
            assert (env["DYN_REPLICA_INDEX"], env["CUDA_VISIBLE_DEVICES"]) == ("1", "1")
            assert sup._replicas["gpu-child"][1] is not victim
            assert sup.replica_count("gpu-child") == 2
        finally:
            await sup.stop()
        assert sup.replica_count("gpu-child") == 0


async def test_supervisor_scales_and_restarts():
    async with EnvReports() as reports:
        sup = ProcessSupervisor()
        sup.add_watcher(ProcessSpec(name="sleeper", cmd=reports.child(), restart=True),
                        replicas=2)
        await sup.start()
        try:
            assert sup.replica_count("sleeper") == 2
            await sup.set_replicas("sleeper", 3)
            assert sup.replica_count("sleeper") == 3
            for _ in range(3):
                await reports.next()
            victim = sup._replicas["sleeper"][0]
            victim.process.kill()
            await victim.process.wait()
            assert (await reports.next())["DYN_REPLICA_INDEX"] == "0"  # restarted
            assert sup.replica_count("sleeper") == 3
            await sup.set_replicas("sleeper", 1)
            assert sup.replica_count("sleeper") == 1
            assert set(sup._replicas["sleeper"]) == {0}  # the highest retired first
        finally:
            await sup.stop()
        assert sup.replica_count("sleeper") == 0


# ---------------------------------------------------------------- the DSL


@service(workers=2)
class Worker:
    @endpoint()
    async def generate(self, request, ctx):
        for tok in request["tokens"]:
            yield {"token": tok * 2}


@service()
class Processor:
    worker = depends(Worker)

    @endpoint()
    async def generate(self, request, ctx):
        request["tokens"] = [t + 1 for t in request["tokens"]]
        stream = await self.worker.generate(Context(request, ctx))
        async for item in stream:
            yield item


@service()
class Frontend:
    processor = depends(Processor)

    @endpoint()
    async def generate(self, request, ctx):
        stream = await self.processor.generate(Context(request, ctx))
        async for item in stream:
            yield {"final": item["token"]}


def test_declarations():
    assert Worker._dyn_service.name == "worker"
    assert Worker._dyn_service.workers == 2
    assert [e.name for e in Worker._dyn_endpoints] == ["generate"]
    assert isinstance(vars(Processor)["worker"], Depends)
    assert dependency_closure(Frontend) == [Worker, Processor, Frontend]


async def test_inprocess_graph_deploy():
    MemoryControlPlane.reset_named()
    rt = await DistributedRuntime.create(RuntimeConfig(control_plane="memory://torch-sdk"))
    try:
        handles = await deploy_inprocess(Frontend, rt)
        assert set(handles) == {Worker, Processor, Frontend}
        ep = rt.namespace("dynamo").component("frontend").endpoint("generate")
        router = await PushRouter.from_endpoint(ep)
        await router.client.wait_for_instances(1, timeout=5)
        out = await (await router.generate(Context({"tokens": [1, 2, 3]}))).collect()
        assert [o["final"] for o in out] == [4, 6, 8]  # (t + 1) * 2
        for services in handles.values():
            for s in services:
                await s.shutdown(drain_timeout=1)
    finally:
        await rt.close()
