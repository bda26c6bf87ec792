"""The port's example graphs (dynamo_tpu_torch/examples) against the
repository's (examples/), on the CPU.

- hello_world's chained services give the reference's words.
- ``agg``, ``agg_router``, ``disagg`` and ``disagg_router`` on
  tests/data/tiny-chat-model serve a greedy chat whose text equals the
  reference graph's on the same request (the reference's engines are
  ``JaxLlmEngine``'s); the disaggregated graphs ship the prompt's prefill to
  their prefill worker (``remote_prefills`` >= 1), as the reference's do.
- A ``Planner`` with a ``LocalConnector`` scales the agg graph's worker
  watcher 1 -> 2 -> 1 under the SDK's ``ProcessSupervisor``, each worker a
  ``run in=none out=torch`` process behind a control-plane server and the
  frontend in the test's process, while requests stream: none is lost and
  every one completes.

Waits are on events: a model's pipeline being built, the endpoint client's
instance set changing, a request's completion.
"""

import asyncio
import json
import sys
from pathlib import Path

import httpx
import pytest

from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.controlplane.memory import MemoryControlPlane as JaxMemoryPlane
from dynamo_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu_torch.runtime import DistributedRuntime
from dynamo_tpu_torch.runtime.controlplane.memory import MemoryControlPlane
from dynamo_tpu_torch.utils.config import RuntimeConfig

from examples.llm.common import LlmGraphConfig as JaxGraphConfig
from examples.llm.graphs import GRAPHS as JAX_GRAPHS

ROOT = Path(__file__).resolve().parent.parent
MODEL_DIR = str(ROOT / "tests" / "data" / "tiny-chat-model")
PROMPT = "a long prompt that exceeds the local prefill budget"


def graph_kw(**overrides) -> dict:
    return dict(dict(model_dir=MODEL_DIR, model_name="tiny-chat", http_port=0, num_blocks=64,
                     max_batch_size=4, max_model_len=128, max_local_prefill_length=8,
                     engine_overrides={"prefill_buckets": (32, 64)}), **overrides)


def watch_models(watcher) -> asyncio.Event:
    """An event set once the frontend's model watcher has built a
    pipeline."""
    built = asyncio.Event()
    build = watcher._build_pipeline

    async def spy(entry):
        await build(entry)
        built.set()

    watcher._build_pipeline = spy
    if watcher._pipelines:
        built.set()
    return built


async def chat(port: int, content: str = PROMPT, max_tokens: int = 8) -> dict:
    async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{port}", timeout=120) as c:
        r = await c.post("/v1/chat/completions", json={
            "model": "tiny-chat", "messages": [{"role": "user", "content": content}],
            "max_tokens": max_tokens, "temperature": 0})
    assert r.status_code == 200, r.text
    return r.json()


async def run_graph(name: str, ours: bool) -> tuple[dict, int]:
    """One graph of one package, up on a memory plane; its answer to the
    greedy chat and its disaggregated decode worker's remote prefills
    (None for the aggregated graphs)."""
    if ours:
        from dynamo_tpu_torch.examples.llm.common import LlmGraphConfig
        from dynamo_tpu_torch.examples.llm.graphs import GRAPHS

        MemoryControlPlane.reset_named()
        rt = await DistributedRuntime.create(RuntimeConfig(control_plane=f"memory://t-{name}"))
        cfg = LlmGraphConfig(**graph_kw(engine_kind="torch", device="cpu"))
    else:
        GRAPHS = JAX_GRAPHS
        JaxMemoryPlane.reset_named()
        rt = await JaxRuntime.create(JaxRuntimeConfig(control_plane=f"memory://j-{name}"))
        cfg = JaxGraphConfig(**graph_kw(engine_kind="jax"))
    handle = None
    try:
        handle = await GRAPHS[name](rt, cfg)
        if ours:
            built = watch_models(handle.watcher)
            await asyncio.wait_for(built.wait(), 30)
        else:
            await asyncio.wait_for(_ref_model_listed(handle.watcher), 30)
        body = await chat(handle.frontend.port)
        remote = handle.workers[0].engine.remote_prefills if name.startswith("disagg") else None
        return body, remote
    finally:
        if handle is not None:
            await handle.shutdown()
        await rt.close()


async def _ref_model_listed(watcher) -> None:
    """The reference watcher's pipeline, awaited the same way."""
    built = asyncio.Event()
    build = watcher._build_pipeline

    async def spy(entry):
        await build(entry)
        built.set()

    watcher._build_pipeline = spy
    if watcher._pipelines:
        return
    await built.wait()


async def test_hello_world_words_equal_the_reference():
    from dynamo_tpu_torch.examples.hello_world.hello_world import run

    from examples.hello_world.hello_world import run as ref_run

    MemoryControlPlane.reset_named()
    JaxMemoryPlane.reset_named()
    words = await run("gpu serving")
    assert words == await ref_run("gpu serving")
    assert words == ["Middle(Backend[GPU])", "Middle(Backend[SERVING])"]


@pytest.mark.parametrize("name", ["agg", "agg_router", "disagg", "disagg_router"])
async def test_llm_graph_serves_the_reference_text(name):
    ours, ours_remote = await run_graph(name, ours=True)
    ref, ref_remote = await run_graph(name, ours=False)
    text = ours["choices"][0]["message"]["content"]
    assert text == ref["choices"][0]["message"]["content"]
    assert ours["usage"]["completion_tokens"] == ref["usage"]["completion_tokens"] == 8
    assert ours["choices"][0]["finish_reason"] == "length"
    if name.startswith("disagg"):
        assert ours_remote >= 1 and ref_remote >= 1


def test_launch_cli_and_configs_name_the_port():
    from dynamo_tpu_torch.examples.llm.common import LlmGraphConfig
    from dynamo_tpu_torch.examples.llm.graphs import GRAPHS

    assert sorted(GRAPHS) == ["agg", "agg_router", "disagg", "disagg_router"]
    configs = ROOT / "dynamo_tpu_torch" / "examples" / "llm" / "configs"
    for yaml_name in ("agg.yaml", "agg_perf.yaml", "disagg.yaml"):
        cfg = LlmGraphConfig.load(configs / yaml_name)
        assert cfg.engine_kind == "torch" and cfg.model_dir == "tests/data/tiny-chat-model"
    assert LlmGraphConfig.load(configs / "disagg.yaml").num_prefill_workers == 2
    assert LlmGraphConfig.load(configs / "agg_perf.yaml").engine_overrides["quantize"] == "int8"


# ------------------------------------------------ the planner over the agg graph


async def instances_reach(client, n: int, timeout: float = 45.0) -> None:
    """Until the endpoint client sees exactly ``n`` instances, on its
    change event."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while len(client.instances) != n:
        remaining = deadline - loop.time()
        if remaining <= 0:
            raise TimeoutError(f"{len(client.instances)} instances, waiting for {n}")
        changed = client._changed
        try:
            await asyncio.wait_for(changed.wait(), min(remaining, 1.0))
        except asyncio.TimeoutError:
            pass


async def test_planner_scales_the_agg_worker_under_the_supervisor():
    from dynamo_tpu_torch.planner import (
        PerfProfile,
        Planner,
        PlannerConfig,
        ProfilePoint,
        WorkloadSample,
    )
    from dynamo_tpu_torch.planner.connectors import LocalConnector
    from dynamo_tpu_torch.runtime.client import PushRouter, RouterMode
    from dynamo_tpu_torch.runtime.component import stats_subject
    from dynamo_tpu_torch.runtime.controlplane.server import ControlPlaneServer
    from dynamo_tpu_torch.sdk import ProcessSpec, ProcessSupervisor
    from dynamo_tpu_torch.serve import serve_frontend

    server = ControlPlaneServer(port=0)
    await server.start()
    address = f"127.0.0.1:{server.port}"
    rt = await DistributedRuntime.create(RuntimeConfig(control_plane=address))
    sup = ProcessSupervisor()
    frontend = watcher = None
    try:
        frontend, watcher = await serve_frontend(rt, host="127.0.0.1", port=0,
                                                 router_mode=RouterMode.ROUND_ROBIN)
        built = watch_models(watcher)
        client = (await PushRouter.from_endpoint(
            rt.namespace("dynamo").component("backend").endpoint("generate"))).client
        sup.add_watcher(ProcessSpec(name="worker", cmd=[
            sys.executable, "-m", "dynamo_tpu_torch.cli.run", "run", "in=none", "out=torch",
            "--model-path", MODEL_DIR, "--model-name", "tiny-chat", "--device", "cpu",
            "--control-plane", address, "--num-blocks", "64", "--max-batch-size", "4",
            "--context-length", "128"], cwd=str(ROOT), stop_timeout_s=30.0), replicas=1)
        # the agg graph has no prefill pool: its watcher stays at 0
        sup.add_watcher(ProcessSpec(name="prefill", cmd=[sys.executable, "-c", "pass"]),
                        replicas=0)
        await sup.start()
        await asyncio.wait_for(built.wait(), 45)
        await instances_reach(client, 1)
        profile = PerfProfile([ProfilePoint(isl=64, osl=8, prefill_tok_s=10_000,
                                            decode_tok_s=100, ttft_s=0.05, itl_s=0.02)])
        planner = Planner(profile, LocalConnector(sup, decode_watcher="worker"),
                          PlannerConfig(predictor="constant", min_prefill=0, max_prefill=0,
                                        min_decode=1, max_decode=2, scale_down_headroom=1.0,
                                        cooldown_s=5.0))
        results: list = []
        stop, progress = asyncio.Event(), asyncio.Event()

        async def stream(k: int):
            i = 0
            while not stop.is_set():
                body = await chat(frontend.port, f"request {k}.{i} of the burst", max_tokens=8)
                results.append(body["usage"]["completion_tokens"])
                progress.set()
                i += 1

        async def served(n: int) -> None:
            while len(results) < n:
                progress.clear()
                await asyncio.wait_for(progress.wait(), 30)

        clients = [asyncio.ensure_future(stream(k)) for k in range(3)]
        # a burst: 20 requests a second x 8 tokens over 100 tok/s a replica
        up = await planner.step(WorkloadSample(request_rate=20, avg_isl=64, avg_osl=8,
                                               num_decode_replicas=1), now=0.0)
        assert (up.num_prefill, up.num_decode) == (0, 2)
        await instances_reach(client, 2)
        assert sup.replica_count("worker") == 2
        await served(len(results) + 8)
        # round robin: both replicas took requests
        handled = [json.loads(await rt.plane.bus.request(
            stats_subject(inst.subject), b"", timeout=30))["handled_total"]
            for inst in client.instances]
        assert len(handled) == 2 and min(handled) > 0, handled
        # inside the scale-up's cooldown the fleet holds; after it, it shrinks
        hold = await planner.step(WorkloadSample(request_rate=1, avg_isl=64, avg_osl=8,
                                                 num_decode_replicas=2), now=1.0)
        assert hold.num_decode == 2
        down = await planner.step(WorkloadSample(request_rate=1, avg_isl=64, avg_osl=8,
                                                 num_decode_replicas=2), now=6.0)
        assert down.num_decode == 1
        await instances_reach(client, 1)
        assert sup.replica_count("worker") == 1
        stop.set()
        await asyncio.gather(*clients)
        assert results and all(n == 8 for n in results)  # none lost, every one complete
        assert sup.replica_count("prefill") == 0
    finally:
        if watcher is not None:
            await watcher.stop()
        if frontend is not None:
            await frontend.stop()
        await sup.stop()
        await rt.close()
        await server.stop()
