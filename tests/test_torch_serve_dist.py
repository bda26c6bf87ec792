"""The port's distributed serving path (``serve_worker`` / ``serve_frontend``
over the runtime) against the JAX package's on the same requests, two port
workers behind the KV router, cancellation from the HTTP client down to the
engine, and a worker in its own process behind a TCP control plane.

The JAX side runs with ``DYN_TOPO=0``, ``DYN_PREFETCH=0`` and
``DYN_DISABLE_NATIVE=1``, so both sides route with the same algorithm (the
port has no topology plane or native codecs yet; its prefetch hints are
held in tests/test_torch_prefetch.py and test_torch_http_full.py).  The
two-worker test puts two ``TorchLlmEngine``s in one process on the CPU,
where they capture no graph; on the card each worker is its own process.
"""

import asyncio
import itertools
import json
import os
import signal
import sys
import time
from pathlib import Path

import httpx
import pytest

from dynamo_tpu_torch.cli.run import parse_args

ROOT = Path(__file__).parent.parent
MODEL_DIR = str(ROOT / "tests" / "data" / "tiny-chat-model")
ENGINE = dict(num_blocks=64, max_batch_size=4, max_model_len=128, prefill_buckets=(32, 64))
_names = itertools.count()

CHAT = [
    ({"messages": [{"role": "user", "content": "hello there"}], "max_tokens": 10,
      "temperature": 0}),
    ({"messages": [{"role": "user", "content": "count: abc"}], "max_tokens": 6,
      "temperature": 0, "stream": True}),
]
COMPLETIONS = [
    {"prompt": "abcdef", "max_tokens": 7, "temperature": 0},
    {"prompt": "xyz", "max_tokens": 5, "temperature": 0, "stream": True},
    # a seeded sampled stream
    {"prompt": "hello world", "max_tokens": 9, "temperature": 1.3, "seed": 4321,
     "stream": True},
    {"prompt": "the quick brown fox", "max_tokens": 8, "temperature": 0.8, "top_k": 20,
     "seed": 99},
]
TOKEN_PROMPTS = [list(range(5, 30)), [7, 8, 9], list(range(60, 75))]


@pytest.fixture
def same_algorithm_env(monkeypatch):
    for knob in ("DYN_TOPO", "DYN_PREFETCH"):
        monkeypatch.setenv(knob, "0")
    monkeypatch.setenv("DYN_DISABLE_NATIVE", "1")


def stack(pkg: str):
    """(runtime module, serve module, RouterMode, config module) of a package."""
    import importlib

    return (importlib.import_module(f"{pkg}.runtime"), importlib.import_module(f"{pkg}.serve"),
            importlib.import_module(f"{pkg}.runtime.client").RouterMode,
            importlib.import_module(f"{pkg}.utils.config"))


async def wait_for(predicate, timeout: float = 30.0, what: str = "condition"):
    deadline = time.monotonic() + timeout
    while True:
        result = predicate()
        if asyncio.iscoroutine(result):
            result = await result
        if result:
            return result
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} never held")
        await asyncio.sleep(0.02)


async def listed_models(client) -> list[str]:
    r = await client.get("/v1/models")
    return [m["id"] for m in r.json().get("data", [])]


def parse_sse(text: str):
    chunks, finish, usage = "", None, None
    for line in text.splitlines():
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        body = json.loads(line[6:])
        usage = body.get("usage") or usage
        for choice in body.get("choices", []):
            chunks += choice.get("delta", {}).get("content") or choice.get("text") or ""
            finish = choice.get("finish_reason") or finish
    return chunks, finish, usage


async def ask(client, path: str, body: dict):
    r = await client.post(path, json={"model": "tiny", **body})
    assert r.status_code == 200, r.text
    if body.get("stream"):
        return parse_sse(r.text)
    choice = r.json()["choices"][0]
    return (choice.get("message", {}).get("content") or choice.get("text"),
            choice["finish_reason"], r.json()["usage"])


async def run_stack(pkg: str, engine_kind: str, **engine):
    """Serve the tiny model through one package's worker and KV-routed
    frontend; return the HTTP answers and the token ids the worker's
    endpoint streams for ``TOKEN_PROMPTS``."""
    runtime_mod, serve, RouterMode, config = stack(pkg)
    proto = __import__(f"{pkg}.llm.protocols.common", fromlist=["PreprocessedRequest"])
    engine_mod = __import__(f"{pkg}.runtime.engine", fromlist=["Context"])
    client_mod = __import__(f"{pkg}.runtime.client", fromlist=["PushRouter"])
    rt = await runtime_mod.DistributedRuntime.create(config.RuntimeConfig(
        control_plane=f"memory://serve-dist-{pkg}-{next(_names)}"))
    service = watcher = worker = None
    try:
        worker = await serve.serve_worker(rt, MODEL_DIR, model_name="tiny",
                                          engine_kind=engine_kind, **engine)
        service, watcher = await serve.serve_frontend(rt, host="127.0.0.1", port=0,
                                                      router_mode=RouterMode.KV)
        answers = []
        async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{service.port}",
                                     timeout=60) as client:
            await wait_for(lambda: listed_models(client), what="model discovery")
            for body in CHAT:
                answers.append(await ask(client, "/v1/chat/completions", body))
            for body in COMPLETIONS:
                answers.append(await ask(client, "/v1/completions", body))
        ep = rt.namespace("dynamo").component("backend").endpoint("generate")
        router = await client_mod.PushRouter.from_endpoint(ep)
        token_ids = []
        for prompt in TOKEN_PROMPTS:
            req = proto.PreprocessedRequest(
                token_ids=prompt, stop=proto.StopConditions(max_tokens=6, ignore_eos=True),
                sampling=proto.SamplingOptions(use_greedy=True), eos_token_ids=[])
            out = []
            async for item in await router.generate(engine_mod.Context(req.to_wire())):
                out.extend((item.get("data") or {}).get("token_ids") or [])
            token_ids.append(out)
        return answers, token_ids
    finally:
        if watcher:
            await watcher.stop()
        if service:
            await service.stop()
        if worker:
            await worker.shutdown()
        await rt.close()


async def test_distributed_path_equals_the_jax_stack(same_algorithm_env):
    """Greedy chat content and completion token ids (unary and streamed), a
    seeded sampled stream, finish reasons and usage: the port's worker and
    frontend answer as the JAX package's do."""
    ref = await run_stack("dynamo_tpu", "jax", **ENGINE)
    ours = await run_stack("dynamo_tpu_torch", "torch", device="cpu", warmup=True, **ENGINE)
    assert ours == ref
    answers, token_ids = ours
    assert answers[0][0].startswith('!"#$%&')  # the token-counter continuation
    assert token_ids[0] == list(range(30, 36))
    assert all(a[1] == "length" for a in answers)


async def test_two_port_workers_behind_kv_routing():
    """Follow-up turns go to the worker that holds their prefix; a flush
    empties both workers and the router's index; the model goes with its
    last instance."""
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.runtime.client import RouterMode
    from dynamo_tpu_torch.serve import serve_frontend, serve_worker
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    rt = await DistributedRuntime.create(RuntimeConfig(
        control_plane=f"memory://serve-dist-kv-{next(_names)}"))
    workers = []
    service = watcher = None
    engine = dict(num_blocks=64, max_batch_size=4, max_model_len=256, device="cpu")
    try:
        for _ in range(2):
            workers.append(await serve_worker(rt, MODEL_DIR, model_name="tiny",
                                              engine_kind="torch", **engine))
        service, watcher = await serve_frontend(rt, host="127.0.0.1", port=0,
                                                router_mode=RouterMode.KV)
        ids = [w.service.instance.instance_id for w in workers]

        def stats():
            return [w.engine.stats() for w in workers]

        async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{service.port}",
                                     timeout=60) as client:
            await wait_for(lambda: listed_models(client), what="model discovery")
            kv = watcher._pipelines["tiny"]["kv"]
            push = watcher._pipelines["tiny"]["router"]
            await wait_for(lambda: len(push.client.instances) == 2, what="both instances")
            # first turns tie (no worker holds their prefix): break the ties
            # in turn, so the sessions spread over both workers every run
            kv.scheduler._rng = AlternatingChoice()
            followed = []
            for session in range(4):
                # completions, so no chat template's preamble is shared:
                # a session's first block is its own
                turn1 = (f"session {session}: " + "the quick brown fox jumps " * 6
                         + f"first question {session}")
                before = stats()
                held = [kv.indexer.tree.worker_block_count(i) for i in ids]
                r = await client.post("/v1/completions", json={
                    "model": "tiny", "prompt": turn1, "max_tokens": 4, "temperature": 0})
                assert r.status_code == 200
                reply = r.json()["choices"][0]["text"]
                after = stats()
                served = [a["tokens_emitted_total"] > b["tokens_emitted_total"]
                          for a, b in zip(after, before)].index(True)
                # the router learns the first turn's blocks from the worker
                await wait_for(
                    lambda: kv.indexer.tree.worker_block_count(ids[served]) > held[served],
                    what="stored events at the router")
                turn2 = turn1 + reply + " and a follow-up"
                before = stats()
                r = await client.post("/v1/completions", json={
                    "model": "tiny", "prompt": turn2, "max_tokens": 4, "temperature": 0})
                assert r.status_code == 200
                after = stats()
                hits = [a["prefix_hits_total"] - b["prefix_hits_total"]
                        for a, b in zip(after, before)]
                followed.append((served, hits))
            for served, hits in followed:
                assert hits[served] == 1 and hits[1 - served] == 0, followed
            assert all(s["kv_cached_blocks"] > 0 for s in stats()), \
                "every session on one worker: the test drew no spread"

            r = await client.post("/clear_kv_blocks")
            assert r.status_code == 200 and r.json()["status"] == "ok"
            await wait_for(lambda: all(s["kv_cached_blocks"] == 0 for s in stats()),
                           what="both workers flushed")
            await wait_for(lambda: kv.indexer.tree.size() == 0, what="router index emptied")

            await workers[0].shutdown()
            await wait_for(lambda: len(push.client.instances) == 1, what="one instance left")
            assert await listed_models(client) == ["tiny"]
            r = await client.post("/v1/chat/completions", json={
                "model": "tiny", "messages": [{"role": "user", "content": "still here"}],
                "max_tokens": 3, "temperature": 0})
            assert r.status_code == 200
            await workers[1].shutdown()
            await wait_for(lambda: _empty(listed_models(client)), what="model removal")
            r = await client.post("/v1/chat/completions", json={
                "model": "tiny", "messages": [{"role": "user", "content": "gone"}]})
            assert r.status_code == 404
    finally:
        if watcher:
            await watcher.stop()
        if service:
            await service.stop()
        for w in workers:
            await w.shutdown()
        await rt.close()


class AlternatingChoice:
    """A tie-break that takes the candidates in turn (sorted by id)."""

    def __init__(self):
        self.turn = 0

    def choice(self, seq):
        if len(seq) == 1:
            return seq[0]
        self.turn += 1
        return sorted(seq)[self.turn % len(seq)]


async def _empty(coro) -> bool:
    return not await coro


async def test_client_disconnect_cancels_down_to_the_engine():
    """An SSE client that drops its stream cancels through the frontend,
    the router, the TCP data plane and the ingress: the engine aborts the
    sequence and frees its blocks long before its token budget."""
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.serve import serve_frontend, serve_worker
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    rt = await DistributedRuntime.create(RuntimeConfig(
        control_plane=f"memory://serve-dist-cancel-{next(_names)}"))
    worker = service = watcher = None
    budget = 900
    try:
        worker = await serve_worker(rt, MODEL_DIR, model_name="tiny", engine_kind="torch",
                                    device="cpu", num_blocks=128, max_model_len=1024)
        service, watcher = await serve_frontend(rt, host="127.0.0.1", port=0)
        async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{service.port}",
                                     timeout=60) as client:
            await wait_for(lambda: listed_models(client), what="model discovery")
            body = {"model": "tiny", "messages": [{"role": "user", "content": "go on"}],
                    "max_tokens": budget, "temperature": 0, "stream": True,
                    "ignore_eos": True}
            async with client.stream("POST", "/v1/chat/completions", json=body) as r:
                assert r.status_code == 200
                seen = 0
                async for line in r.aiter_lines():
                    if line.startswith("data: "):
                        seen += 1
                    if seen == 4:
                        break
        engine = worker.engine
        await wait_for(lambda: engine.stats()["num_requests_running"] == 0,
                       what="engine abort")
        stats = engine.stats()
        assert stats["kv_active_blocks"] == 0
        assert stats["tokens_emitted_total"] < budget
        await wait_for(lambda: worker.service._in_flight == 0, what="ingress drained")
    finally:
        if watcher:
            await watcher.stop()
        if service:
            await service.stop()
        if worker:
            await worker.shutdown()
        await rt.close()


async def test_worker_process_behind_a_tcp_control_plane():
    """``run in=none out=torch --device cpu`` in its own process registers
    with the port's control-plane server; a KV-routed frontend here serves
    a chat from it; a SIGTERM stops it and its model goes."""
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.runtime.client import RouterMode
    from dynamo_tpu_torch.runtime.controlplane.server import ControlPlaneServer
    from dynamo_tpu_torch.serve import serve_frontend
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    server = ControlPlaneServer(port=0)
    await server.start()
    address = f"127.0.0.1:{server.port}"
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_tpu_torch.cli.run", "run", "in=none", "out=torch",
        "--model-path", MODEL_DIR, "--model-name", "tiny", "--device", "cpu",
        "--control-plane", address, "--num-blocks", "64", "--warmup",
        cwd=str(ROOT), env=env,
        stdout=asyncio.subprocess.DEVNULL, stderr=asyncio.subprocess.PIPE,
    )
    runtime = service = watcher = None
    try:
        runtime = await DistributedRuntime.create(RuntimeConfig(control_plane=address))
        service, watcher = await serve_frontend(runtime, host="127.0.0.1", port=0,
                                                router_mode=RouterMode.KV)
        async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{service.port}",
                                     timeout=60) as client:
            await wait_for(lambda: listed_models(client), timeout=50,
                           what="the worker process's model")
            content, finish, usage = await ask(client, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": "abc"}], "max_tokens": 6,
                "temperature": 0})
            assert content == '!"#$' and finish == "length"  # two tokens print nothing
            assert usage["completion_tokens"] == 6
            proc.send_signal(signal.SIGTERM)
            assert await asyncio.wait_for(proc.wait(), 30) == 0
            await wait_for(lambda: _empty(listed_models(client)), what="model removal")
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
        if watcher:
            await watcher.stop()
        if service:
            await service.stop()
        if runtime:
            await runtime.close()
        await server.stop()


def test_cli_modes_and_refusals():
    worker = parse_args(["run", "in=none", "out=torch", "--model-path", "m",
                         "--control-plane", "h:1", "--warmup", "--device", "cpu"])
    assert (worker.input, worker.output, worker.control_plane, worker.warmup) == (
        "none", "torch", "h:1", True)
    frontend = parse_args(["run", "in=http", "out=dyn", "--control-plane", "h:1",
                           "--router-mode", "kv"])
    assert (frontend.output, frontend.router_mode, frontend.model_path) == ("dyn", "kv", None)
    local = parse_args(["run", "in=http", "out=echo", "--model-path", "m"])
    assert (local.control_plane, local.warmup) == (None, False)
    text = parse_args(["run", "in=text", "out=torch", "--model-path", "m"])
    batch = parse_args(["run", "in=batch:p.jsonl", "out=mocker", "--model-path", "m"])
    assert (text.input, batch.input, batch.output) == ("text", "batch:p.jsonl", "mocker")
    for bad in (["run", "in=http", "out=dyn"],                     # no control plane
                ["run", "in=none", "out=torch", "--model-path", "m"],
                ["run", "in=none", "out=dyn", "--control-plane", "h:1"],
                ["run", "in=file", "out=torch", "--model-path", "m"],
                ["run", "in=http", "out=jax", "--model-path", "m"],
                ["run", "in=http", "out=torch"],                    # no model
                ["run", "--model-path", "m", "--router-mode", "nearest"]):
        with pytest.raises(SystemExit):
            parse_args(bad)


async def test_later_subsystems_are_refused_by_name(monkeypatch):
    """Nothing of these is refused any more: ``engine_kind="mocker"`` serves
    the mocker (it registers its model with the KV event and load
    publishers wired to it), an unknown kind raises; admission
    control and the prefetch hinter are served: ``serve_frontend(admission=
    ...)`` gates its inference routes with the given config, a KV frontend
    builds a ``FrontendHinter`` under ``DYN_PREFETCH`` and hands it to its
    watcher."""
    from dynamo_tpu_torch.llm.discovery import ModelWatcher
    from dynamo_tpu_torch.prefetch.frontend import FrontendHinter
    from dynamo_tpu_torch.robustness.admission import AdmissionConfig
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.runtime.client import RouterMode
    from dynamo_tpu_torch.serve import serve_frontend, serve_worker
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    rt = await DistributedRuntime.create(RuntimeConfig(
        control_plane=f"memory://serve-dist-refuse-{next(_names)}"))
    frontends = []
    try:
        from dynamo_tpu_torch.llm.mocker import MockerEngine

        mocker = await serve_worker(rt, MODEL_DIR, engine_kind="mocker",
                                    component="mocker")
        try:
            assert isinstance(mocker.engine, MockerEngine)
            assert [type(p).__name__ for p in mocker.publishers] == [
                "KvEventPublisher", "WorkerMetricsPublisher"]
            assert mocker.engine._event_sink is not None
            from dynamo_tpu_torch.llm.discovery import MODELS_PREFIX, ModelEntry

            entries = [ModelEntry.from_json(e.value)
                       for e in await rt.plane.kv.get_prefix(MODELS_PREFIX)]
            assert [e.component for e in entries] == ["mocker"]
        finally:
            await mocker.shutdown()
        with pytest.raises(ValueError, match="unknown engine kind"):
            await serve_worker(rt, MODEL_DIR, engine_kind="jax")
        gate = AdmissionConfig(max_inflight=2, max_queue_depth=1)
        frontends.append(await serve_frontend(rt, host="127.0.0.1", port=0, admission=gate,
                                              router_mode=RouterMode.KV))
        service, watcher = frontends[-1]
        assert service.admission.config is gate and service.admission.enabled
        assert isinstance(watcher.prefetch_hinter, FrontendHinter)
        assert service.prefetch_hinter is watcher.prefetch_hinter
        monkeypatch.setenv("DYN_PREFETCH", "0")
        frontends.append(await serve_frontend(rt, host="127.0.0.1", port=0,
                                              router_mode=RouterMode.KV))
        assert frontends[-1][1].prefetch_hinter is None
        assert not frontends[-1][0].admission.enabled
        hinter = FrontendHinter()
        assert ModelWatcher(rt, None, prefetch_hinter=hinter).prefetch_hinter is hinter
    finally:
        for service, watcher in frontends:
            await watcher.stop()
            await service.stop()
        await rt.close()


async def test_echo_worker_and_request_template(tmp_path):
    """``out=echo`` behind the frontend, with a request template filling the
    model and the token budget."""
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.serve import serve_frontend, serve_worker
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    template = tmp_path / "template.json"
    template.write_text(json.dumps({"model": "tiny", "max_tokens": 3}))
    rt = await DistributedRuntime.create(RuntimeConfig(
        control_plane=f"memory://serve-dist-echo-{next(_names)}"))
    worker = service = watcher = None
    try:
        worker = await serve_worker(rt, MODEL_DIR, model_name="tiny", engine_kind="echo")
        service, watcher = await serve_frontend(rt, host="127.0.0.1", port=0,
                                                request_template=template)
        async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{service.port}",
                                     timeout=60) as client:
            await wait_for(lambda: listed_models(client), what="model discovery")
            r = await client.post("/v1/chat/completions", json={
                "messages": [{"role": "user", "content": "hello world again"}]})
            assert r.status_code == 200, r.text
            assert r.json()["usage"]["completion_tokens"] == 3
            r = await client.post("/clear_kv_blocks")
            assert r.json() == {"status": "ok", "cleared": ["dynamo.backend._events.clear_kv_blocks"]}
    finally:
        if watcher:
            await watcher.stop()
        if service:
            await service.stop()
        if worker:
            await worker.shutdown()
        await rt.close()
