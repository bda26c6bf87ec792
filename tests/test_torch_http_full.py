"""The port's full HTTP frontend and its engine's telemetry, held against the
JAX stack on the CPU.

- Admission control: the controller and the HTTP service of each package
  on the cases of tests/robustness/test_admission.py and
  tests/llm/test_slo_exemplars.py (a full queue sheds 429 at once, a queue
  timeout 503, a burst gets ``Retry-After``, a slot is released after its
  request, burn-rate shedding and its hook off by default).
- The served stack: ``serve_worker`` / ``serve_frontend`` of each package
  on a named memory plane with tests/data/tiny-chat-model, KV-routed, the
  same requests: the ``/metrics`` families and values and ``/slo`` equal
  with timing values masked; ``n > 1`` choices, usage and finish reasons
  byte for byte, streamed and unary; the span tree of
  tests/llm/test_tracing_e2e.py with the same names, parents and
  attributes, the port with its decode overlap on and off; a minted
  ``x-request-id`` echoed; a burst through ``serve_frontend(admission=...)``.
- The engine's flight recorder and fault seam: step records, a preemption
  event and a ``step_error`` after ``DYN_FAULTS`` injects ``engine.step``
  once, and a stream after the fault equal to the JAX engine's.

Both sides run with ``DYN_TOPO=0`` (their ``dyn_topology_*`` families,
compared with the rest, render at zero: live maps would hold per-run worker
ids) and ``DYN_DISABLE_NATIVE=1``; both sides' SLO thresholds are set far
above any CPU latency so that every good / bad count is the same on both.
"""

import asyncio
import contextlib
import functools
import importlib
import itertools
import json
import os
import re
import tempfile
from pathlib import Path

import httpx
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import collect, request
from tests.test_torch_offload import family_models

ROOT = Path(__file__).parent.parent
MODEL_DIR = str(ROOT / "tests" / "data" / "tiny-chat-model")
ENGINE = dict(num_blocks=64, max_batch_size=4, max_model_len=128, prefill_buckets=(32, 64))
PKGS = ("dynamo_tpu_torch", "dynamo_tpu")
_names = itertools.count()


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@contextlib.contextmanager
def env(**values):
    """Set environment knobs for the duration of a stack's run."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# admission control, on each package
# ---------------------------------------------------------------------------


@pytest.fixture(params=PKGS, ids=["port", "ref"])
def pkg(request):
    counters = mod(request.param, "robustness.counters")
    counters.reset()
    yield request.param
    counters.reset()


def admission(pkg: str):
    return mod(pkg, "robustness.admission")


async def test_queue_full_sheds_429_at_once(pkg):
    a = admission(pkg)
    ctl = a.AdmissionController(a.AdmissionConfig(max_inflight=1, max_queue_depth=1,
                                                  queue_timeout_s=5))
    await ctl.acquire()
    waiter = asyncio.ensure_future(ctl.acquire())
    await asyncio.sleep(0.01)
    with pytest.raises(a.Overloaded) as exc:
        await ctl.acquire()
    assert exc.value.status == 429 and "queue full" in str(exc.value)
    assert mod(pkg, "robustness.counters").get("dyn_shed_total") == 1
    await ctl.release()
    await asyncio.wait_for(waiter, 2)
    assert ctl.inflight == 1
    await ctl.release()


async def test_queue_timeout_sheds_503(pkg):
    a = admission(pkg)
    ctl = a.AdmissionController(a.AdmissionConfig(max_inflight=1, max_queue_depth=1,
                                                  queue_timeout_s=0.1))
    await ctl.acquire()
    with pytest.raises(a.Overloaded) as exc:
        await ctl.acquire()
    assert exc.value.status == 503 and ctl.queue_depth == 0
    await ctl.release()
    disabled = a.AdmissionController(a.AdmissionConfig(max_inflight=0))
    for _ in range(10):
        await disabled.acquire()
    assert disabled.inflight == 0


async def test_burn_rate_sheds_and_the_hook_is_off_by_default(pkg):
    a = admission(pkg)
    ctl = a.AdmissionController(a.AdmissionConfig(max_inflight=1, max_queue_depth=4,
                                                  queue_timeout_s=5.0))
    burn = [0.0]
    ctl.burn_rate_fn = lambda: burn[0]
    ctl.shed_burn_threshold = 10.0
    await ctl.acquire()
    burn[0] = 99.0
    with pytest.raises(a.Overloaded) as exc:
        await ctl.acquire()
    assert exc.value.status == 429 and "burn" in str(exc.value)
    burn[0] = 0.0
    release = asyncio.ensure_future(ctl.release())
    await ctl.acquire()
    await release
    await ctl.release()
    off = a.AdmissionController(a.AdmissionConfig(max_inflight=1, max_queue_depth=0,
                                                  queue_timeout_s=0.1))
    off.burn_rate_fn = lambda: 1e9  # wired, but the threshold is 0
    await off.acquire()
    with pytest.raises(a.Overloaded) as exc:
        await off.acquire()
    assert "queue full" in str(exc.value)
    await off.release()


class SlowChatEngine:
    """Holds its admission slot a while, then 400s."""

    async def generate(self, ctx):
        await asyncio.sleep(0.5)
        raise ValueError("slow fake engine")


async def test_burst_sheds_with_retry_after_and_slots_are_released(pkg):
    a = admission(pkg)
    http = mod(pkg, "llm.http.service")
    service = http.HttpService(host="127.0.0.1", port=0, admission=a.AdmissionConfig(
        max_inflight=1, max_queue_depth=0, queue_timeout_s=1, retry_after_s=3))
    service.manager.add_chat_model("tiny", SlowChatEngine())
    await service.start()
    try:
        async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{service.port}") as client:
            body = {"model": "tiny", "messages": [{"role": "user", "content": "x"}]}
            responses = await asyncio.gather(
                *[client.post("/v1/chat/completions", json=body, timeout=30) for _ in range(4)])
            codes = sorted(r.status_code for r in responses)
            assert codes.count(429) == 3 and codes.count(400) == 1, codes
            for r in responses:
                if r.status_code == 429:
                    assert r.headers.get("retry-after") == "3"
                    assert r.json()["error"]["code"] == "overloaded"
                    assert r.headers.get("x-request-id")
            for path in ("/health", "/live"):
                assert (await client.get(path)).status_code == 200
            assert "dyn_shed_total 3" in (await client.get("/metrics")).text
            # sequential requests never shed: each frees its slot
            for _ in range(5):
                r = await client.post("/v1/chat/completions", json={
                    "model": "absent", "messages": [{"role": "user", "content": "x"}]})
                assert r.status_code == 404
            assert service.admission.inflight == 0
            r = await client.post("/v1/embeddings", json={"model": "absent", "input": "x"})
            assert r.status_code == 404 and r.json()["error"]["code"] == "model_not_found"
    finally:
        await service.stop()


async def test_slo_endpoint_and_guard_exemplars(pkg):
    http = mod(pkg, "llm.http.service")
    metrics = mod(pkg, "llm.http.metrics")
    service = http.HttpService(host="127.0.0.1", port=0)
    g = service.metrics.guard("m", "chat_completions", "stream", trace_id="x1")
    g.token_observed()
    g.token_observed()
    g.mark_ok()
    g.done()
    bad = service.metrics.guard("m", "chat_completions", "unary", trace_id="boom")
    bad.done()  # never marked ok: a server error burns the error budget
    try:
        await service.start()
        async with httpx.AsyncClient() as client:
            r = await client.get(f"http://127.0.0.1:{service.port}/slo")
            body = (await client.get(f"http://127.0.0.1:{service.port}/metrics")).text
        payload = r.json()
        assert set(payload["objectives"]) == {"ttft", "itl", "error_rate"}
        assert payload["objectives"]["error_rate"]["bad_total"] == 1
        assert payload["worst_burn_rate"] > 0
        assert any(e["trace_id"] == "x1" for e in payload["exemplars"][metrics.TTFT_FAMILY])
        assert '# EXEMPLAR' in body and 'trace_id="x1"' in body
    finally:
        await service.stop()


# ---------------------------------------------------------------------------
# the served stacks
# ---------------------------------------------------------------------------

# requests whose answers are compared byte for byte: n > 1, greedy and
# seeded, streamed and unary, chat and completions
N_REQUESTS = [
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello there"}],
                              "max_tokens": 6, "temperature": 0, "n": 2}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "pick one"}],
                              "max_tokens": 5, "temperature": 1.1, "seed": 17, "n": 3,
                              "stream": True, "stream_options": {"include_usage": True}}),
    ("/v1/completions", {"prompt": "abcdef", "max_tokens": 7, "temperature": 0.9,
                         "seed": 5, "n": 2}),
    ("/v1/completions", {"prompt": "xyz", "max_tokens": 4, "temperature": 0, "n": 2,
                         "stream": True}),
]
# more traffic for /metrics: unary, streamed, a 404 and a 400
METRIC_REQUESTS = [
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "count: abc"}],
                              "max_tokens": 6, "temperature": 0, "stream": True}),
    ("/v1/completions", {"prompt": "the quick brown fox", "max_tokens": 5, "temperature": 0}),
    ("/v1/completions", {"model": "nope", "prompt": "x", "max_tokens": 2}),
    ("/v1/completions", {"prompt": "x", "max_tokens": 2, "n": 17}),
]
# the span tree of one traced request: every layer's span (the worker's
# closes after the stream, so the tree is read once every one is there)
SPAN_NAMES = {"http.request", "router.schedule", "dispatch", "worker.handle",
              "engine.queue", "engine.prefill", "engine.decode"}
TRACE_BODY = {"messages": [{"role": "user", "content": "trace me please"}], "max_tokens": 8,
              "stream": True}
# timing-valued samples: masked before the two stacks' scrapes are compared
TIMED = re.compile(r"(_seconds_(bucket|sum)|_created|^dyn_flight_|^dyn_slo_burn_rate)")


def scrub(obj):
    """A response body without the values that differ run to run: ids,
    creation times and fingerprints."""
    if isinstance(obj, dict):
        return {k: scrub(v) for k, v in obj.items()
                if k not in ("id", "created", "system_fingerprint")}
    if isinstance(obj, list):
        return [scrub(v) for v in obj]
    return obj


def sse_chunks(text: str) -> dict:
    """A streamed response's chunks, each choice's in its own order (the
    choices of ``n > 1`` interleave as their sub-streams deliver) and the
    chunks without a choice (usage) apart."""
    out: dict = {"no_choice": []}
    for line in text.splitlines():
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        chunk = scrub(json.loads(line[6:]))
        if not chunk.get("choices"):
            out["no_choice"].append(chunk)
        for choice in chunk.get("choices", []):
            rest = {k: v for k, v in chunk.items() if k != "choices"}
            out.setdefault(choice["index"], []).append({**rest, "choice": choice})
    return out


def exposition(text: str) -> dict:
    """{(sample name, labels): value} of a Prometheus text body, timing
    values masked; exemplar lines keep their family only."""
    out = {}
    for line in text.splitlines():
        if line.startswith("# EXEMPLAR"):
            out[("exemplar", line.split()[2].split("_bucket")[0])] = "*"
            continue
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        name = key.split("{")[0]
        out[(name, key[len(name):])] = "*" if TIMED.search(name) else float(value)
    return out


def slo_view(payload: dict) -> dict:
    objectives = {
        name: {k: v for k, v in o.items() if k != "windows"} | {"windows": sorted(o["windows"])}
        for name, o in payload["objectives"].items()
    }
    return {"objectives": objectives, "exemplars": sorted(payload["exemplars"]),
            "keys": sorted(payload)}


def span_view(spans) -> list:
    """The tree of one trace: (name, parent's name, component, status,
    attributes), timing values masked and the ids of instances dropped."""
    by_id = {s.span_id: s for s in spans}
    rows = []
    for s in spans:
        parent = by_id[s.parent_span_id].name if s.parent_span_id in by_id else None
        if s.name.startswith("engine.") or s.name == "http.request":
            attrs = {k: ("*" if k.endswith("_s") else v) for k, v in s.attrs.items()}
        else:
            attrs = sorted(s.attrs)
        rows.append((s.name, parent, s.component, s.status, json.dumps(attrs, sort_keys=True)))
    return sorted(rows)


async def wait_for(cond, what: str, timeout: float = 60.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        result = cond()
        if asyncio.iscoroutine(result):
            result = await result
        if result:
            return result
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.02)


async def drive_stack(pkg: str, overlap: bool | None = None) -> dict:
    """One package's worker and KV-routed frontend on a named memory plane:
    the traced request, the ``n > 1`` requests, the metric traffic and the
    scrapes, a minted request id, then a burst through a second frontend
    with admission control."""
    port = pkg == "dynamo_tpu_torch"
    obs = mod(pkg, "observability")
    obs.set_recorder(obs.SpanRecorder(max_spans=8192))
    mod(pkg, "robustness.counters").reset()
    serve = mod(pkg, "serve")
    RouterMode = mod(pkg, "runtime.client").RouterMode
    rt = await mod(pkg, "runtime").DistributedRuntime.create(mod(pkg, "utils.config").RuntimeConfig(
        control_plane=f"memory://http-full-{next(_names)}"))
    kw = dict(ENGINE, device="cpu", decode_overlap=overlap) if port else dict(ENGINE)
    frontends = []
    worker = None
    out = {}
    try:
        worker = await serve.serve_worker(rt, MODEL_DIR, model_name="tiny",
                                          engine_kind="torch" if port else "jax", **kw)
        frontends.append(await serve.serve_frontend(rt, host="127.0.0.1", port=0,
                                                    router_mode=RouterMode.KV))
        base = f"http://127.0.0.1:{frontends[0][0].port}"
        async with httpx.AsyncClient(base_url=base, timeout=120) as client:
            await wait_for(listed_on(client), "model discovery")
            rid = f"trace-{pkg}-{overlap}"
            async with client.stream("POST", "/v1/chat/completions",
                                     headers={"x-request-id": rid},
                                     json={"model": "tiny", **TRACE_BODY}) as r:
                assert r.status_code == 200 and r.headers["x-request-id"] == rid
                await r.aread()
            rec = obs.get_recorder()
            await wait_for(lambda: SPAN_NAMES <= {s.name for s in rec.spans_for(rid)},
                           "the span tree")
            out["spans"] = span_view(rec.spans_for(rid))
            out["summary"] = {k: v for k, v in rec.summary(rid).items()
                              if k in ("status", "tokens_out")}
            out["n"] = []
            for path, body in N_REQUESTS:
                r = await client.post(path, json={"model": "tiny", **body})
                out["n"].append((r.status_code, sse_chunks(r.text) if body.get("stream")
                                 else scrub(r.json())))
            out["codes"] = []
            for path, body in METRIC_REQUESTS:
                r = await client.post(path, json={"model": "tiny", **body})
                out["codes"].append(r.status_code)
            out["metrics"] = exposition((await client.get("/metrics")).text)
            out["slo"] = slo_view((await client.get("/slo")).json())
            r = await client.post("/v1/completions", json={"model": "tiny", "prompt": "hi",
                                                           "max_tokens": 2})
            minted = r.headers.get("x-request-id")
            out["minted"] = bool(minted) and "http.request" in {
                s.name for s in rec.spans_for(minted)}

        # a burst through a frontend with admission control
        gate = mod(pkg, "robustness.admission").AdmissionConfig(
            max_inflight=1, max_queue_depth=0, queue_timeout_s=1, retry_after_s=3)
        frontends.append(await serve.serve_frontend(rt, host="127.0.0.1", port=0,
                                                    router_mode=RouterMode.KV, admission=gate))
        async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{frontends[1][0].port}",
                                     timeout=120) as client:
            await wait_for(listed_on(client), "model discovery")
            body = {"model": "tiny", "prompt": "burst of four", "max_tokens": 32,
                    "temperature": 0, "ext": {"ignore_eos": True}}
            responses = await asyncio.gather(*[client.post("/v1/completions", json=body)
                                               for _ in range(4)])
            out["burst"] = sorted((r.status_code, r.headers.get("retry-after"))
                                  for r in responses)
    finally:
        for service, watcher in frontends:
            await watcher.stop()
            await service.stop()
        if worker is not None:
            await worker.shutdown()
        await rt.close()
    return out


def listed_on(client):
    async def listed():
        r = await client.get("/v1/models")
        return "tiny" in [m["id"] for m in r.json().get("data", [])]
    return listed


@functools.cache
def served(pkg: str, overlap: bool | None = None) -> dict:
    with tempfile.TemporaryDirectory() as flight_dir, env(
            DYN_TOPO="0", DYN_DISABLE_NATIVE="1", DYN_SLO_TTFT_S="600", DYN_SLO_ITL_S="600",
            DYN_FLIGHT_DIR=flight_dir):
        return asyncio.run(drive_stack(pkg, overlap))


def test_metrics_and_slo_equal_the_jax_stack():
    ours, ref = served("dynamo_tpu_torch", True), served("dynamo_tpu")
    assert ours["codes"] == ref["codes"] == [200, 200, 404, 400]
    assert ours["metrics"] == ref["metrics"]
    families = {name for name, _ in ours["metrics"]}
    for family in ("dyn_llm_http_service_requests_total",
                   "dyn_llm_http_service_time_to_first_token_seconds_count",
                   "dyn_llm_http_service_output_sequence_tokens_sum",
                   "dyn_slo_good_total", "dyn_flight_records_total", "dyn_shed_total",
                   "dyn_topology_nodes", "dyn_topology_links", "dyn_topology_map_age_seconds"):
        assert family in families, family
    assert ours["slo"] == ref["slo"]


def test_n_choices_equal_the_jax_stack():
    ours, ref = served("dynamo_tpu_torch", True), served("dynamo_tpu")
    assert ours["n"] == ref["n"]
    status, body = ours["n"][0]
    assert status == 200 and [c["index"] for c in body["choices"]] == [0, 1]
    assert body["usage"]["completion_tokens"] == 12
    streamed = ours["n"][1][1]
    assert sorted(k for k in streamed if k != "no_choice") == [0, 1, 2]
    assert streamed["no_choice"][-1]["usage"]["completion_tokens"] == 15
    # seeded choices draw seed + i: not all the same
    texts = [c["text"] for c in ours["n"][2][1]["choices"]]
    assert len(texts) == 2


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_span_tree_equals_the_jax_stack(overlap):
    ours, ref = served("dynamo_tpu_torch", overlap), served("dynamo_tpu")
    assert ours["spans"] == ref["spans"]
    assert {row[0] for row in ours["spans"]} == SPAN_NAMES
    prefill = [row for row in ours["spans"] if row[0] == "engine.prefill"]
    assert len(prefill) == 1 and '"ttft_s": "*"' in prefill[0][4]
    assert ours["summary"] == ref["summary"] == {"status": "success", "tokens_out": 8}
    assert ours["minted"] and ref["minted"]


def test_admission_burst_through_the_served_stack():
    ours, ref = served("dynamo_tpu_torch", True), served("dynamo_tpu")
    assert ours["burst"] == ref["burst"] == [(200, None)] + [(429, "3")] * 3


# ---------------------------------------------------------------------------
# the engine's flight recorder and fault seam
# ---------------------------------------------------------------------------


async def fault_run(engine, ctx_cls, faults):
    """Arm ``engine.step`` to fail once, wait for the loop to record it,
    then serve two requests that preempt each other."""
    engine.start()
    try:
        faults.arm_from_env()
        await wait_for(lambda: any(r.get("event") == "step_error"
                                   for r in engine.flight.records()), "the step error")
        prompts = [list(range(3, 13)), list(range(40, 50))]
        streams = await asyncio.gather(*[
            collect(engine, request(p, max_tokens=12, ignore_eos=True), ctx_cls) for p in prompts])
        return streams, engine.flight.records(), engine.stats()
    finally:
        engine.stop()
        faults.reset()


async def test_flight_ring_and_fault_seam_match_the_jax_engine(monkeypatch, tmp_path):
    monkeypatch.setenv("DYN_FAULTS", "engine.step:once:exc=RuntimeError")
    monkeypatch.setenv("DYN_FLIGHT_DIR", str(tmp_path))
    name, cfg, jcfg, params, jparams = family_models("llama")
    geometry = dict(num_blocks=8, block_size=4, max_batch_size=2, max_model_len=24,
                    prefill_buckets=(16,))
    ref = await fault_run(JaxLlmEngine(JaxEngineConfig(model=jcfg, decode_overlap=False,
                                                       **geometry), params=jparams),
                          JaxContext, mod("dynamo_tpu", "robustness.faults").FAULTS)
    ours = await fault_run(TorchLlmEngine(EngineConfig(model=cfg, **geometry), params=params,
                                          device="cpu"),
                           Context, mod("dynamo_tpu_torch", "robustness.faults").FAULTS)
    assert ours[0] == ref[0]
    for streams, records, stats in (ours, ref):
        kinds = [r["kind"] for r in records]
        events = [r["event"] for r in records if r["kind"] == "event"]
        assert "step" in kinds and "step_error" in events and "preemption" in events
        error = next(r for r in records if r.get("event") == "step_error")
        assert error["error"].startswith("RuntimeError")
        preempt = next(r for r in records if r.get("event") == "preemption")
        assert preempt["count"] >= 1 and stats["num_preemptions_total"] >= 1
        assert stats["flight_records_total"] == len(records) and stats["flight_dumps_total"] >= 1
        step = next(r for r in records if r["kind"] == "step")
        assert set(step) == {"kind", "t", "iteration", "num_running", "num_waiting",
                             "kv_usage", "prefill_tokens", "decode_tokens", "emitted_tokens",
                             "step_duration_s", "mfu", "goodput_tok_s"}
    assert list(tmp_path.glob("flight-engine-*-step_error.jsonl"))


async def test_a_stopped_frontend_leaves_its_engine_collectable():
    """aiohttp caches each route's middleware chain by its bound handler; a
    stopped service drops that cache, so its models and their engine (on a
    card, its weights and cache) are freed with the last reference."""
    import gc
    import weakref

    from dynamo_tpu_torch.serve import serve_http

    handle = await serve_http(MODEL_DIR, model_name="tiny", host="127.0.0.1", port=0,
                              device="cpu", **ENGINE)
    engine = weakref.ref(handle.engine)
    try:
        async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{handle.service.port}",
                                     timeout=60) as client:
            r = await client.post("/v1/completions", json={
                "model": "tiny", "prompt": "abc", "max_tokens": 2, "temperature": 0})
            assert r.status_code == 200 and r.headers.get("x-request-id")
    finally:
        await handle.shutdown()
    del handle
    gc.collect()
    assert engine() is None
