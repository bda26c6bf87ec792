"""The port's HTTP stack (dynamo_tpu_torch.serve.serve_http on the CPU)
against the JAX worker behind the reference frontend: the same chat and
completion requests, unary and streamed, give the same content."""

import asyncio
import json
from pathlib import Path

import httpx

from dynamo_tpu.runtime import DistributedRuntime
from dynamo_tpu.runtime.controlplane.memory import MemoryControlPlane
from dynamo_tpu.serve import serve_frontend, serve_worker
from dynamo_tpu.utils.config import RuntimeConfig
from dynamo_tpu_torch.cli.run import parse_args
from dynamo_tpu_torch.serve import serve_http

MODEL_DIR = str(Path(__file__).parent / "data" / "tiny-chat-model")
ENGINE = dict(num_blocks=64, max_batch_size=4, max_model_len=128, prefill_buckets=(32, 64))

REQUESTS = [
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello there"}],
                              "max_tokens": 10, "temperature": 0}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "count: abc"}],
                              "max_tokens": 6, "temperature": 0, "stream": True}),
    ("/v1/completions", {"prompt": "abcdef", "max_tokens": 7, "temperature": 0}),
    ("/v1/completions", {"prompt": "xyz", "max_tokens": 5, "temperature": 0, "stream": True}),
]


async def ask_all(base_url: str, model: str) -> list:
    out = []
    async with httpx.AsyncClient(base_url=base_url, timeout=60) as client:
        for _ in range(100):  # the reference frontend discovers its worker
            r = await client.get("/v1/models")
            if model in [m["id"] for m in r.json().get("data", [])]:
                break
            await asyncio.sleep(0.1)
        for path, body in REQUESTS:
            r = await client.post(path, json={"model": model, **body})
            assert r.status_code == 200, r.text
            if not body.get("stream"):
                choice = r.json()["choices"][0]
                out.append((choice.get("message", {}).get("content") or choice.get("text"),
                            choice["finish_reason"], r.json()["usage"]))
                continue
            text, finish = "", None
            for line in r.text.splitlines():
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                for choice in json.loads(line[6:]).get("choices", []):
                    delta = choice.get("delta", {}).get("content") or choice.get("text") or ""
                    text += delta
                    finish = choice.get("finish_reason") or finish
            out.append((text, finish, None))
    return out


async def test_port_http_content_equals_jax_worker():
    MemoryControlPlane.reset_named()
    rt = await DistributedRuntime.create(RuntimeConfig(control_plane="memory://torch-serve-test"))
    service = watcher = worker = None
    try:
        worker = await serve_worker(rt, MODEL_DIR, model_name="tiny", engine_kind="jax",
                                    decode_overlap=False, **ENGINE)
        service, watcher = await serve_frontend(rt, host="127.0.0.1", port=0)
        ref = await ask_all(f"http://127.0.0.1:{service.port}", "tiny")
    finally:
        if watcher:
            await watcher.stop()
        if service:
            await service.stop()
        if worker:
            await worker.shutdown()
        await rt.close()

    handle = await serve_http(MODEL_DIR, model_name="tiny", host="127.0.0.1", port=0,
                              device="cpu", **ENGINE)
    try:
        ours = await ask_all(f"http://127.0.0.1:{handle.service.port}", "tiny")
        async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{handle.service.port}") as c:
            health = (await c.get("/health")).json()
            missing = await c.post("/v1/chat/completions", json={
                "model": "nope", "messages": [{"role": "user", "content": "x"}]})
            image = await c.post("/v1/chat/completions", json={
                "model": "tiny", "messages": [{"role": "user", "content": [
                    {"type": "text", "text": "what is this"},
                    {"type": "image_url", "image_url": {"url": "data:image/png;base64,AA=="}},
                ]}]})
        stats = handle.engine.stats()
    finally:
        await handle.shutdown()
    assert ours == ref
    assert ours[0][0].startswith('!"#$%&')  # the token-counter continuation
    assert health["models"] == ["tiny"]
    assert missing.status_code == 404
    assert image.status_code == 400  # multimodal input is a later slice
    assert stats["decode_windows_unified_total"] > 0


def test_cli_parses_the_run_line():
    args = parse_args(["run", "in=http", "out=torch", "--model-path", MODEL_DIR,
                       "--device", "cpu", "--port", "0"])
    assert (args.input, args.output, args.device) == ("http", "torch", "cpu")
