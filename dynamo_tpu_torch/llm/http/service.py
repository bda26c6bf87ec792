"""OpenAI-compatible HTTP frontend (aiohttp), slim counterpart of
dynamo_tpu/llm/http/service.py.

Routes:
- ``POST /v1/chat/completions``  (streaming SSE + unary)
- ``POST /v1/completions``       (streaming SSE + unary)
- ``GET  /v1/models``
- ``GET  /health``

Request ids, admission control, metrics, tracing, embeddings and ``n > 1``
fan-out come with a later slice of the port.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any

from aiohttp import web

from dynamo_tpu_torch.llm.protocols import sse
from dynamo_tpu_torch.llm.protocols.aggregator import (
    aggregate_chat_stream,
    aggregate_completion_stream,
)
from dynamo_tpu_torch.llm.protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
    ModelInfo,
    ModelList,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("llm.http")


class ModelManager:
    """Per-model engine registry."""

    def __init__(self) -> None:
        self.chat_engines: dict[str, Any] = {}
        self.completion_engines: dict[str, Any] = {}

    def add_chat_model(self, name: str, engine: Any) -> None:
        self.chat_engines[name] = engine

    def add_completion_model(self, name: str, engine: Any) -> None:
        self.completion_engines[name] = engine

    def model_names(self) -> list[str]:
        return sorted(set(self.chat_engines) | set(self.completion_engines))


def _error(
    status: int,
    message: str,
    err_type: str = "invalid_request_error",
    *,
    param: str | None = None,
    code: str | None = None,
) -> web.Response:
    """OpenAI-shaped error body: ``{"error": {message, type, param, code}}``."""
    return web.json_response(
        {"error": {"message": message, "type": err_type, "param": param, "code": code}},
        status=status,
    )


def _validation_error(exc: Exception) -> web.Response:
    """Pydantic ValidationError → 400 naming the first violation's field."""
    try:
        first = exc.errors()[0]
        loc = [str(p) for p in first.get("loc", ()) if not isinstance(p, int)]
        param = loc[0] if loc else None
        message = f"{'.'.join(loc) or 'request'}: {first.get('msg', 'invalid')}"
    except (AttributeError, IndexError, TypeError):
        param, message = None, f"invalid request: {exc}"
    return _error(400, message, param=param, code="invalid_value")


class HttpService:
    def __init__(
        self,
        manager: ModelManager | None = None,
        *,
        host: str = "0.0.0.0",
        port: int = 8080,
    ):
        self.manager = manager or ModelManager()
        self.host = host
        self.port = port
        self.app = web.Application(client_max_size=64 * 1024 * 1024)
        self.app.router.add_post("/v1/chat/completions", self.handle_chat)
        self.app.router.add_post("/v1/completions", self.handle_completions)
        self.app.router.add_get("/v1/models", self.handle_models)
        self.app.router.add_get("/health", self.handle_health)
        self._runner: web.AppRunner | None = None

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        self._runner = web.AppRunner(self.app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        for s in site._server.sockets:  # resolve an ephemeral port
            self.port = s.getsockname()[1]
            break
        logger.info("HTTP frontend on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    # -- handlers ----------------------------------------------------------
    async def handle_health(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "healthy", "models": self.manager.model_names()})

    async def handle_models(self, request: web.Request) -> web.Response:
        models = ModelList(data=[ModelInfo(id=name) for name in self.manager.model_names()])
        return web.json_response(models.model_dump())

    async def handle_chat(self, request: web.Request) -> web.StreamResponse:
        try:
            body = await request.json()
        except Exception as exc:  # noqa: BLE001
            return _error(400, f"invalid request body: {exc}", code="invalid_json")
        try:
            req = ChatCompletionRequest.model_validate(body)
        except Exception as exc:  # noqa: BLE001
            return _validation_error(exc)
        if req.top_logprobs and not req.logprobs:
            return _error(
                400, "top_logprobs requires logprobs=true", param="top_logprobs",
                code="invalid_value",
            )
        rf_type = (req.response_format or {}).get("type", "text")
        if rf_type not in ("text", "json_object"):
            return _error(
                400, f"response_format type {rf_type!r} is not supported",
                param="response_format", code="unsupported_value",
            )
        engine = self.manager.chat_engines.get(req.model)
        if engine is None:
            return _error(
                404, f"model '{req.model}' not found", param="model",
                code="model_not_found",
            )
        return await self._serve(request, engine, req, aggregate_chat_stream)

    async def handle_completions(self, request: web.Request) -> web.StreamResponse:
        try:
            body = await request.json()
        except Exception as exc:  # noqa: BLE001
            return _error(400, f"invalid request body: {exc}", code="invalid_json")
        try:
            req = CompletionRequest.model_validate(body)
        except Exception as exc:  # noqa: BLE001
            return _validation_error(exc)
        if req.echo:
            # echo prepends the prompt to the completion text; supported for
            # unary string prompts without logprobs
            if req.stream or not isinstance(req.prompt, str) or req.logprobs:
                return _error(
                    400, "echo needs a unary string prompt without logprobs",
                    param="echo",
                )
        engine = self.manager.completion_engines.get(req.model)
        if engine is None:
            return _error(
                404, f"model '{req.model}' not found", param="model",
                code="model_not_found",
            )
        return await self._serve(request, engine, req, aggregate_completion_stream)

    async def _serve(self, request, engine, req, aggregate) -> web.StreamResponse:
        """Shared tail of both OpenAI endpoints: start generation, then
        stream SSE or aggregate one unary response (which always carries
        usage)."""
        if req.n not in (None, 1):
            return _error(400, "n > 1 is not served yet", param="n")
        if not req.stream:
            req.stream_options = {**(req.stream_options or {}), "include_usage": True}
        ctx = Context(req)
        try:
            try:
                stream = await engine.generate(ctx)
            except ValueError as exc:
                return _error(400, str(exc))
            if req.stream:
                return await self._stream_sse(request, stream, ctx)
            response = await aggregate(_data_only(stream))
            if getattr(req, "echo", False):
                for choice in response.choices:
                    choice.text = req.prompt + (choice.text or "")
            return web.json_response(response.model_dump(exclude_none=True))
        except asyncio.CancelledError:
            ctx.ctx.kill()
            raise
        except Exception as exc:  # noqa: BLE001
            logger.exception("request failed")
            return _error(500, repr(exc), "internal_error")

    async def _stream_sse(self, request, stream, ctx) -> web.StreamResponse:
        response = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
            }
        )
        await response.prepare(request)
        try:
            async for ann in stream:
                if ann.is_annotation():
                    await response.write(
                        sse.encode_event(event=ann.event, comments=ann.comment).encode()
                    )
                    continue
                payload = ann.data.model_dump_json(exclude_none=True)
                await response.write(sse.encode_event(data=payload).encode())
            await response.write(sse.encode_done().encode())
        except (ConnectionResetError, asyncio.CancelledError):
            # client went away: stop generation upstream
            ctx.ctx.kill()
        except Exception as exc:  # noqa: BLE001 — engine failure mid-stream:
            # the SSE response already started, so surface an error event
            logger.exception("stream failed mid-flight")
            try:
                payload = json.dumps(
                    {"error": {"message": repr(exc), "type": "internal_error"}}
                )
                await response.write(sse.encode_event(data=payload).encode())
            except Exception:  # noqa: BLE001 — connection may be gone too
                pass
            ctx.ctx.kill()
        await response.write_eof()
        return response


def _data_only(stream):
    """Strip annotations for unary aggregation."""

    async def gen():
        async for ann in stream:
            if ann.is_annotation() or ann.data is None:
                continue
            yield ann.data

    return gen()
