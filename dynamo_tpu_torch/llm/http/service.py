"""OpenAI-compatible HTTP frontend (aiohttp), a copy of
dynamo_tpu/llm/http/service.py.

Routes:
- ``POST /v1/chat/completions``  (streaming SSE + unary; ``n > 1`` fans out)
- ``POST /v1/completions``
- ``POST /v1/embeddings``        (404 until an embedding model is added)
- ``GET  /v1/models``
- ``GET  /health`` / ``GET /live``
- ``GET  /metrics``              (Prometheus)
- ``GET  /slo``                  (burn rates and exemplars, JSON)
- ``POST /clear_kv_blocks``      (admin: flush every worker's KV cache)

Every request gets an ``x-request-id`` (an incoming one is honoured) and a
root span; the inference routes pass admission control (429/503 with
``Retry-After``, off unless configured or ``DYN_ADMISSION_MAX_INFLIGHT`` is
set).  ``ModelManager`` holds per-model typed engines, added/removed live
by the discovery watcher.
"""

from __future__ import annotations

import asyncio
import json
import uuid
from typing import Any

from aiohttp import web

from dynamo_tpu_torch.llm.http.metrics import FrontendMetrics
from dynamo_tpu_torch.observability import get_recorder
from dynamo_tpu_torch.observability.trace import sanitize_request_id
from dynamo_tpu_torch.robustness.admission import (
    AdmissionConfig,
    AdmissionController,
    Overloaded,
)
from dynamo_tpu_torch.llm.protocols import sse
from dynamo_tpu_torch.llm.protocols.aggregator import (
    aggregate_chat_stream,
    aggregate_completion_stream,
)
from dynamo_tpu_torch.llm.protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
    EmbeddingRequest,
    ModelInfo,
    ModelList,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.utils.logging import get_logger, log_fields
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("llm.http")

REQUEST_ID_HEADER = "x-request-id"


class ModelManager:
    """Per-model engine registry, mutated live by discovery."""

    def __init__(self) -> None:
        self.chat_engines: dict[str, Any] = {}
        self.completion_engines: dict[str, Any] = {}
        self.embedding_engines: dict[str, Any] = {}

    def add_chat_model(self, name: str, engine: Any) -> None:
        self.chat_engines[name] = engine

    def add_completion_model(self, name: str, engine: Any) -> None:
        self.completion_engines[name] = engine

    def add_embedding_model(self, name: str, engine: Any) -> None:
        self.embedding_engines[name] = engine

    def remove_model(self, name: str) -> None:
        self.chat_engines.pop(name, None)
        self.completion_engines.pop(name, None)
        self.embedding_engines.pop(name, None)

    def model_names(self) -> list[str]:
        return sorted(
            set(self.chat_engines) | set(self.completion_engines) | set(self.embedding_engines)
        )


def _error(
    status: int,
    message: str,
    err_type: str = "invalid_request_error",
    *,
    param: str | None = None,
    code: str | None = None,
    headers: dict[str, str] | None = None,
) -> web.Response:
    """Structured OpenAI-shaped error body: ``{"error": {message, type,
    param, code}}`` with ``param`` naming the offending field and ``code``
    a machine-readable string (the reference returns the same typed shape,
    lib/llm/src/http/service/error.rs)."""
    return web.json_response(
        {"error": {"message": message, "type": err_type, "param": param, "code": code}},
        status=status,
        headers=headers,
    )


def _validation_error(exc: Exception) -> web.Response:
    """Pydantic ValidationError → 400 with the first violation's field as
    ``param`` (contract-tested in tests/llm/test_protocol_validation.py)."""
    try:
        first = exc.errors()[0]
        loc = [str(p) for p in first.get("loc", ()) if not isinstance(p, int)]
        # union branches show up as synthetic loc tails (e.g. "str",
        # "list[str]") — keep the leading concrete field path
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
        metrics: FrontendMetrics | None = None,
        request_template=None,
        clear_kv=None,
        admission: AdmissionConfig | None = None,
        prefetch_hinter=None,
    ):
        self.manager = manager or ModelManager()
        self.host = host
        self.port = port
        self.metrics = metrics or FrontendMetrics()
        self.request_template = request_template
        # predictive prefetch (prefetch/frontend.py FrontendHinter): a hint
        # is emitted the moment a validated request enters the admission
        # path — before preprocessing/queueing/dispatch — so the target
        # worker pages the prefix up-tier during that window.  None = off.
        self.prefetch_hinter = prefetch_hinter
        # async () -> list[str]: broadcast a cache flush to every backing
        # worker component (reference: lib/llm/src/http/service/clear_kv_blocks.rs)
        self.clear_kv = clear_kv
        # load shedding on the inference routes (429/503 + Retry-After);
        # disabled unless configured or DYN_ADMISSION_MAX_INFLIGHT is set.
        # The SLO tracker's burn rate feeds it (DYN_SLO_SHED_BURN): when the
        # error budget is burning fast, shed instead of queueing deeper.
        self.admission = AdmissionController(admission)
        self.admission.burn_rate_fn = self.metrics.slo.worst_burn_rate
        self.admission.shed_burn_threshold = (
            self.metrics.slo.config.shed_burn_threshold
        )
        self.app = web.Application(
            client_max_size=64 * 1024 * 1024,
            middlewares=[self._request_id_middleware, self._admission_middleware],
        )
        self.app.router.add_post("/v1/chat/completions", self.handle_chat)
        self.app.router.add_post("/v1/completions", self.handle_completions)
        self.app.router.add_post("/v1/embeddings", self.handle_embeddings)
        self.app.router.add_get("/v1/models", self.handle_models)
        self.app.router.add_get("/health", self.handle_health)
        self.app.router.add_get("/live", self.handle_health)
        self.app.router.add_get("/metrics", self.handle_metrics)
        self.app.router.add_get("/slo", self.handle_slo)
        self.app.router.add_post("/clear_kv_blocks", self.handle_clear_kv_blocks)
        self._runner: web.AppRunner | None = None

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        self._runner = web.AppRunner(self.app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        for s in site._server.sockets:  # resolve ephemeral port
            self.port = s.getsockname()[1]
            break
        logger.info("HTTP frontend on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
        _drop_middleware_cache()

    # -- request identity / tracing ---------------------------------------
    @web.middleware
    async def _request_id_middleware(self, request: web.Request, handler):
        """Assign every request an id (honoring an incoming ``x-request-id``)
        and echo it on the response — including error responses.  Streaming
        responses prepare inside their handler, so ``_stream_sse`` sets the
        header itself before ``prepare()``."""
        rid = sanitize_request_id(request.headers.get(REQUEST_ID_HEADER))
        request["request_id"] = rid or uuid.uuid4().hex
        try:
            response = await handler(request)
        except web.HTTPException as exc:
            exc.headers.setdefault(REQUEST_ID_HEADER, request["request_id"])
            raise
        if not response.prepared:
            response.headers.setdefault(REQUEST_ID_HEADER, request["request_id"])
        return response

    @web.middleware
    async def _admission_middleware(self, request: web.Request, handler):
        """Admission control on the inference routes only — health, metrics
        and admin endpoints must stay reachable exactly when the service is
        overloaded."""
        if request.method != "POST" or not request.path.startswith("/v1/"):
            return await handler(request)
        try:
            await self.admission.acquire()
        except Overloaded as exc:
            return _error(
                exc.status, str(exc), "overloaded_error", code="overloaded",
                headers={"Retry-After": f"{max(int(exc.retry_after_s), 1)}"},
            )
        try:
            return await handler(request)
        finally:
            # streaming handlers return only after the SSE body is fully
            # written, so the slot covers the whole stream lifetime
            await self.admission.release()

    def _trace_root(self, request: web.Request, endpoint: str, model: str):
        """Root span of the request's trace tree; the request id IS the
        trace id, so a client-supplied ``x-request-id`` correlates client
        logs, server logs, and the exported span tree."""
        return get_recorder().start(
            "http.request", None, component="frontend",
            root_trace_id=request["request_id"],
            attrs={"endpoint": endpoint, "model": model},
        )

    def _finish_request(self, request: web.Request, root, guard) -> None:
        """Close the root span with the lifecycle facts the guard gathered
        and emit one structured per-request log record."""
        if root is not None:
            root.end(
                status=guard.status,
                ttft_s=guard.ttft_s,
                tokens_out=guard.token_count,
            )
        logger.info(
            "%s %s -> %s",
            guard.endpoint, guard.model, guard.status,
            extra=log_fields(
                request_id=request["request_id"],
                model=guard.model,
                endpoint=guard.endpoint,
                request_type=guard.request_type,
                status=guard.status,
                duration_s=round(guard.duration_s, 6),
                ttft_s=None if guard.ttft_s is None else round(guard.ttft_s, 6),
                tokens_out=guard.token_count,
            ),
        )

    # -- handlers ----------------------------------------------------------
    async def handle_health(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "healthy", "models": self.manager.model_names()})

    async def handle_metrics(self, request: web.Request) -> web.Response:
        return web.Response(body=self.metrics.render(), content_type="text/plain")

    async def handle_slo(self, request: web.Request) -> web.Response:
        """SLO burn rates + histogram-bucket exemplars as JSON — the
        machine-readable twin of the ``dyn_slo_*`` exposition (consumed by
        scripts/dyn_top.py and autoscalers)."""
        return web.json_response(self.metrics.slo_status())

    async def handle_clear_kv_blocks(self, request: web.Request) -> web.Response:
        """Admin: flush every worker's published KV-cache state (reference:
        lib/llm/src/http/service/clear_kv_blocks.rs — frontend route that
        fans the flush out to all workers)."""
        if self.clear_kv is None:
            return _error(501, "clear_kv_blocks not wired on this frontend")
        try:
            cleared = await self.clear_kv()
        except Exception as exc:  # noqa: BLE001
            return _error(500, f"clear_kv_blocks failed: {exc}", "internal_error")
        return web.json_response({"status": "ok", "cleared": cleared})

    async def handle_models(self, request: web.Request) -> web.Response:
        models = ModelList(data=[ModelInfo(id=name) for name in self.manager.model_names()])
        return web.json_response(models.model_dump())

    async def handle_chat(self, request: web.Request) -> web.StreamResponse:
        try:
            body = await request.json()
            if self.request_template is not None:
                body = self.request_template.apply(body)
        except Exception as exc:  # noqa: BLE001
            return _error(400, f"invalid request body: {exc}", code="invalid_json")
        try:
            chat_request = ChatCompletionRequest.model_validate(body)
        except Exception as exc:  # noqa: BLE001
            return _validation_error(exc)
        if chat_request.top_logprobs and not chat_request.logprobs:
            return _error(
                400, "top_logprobs requires logprobs=true", param="top_logprobs",
                code="invalid_value",
            )
        rf_type = (chat_request.response_format or {}).get("type", "text")
        if rf_type not in ("text", "json_object"):
            # json_object rides guided decoding (llm/guided.py; workers
            # without the mask table reject and this surfaces as a 400
            # below).  json_schema is not implemented: silently ignoring it
            # would hand the client unconstrained text it believes is
            # schema-guaranteed
            return _error(
                400,
                f"response_format type {rf_type!r} is not supported "
                "(json_object is; schema-constrained decoding is not)",
                param="response_format", code="unsupported_value",
            )
        engine = self.manager.chat_engines.get(chat_request.model)
        if engine is None:
            return _error(
                404, f"model '{chat_request.model}' not found",
                param="model", code="model_not_found",
            )
        if self.prefetch_hinter is not None:
            self.prefetch_hinter.on_request(chat_request.model, chat_request)

        guard = self.metrics.guard(
            chat_request.model, "chat_completions",
            "stream" if chat_request.stream else "unary",
            trace_id=request["request_id"],
        )
        root = self._trace_root(request, "chat_completions", chat_request.model)
        if not chat_request.stream:
            # non-streaming responses always carry usage (OpenAI semantics)
            chat_request.stream_options = {**(chat_request.stream_options or {}), "include_usage": True}
        ctx = None
        try:
            try:
                stream, ctx = await _start_generation(engine, chat_request, root)
            except ValueError as exc:
                guard.mark_client_error()
                return _error(400, str(exc))
            if chat_request.stream:
                return await self._stream_sse(request, stream, ctx, guard, chat_request.model)
            chunks = _data_only(stream, guard)
            response = await aggregate_chat_stream(chunks)
            guard.mark_ok()
            self._observe_usage(chat_request.model, response.usage)
            return web.json_response(response.model_dump(exclude_none=True))
        except asyncio.CancelledError:
            guard.mark_cancelled()
            if ctx is not None:
                ctx.ctx.kill()
            raise
        except Exception as exc:  # noqa: BLE001
            logger.exception("chat request failed")
            return _error(500, repr(exc), "internal_error")
        finally:
            guard.done()
            self._finish_request(request, root, guard)

    async def handle_completions(self, request: web.Request) -> web.StreamResponse:
        try:
            body = await request.json()
            if self.request_template is not None:
                body = self.request_template.apply(body)
        except Exception as exc:  # noqa: BLE001
            return _error(400, f"invalid request body: {exc}", code="invalid_json")
        try:
            completion_request = CompletionRequest.model_validate(body)
        except Exception as exc:  # noqa: BLE001
            return _validation_error(exc)
        if completion_request.echo:
            # echo prepends the prompt to the completion text (OpenAI
            # completions semantics); supported for unary string prompts
            if completion_request.stream:
                return _error(400, "echo is not supported with stream", param="echo")
            if not isinstance(completion_request.prompt, str):
                return _error(400, "echo requires a string prompt", param="echo")
            if completion_request.logprobs:
                # prompt-token logprobs are not computed, and prepending the
                # prompt would desync text_offset; reject rather than return
                # silently-wrong scoring data
                return _error(400, "echo is not supported with logprobs", param="echo")
        engine = self.manager.completion_engines.get(completion_request.model)
        if engine is None:
            return _error(
                404, f"model '{completion_request.model}' not found",
                param="model", code="model_not_found",
            )
        if self.prefetch_hinter is not None:
            self.prefetch_hinter.on_request(
                completion_request.model, completion_request
            )

        guard = self.metrics.guard(
            completion_request.model, "completions",
            "stream" if completion_request.stream else "unary",
            trace_id=request["request_id"],
        )
        root = self._trace_root(request, "completions", completion_request.model)
        if not completion_request.stream:
            completion_request.stream_options = {**(completion_request.stream_options or {}), "include_usage": True}
        ctx = None
        try:
            try:
                stream, ctx = await _start_generation(engine, completion_request, root)
            except ValueError as exc:
                guard.mark_client_error()
                return _error(400, str(exc))
            if completion_request.stream:
                return await self._stream_sse(request, stream, ctx, guard, completion_request.model)
            chunks = _data_only(stream, guard)
            response = await aggregate_completion_stream(chunks)
            if completion_request.echo:
                for choice in response.choices:
                    choice.text = completion_request.prompt + (choice.text or "")
            guard.mark_ok()
            self._observe_usage(completion_request.model, response.usage)
            return web.json_response(response.model_dump(exclude_none=True))
        except asyncio.CancelledError:
            guard.mark_cancelled()
            if ctx is not None:
                ctx.ctx.kill()
            raise
        except Exception as exc:  # noqa: BLE001
            logger.exception("completion request failed")
            return _error(500, repr(exc), "internal_error")
        finally:
            guard.done()
            self._finish_request(request, root, guard)

    async def handle_embeddings(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except Exception as exc:  # noqa: BLE001
            return _error(400, f"invalid request body: {exc}", code="invalid_json")
        try:
            embedding_request = EmbeddingRequest.model_validate(body)
        except Exception as exc:  # noqa: BLE001
            return _validation_error(exc)
        engine = self.manager.embedding_engines.get(embedding_request.model)
        if engine is None:
            return _error(
                404, f"model '{embedding_request.model}' not found",
                param="model", code="model_not_found",
            )
        guard = self.metrics.guard(
            embedding_request.model, "embeddings", "unary",
            trace_id=request["request_id"],
        )
        root = self._trace_root(request, "embeddings", embedding_request.model)
        try:
            try:
                response = await engine.embed(embedding_request)
            except ValueError as exc:
                guard.mark_client_error()
                return _error(400, str(exc))
            guard.mark_ok()
            return web.json_response(response.model_dump(exclude_none=True))
        except Exception as exc:  # noqa: BLE001
            logger.exception("embedding request failed")
            return _error(500, repr(exc), "internal_error")
        finally:
            guard.done()
            self._finish_request(request, root, guard)

    # -- streaming ---------------------------------------------------------
    async def _stream_sse(self, request, stream, ctx, guard, model: str) -> web.StreamResponse:
        response = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
                # echoed here (not in the middleware): an SSE response is
                # already prepared by the time the middleware sees it
                REQUEST_ID_HEADER: request["request_id"],
            }
        )
        await response.prepare(request)
        completion_tokens = 0
        try:
            async for ann in stream:
                if ann.is_annotation():
                    await response.write(
                        sse.encode_event(event=ann.event, comments=ann.comment).encode()
                    )
                    continue
                # usage-only final chunks (include_usage) carry no choices:
                # counting them would inflate ITL samples and the output-
                # token histogram by one per stream
                if getattr(ann.data, "choices", None):
                    guard.token_observed()
                    completion_tokens += 1
                # pydantic-core's Rust serializer: ~3x faster than
                # model_dump() + json.dumps() (measured 4us vs 12us per
                # chunk), and this runs once per streamed chunk, squarely
                # on the per-token serving path
                payload = ann.data.model_dump_json(exclude_none=True)
                await response.write(sse.encode_event(data=payload).encode())
            await response.write(sse.encode_done().encode())
            guard.mark_ok()
        except (ConnectionResetError, asyncio.CancelledError):
            # client went away: propagate kill upstream; not a server error
            guard.mark_cancelled()
            ctx.ctx.kill()
        except Exception as exc:  # noqa: BLE001 — engine failure mid-stream:
            # the SSE response already started, so surface an error event
            # (never a fake finish) and stop generation
            logger.exception("stream failed mid-flight")
            try:
                payload = json.dumps(
                    {"error": {"message": repr(exc), "type": "internal_error"}}
                )
                await response.write(sse.encode_event(data=payload).encode())
            except Exception:  # noqa: BLE001 — connection may be gone too
                pass
            ctx.ctx.kill()
        finally:
            self.metrics.output_tokens.labels(model).observe(completion_tokens)
        await response.write_eof()
        return response

    def _observe_usage(self, model: str, usage) -> None:
        if usage is None:
            return
        self.metrics.input_tokens.labels(model).observe(usage.prompt_tokens)
        self.metrics.output_tokens.labels(model).observe(usage.completion_tokens)


def _drop_middleware_cache() -> None:
    """aiohttp caches each route's middleware chain in a module-level LRU
    keyed by the bound handler, which would keep a stopped service, its
    models and their engines (and their device memory) alive: drop it."""
    from aiohttp import web_app

    cache = getattr(web_app, "_cached_build_middleware", None)
    if hasattr(cache, "cache_clear"):
        cache.cache_clear()


def _data_only(stream, guard):
    """Strip annotations; count tokens for metrics (usage-only chunks have
    no choices and pass through uncounted)."""

    async def gen():
        async for ann in stream:
            if ann.is_annotation() or ann.data is None:
                continue
            if getattr(ann.data, "choices", None):
                guard.token_observed()
            yield ann.data

    return gen()


async def _start_generation(engine, request_model, root=None):
    """One dispatch for both OpenAI endpoints: validates ``n``, fans out
    when n>1, else a plain single-choice generate.  ``root`` is the
    request's root span handle; its context rides the EngineContext into
    every downstream layer.  Returns (stream, ctx); raises ValueError for
    400-class problems."""
    n = request_model.n if request_model.n is not None else 1
    if n < 1:
        raise ValueError("n must be >= 1")
    if n > 16:
        raise ValueError("n must be <= 16")
    trace_ctx = root.ctx if root is not None else None
    if n > 1:
        return await _generate_fanout(engine, request_model, n, trace_ctx)
    ctx = Context(request_model)
    ctx.ctx.trace = trace_ctx
    return await engine.generate(ctx), ctx


async def _generate_fanout(engine, request_model, n: int, trace_ctx=None):
    """OpenAI ``n>1``: issue n independent single-choice requests (seeded
    requests get seed+i per choice, like vLLM) and merge the streams with
    choice indices rewritten; per-choice usage chunks are summed into one.
    Returns (merged_annotated_stream, parent_ctx); cancelling the parent
    context fans out to every sub-request through link_child."""
    subs = []
    for i in range(n):
        sub = request_model.model_copy(deep=True)
        sub.n = 1
        if getattr(sub, "seed", None) is not None:
            sub.seed = sub.seed + i
        subs.append(sub)
    parent = Context(request_model)
    parent.ctx.trace = trace_ctx
    ctxs = [Context(sub) for sub in subs]
    for c in ctxs:
        # all sub-requests parent to the one root span: the trace tree shows
        # n parallel dispatch/worker/engine branches under one http.request
        c.ctx.trace = trace_ctx
        parent.ctx.link_child(c.ctx)
    streams = []
    try:
        for c in ctxs:
            streams.append(await engine.generate(c))
    except BaseException:
        # sub-requests already submitted must not decode to max_tokens
        # with nobody consuming them
        for c in ctxs:
            c.ctx.kill()
        raise

    queue: asyncio.Queue = asyncio.Queue()

    async def pump(i, stream):
        try:
            async for ann in stream:
                await queue.put((i, ann))
        except Exception as exc:  # noqa: BLE001 — surface to the consumer
            await queue.put((i, exc))
        finally:
            await queue.put((i, None))

    tasks = [spawn_logged(pump(i, st)) for i, st in enumerate(streams)]

    async def gen():
        done = 0
        usage_sum = None
        proto = None   # any data chunk: template for the final usage chunk
        resp_id = None  # one response id for the whole merged stream
        try:
            while done < len(streams):
                i, ann = await queue.get()
                if ann is None:
                    done += 1
                    continue
                if isinstance(ann, Exception):
                    raise ann
                if ann.is_annotation():
                    if i == 0:  # identical per sub-request: emit once
                        yield ann
                    continue
                data = ann.data
                if data is None:
                    continue
                if getattr(data, "usage", None) is not None and not data.choices:
                    u = data.usage
                    if usage_sum is None:
                        usage_sum = u.model_copy()
                    else:
                        # one shared prompt, n completions
                        usage_sum.completion_tokens += u.completion_tokens
                        usage_sum.total_tokens += u.completion_tokens
                    continue
                # every sub-request minted its own id: present ONE id so
                # clients grouping deltas by response id see one stream
                if resp_id is None:
                    resp_id = data.id
                data.id = resp_id
                proto = proto or data
                for choice in data.choices:
                    choice.index = i
                yield ann
            if usage_sum is not None and proto is not None:
                final = type(proto)(
                    id=resp_id, model=proto.model, choices=[], usage=usage_sum
                )
                from dynamo_tpu_torch.llm.protocols.common import Annotated

                yield Annotated.from_data(final)
        except BaseException:
            # one sub-stream failed or the consumer went away: the healthy
            # sub-requests must not keep decoding into dead air
            for c in ctxs:
                c.ctx.kill()
            raise
        finally:
            for t in tasks:
                t.cancel()

    from dynamo_tpu_torch.runtime.engine import ResponseStream

    return ResponseStream(gen(), parent.ctx), parent
