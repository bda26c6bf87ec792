"""Streaming engine abstraction.

The universal building block of the framework, mirroring the reference's
``AsyncEngine`` trait and ``Context`` envelope (reference:
lib/runtime/src/engine.rs:46-110, lib/runtime/src/pipeline/context.rs):

- ``EngineContext``  — per-request identity + two-phase cancellation
  (``stop_generating`` = stop issuing new tokens gracefully, ``kill`` = abort).
- ``Context[T]``     — a request ``T`` wrapped with its ``EngineContext``;
  ``map`` transforms the payload while *transferring* the context.
- ``AsyncEngine``    — ``generate(Context[Req]) -> ResponseStream[Resp]``.
- ``ResponseStream`` — an async iterator of responses paired with the context.
- ``Operator``       — a bidirectional pipeline stage that transforms the
  request on the way in and the response stream on the way out (how the
  preprocessor/detokenizer compose around a backend engine; reference:
  lib/runtime/src/pipeline/nodes.rs).
"""

from __future__ import annotations

import asyncio
import uuid
from abc import ABC, abstractmethod
from typing import Any, AsyncIterator, Callable, Generic, Protocol, TypeVar

T = TypeVar("T")
U = TypeVar("U")
Req = TypeVar("Req")
Resp = TypeVar("Resp")


class EngineContext:
    """Identity + cancellation state for one in-flight request."""

    def __init__(self, request_id: str | None = None):
        self.id: str = request_id or uuid.uuid4().hex
        # distributed tracing context (observability.trace.TraceContext |
        # None): set by whoever minted this request (HTTP frontend) or
        # decoded it off the wire (ingress); rides Context.map/transfer for
        # free since the EngineContext object itself is transferred
        self.trace = None
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()
        self._children: list[EngineContext] = []

    # --- cancellation -----------------------------------------------------
    def stop_generating(self) -> None:
        """Gracefully stop producing new output (finish current token)."""
        self._stopped.set()
        for child in self._children:
            child.stop_generating()

    def kill(self) -> None:
        """Abort the request immediately."""
        self._killed.set()
        self._stopped.set()
        for child in self._children:
            child.kill()

    @property
    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    @property
    def is_killed(self) -> bool:
        return self._killed.is_set()

    async def stopped(self) -> None:
        await self._stopped.wait()

    async def killed(self) -> None:
        await self._killed.wait()

    def link_child(self, child: "EngineContext") -> None:
        """Propagate cancellation to a downstream context."""
        self._children.append(child)
        if self.is_killed:
            child.kill()
        elif self.is_stopped:
            child.stop_generating()


class Context(Generic[T]):
    """A request payload travelling with its EngineContext (``SingleIn<T>``)."""

    __slots__ = ("data", "ctx")

    def __init__(self, data: T, ctx: EngineContext | None = None):
        self.data = data
        self.ctx = ctx or EngineContext()

    @property
    def id(self) -> str:
        return self.ctx.id

    def map(self, fn: Callable[[T], U]) -> "Context[U]":
        """Transform the payload, transferring the context."""
        return Context(fn(self.data), self.ctx)

    def transfer(self, data: U) -> "Context[U]":
        return Context(data, self.ctx)

    def __repr__(self) -> str:
        return f"Context(id={self.ctx.id[:8]}, data={type(self.data).__name__})"


class ResponseStream(Generic[T]):
    """``ManyOut<T>``: an async response iterator paired with its context."""

    def __init__(self, stream: AsyncIterator[T], ctx: EngineContext):
        self._stream = stream
        self.ctx = ctx

    def __aiter__(self) -> AsyncIterator[T]:
        return self._stream.__aiter__()

    async def __anext__(self) -> T:
        return await self._stream.__anext__()

    def map(self, fn: Callable[[T], U]) -> "ResponseStream[U]":
        async def _mapped() -> AsyncIterator[U]:
            async for item in self._stream:
                yield fn(item)

        return ResponseStream(_mapped(), self.ctx)

    @classmethod
    def from_items(cls, items: list[T], ctx: EngineContext) -> "ResponseStream[T]":
        async def _gen() -> AsyncIterator[T]:
            for item in items:
                yield item

        return cls(_gen(), ctx)

    async def collect(self) -> list[T]:
        return [item async for item in self]


class AsyncEngine(Protocol[Req, Resp]):
    """The universal streaming-engine interface."""

    async def generate(self, request: Context[Req]) -> ResponseStream[Resp]:
        ...


class FnEngine(Generic[Req, Resp]):
    """Adapt ``async def fn(request, ctx) -> AsyncIterator`` into an engine."""

    def __init__(self, fn: Callable[[Req, EngineContext], AsyncIterator[Resp]]):
        self._fn = fn

    async def generate(self, request: Context[Req]) -> ResponseStream[Resp]:
        return ResponseStream(self._fn(request.data, request.ctx), request.ctx)


class Operator(ABC, Generic[Req, Resp]):
    """A bidirectional pipeline stage.

    ``preprocess`` maps the incoming request to the inner request type;
    ``postprocess`` maps the inner response stream back out.  ``wrap`` closes
    the stage over an inner engine, yielding a composed engine — the Python
    rendering of the reference's forward/backward operator edges.
    """

    @abstractmethod
    async def preprocess(self, request: Context[Req]) -> Context[Any]:
        ...

    @abstractmethod
    async def postprocess(
        self, stream: ResponseStream[Any], request: Context[Req]
    ) -> ResponseStream[Resp]:
        ...

    def wrap(self, inner: AsyncEngine) -> "PipelineEngine[Req, Resp]":
        return PipelineEngine(self, inner)

    # Fluent alias matching the reference's ``.link()`` graph composition.
    def link(self, inner: AsyncEngine) -> "PipelineEngine[Req, Resp]":
        return self.wrap(inner)


class PipelineEngine(Generic[Req, Resp]):
    """An Operator closed over an inner engine."""

    def __init__(self, operator: Operator[Req, Resp], inner: AsyncEngine):
        self.operator = operator
        self.inner = inner

    async def generate(self, request: Context[Req]) -> ResponseStream[Resp]:
        inner_request = await self.operator.preprocess(request)
        inner_stream = await self.inner.generate(inner_request)
        return await self.operator.postprocess(inner_stream, request)
