"""Typed pipeline node graph.

The reference's pipeline layer (lib/runtime/src/pipeline/nodes.rs:1-351)
composes typed nodes — a frontend Source, chained Operators, and a terminal
Sink — and lets a pipeline be CUT at any edge into network-separated
segments (SegmentSource/SegmentSink).  This is the same model over our
streaming-engine contract (`runtime/engine.py`):

- ``source()`` starts a chain; ``.link(op)`` appends an Operator;
  ``.link(engine)`` terminates it with any AsyncEngine and returns the
  runnable pipeline.
- ``SegmentSink`` serves the downstream half of a cut pipeline on a
  component endpoint; ``segment_source`` connects the upstream half to it
  through the push router — the process-boundary edge is just another link.

Links are validated at composition time (an unterminated chain cannot
generate; a terminated chain cannot be extended), which is the Python
rendering of the reference's compile-time edge typing.
"""

from __future__ import annotations

from typing import Any, Generic

from dynamo_tpu_torch.runtime.engine import (
    AsyncEngine,
    Context,
    Operator,
    Req,
    Resp,
    ResponseStream,
)


class PipelineChain(Generic[Req, Resp]):
    """A partially- or fully-linked chain of pipeline nodes."""

    def __init__(self, operators: list[Operator], engine: AsyncEngine | None = None):
        self._operators = operators
        self._engine = engine

    @property
    def terminated(self) -> bool:
        return self._engine is not None

    def link(self, node: "Operator | AsyncEngine") -> "PipelineChain":
        """Append an Operator, or terminate with an engine (Sink)."""
        if self.terminated:
            raise ValueError("pipeline already terminated by a sink")
        if isinstance(node, Operator):
            return PipelineChain([*self._operators, node])
        if not hasattr(node, "generate"):
            raise TypeError(
                f"link() takes an Operator or an AsyncEngine, got {type(node).__name__}"
            )
        # fold operators around the sink from the inside out
        engine: AsyncEngine = node
        for op in reversed(self._operators):
            engine = op.wrap(engine)
        return PipelineChain([], engine)

    async def generate(self, request: Context[Req]) -> ResponseStream[Resp]:
        if not self.terminated:
            raise ValueError(
                "pipeline not terminated: .link(engine) a sink before generating"
            )
        return await self._engine.generate(request)


def source() -> PipelineChain:
    """Start a typed pipeline chain (the frontend Source node)."""
    return PipelineChain([])


class SegmentSink:
    """Downstream half of a cut pipeline: serve a chain (or bare engine) on
    a component endpoint so remote segment-sources can link to it
    (reference: SegmentSink in pipeline/nodes.rs — the network edge)."""

    def __init__(self, endpoint, chain: "PipelineChain | AsyncEngine"):
        self.endpoint = endpoint
        if isinstance(chain, PipelineChain):
            if not chain.terminated:
                raise ValueError("segment sink needs a terminated chain")
        elif not hasattr(chain, "generate"):
            raise TypeError(
                f"segment sink takes a chain or engine, got {type(chain).__name__}"
            )
        self.engine = chain
        self._service = None

    async def start(self, **serve_kwargs: Any):
        self._service = await self.endpoint.serve(self.engine, **serve_kwargs)
        return self._service

    async def stop(self) -> None:
        if self._service is not None:
            await self._service.shutdown()
            self._service = None


async def segment_source(endpoint, *, router_mode=None) -> AsyncEngine:
    """Upstream half of a cut pipeline: an engine that forwards requests to
    the remote SegmentSink through the push router (the client side of the
    network edge).  Use its result as the sink of the local chain:
    ``source().link(op).link(await segment_source(ep))``."""
    from dynamo_tpu_torch.runtime.client import PushRouter, RemoteEngine, RouterMode

    router = await PushRouter.from_endpoint(
        endpoint, router_mode or RouterMode.ROUND_ROBIN
    )
    return RemoteEngine(router)
