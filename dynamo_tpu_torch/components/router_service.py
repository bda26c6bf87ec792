"""Standalone KV-aware router component.

Hosts a KvRouter behind a control-plane endpoint: ``generate`` takes
``{"token_ids": [...]}`` and streams back the selected ``worker_id`` +
matched prefix blocks (reference: components/router/src/main.rs — the
router-as-a-service deployment shape, used when routing decisions are made
outside the frontend process).

A copy of dynamo_tpu/components/router_service.py over the port's KvRouter.

Run: ``python -m dynamo_tpu_torch.components.router_service --control-plane H:P``
"""

from __future__ import annotations

import argparse
import asyncio

from dynamo_tpu_torch.llm.kv_router.router import KvRouter
from dynamo_tpu_torch.observability import get_recorder
from dynamo_tpu_torch.runtime.client import Client
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context, ResponseStream
from dynamo_tpu_torch.utils.config import RuntimeConfig
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

logger = get_logger("components.router")


class RouterEngine:
    """AsyncEngine answering scheduling queries.  Worker membership comes
    from the watch-backed Client view (no control-plane scan per request)."""

    def __init__(self, kv_router: KvRouter, client: Client):
        self.kv_router = kv_router
        self.client = client

    async def generate(self, request: Context[dict]) -> ResponseStream[dict]:
        token_ids = request.data.get("token_ids", [])
        span = get_recorder().start(
            "router.schedule", getattr(request.ctx, "trace", None),
            component="router_service",
        )
        try:
            worker_id, matched = await self.kv_router.schedule(
                token_ids, self.client.instance_ids
            )
        except BaseException as exc:
            if span is not None:
                span.end(status="error", error=repr(exc))
            raise
        if span is not None:
            span.end(worker=f"{worker_id:x}", overlap_blocks=matched)

        async def gen():
            yield {"worker_id": worker_id, "overlap_blocks": matched}

        return ResponseStream(gen(), request.ctx)


async def serve_router(
    runtime: DistributedRuntime,
    *,
    namespace: str = "dynamo",
    component: str = "backend",
    endpoint: str = "generate",
    block_size: int = 16,
):
    """Start the router service; returns (EndpointService, KvRouter, Client).

    ``Client.start`` awaits the instance watch's initial snapshot, so by the
    time the endpoint is served the worker view is populated."""
    backend_component = runtime.namespace(namespace).component(component)
    kv_router = KvRouter(backend_component, block_size=block_size)
    await kv_router.start()
    client = Client(runtime, backend_component.endpoint(endpoint))
    await client.start()
    engine = RouterEngine(kv_router, client)
    router_ep = runtime.namespace(namespace).component("router").endpoint("generate")
    service = await router_ep.serve(engine)
    return service, kv_router, client


async def amain(args) -> int:
    configure_logging()
    runtime = await DistributedRuntime.create(RuntimeConfig(control_plane=args.control_plane))
    service, kv_router, client = await serve_router(
        runtime, namespace=args.namespace, component=args.component,
        block_size=args.kv_block_size,
    )
    logger.info("router service up")
    await runtime.wait_for_shutdown()
    await service.shutdown()
    await client.close()
    await kv_router.stop()
    await runtime.close()
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--control-plane", default="127.0.0.1:2379")
    parser.add_argument("--namespace", default="dynamo")
    parser.add_argument("--component", default="backend")
    parser.add_argument("--kv-block-size", type=int, default=16)
    return asyncio.run(amain(parser.parse_args()))


if __name__ == "__main__":
    raise SystemExit(main())
