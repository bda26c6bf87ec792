"""Standalone KV-aware router with no discovery plane (reference:
examples/router_standalone/router.py:57 — the ZMQ-based router that runs
without etcd/NATS).

Workers are registered explicitly; KV events and load metrics are pushed
straight into the indexer/scheduler over plain method calls (or, across
processes, an aiohttp POST API).  Useful for embedding the routing brain in
an existing serving stack.

    python -m dynamo_tpu_torch.examples.router_standalone.router --port 8090

    POST /register   {"worker_id": 0}
    POST /events     RouterEvent JSON
    POST /metrics    ForwardPassMetrics JSON
    POST /route      {"token_ids": [...]} → {"worker_id": ..., "overlap_blocks": ...}
"""

from __future__ import annotations

import argparse
import asyncio

from aiohttp import web

from dynamo_tpu_torch.llm.kv_router.hashing import compute_block_hashes
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics, RouterEvent
from dynamo_tpu_torch.llm.kv_router.scheduler import KvRouterConfig, KvScheduler
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

logger = get_logger("dynamo_tpu_torch.examples.router_standalone")


class StandaloneRouter:
    """Indexer + 3-term scheduler with explicit worker registration."""

    def __init__(self, *, block_size: int = 16, config: KvRouterConfig | None = None):
        self.block_size = block_size
        self.indexer = KvIndexer()
        self.scheduler = KvScheduler(config)
        self.worker_ids: set[int] = set()

    def register(self, worker_id: int) -> None:
        self.worker_ids.add(worker_id)

    def deregister(self, worker_id: int) -> None:
        self.worker_ids.discard(worker_id)
        self.indexer.remove_worker(worker_id)
        self.scheduler.remove_worker(worker_id)

    def apply_event(self, event: RouterEvent) -> None:
        self.indexer.push(event)

    def update_metrics(self, metrics: ForwardPassMetrics) -> None:
        self.scheduler.update_metrics(metrics)

    def route(self, token_ids: list[int]) -> tuple[int, int]:
        if not self.worker_ids:
            raise LookupError("no workers registered")
        hashes = compute_block_hashes(token_ids, self.block_size)
        overlaps = self.indexer.find_matches(hashes)
        worker_id, _ratio = self.scheduler.select_worker(
            sorted(self.worker_ids), overlaps, len(hashes)
        )
        return worker_id, overlaps.scores.get(worker_id, 0)


def make_app(router: StandaloneRouter) -> web.Application:
    async def register(request: web.Request) -> web.Response:
        body = await request.json()
        router.register(int(body["worker_id"]))
        return web.json_response({"ok": True})

    async def events(request: web.Request) -> web.Response:
        router.apply_event(RouterEvent.from_json(await request.read()))
        return web.json_response({"ok": True})

    async def metrics(request: web.Request) -> web.Response:
        router.update_metrics(ForwardPassMetrics.from_json(await request.read()))
        return web.json_response({"ok": True})

    async def route(request: web.Request) -> web.Response:
        body = await request.json()
        try:
            worker_id, overlap = router.route(list(body["token_ids"]))
        except LookupError as exc:
            return web.json_response({"error": str(exc)}, status=503)
        return web.json_response({"worker_id": worker_id, "overlap_blocks": overlap})

    app = web.Application()
    app.router.add_post("/register", register)
    app.router.add_post("/events", events)
    app.router.add_post("/metrics", metrics)
    app.router.add_post("/route", route)
    return app


async def amain(port: int, block_size: int) -> None:
    router = StandaloneRouter(block_size=block_size)
    router.indexer.start()
    runner = web.AppRunner(make_app(router))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", port)
    await site.start()
    logger.info("standalone router on :%d (block_size=%d)", port, block_size)
    try:
        await asyncio.Event().wait()
    finally:
        await runner.cleanup()
        await router.indexer.stop()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--port", type=int, default=8090)
    parser.add_argument("--block-size", type=int, default=16)
    args = parser.parse_args()
    configure_logging()
    asyncio.run(amain(args.port, args.block_size))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
