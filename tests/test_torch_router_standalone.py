"""The port's standalone KV router (dynamo_tpu_torch/examples/
router_standalone/router.py) against the repository's
examples/router_standalone/router.py: the reference test's HTTP walk, and
the same decisions (``worker_id``, ``overlap_blocks``) on the same
registered workers, KV events, load metrics and token ids, ties broken by
one seeded generator in each."""

import asyncio
import random

import numpy as np
from aiohttp.test_utils import TestClient, TestServer

from dynamo_tpu.llm.kv_router import protocols as ref_protocols
from dynamo_tpu.llm.kv_router.hashing import compute_block_hashes as ref_hashes
from dynamo_tpu_torch.examples.router_standalone.router import StandaloneRouter, make_app
from dynamo_tpu_torch.llm.kv_router.hashing import compute_block_hashes
from dynamo_tpu_torch.llm.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    RouterEvent,
)
from examples.router_standalone.router import StandaloneRouter as RefRouter

BLOCK = 4


def stored_event(worker_id: int, token_ids: list[int]) -> RouterEvent:
    return RouterEvent(worker_id=worker_id, event=KvCacheEvent(
        kind="stored", block_hashes=compute_block_hashes(token_ids, BLOCK)))


async def test_standalone_router_http():
    router = StandaloneRouter(block_size=BLOCK)
    router.indexer.start()
    client = TestClient(TestServer(make_app(router)))
    await client.start_server()
    try:
        assert (await client.post("/route", json={"token_ids": [1, 2, 3, 4]})).status == 503
        for wid in (0, 1):
            assert (await client.post("/register", json={"worker_id": wid})).status == 200
        prefix = list(range(16))
        assert (await client.post("/events", data=stored_event(1, prefix).to_json())).status \
            == 200
        for wid in (0, 1):
            metrics = ForwardPassMetrics(worker_id=wid)
            assert (await client.post("/metrics", data=metrics.to_json())).status == 200
        await asyncio.sleep(0.05)  # the indexer's loop applies the pushes
        body = await (await client.post("/route", json={"token_ids": prefix + [99, 100]})).json()
        assert body == {"worker_id": 1, "overlap_blocks": len(prefix) // BLOCK}
    finally:
        await client.close()
        await router.indexer.stop()


async def test_decisions_equal_the_references():
    """Four workers, prefixes stored and removed on several of them, loads
    that differ, then queries that share prefixes of every length: each
    decision is the reference router's."""
    rng = np.random.default_rng(0)
    routers = [StandaloneRouter(block_size=BLOCK), RefRouter(block_size=BLOCK)]
    protos = [RouterEvent, ref_protocols.RouterEvent]
    metrics_cls = [ForwardPassMetrics, ref_protocols.ForwardPassMetrics]
    for router in routers:
        router.scheduler._rng = random.Random(7)
        router.indexer.start()
    try:
        prefixes = [rng.integers(0, 1000, 40).tolist() for _ in range(5)]
        assert compute_block_hashes(prefixes[0], BLOCK) == ref_hashes(prefixes[0], BLOCK)
        events = []
        for i, prefix in enumerate(prefixes):
            for worker in rng.choice(4, size=1 + i % 3, replace=False).tolist():
                cut = int(rng.integers(1, 11)) * BLOCK
                events.append(stored_event(worker, prefix[:cut]).to_json())
        events.append(RouterEvent(worker_id=2, event=KvCacheEvent(
            kind="removed", block_hashes=compute_block_hashes(prefixes[1], BLOCK)[5:])).to_json())
        loads = [dict(worker_id=w, kv_active_blocks=int(rng.integers(0, 60)),
                      kv_total_blocks=64, num_requests_waiting=int(rng.integers(0, 4)),
                      gpu_cache_usage_perc=float(rng.random())) for w in range(4)]
        for router, proto, metrics in zip(routers, protos, metrics_cls):
            for w in range(4):
                router.register(w)
            for wire in events:
                router.apply_event(proto.from_json(wire))
            for load in loads:
                router.update_metrics(metrics(**load))
        await asyncio.sleep(0.1)  # the indexers' loops apply the pushes

        queries = [p[:n] + rng.integers(0, 1000, 6).tolist()
                   for p in prefixes for n in (0, 4, 13, 24, 40)]
        ours = [routers[0].route(q) for q in queries]
        ref = [routers[1].route(q) for q in queries]
        assert ours == ref
        assert len({w for w, _ in ours}) > 1 and max(o for _, o in ours) >= 5
        routers[0].deregister(3)
        routers[1].deregister(3)
        assert [routers[0].route(q) for q in queries] == [routers[1].route(q) for q in queries]
    finally:
        for router in routers:
            await router.indexer.stop()
