"""Leader/worker barrier for multi-node engine bring-up.

KV-store rendezvous (reference: lib/runtime/src/utils/leader_worker_barrier.rs
— LeaderBarrier :153 posts data and waits for N workers; WorkerBarrier :237
reads it and checks in).  Used to coordinate multi-host JAX process groups
(``jax.distributed.initialize`` addresses flow through the barrier data).
"""

from __future__ import annotations

import asyncio
import json

from dynamo_tpu_torch.runtime.component import ROOT_PATH
from dynamo_tpu_torch.runtime.controlplane.interface import KeyValueStore, WatchEventType
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("runtime.barrier")


def _barrier_prefix(barrier_id: str) -> str:
    return f"{ROOT_PATH}barriers/{barrier_id}/"


class LeaderBarrier:
    """Leader posts payload, waits until ``num_workers`` check in."""

    def __init__(self, kv: KeyValueStore, barrier_id: str, num_workers: int):
        self.kv = kv
        self.barrier_id = barrier_id
        self.num_workers = num_workers

    async def sync(self, data: dict, *, timeout: float = 120.0, lease_id: int = 0) -> list[str]:
        prefix = _barrier_prefix(self.barrier_id)
        created = await self.kv.create(prefix + "leader", json.dumps(data).encode(), lease_id)
        if not created:
            raise RuntimeError(f"barrier {self.barrier_id} already has a leader")
        workers: set[str] = set()
        watch = self.kv.watch_prefix(prefix + "workers/")
        try:
            async with asyncio.timeout(timeout):
                async for event in watch:
                    if event.type != WatchEventType.PUT:
                        continue
                    workers.add(event.entry.key.rsplit("/", 1)[-1])
                    if len(workers) >= self.num_workers:
                        return sorted(workers)
        except TimeoutError:
            raise TimeoutError(
                f"barrier {self.barrier_id}: {len(workers)}/{self.num_workers} workers"
            ) from None
        finally:
            watch.cancel()
        return sorted(workers)


class WorkerBarrier:
    """Worker waits for the leader's payload, then checks in."""

    def __init__(self, kv: KeyValueStore, barrier_id: str, worker_id: str):
        self.kv = kv
        self.barrier_id = barrier_id
        self.worker_id = worker_id

    async def sync(self, *, timeout: float = 120.0, lease_id: int = 0) -> dict:
        prefix = _barrier_prefix(self.barrier_id)
        watch = self.kv.watch_prefix(prefix + "leader")
        try:
            async with asyncio.timeout(timeout):
                async for event in watch:
                    if event.type == WatchEventType.PUT:
                        data = json.loads(event.entry.value)
                        await self.kv.put(
                            prefix + f"workers/{self.worker_id}", b"ready", lease_id
                        )
                        return data
        except TimeoutError:
            raise TimeoutError(f"barrier {self.barrier_id}: no leader within {timeout}s") from None
        finally:
            watch.cancel()
        raise RuntimeError("unreachable")
