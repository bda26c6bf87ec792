"""Aggregated load view across a component's workers (reference:
lib/llm/src/kv_router/metrics_aggregator.rs, scoring.rs ProcessedEndpoints).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

from dynamo_tpu_torch.llm.kv_router.protocols import LOAD_METRICS_SUBJECT, ForwardPassMetrics
from dynamo_tpu_torch.runtime.component import Component
from dynamo_tpu_torch.utils.tasks import spawn_logged


@dataclass
class ProcessedEndpoints:
    """Snapshot of all known workers' load."""

    workers: dict[int, ForwardPassMetrics] = field(default_factory=dict)

    @property
    def worker_ids(self) -> list[int]:
        return list(self.workers)

    @property
    def total_active_blocks(self) -> int:
        return sum(m.kv_active_blocks for m in self.workers.values())

    @property
    def total_waiting(self) -> int:
        return sum(m.num_requests_waiting for m in self.workers.values())

    @property
    def average_cache_usage(self) -> float:
        if not self.workers:
            return 0.0
        return sum(m.gpu_cache_usage_perc for m in self.workers.values()) / len(self.workers)


class KvMetricsAggregator:
    """Subscribes a component's load_metrics events into a live snapshot."""

    def __init__(self, component: Component, *, ttl_s: float = 10.0):
        self.component = component
        self.ttl_s = ttl_s
        self._metrics: dict[int, tuple[ForwardPassMetrics, float]] = {}
        self._sub = None
        self._task: asyncio.Task | None = None

    async def start(self) -> None:
        bus = self.component.runtime.plane.bus
        self._sub = await bus.subscribe(self.component.event_subject(LOAD_METRICS_SUBJECT))
        self._task = spawn_logged(self._loop())

    async def stop(self) -> None:
        if self._sub is not None:
            await self._sub.unsubscribe()
        if self._task is not None:
            self._task.cancel()

    async def _loop(self) -> None:
        async for msg in self._sub:
            try:
                metrics = ForwardPassMetrics.from_json(msg.payload)
            except Exception:  # noqa: BLE001
                continue
            self._metrics[metrics.worker_id] = (metrics, time.monotonic())

    def snapshot(self) -> ProcessedEndpoints:
        now = time.monotonic()
        return ProcessedEndpoints(
            workers={
                wid: m
                for wid, (m, stamp) in self._metrics.items()
                if now - stamp <= self.ttl_s
            }
        )
