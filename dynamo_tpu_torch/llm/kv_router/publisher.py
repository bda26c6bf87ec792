"""Worker-side publishers: KV events + load metrics.

(Reference: lib/llm/src/kv_router/publisher.rs — there, events arrive from
vLLM over ZMQ; here the native engine calls straight into the publisher.)

Subjects are component-scoped event subjects on the control-plane bus:
``{ns}.{component}._events.kv_events`` and ``..._events.load_metrics``.
"""

from __future__ import annotations

import asyncio

from dynamo_tpu_torch.engine.kv_manager import KvEvent
from dynamo_tpu_torch.llm.kv_router.protocols import (
    KV_EVENT_SUBJECT,
    LOAD_METRICS_SUBJECT,
    ForwardPassMetrics,
    KvCacheEvent,
    RouterEvent,
)
from dynamo_tpu_torch.runtime.component import Component
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("llm.kv_router.publisher")


class KvEventPublisher:
    """Forwards engine allocator events to the bus, attributed to a worker.

    ``sink`` (a plain callable) is handed to the engine's BlockAllocator; it
    is thread-safe (the engine's device thread produces events) by hopping
    through ``loop.call_soon_threadsafe``.
    """

    def __init__(self, component: Component, worker_id: int):
        self.component = component
        self.worker_id = worker_id
        self.subject = component.event_subject(KV_EVENT_SUBJECT)
        self._loop = asyncio.get_event_loop()
        self._queue: asyncio.Queue[RouterEvent] = asyncio.Queue()
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        self._loop = asyncio.get_event_loop()
        if self._task is None:
            self._task = spawn_logged(self._pump())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def sink(self, event: KvEvent) -> None:
        """Engine-facing callback (called from the device thread)."""
        router_event = RouterEvent(
            worker_id=self.worker_id,
            event=KvCacheEvent(
                kind=event.kind,
                block_hashes=list(event.block_hashes),
                parent_hash=event.parent_hash,
                token_count=event.token_count,
            ),
        )
        self._loop.call_soon_threadsafe(self._queue.put_nowait, router_event)

    async def _pump(self) -> None:
        bus = self.component.runtime.plane.bus
        while True:
            event = await self._queue.get()
            try:
                await bus.publish(self.subject, event.to_json())
            except Exception:  # noqa: BLE001
                logger.exception("failed to publish kv event")


class WorkerMetricsPublisher:
    """Periodically publishes ForwardPassMetrics from an engine's stats."""

    def __init__(self, component: Component, worker_id: int, stats_fn, *, period_s: float = 1.0):
        self.component = component
        self.worker_id = worker_id
        self.stats_fn = stats_fn
        self.period_s = period_s
        self.subject = component.event_subject(LOAD_METRICS_SUBJECT)
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        if self._task is None:
            self._task = spawn_logged(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def publish_once(self) -> None:
        metrics = ForwardPassMetrics.from_stats(self.worker_id, self.stats_fn())
        await self.component.runtime.plane.bus.publish(self.subject, metrics.to_json())

    async def _loop(self) -> None:
        while True:
            try:
                await self.publish_once()
            except Exception:  # noqa: BLE001
                logger.exception("failed to publish metrics")
            await asyncio.sleep(self.period_s)


class ClearKvListener:
    """Worker-side subscriber for the admin cache-flush broadcast (reference:
    clear_kv_blocks admin endpoint, lib/llm/src/http/service/clear_kv_blocks.rs).

    The frontend publishes on the component's ``clear_kv_blocks`` event
    subject; every worker of that component flushes its published prefix
    state (which also emits a "cleared" RouterEvent to the indexers)."""

    def __init__(self, component: Component, engine):
        from dynamo_tpu_torch.llm.kv_router.protocols import CLEAR_KV_SUBJECT

        self.component = component
        self.engine = engine
        self.subject = component.event_subject(CLEAR_KV_SUBJECT)
        self._task: asyncio.Task | None = None
        self._sub = None

    def start(self) -> None:
        self._task = spawn_logged(self._loop())

    async def stop(self) -> None:
        if self._sub is not None:
            await self._sub.unsubscribe()
        if self._task is not None:
            self._task.cancel()

    async def _loop(self) -> None:
        bus = self.component.runtime.plane.bus
        while True:
            # a transient bus failure must not silently disable flush
            # handling for the worker's lifetime: resubscribe and keep going
            try:
                self._sub = await bus.subscribe(self.subject)
                async for _msg in self._sub:
                    try:
                        await self.engine.clear_kv_blocks()
                    except Exception:  # noqa: BLE001
                        logger.exception("clear_kv_blocks failed")
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                logger.exception("clear_kv listener lost its subscription; retrying")
            await asyncio.sleep(1.0)
