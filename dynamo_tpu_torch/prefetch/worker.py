"""Worker-side prefetch hint listener.

Subscribes the component's ``prefetch_targets`` subject (same
resubscribe-on-failure shape as ``ClearKvListener``), filters messages
addressed to this worker's instance id, and feeds the engine's pager via
``engine.prefetch_hint`` — a thread-safe enqueue that wakes the device
loop."""

from __future__ import annotations

import asyncio

from dynamo_tpu_torch.prefetch.hints import PREFETCH_TARGET_SUBJECT, TargetedPrefetchHint
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("prefetch.worker")


class PrefetchListener:
    def __init__(self, component, engine, worker_id: int):
        self.component = component
        self.engine = engine
        self.worker_id = worker_id
        self.subject = component.event_subject(PREFETCH_TARGET_SUBJECT)
        self._task: asyncio.Task | None = None
        self._sub = None
        self.received_total = 0

    def start(self) -> None:
        if self._task is None:
            self._task = spawn_logged(self._loop())

    async def stop(self) -> None:
        if self._sub is not None:
            await self._sub.unsubscribe()
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        bus = self.component.runtime.plane.bus
        while True:
            try:
                self._sub = await bus.subscribe(self.subject)
                async for msg in self._sub:
                    try:
                        targeted = TargetedPrefetchHint.from_json(msg.payload)
                    except Exception:  # noqa: BLE001
                        logger.exception("bad targeted prefetch hint")
                        continue
                    if targeted.worker_id != self.worker_id:
                        continue
                    self.received_total += 1
                    try:
                        self.engine.prefetch_hint(
                            targeted.hint.block_hashes, source=targeted.hint.source
                        )
                    except Exception:  # noqa: BLE001 — hints are best-effort
                        logger.exception("prefetch hint rejected by engine")
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                logger.exception("prefetch listener lost its subscription; retrying")
            await asyncio.sleep(1.0)
