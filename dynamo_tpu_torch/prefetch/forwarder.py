"""Router-side hint targeting + next-turn prediction.

Subscribes the component's ``prefetch_hints`` subject, resolves each hint
to the worker whose radix index holds the longest matching prefix (the
index covers every tier the worker still has the content in — ``removed``
only fires when a hash leaves the worker's *bottom* tier), and republishes
on ``prefetch_targets`` for that worker's listener.

Arrival hints also feed the :class:`SessionPredictor`; a periodic task
fires predicted next-turn hints through the same targeting path, so a
parked session's blocks start paging up-tier *before* the user returns.
"""

from __future__ import annotations

import asyncio

from dynamo_tpu_torch.prefetch.hints import (
    PREFETCH_HINT_SUBJECT,
    PREFETCH_TARGET_SUBJECT,
    SOURCE_PREDICTED,
    PrefetchHint,
    TargetedPrefetchHint,
)
from dynamo_tpu_torch.prefetch.session import SessionPredictor
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("prefetch.forwarder")


class PrefetchForwarder:
    """Owns the hint subscription + prediction loop for one component."""

    def __init__(
        self,
        component,
        indexer,
        *,
        predictor: SessionPredictor | None = None,
        predict_period_s: float = 0.25,
        min_overlap_blocks: int = 1,
    ):
        self.component = component
        self.indexer = indexer
        self.predictor = predictor or SessionPredictor()
        self.predict_period_s = predict_period_s
        self.min_overlap_blocks = min_overlap_blocks
        self._sub = None
        self._tasks: list[asyncio.Task] = []
        self.forwarded_total = 0
        self.unroutable_total = 0
        self.predicted_total = 0

    async def start(self) -> None:
        # initial subscribe happens HERE (not in the loop task) so a hint
        # published right after start() cannot race the subscription
        bus = self.component.runtime.plane.bus
        self._sub = await bus.subscribe(
            self.component.event_subject(PREFETCH_HINT_SUBJECT)
        )
        self._tasks = [
            spawn_logged(self._hint_loop()),
            spawn_logged(self._predict_loop()),
        ]

    async def stop(self) -> None:
        # cancel before unsubscribing so the loop can't resubscribe in
        # the window between the two
        for task in self._tasks:
            task.cancel()
        self._tasks = []
        if self._sub is not None:
            await self._sub.unsubscribe()
            self._sub = None

    # -- loops ---------------------------------------------------------------
    async def _hint_loop(self) -> None:
        # resubscribe-on-failure (same shape as the worker's
        # PrefetchListener): a control-plane blip must not silently kill
        # hint targeting for the component's remaining lifetime
        bus = self.component.runtime.plane.bus
        subject = self.component.event_subject(PREFETCH_HINT_SUBJECT)
        while True:
            try:
                if self._sub is None:
                    self._sub = await bus.subscribe(subject)
                async for msg in self._sub:
                    # one malformed hint (or indexer hiccup) must not kill
                    # targeting — catch everything per message
                    try:
                        hint = PrefetchHint.from_json(msg.payload)
                        self.predictor.observe(hint.block_hashes)
                        await self._target(hint)
                    except asyncio.CancelledError:
                        raise
                    except Exception:  # noqa: BLE001
                        logger.exception("prefetch hint handling failed")
                self._sub = None  # iterator ended cleanly: fresh subscribe
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                logger.exception("prefetch hint subscription lost; retrying")
                self._sub = None
            await asyncio.sleep(1.0)

    async def _predict_loop(self) -> None:
        while True:
            await asyncio.sleep(self.predict_period_s)
            try:
                for pred in self.predictor.due():
                    self.predicted_total += 1
                    await self._target(
                        PrefetchHint(
                            block_hashes=pred.block_hashes,
                            source=SOURCE_PREDICTED,
                        )
                    )
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                logger.exception("prefetch prediction failed")

    # -- targeting -----------------------------------------------------------
    async def _target(self, hint: PrefetchHint) -> None:
        """Forward to the worker with the deepest prefix overlap.  No
        overlap anywhere ⇒ no worker holds the content in any tier —
        nothing to page in, drop the hint."""
        overlap = self.indexer.find_matches(hint.block_hashes)
        if not overlap.scores:
            self.unroutable_total += 1
            return
        worker_id, blocks = max(overlap.scores.items(), key=lambda kv: kv[1])
        if blocks < self.min_overlap_blocks:
            self.unroutable_total += 1
            return
        self.forwarded_total += 1
        try:
            await self.component.runtime.plane.bus.publish(
                self.component.event_subject(PREFETCH_TARGET_SUBJECT),
                TargetedPrefetchHint(worker_id=worker_id, hint=hint).to_json(),
            )
        except Exception:  # noqa: BLE001 — hints are best-effort
            logger.debug("prefetch target publish failed", exc_info=True)
