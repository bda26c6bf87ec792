"""Frontend admission control: bounded in-flight + bounded wait queue.

Overload policy (load-shedding beats timing out: a client told 429/503 with
``Retry-After`` can back off; a client waiting out a 120s socket timeout
cannot):

- up to ``max_inflight`` requests are admitted immediately;
- the next ``max_queue_depth`` wait up to ``queue_timeout_s`` for capacity;
- beyond the queue watermark → **429** at once (the burst is oversized);
- a queued request whose wait expires → **503** (the backlog is not
  draining — the fleet is saturated, not merely bursty).

Both sheds carry ``Retry-After`` and bump ``dyn_shed_total``.  Disabled
(the default, ``max_inflight == 0``) every call is a no-op.

SLO hook: when the HTTP frontend wires a ``burn_rate_fn`` (the SLO
tracker's worst burn rate, observability/slo.py) and
``shed_burn_threshold`` > 0 (``DYN_SLO_SHED_BURN``), a saturated gate stops
queueing while the error budget is burning past the threshold — queueing
deeper during a burn converts future 200s into future SLO violations.
"""

from __future__ import annotations

import asyncio
import os
from dataclasses import dataclass

from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils import knobs

logger = get_logger("robustness.admission")


class Overloaded(Exception):
    """Request shed by admission control."""

    def __init__(self, status: int, message: str, retry_after_s: float):
        super().__init__(message)
        self.status = status
        self.retry_after_s = retry_after_s


@dataclass
class AdmissionConfig:
    max_inflight: int = 0  # 0 = admission control disabled
    max_queue_depth: int = 0
    queue_timeout_s: float = 2.0
    retry_after_s: float = 1.0

    @classmethod
    def from_env(cls) -> "AdmissionConfig":
        max_inflight = knobs.get("DYN_ADMISSION_MAX_INFLIGHT")
        queue_depth = knobs.get("DYN_ADMISSION_QUEUE")
        return cls(
            max_inflight=max_inflight,
            max_queue_depth=(
                queue_depth if queue_depth is not None else 2 * max_inflight
            ),
            queue_timeout_s=knobs.get("DYN_ADMISSION_QUEUE_TIMEOUT_S"),
            retry_after_s=knobs.get("DYN_ADMISSION_RETRY_AFTER_S"),
        )


class AdmissionController:
    """Counting admission gate for one HTTP frontend process."""

    def __init__(self, config: AdmissionConfig | None = None):
        self.config = config or AdmissionConfig.from_env()
        self._cond = asyncio.Condition()
        self._inflight = 0
        self._queued = 0
        self.shed_total = 0
        # SLO consult (set by the frontend): () -> current worst burn rate.
        # 0 threshold = hook disabled.
        self.burn_rate_fn = None
        self.shed_burn_threshold = 0.0

    def _burning(self) -> float | None:
        """Current burn rate when it exceeds the shed threshold, else None."""
        if self.shed_burn_threshold <= 0 or self.burn_rate_fn is None:
            return None
        try:
            burn = float(self.burn_rate_fn())
        except Exception:  # noqa: BLE001 — telemetry must never fail admission
            return None
        return burn if burn >= self.shed_burn_threshold else None

    @property
    def enabled(self) -> bool:
        return self.config.max_inflight > 0

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def queue_depth(self) -> int:
        return self._queued

    def _shed(self, status: int, reason: str) -> Overloaded:
        self.shed_total += 1
        counters.incr("dyn_shed_total")
        logger.warning(
            "shedding request (%s): inflight=%d queued=%d",
            reason, self._inflight, self._queued,
        )
        return Overloaded(
            status,
            f"server overloaded ({reason}); retry after "
            f"{self.config.retry_after_s:g}s",
            self.config.retry_after_s,
        )

    async def acquire(self) -> None:
        """Admit or raise :class:`Overloaded`.  Callers MUST pair a
        successful acquire with exactly one :meth:`release`."""
        if not self.enabled:
            return
        cfg = self.config
        async with self._cond:
            if self._inflight < cfg.max_inflight:
                self._inflight += 1
                return
            burn = self._burning()
            if burn is not None:
                raise self._shed(429, f"slo burn rate {burn:.2f}")
            if self._queued >= cfg.max_queue_depth:
                raise self._shed(429, "queue full")
            self._queued += 1
            try:
                loop = asyncio.get_running_loop()
                deadline = loop.time() + cfg.queue_timeout_s
                while self._inflight >= cfg.max_inflight:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        raise self._shed(503, "queue wait timed out")
                    try:
                        await asyncio.wait_for(self._cond.wait(), remaining)
                    except asyncio.TimeoutError:
                        raise self._shed(503, "queue wait timed out") from None
            except BaseException:
                # shed/cancelled while queued: on py<3.13 a cancelled
                # Condition.wait can swallow a notify that raced it
                # (gh-90155) — re-notify so the freed slot reaches another
                # queued waiter instead of idling until a new request
                self._cond.notify(1)
                raise
            finally:
                self._queued -= 1
            self._inflight += 1

    async def release(self) -> None:
        if not self.enabled:
            return
        async with self._cond:
            self._inflight -= 1
            self._cond.notify(1)
