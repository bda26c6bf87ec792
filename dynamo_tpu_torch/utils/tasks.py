"""Supervised async task utilities.

The port keeps only ``spawn_logged``: the supervised task groups serve the
distributed runtime, which the port does not carry yet.
"""

from __future__ import annotations

import asyncio
from collections.abc import Coroutine

from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("utils.tasks")


def _log_if_failed(task: asyncio.Task) -> None:
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        logger.error("background task %s crashed: %r", task.get_name(), exc)


def spawn_logged(coro: Coroutine, *, name: str | None = None) -> asyncio.Task:
    """``create_task`` with a guaranteed exception surface.

    A raw ``asyncio.ensure_future``/``create_task`` whose handle is only ever
    ``.cancel()``-ed swallows any crash until interpreter shutdown prints
    "Task exception was never retrieved".  This helper attaches a
    done-callback that logs non-cancellation exceptions the moment the task
    dies, so a background loop that crashes is visible in the logs instead of
    silently stopping.
    """
    task = asyncio.ensure_future(coro)
    label = name or getattr(coro, "__qualname__", None)
    if label:
        task.set_name(label)
    task.add_done_callback(_log_if_failed)
    return task
