"""Supervised async task utilities.

Mirrors the reference's ``CriticalTaskExecutionHandle`` (reference:
lib/runtime/src/utils/task.rs): a critical task that fails or panics must take
the whole runtime down rather than leave the process half-alive.
"""

from __future__ import annotations

import asyncio
from collections.abc import Coroutine
from typing import Any, Callable

from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("utils.tasks")


def _notify_flight(name: str, exc: BaseException) -> None:
    """Dump the perf flight recorders on a task crash.  Lazy import (tasks
    is near the bottom of the import graph) and best-effort: a crash report
    must never mask the original failure."""
    try:
        from dynamo_tpu_torch.observability import flight

        flight.on_task_crash(name, exc)
    except Exception:  # noqa: BLE001
        logger.debug("flight crash dump failed", exc_info=True)


def _log_if_failed(task: asyncio.Task) -> None:
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        logger.error("background task %s crashed: %r", task.get_name(), exc)
        _notify_flight(task.get_name(), exc)


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


class CriticalTaskGroup:
    """Tracks supervised background tasks.

    - ``spawn(coro)``: plain background task; exceptions are logged.
    - ``spawn_critical(coro)``: if the task raises, ``on_failure`` is invoked
      (typically ``runtime.shutdown``) so the process fails fast.
    - ``cancel_all()``: cancel and await every tracked task.
    """

    def __init__(self, on_failure: Callable[[BaseException], Any] | None = None):
        self._tasks: set[asyncio.Task] = set()
        self._on_failure = on_failure

    def spawn(self, coro: Coroutine, *, name: str | None = None) -> asyncio.Task:
        task = asyncio.get_running_loop().create_task(coro, name=name)
        self._tasks.add(task)
        task.add_done_callback(self._done)
        return task

    def spawn_critical(self, coro: Coroutine, *, name: str | None = None) -> asyncio.Task:
        task = self.spawn(coro, name=name)
        task._dyn_critical = True  # type: ignore[attr-defined]
        return task

    def _done(self, task: asyncio.Task) -> None:
        self._tasks.discard(task)
        if task.cancelled():
            return
        exc = task.exception()
        if exc is None:
            return
        name = task.get_name()
        if getattr(task, "_dyn_critical", False):
            logger.error("critical task %s failed: %r", name, exc)
            _notify_flight(name, exc)
            if self._on_failure is not None:
                self._on_failure(exc)
        else:
            logger.warning("background task %s failed: %r", name, exc)
            _notify_flight(name, exc)

    async def cancel_all(self) -> None:
        tasks = list(self._tasks)
        self._tasks.clear()
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass

    def __len__(self) -> int:
        return len(self._tasks)
