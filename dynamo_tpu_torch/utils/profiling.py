"""Profiling hooks: device traces of the engine on ``torch.profiler`` (the
counterpart of dynamo_tpu/utils/profiling.py, which wraps
``jax.profiler``).

- ``trace(log_dir)``: context manager capturing a trace of the enclosed
  work into ``log_dir``.
- env ``DYN_PROFILER_TRACE_DIR``: capture a trace of the whole engine serve
  window (``maybe_start_trace_from_env`` at ``TorchLlmEngine.start``,
  ``maybe_stop_trace`` at ``stop``).
- ``annotate(name)``: a named range in the trace, free when no trace runs.

A trace records CPU operators on every thread (the engine's device thread
included) and, on a CUDA machine, every kernel on the card (graph replays
included), and is written as a Chrome trace (``trace_<pid>_<n>.json.gz``,
readable by Perfetto or ``chrome://tracing``; ``python -m
dynamo_tpu_torch.bench.trace_summary`` sums it).  A failure to start or
write a trace is logged and never stops serving.

Not ported: the reference's ``start_server`` / ``DYN_PROFILER_PORT``, which
serve jax's profiler to TensorBoard/xprof; ``torch.profiler`` has no
server to attach to.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from pathlib import Path

from dynamo_tpu_torch.utils import knobs
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("utils.profiling")

_env_profiler = None  # the profiler started from DYN_PROFILER_TRACE_DIR
_env_dir: str | None = None
_active = 0           # traces running in this process (annotate's switch)
_seq = itertools.count()


def _start(log_dir: str):
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    # profile_all_threads: the engine's operators run on its device thread
    prof = profile(activities=activities,
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    return prof


def _stop(prof, log_dir: str) -> str:
    prof.stop()
    path = str(Path(log_dir) / f"trace_{os.getpid()}_{next(_seq)}.json.gz")
    prof.export_chrome_trace(path)
    return path


def maybe_start_trace_from_env() -> str | None:
    """Start a long-running trace into ``DYN_PROFILER_TRACE_DIR`` (once per
    process; the engine calls this at start).  Returns the directory when
    THIS call started the trace, else None: the caller that got the
    directory owns the matching ``maybe_stop_trace``."""
    global _env_profiler, _env_dir, _active
    log_dir = (knobs.get("DYN_PROFILER_TRACE_DIR") or "").strip()
    if not log_dir or _env_profiler is not None:
        return None
    try:
        _env_profiler = _start(log_dir)
    except Exception as exc:  # noqa: BLE001 — profiling must never stop serving
        logger.warning("profiler trace start failed: %r", exc)
        return None
    _env_dir = log_dir
    _active += 1
    logger.info("profiler trace capturing to %s", log_dir)
    return log_dir


def maybe_stop_trace() -> None:
    """Stop the env-started trace and write it (no-op when none runs)."""
    global _env_profiler, _env_dir, _active
    if _env_profiler is None:
        return
    try:
        path = _stop(_env_profiler, _env_dir)
        logger.info("profiler trace written to %s", path)
    except Exception as exc:  # noqa: BLE001
        logger.warning("profiler trace stop failed: %r", exc)
    finally:
        _env_profiler = _env_dir = None
        _active -= 1


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/tb'): run_steps()``."""
    global _active
    prof = _start(log_dir)
    _active += 1
    try:
        yield
    finally:
        _active -= 1
        logger.info("trace written to %s", _stop(prof, log_dir))


def annotate(name: str):
    """A named range in the running trace (``record_function``); a no-op
    context when no trace runs."""
    if not _active:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)
