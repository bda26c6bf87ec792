"""Process-global resilience counters.

The self-healing paths live in layers that must not depend on
prometheus_client (runtime/controlplane, runtime/client run inside workers,
frontends, and bare tools alike), so recovery events are counted here in a
plain thread-safe dict.  Surfaces that already speak Prometheus pull from
it: the HTTP frontend appends :func:`render` to its ``/metrics`` body and
``components/metrics_service.py`` mirrors the snapshot into gauges.

Known families (always rendered, zero-valued until the first event):

- ``dyn_cp_reconnects_total`` — control-plane connections re-established
- ``dyn_retries_total``       — requests re-dispatched pre-first-token
- ``dyn_shed_total``          — requests shed by frontend admission control
- ``dyn_faults_injected_total`` — faults fired by the injection registry
- ``dyn_resume_attempts_total`` — mid-stream resume re-dispatches attempted
- ``dyn_resume_success_total``  — streams completed after >= 1 resume
- ``dyn_resume_prefill_requeues_total`` — disagg prefill work re-enqueued
- ``dyn_drain_started_total``   — worker drains initiated
- ``dyn_drain_completed_total`` — worker drains finished inside the budget
- ``dyn_drain_handoff_total``   — in-flight requests handed off by a drain
"""

from __future__ import annotations

import threading

HELP = {
    "dyn_cp_reconnects_total": "Control-plane connections re-established after loss",
    "dyn_retries_total": "Requests safely re-dispatched after a pre-first-token stream failure",
    "dyn_shed_total": "Requests shed (429/503) by frontend admission control",
    "dyn_faults_injected_total": "Faults fired by the DYN_FAULTS injection registry",
    "dyn_resume_attempts_total": "Mid-stream resume re-dispatches after a post-first-token failure",
    "dyn_resume_success_total": "Streams completed exactly-once after at least one mid-stream resume",
    "dyn_resume_prefill_requeues_total": "Disagg prefill work re-enqueued after a mid-KV-stream loss",
    "dyn_drain_started_total": "Worker graceful drains initiated (dynctl drain / SIGTERM / scale-down)",
    "dyn_drain_completed_total": "Worker graceful drains that emptied within the budget",
    "dyn_drain_handoff_total": "In-flight requests handed off (resume-redispatch) by a draining worker",
    "dyn_migration_started_total": "Live session migrations that passed validation and began the handoff",
    "dyn_migration_committed_total": "Live session migrations whose stream flip committed on the destination",
    "dyn_migration_aborted_total": "Migrations aborted cleanly back to the still-decoding source",
    "dyn_migration_failed_total": "Migrate requests rejected before any handoff started (unknown session, bad destination, unpriced DCN hop)",
    "dyn_migration_hidden_seconds": "Wall seconds of source decode overlapped with migration handoffs (latency hidden from clients)",
}

_lock = threading.Lock()
_counters: dict[str, int] = {}


def incr(name: str, by: float = 1) -> float:
    with _lock:
        _counters[name] = _counters.get(name, 0) + by
        return _counters[name]


def get(name: str) -> int:
    with _lock:
        return _counters.get(name, 0)


def snapshot() -> dict[str, int]:
    """All known families plus any ad-hoc names that have been bumped."""
    with _lock:
        out = {name: 0 for name in HELP}
        out.update(_counters)
        return out


def reset() -> None:
    with _lock:
        _counters.clear()


def render() -> bytes:
    """Prometheus text exposition of every counter (known families always
    present so scrape checks can assert on them before the first event)."""
    lines = []
    for name, value in sorted(snapshot().items()):
        # accumulated-seconds families (e.g. dyn_migration_hidden_seconds)
        # render as gauges: the counter type reserves the _total suffix
        mtype = "counter" if name.endswith("_total") else "gauge"
        lines.append(f"# HELP {name} {HELP.get(name, 'Resilience counter')}")
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name} {value}")
    return ("\n".join(lines) + "\n").encode()
