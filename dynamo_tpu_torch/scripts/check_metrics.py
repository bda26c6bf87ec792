#!/usr/bin/env python
"""Smoke-check the Prometheus surfaces of a running deployment.

Scrapes the frontend's ``/metrics`` (``dyn_llm_*`` + ``dyn_slo_*`` families)
and the metrics service's ``/metrics`` (``dyn_worker_*`` families) and asserts
every expected metric family is present AND none is declared twice — the fast
"is observability wired at all?" gate for CI and for operators bringing up a
fleet.

Usage::

    python -m dynamo_tpu_torch.scripts.check_metrics \
        --frontend http://127.0.0.1:8080/metrics \
        --worker   http://127.0.0.1:9091/metrics

Either URL may be omitted to check only one surface.  Exit code 0 = all
expected families present; 1 = something missing (printed).

The family lists are importable (``FRONTEND_FAMILIES``/``WORKER_FAMILIES``,
``missing_families``) so the tier-1 test (tests/test_torch_ops_tools.py)
runs the same assertions in-process without sockets flakiness.
"""

from __future__ import annotations

import argparse
import re
import sys
import urllib.request

# resilience counters (dynamo_tpu_torch/robustness/counters.py): appended to the
# frontend's /metrics body and mirrored as gauges by the metrics service
RESILIENCE_FAMILIES = (
    "dyn_cp_reconnects_total",
    "dyn_retries_total",
    "dyn_shed_total",
    "dyn_faults_injected_total",
)

# mid-stream resume + graceful drain (dynamo_tpu_torch/runtime/resume.py and the
# ingress drain state machine), exported next to the other resilience counters
RESUME_DRAIN_FAMILIES = (
    "dyn_resume_attempts_total",
    "dyn_resume_success_total",
    "dyn_resume_prefill_requeues_total",
    "dyn_drain_started_total",
    "dyn_drain_completed_total",
    "dyn_drain_handoff_total",
)

# live session migration (dynamo_tpu_torch/runtime/migration.py), counted in the
# same robustness registry and rendered on both surfaces
MIGRATION_FAMILIES = (
    "dyn_migration_started_total",
    "dyn_migration_committed_total",
    "dyn_migration_aborted_total",
    "dyn_migration_failed_total",
    "dyn_migration_hidden_seconds",
)

# SLO burn-rate families (dynamo_tpu_torch/observability/slo.py), appended to the
# frontend exposition next to the resilience counters
SLO_FAMILIES = (
    "dyn_slo_burn_rate_ratio",
    "dyn_slo_good_total",
    "dyn_slo_bad_total",
    "dyn_slo_threshold_seconds",
)

# perf flight recorder (dynamo_tpu_torch/observability/flight.py): ring-buffer
# accounting rendered on BOTH surfaces — aggregated text families on the
# frontend (flight.render()) and per-worker gauges on the metrics service.
# Always declared — zeros until a recorder goes live.
FLIGHT_FAMILIES = (
    "dyn_flight_records_total",
    "dyn_flight_dropped_total",
    "dyn_flight_dumps_total",
    "dyn_flight_buffer_bytes",
)

# fleet topology plane (dynamo_tpu_torch/topology/): map shape + link measurements,
# rendered on BOTH surfaces (frontend text helper + metrics-service registry).
# Always declared — zeros until topology cards are published.
TOPOLOGY_FAMILIES = (
    "dyn_topology_nodes",
    "dyn_topology_links",
    "dyn_topology_probe_rtt_seconds",
    "dyn_topology_probe_bandwidth_bps",
    "dyn_topology_map_age_seconds",
)

# frontend registry (dynamo_tpu_torch/llm/http/metrics.py) + resilience counters
FRONTEND_FAMILIES = (
    "dyn_llm_http_service_requests_total",
    "dyn_llm_http_service_inflight_requests",
    "dyn_llm_http_service_request_duration_seconds",
    "dyn_llm_http_service_time_to_first_token_seconds",
    "dyn_llm_http_service_inter_token_latency_seconds",
    "dyn_llm_http_service_input_sequence_tokens",
    "dyn_llm_http_service_output_sequence_tokens",
) + RESILIENCE_FAMILIES + RESUME_DRAIN_FAMILIES + MIGRATION_FAMILIES + SLO_FAMILIES + TOPOLOGY_FAMILIES + FLIGHT_FAMILIES

# utilization accounting (dynamo_tpu_torch/observability/perf.py → engine stats →
# ForwardPassMetrics → metrics service)
UTILIZATION_FAMILIES = (
    "dyn_worker_mfu_perc",
    "dyn_worker_bandwidth_util_perc",
    "dyn_worker_goodput_tokens_per_second",
    "dyn_worker_prefill_tokens_per_second",
    "dyn_worker_prefill_tokens",
    "dyn_worker_decode_tokens",
    "dyn_worker_tokens_emitted",
    "dyn_worker_preempted_tokens",
    "dyn_worker_spec_rejected_tokens",
    "dyn_worker_wasted_tokens",
    "dyn_worker_engine_phase_seconds",
)

# predictive prefetch (dynamo_tpu_torch/prefetch/ via engine stats) + offload-tier
# occupancy, mirrored by the metrics service
PREFETCH_FAMILIES = (
    "dyn_prefetch_hits_total",
    "dyn_prefetch_misses_total",
    "dyn_prefetch_stale_total",
    "dyn_prefetch_hidden_seconds",
    "dyn_worker_offload_blocks",
    "dyn_worker_offload_blocks_used",
    "dyn_worker_offload_blocks_pinned",
)

# disagg streamed KV transfer (dynamo_tpu_torch/llm/disagg.py via engine stats →
# ForwardPassMetrics → metrics service): routing outcomes, transfer totals,
# and the hidden-fraction headline
DISAGG_FAMILIES = (
    "dyn_disagg_remote_prefills_total",
    "dyn_disagg_local_prefills_total",
    "dyn_disagg_prefill_timeouts_total",
    "dyn_disagg_kv_transfer_bytes_total",
    "dyn_disagg_kv_transfer_seconds_total",
    "dyn_disagg_kv_transfer_hidden_seconds_total",
    "dyn_disagg_kv_transfer_parts_total",
    "dyn_disagg_transfer_hidden_ratio",
    "dyn_disagg_kv_transfer_bandwidth_bps",
)

# ragged unified-batch step (engine unified_batch knob → engine stats →
# ForwardPassMetrics → metrics service)
UNIFIED_FAMILIES = (
    "dyn_worker_unified_windows",
    "dyn_worker_admission_drains",
    "dyn_worker_unified_fallbacks_total",
)

# planner autopilot state (dynamo_tpu_torch/planner/state.py events mirrored by
# the metrics service): latest decision targets + the burn input behind them
PLANNER_FAMILIES = (
    "dyn_planner_target_replicas",
    "dyn_planner_observed_capacity_tok_s",
    "dyn_planner_burn_rate_input",
)

# metrics service registry (dynamo_tpu_torch/components/metrics_service.py)
WORKER_FAMILIES = (
    "dyn_worker_kv_active_blocks",
    "dyn_worker_kv_total_blocks",
    "dyn_worker_cache_usage_perc",
    "dyn_worker_requests_waiting",
    "dyn_worker_requests_running",
    "dyn_worker_batch_occupancy_perc",
    "dyn_worker_preemptions",
    "dyn_worker_prefix_hits",
    "dyn_worker_prefix_cached_tokens",
    "dyn_worker_spec_accepted_tokens",
    "dyn_worker_kv_hit_blocks_total",
    "dyn_worker_kv_isl_blocks_total",
) + UNIFIED_FAMILIES + UTILIZATION_FAMILIES + RESILIENCE_FAMILIES + RESUME_DRAIN_FAMILIES + MIGRATION_FAMILIES + PREFETCH_FAMILIES + PLANNER_FAMILIES + DISAGG_FAMILIES + TOPOLOGY_FAMILIES + FLIGHT_FAMILIES + (
    # worker-surface-only: per-worker placement facts for dyn_top, plus the
    # latest flight-dump reason per worker (info-gauge, value 1)
    "dyn_topology_worker_info",
    "dyn_flight_last_dump_info",
)

_HELP_RE = re.compile(r"^# (?:HELP|TYPE) (\S+)", re.MULTILINE)
_TYPE_RE = re.compile(r"^# TYPE (\S+)", re.MULTILINE)


def exposed_families(text: str) -> set[str]:
    """Metric family names declared in a Prometheus text exposition."""
    return set(_HELP_RE.findall(text))


def missing_families(text: str, expected) -> list[str]:
    have = exposed_families(text)
    return [name for name in expected if name not in have]


def duplicate_families(text: str) -> list[str]:
    """Families declared (``# TYPE``) more than once — the signature of two
    code paths registering the same metric, which Prometheus servers reject
    and dashboards silently double-count."""
    counts: dict[str, int] = {}
    for name in _TYPE_RE.findall(text):
        counts[name] = counts.get(name, 0) + 1
    return sorted(name for name, n in counts.items() if n > 1)


def _scrape(url: str, timeout: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:  # noqa: S310
        return resp.read().decode("utf-8", "replace")


def check_url(url: str, expected, timeout: float = 5.0) -> tuple[list[str], list[str]]:
    """(missing families, duplicated families) for a live endpoint."""
    text = _scrape(url, timeout)
    return missing_families(text, expected), duplicate_families(text)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--frontend", help="frontend /metrics URL (dyn_llm_*)")
    parser.add_argument("--worker", help="metrics service /metrics URL (dyn_worker_*)")
    parser.add_argument("--timeout", type=float, default=5.0)
    args = parser.parse_args(argv)
    if not args.frontend and not args.worker:
        parser.error("give --frontend and/or --worker")

    failed = False
    for url, expected, label in (
        (args.frontend, FRONTEND_FAMILIES, "frontend"),
        (args.worker, WORKER_FAMILIES, "worker"),
    ):
        if not url:
            continue
        try:
            missing, duplicated = check_url(url, expected, args.timeout)
        except OSError as exc:
            print(f"{label}: scrape of {url} failed: {exc}")
            failed = True
            continue
        if missing:
            print(f"{label}: {url} missing families: {', '.join(missing)}")
            failed = True
        if duplicated:
            print(f"{label}: {url} duplicate families: {', '.join(duplicated)}")
            failed = True
        if not missing and not duplicated:
            print(f"{label}: {url} ok ({len(expected)} families)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
