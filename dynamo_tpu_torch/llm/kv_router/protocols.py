"""KV-routing wire protocols (reference: lib/llm/src/kv_router/protocols.rs)."""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field


@dataclass
class KvCacheEvent:
    """A stored/removed block event from an engine."""

    kind: str                        # "stored" | "removed" | "cleared"
    block_hashes: list[int] = field(default_factory=list)
    parent_hash: int | None = None
    token_count: int = 0

    def to_json(self) -> bytes:
        return json.dumps(asdict(self)).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "KvCacheEvent":
        return cls(**json.loads(data))


@dataclass
class RouterEvent:
    """A KvCacheEvent attributed to a worker instance."""

    worker_id: int
    event: KvCacheEvent

    def to_json(self) -> bytes:
        return json.dumps({"worker_id": self.worker_id, "event": asdict(self.event)}).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "RouterEvent":
        d = json.loads(data)
        return cls(worker_id=d["worker_id"], event=KvCacheEvent(**d["event"]))


@dataclass
class ForwardPassMetrics:
    """Per-engine load snapshot (reference: protocols.rs:43-59; the
    ``gpu_cache_usage_perc`` name is kept for wire parity — on TPU it is HBM
    cache usage)."""

    worker_id: int = 0
    # disagg pool membership ("prefill"/"decode", "" = serves both): lets
    # planner.sample_from_endpoints split a mixed fleet into per-pool
    # capacity/occupancy without an out-of-band role map
    role: str = ""
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    gpu_cache_usage_perc: float = 0.0
    num_requests_waiting: int = 0
    num_requests_running: int = 0
    request_total_slots: int = 0
    iterations_total: int = 0
    # engine-side reuse/speculation evidence (cumulative)
    prefix_hits_total: int = 0
    prefix_cached_tokens_total: int = 0
    spec_accepted_tokens_total: int = 0
    # step telemetry (observability.step_metrics): decode-lane occupancy of
    # the latest step and cumulative preemption count
    batch_occupancy_perc: float = 0.0
    num_preemptions_total: int = 0
    # ragged unified-batch step: mixed prefill+decode windows served by one
    # dispatch, and pipeline drains forced by new-sequence admission (the
    # sync point the unified step exists to remove — flat while unified)
    decode_windows_unified_total: int = 0
    admission_drains_total: int = 0
    # unified-batch fallbacks by reason slug ({reason: count} — why windows
    # took the split path: init-time disables like "speculative"/"mesh" and
    # per-step route checks like "guided"/"slot_oom"; empty while every
    # window rides the unified step)
    unified_fallbacks: dict = field(default_factory=dict)
    # utilization accounting (observability.perf): rolling rates + token
    # totals + wasted-work counters, and the opt-in engine phase timings
    # (DYN_ENGINE_PHASE_TIMING=1) as {phase: cumulative seconds}
    mfu_perc: float = 0.0
    bandwidth_util_perc: float = 0.0
    goodput_tokens_per_second: float = 0.0
    prefill_tokens_per_second: float = 0.0
    prefill_tokens_total: int = 0
    decode_tokens_total: int = 0
    tokens_emitted_total: int = 0
    preempted_tokens_total: int = 0
    spec_rejected_tokens_total: int = 0
    wasted_tokens_total: int = 0
    phase_seconds: dict = field(default_factory=dict)
    # predictive prefetch (prefetch/pager.py) + offload-tier occupancy
    # ({tier: {"blocks": total, "used": n, "pinned": n?}} — empty when no
    # offload tier is mounted)
    prefetch_hits_total: int = 0
    prefetch_misses_total: int = 0
    prefetch_stale_total: int = 0
    prefetch_hidden_seconds_total: float = 0.0
    prefetch_blocks_restored_total: int = 0
    prefetch_blocks_onboarded_total: int = 0
    offload_tiers: dict = field(default_factory=dict)
    # disagg streamed KV transfer (llm/disagg.DisaggDecodeEngine): decode-side
    # prefill routing outcomes + transfer totals, and the link fields the
    # router's transfer-cost model consumes (hop class + measured inbound
    # bandwidth; "" / 0.0 = uncharacterized)
    disagg_remote_prefills_total: int = 0
    disagg_local_prefills_total: int = 0
    disagg_prefill_timeouts_total: int = 0
    disagg_kv_transfer_bytes_total: int = 0
    disagg_kv_transfer_seconds_total: float = 0.0
    disagg_kv_transfer_hidden_seconds_total: float = 0.0
    disagg_kv_transfer_parts_total: int = 0
    disagg_transfer_hidden_ratio: float = 0.0
    transfer_hop: str = ""
    kv_transfer_bandwidth_bps: float = 0.0
    # perf flight recorder (observability.flight): ring bookkeeping + the
    # last dump's trigger reason ("" until something dumped)
    flight_records_total: int = 0
    flight_dropped_total: int = 0
    flight_dumps_total: int = 0
    flight_buffer_bytes: int = 0
    flight_last_dump_reason: str = ""

    def to_json(self) -> bytes:
        return json.dumps(asdict(self)).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "ForwardPassMetrics":
        d = json.loads(data)
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_stats(cls, worker_id: int, stats: dict) -> "ForwardPassMetrics":
        return cls(
            worker_id=worker_id,
            role=str(stats.get("role", "") or ""),
            kv_active_blocks=stats.get("kv_active_blocks", 0),
            kv_total_blocks=stats.get("kv_total_blocks", 0),
            gpu_cache_usage_perc=stats.get("gpu_cache_usage_perc", 0.0),
            num_requests_waiting=stats.get("num_requests_waiting", 0),
            num_requests_running=stats.get("num_requests_running", 0),
            request_total_slots=stats.get("request_total_slots", 0),
            iterations_total=stats.get("iterations_total", 0),
            prefix_hits_total=stats.get("prefix_hits_total", 0),
            prefix_cached_tokens_total=stats.get("prefix_cached_tokens_total", 0),
            spec_accepted_tokens_total=stats.get("spec_accepted_tokens_total", 0),
            batch_occupancy_perc=stats.get("batch_occupancy_perc", 0.0),
            num_preemptions_total=stats.get("num_preemptions_total", 0),
            decode_windows_unified_total=stats.get(
                "decode_windows_unified_total", 0
            ),
            admission_drains_total=stats.get("admission_drains_total", 0),
            unified_fallbacks={
                str(reason): int(count)
                for reason, count in (stats.get("unified_fallbacks") or {}).items()
            },
            mfu_perc=stats.get("mfu_perc", 0.0),
            bandwidth_util_perc=stats.get("bandwidth_util_perc", 0.0),
            goodput_tokens_per_second=stats.get("goodput_tokens_per_second", 0.0),
            prefill_tokens_per_second=stats.get("prefill_tokens_per_second", 0.0),
            prefill_tokens_total=stats.get("prefill_tokens_total", 0),
            decode_tokens_total=stats.get("decode_tokens_total", 0),
            tokens_emitted_total=stats.get("tokens_emitted_total", 0),
            preempted_tokens_total=stats.get("preempted_tokens_total", 0),
            spec_rejected_tokens_total=stats.get("spec_rejected_tokens_total", 0),
            wasted_tokens_total=stats.get("wasted_tokens_total", 0),
            phase_seconds={
                str(name): float(row.get("total_ms", 0.0)) / 1e3
                for name, row in (stats.get("phase_ms") or {}).items()
                if isinstance(row, dict)
            },
            prefetch_hits_total=stats.get("prefetch_hits_total", 0),
            prefetch_misses_total=stats.get("prefetch_misses_total", 0),
            prefetch_stale_total=stats.get("prefetch_stale_total", 0),
            prefetch_hidden_seconds_total=stats.get(
                "prefetch_hidden_seconds_total", 0.0
            ),
            prefetch_blocks_restored_total=stats.get(
                "prefetch_blocks_restored_total", 0
            ),
            prefetch_blocks_onboarded_total=stats.get(
                "prefetch_blocks_onboarded_total", 0
            ),
            offload_tiers={
                str(tier): row
                for tier, row in (stats.get("offload_tiers") or {}).items()
                if isinstance(row, dict)
            },
            disagg_remote_prefills_total=stats.get("disagg_remote_prefills_total", 0),
            disagg_local_prefills_total=stats.get("disagg_local_prefills_total", 0),
            disagg_prefill_timeouts_total=stats.get(
                "disagg_prefill_timeouts_total", 0
            ),
            disagg_kv_transfer_bytes_total=stats.get(
                "disagg_kv_transfer_bytes_total", 0
            ),
            disagg_kv_transfer_seconds_total=stats.get(
                "disagg_kv_transfer_seconds_total", 0.0
            ),
            disagg_kv_transfer_hidden_seconds_total=stats.get(
                "disagg_kv_transfer_hidden_seconds_total", 0.0
            ),
            disagg_kv_transfer_parts_total=stats.get(
                "disagg_kv_transfer_parts_total", 0
            ),
            disagg_transfer_hidden_ratio=stats.get(
                "disagg_transfer_hidden_ratio", 0.0
            ),
            transfer_hop=str(stats.get("transfer_hop", "") or ""),
            kv_transfer_bandwidth_bps=stats.get("kv_transfer_bandwidth_bps", 0.0),
            flight_records_total=stats.get("flight_records_total", 0),
            flight_dropped_total=stats.get("flight_dropped_total", 0),
            flight_dumps_total=stats.get("flight_dumps_total", 0),
            flight_buffer_bytes=stats.get("flight_buffer_bytes", 0),
            flight_last_dump_reason=str(
                stats.get("flight_last_dump_reason", "") or ""
            ),
        )


@dataclass
class OverlapScores:
    """find_matches result: worker → number of matched prefix blocks."""

    scores: dict[int, int] = field(default_factory=dict)
    total_blocks: int = 0


@dataclass
class KvHitRateEvent:
    """Per-request routing outcome for observability (reference:
    lib/llm/src/kv_router/scheduler.rs:32)."""

    worker_id: int
    isl_blocks: int
    overlap_blocks: int

    def to_json(self) -> bytes:
        return json.dumps(asdict(self)).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "KvHitRateEvent":
        return cls(**json.loads(data))


KV_EVENT_SUBJECT = "kv_events"
LOAD_METRICS_SUBJECT = "load_metrics"
CLEAR_KV_SUBJECT = "clear_kv_blocks"
KV_HIT_RATE_SUBJECT = "kv_hit_rate"
