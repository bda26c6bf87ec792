"""Metrics service: aggregates worker load metrics into Prometheus.

(Reference: components/metrics/src/lib.rs — scrapes ``load_metrics``,
aggregates ProcessedEndpoints, exposes Prometheus; plus the KV-hit-rate
event subscription, KVHitRateEvent.)

A copy of dynamo_tpu/components/metrics_service.py.  ``prometheus_client``
is imported where the service builds its registry and renders it, so that
importing the port leaves it out.  With ``DYN_TOPO`` on (its default) the
service starts a ``TopologyWatcher`` and renders the ``dyn_topology_*``
families from its live map, unless a map is attached (``attach_topology``);
with it off, at zero, as the reference does with no map.

Run: ``python -m dynamo_tpu_torch.components.metrics_service --control-plane H:P``
"""

from __future__ import annotations

import argparse
import asyncio

from aiohttp import web

from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import KvMetricsAggregator
from dynamo_tpu_torch.llm.kv_router.protocols import KV_HIT_RATE_SUBJECT, KvHitRateEvent
from dynamo_tpu_torch.planner.state import PLANNER_STATE_EVENT, PlannerStateEvent
from dynamo_tpu_torch.robustness import counters as robustness_counters
from dynamo_tpu_torch.runtime.component import Component
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.utils.config import RuntimeConfig
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("components.metrics")

PREFIX = "dyn_worker"


class MetricsService:
    def __init__(self, component: Component, *, host: str = "0.0.0.0", port: int = 9091):
        self.component = component
        self.host = host
        self.port = port
        from prometheus_client import CollectorRegistry, Counter, Gauge

        self.aggregator = KvMetricsAggregator(component)
        self.registry = CollectorRegistry()
        self.kv_active = Gauge(
            f"{PREFIX}_kv_active_blocks", "Active KV blocks", ["worker"], registry=self.registry
        )
        self.kv_total = Gauge(
            f"{PREFIX}_kv_total_blocks", "Total KV blocks", ["worker"], registry=self.registry
        )
        self.cache_usage = Gauge(
            f"{PREFIX}_cache_usage_perc", "KV cache usage", ["worker"], registry=self.registry
        )
        self.waiting = Gauge(
            f"{PREFIX}_requests_waiting", "Queued requests", ["worker"], registry=self.registry
        )
        # engine step telemetry (emitted every scheduler iteration by the
        # engine's device loop; observability.step_metrics)
        self.running = Gauge(
            f"{PREFIX}_requests_running", "Running (decoding) requests",
            ["worker"], registry=self.registry,
        )
        self.batch_occupancy = Gauge(
            f"{PREFIX}_batch_occupancy_perc",
            "Decode-lane occupancy of the latest engine step (running/slots)",
            ["worker"], registry=self.registry,
        )
        self.preemptions = Gauge(
            f"{PREFIX}_preemptions",
            "Sequences preempted for KV pressure (cumulative)",
            ["worker"], registry=self.registry,
        )
        # ragged unified-batch step (engine unified_batch knob): one-dispatch
        # mixed windows served, and the admission-forced pipeline drains the
        # unified step removes (flat while unified serves the traffic)
        self.unified_windows = Gauge(
            f"{PREFIX}_unified_windows",
            "Mixed prefill+decode windows served by the ragged unified-batch "
            "dispatch (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.admission_drains = Gauge(
            f"{PREFIX}_admission_drains",
            "Decode-pipeline drains forced by new-sequence admission "
            "(cumulative)",
            ["worker"], registry=self.registry,
        )
        self.unified_fallbacks = Gauge(
            f"{PREFIX}_unified_fallbacks_total",
            "Unified-batch windows (or engine inits) downgraded to the "
            "split step, by reason slug (cumulative mirrored counter)",
            ["worker", "reason"], registry=self.registry,
        )
        # mirrored remote counters need .set(), so they are gauges —
        # named WITHOUT the counter-reserved _total suffix
        self.prefix_hits = Gauge(
            f"{PREFIX}_prefix_hits", "Engine prefix-cache hits (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.prefix_cached_tokens = Gauge(
            f"{PREFIX}_prefix_cached_tokens",
            "Prompt tokens served from the prefix cache (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.spec_accepted = Gauge(
            f"{PREFIX}_spec_accepted_tokens",
            "Draft tokens accepted by speculative verification (cumulative)",
            ["worker"], registry=self.registry,
        )
        # utilization accounting (observability/perf.py): rolling rates and
        # cumulative token/wasted-work totals per worker.  Mirrored remote
        # values, so gauges throughout (same rationale as the counters
        # below); rates carry their unit in the name.
        self.mfu = Gauge(
            f"{PREFIX}_mfu_perc",
            "Model FLOPs utilization over the rolling window (0-1)",
            ["worker"], registry=self.registry,
        )
        self.bandwidth_util = Gauge(
            f"{PREFIX}_bandwidth_util_perc",
            "Model HBM bandwidth utilization over the rolling window (0-1)",
            ["worker"], registry=self.registry,
        )
        self.goodput = Gauge(
            f"{PREFIX}_goodput_tokens_per_second",
            "Tokens per second actually delivered to callers (rolling window)",
            ["worker"], registry=self.registry,
        )
        self.prefill_rate = Gauge(
            f"{PREFIX}_prefill_tokens_per_second",
            "Prompt tokens per second computed (rolling window)",
            ["worker"], registry=self.registry,
        )
        self.prefill_tokens = Gauge(
            f"{PREFIX}_prefill_tokens",
            "Prompt tokens computed (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.decode_tokens = Gauge(
            f"{PREFIX}_decode_tokens",
            "Decode positions computed (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.tokens_emitted = Gauge(
            f"{PREFIX}_tokens_emitted",
            "Tokens emitted to caller streams (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.preempted_tokens = Gauge(
            f"{PREFIX}_preempted_tokens",
            "Context tokens recomputed due to KV-pressure preemption (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.spec_rejected = Gauge(
            f"{PREFIX}_spec_rejected_tokens",
            "Draft tokens rejected by speculative verification (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.wasted_tokens = Gauge(
            f"{PREFIX}_wasted_tokens",
            "Tokens computed that bought nothing a client received (cumulative)",
            ["worker"], registry=self.registry,
        )
        # engine phase timing (DYN_ENGINE_PHASE_TIMING=1): cumulative wall
        # seconds per decode/prefill phase — makes the overlap/sync pipeline
        # difference (decode.retire vs decode.readback) visible in /metrics
        self.phase_seconds = Gauge(
            f"{PREFIX}_engine_phase_seconds",
            "Cumulative engine wall seconds per hot-loop phase "
            "(DYN_ENGINE_PHASE_TIMING=1)",
            ["worker", "phase"], registry=self.registry,
        )
        # predictive prefetch (prefetch/pager.py via engine stats):
        # canonical dyn_prefetch_* family names from the subsystem contract
        # — mirrored remote counters, so gauges (same rationale as the
        # resilience counters below)
        self.prefetch_hits = Gauge(
            "dyn_prefetch_hits_total",
            "Prefetched KV blocks consumed by a sequence before eviction "
            "(cumulative)",
            ["worker"], registry=self.registry,
        )
        self.prefetch_misses = Gauge(
            "dyn_prefetch_misses_total",
            "Prefetched KV blocks evicted before any sequence matched them "
            "(cumulative)",
            ["worker"], registry=self.registry,
        )
        self.prefetch_stale = Gauge(
            "dyn_prefetch_stale_total",
            "Prefetch hints cancelled because they expired before paging ran "
            "(cumulative)",
            ["worker"], registry=self.registry,
        )
        self.prefetch_hidden = Gauge(
            "dyn_prefetch_hidden_seconds",
            "Page-in wall seconds moved off request critical paths by "
            "prefetch (cumulative)",
            ["worker"], registry=self.registry,
        )
        # disagg streamed KV transfer (llm/disagg.DisaggDecodeEngine stats):
        # canonical dyn_disagg_* family names — mirrored remote counters, so
        # gauges (same rationale as the prefetch family above).  The hidden
        # ratio is the headline: what fraction of transfer wall time the
        # streamed protocol moved off the TTFT critical path.
        self.disagg_remote_prefills = Gauge(
            "dyn_disagg_remote_prefills_total",
            "Prefills served by a remote prefill worker (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.disagg_local_prefills = Gauge(
            "dyn_disagg_local_prefills_total",
            "Prefills served locally after the disagg router declined remote "
            "(cumulative)",
            ["worker"], registry=self.registry,
        )
        self.disagg_prefill_timeouts = Gauge(
            "dyn_disagg_prefill_timeouts_total",
            "Remote prefills abandoned for local fallback after timeout "
            "(cumulative)",
            ["worker"], registry=self.registry,
        )
        self.disagg_transfer_bytes = Gauge(
            "dyn_disagg_kv_transfer_bytes_total",
            "KV bytes received from prefill workers (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.disagg_transfer_seconds = Gauge(
            "dyn_disagg_kv_transfer_seconds_total",
            "Wall seconds spent receiving+injecting KV transfer parts "
            "(cumulative)",
            ["worker"], registry=self.registry,
        )
        self.disagg_transfer_hidden = Gauge(
            "dyn_disagg_kv_transfer_hidden_seconds_total",
            "KV transfer seconds overlapped with remote prefill compute "
            "instead of exposed to TTFT (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.disagg_transfer_parts = Gauge(
            "dyn_disagg_kv_transfer_parts_total",
            "Streamed KV transfer parts received (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.disagg_hidden_ratio = Gauge(
            "dyn_disagg_transfer_hidden_ratio",
            "Fraction of KV transfer wall time hidden behind prefill "
            "compute (cumulative ratio, 0-1)",
            ["worker"], registry=self.registry,
        )
        self.disagg_bandwidth = Gauge(
            "dyn_disagg_kv_transfer_bandwidth_bps",
            "Measured inbound KV transfer bandwidth, bytes/second "
            "(cumulative mean; 0 until measured)",
            ["worker"], registry=self.registry,
        )
        # offload-tier occupancy (engine offload_tiers snapshot): capacity
        # and usage per mounted tier (g2 host / g3 disk / g4 remote)
        self.offload_blocks = Gauge(
            "dyn_worker_offload_blocks",
            "Offload-tier capacity in KV blocks",
            ["worker", "tier"], registry=self.registry,
        )
        self.offload_blocks_used = Gauge(
            "dyn_worker_offload_blocks_used",
            "Offload-tier blocks holding content",
            ["worker", "tier"], registry=self.registry,
        )
        self.offload_blocks_pinned = Gauge(
            "dyn_worker_offload_blocks_pinned",
            "Hot shared prefixes pinned tier-resident",
            ["worker", "tier"], registry=self.registry,
        )
        # perf flight recorder (observability/flight.py via engine stats):
        # ring bookkeeping per worker — mirrored remote counters, so gauges
        # with the canonical *_total names (same rationale as above).  The
        # last-dump reason rides as a label on a value-1 info series
        # (dyn_topology_worker_info precedent) — the dyn_top FLIGHT column
        # reads it.
        self.flight_records = Gauge(
            "dyn_flight_records_total",
            "Flight-recorder records captured (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.flight_dropped = Gauge(
            "dyn_flight_dropped_total",
            "Flight-recorder records evicted over the byte budget (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.flight_dumps = Gauge(
            "dyn_flight_dumps_total",
            "Flight-recorder JSONL dumps written (cumulative)",
            ["worker"], registry=self.registry,
        )
        self.flight_buffer = Gauge(
            "dyn_flight_buffer_bytes",
            "Flight-recorder ring occupancy in bytes",
            ["worker"], registry=self.registry,
        )
        self.flight_last_dump = Gauge(
            "dyn_flight_last_dump_info",
            "Per-worker last flight-dump trigger (value always 1; the "
            "reason rides as a label; absent until something dumped)",
            ["worker", "reason"], registry=self.registry,
        )
        self._seen_flight_dumps: set[tuple[str, str]] = set()
        self._worker_gauges = (
            self.kv_active, self.kv_total, self.cache_usage, self.waiting,
            self.running, self.batch_occupancy, self.preemptions,
            self.unified_windows, self.admission_drains,
            self.prefix_hits, self.prefix_cached_tokens, self.spec_accepted,
            self.mfu, self.bandwidth_util, self.goodput, self.prefill_rate,
            self.prefill_tokens, self.decode_tokens, self.tokens_emitted,
            self.preempted_tokens, self.spec_rejected, self.wasted_tokens,
            self.prefetch_hits, self.prefetch_misses, self.prefetch_stale,
            self.prefetch_hidden,
            self.disagg_remote_prefills, self.disagg_local_prefills,
            self.disagg_prefill_timeouts, self.disagg_transfer_bytes,
            self.disagg_transfer_seconds, self.disagg_transfer_hidden,
            self.disagg_transfer_parts, self.disagg_hidden_ratio,
            self.disagg_bandwidth,
            self.flight_records, self.flight_dropped, self.flight_dumps,
            self.flight_buffer,
        )
        self._seen_workers: set[str] = set()
        self._seen_phases: set[tuple[str, str]] = set()
        self._seen_fallback_reasons: set[tuple[str, str]] = set()
        self._seen_tiers: set[tuple[str, str]] = set()
        self.hit_blocks = Counter(
            f"{PREFIX}_kv_hit_blocks_total", "Matched prefix blocks routed", registry=self.registry
        )
        self.isl_blocks = Counter(
            f"{PREFIX}_kv_isl_blocks_total", "Total request prefix blocks", registry=self.registry
        )
        # resilience counters (robustness.counters): mirrored on refresh so
        # one scrape shows recovery activity next to worker load.  Gauges
        # because a mirror needs .set() (same rationale as above), but they
        # keep the canonical *_total names the frontend exposition uses.
        self.resilience = {
            name: Gauge(name, help_text, registry=self.registry)
            for name, help_text in robustness_counters.HELP.items()
        }
        # planner autopilot state (planner/state.py events on the component
        # bus): latest decision targets, per-pool observed capacity, and the
        # worst burn rate the planner consumed — WHY the fleet is its size
        self.planner_target = Gauge(
            "dyn_planner_target_replicas",
            "Replica target from the planner's latest executed decision",
            ["pool"], registry=self.registry,
        )
        self.planner_capacity = Gauge(
            "dyn_planner_observed_capacity_tok_s",
            "Planner's observed per-replica capacity estimate (EWMA at "
            "saturation; 0 until measured)",
            ["pool"], registry=self.registry,
        )
        self.planner_burn = Gauge(
            "dyn_planner_burn_rate_input",
            "Worst per-objective SLO burn rate the planner consumed for its "
            "latest decision",
            registry=self.registry,
        )
        # fleet topology plane (topology/): map shape + link measurements,
        # mirrored from the service's own TopologyWatcher (or an attached
        # map).  Families always exist — zeros until cards are published.
        self.topology_nodes = Gauge(
            "dyn_topology_nodes",
            "Workers with a published topology card",
            registry=self.registry,
        )
        self.topology_links = Gauge(
            "dyn_topology_links",
            "Pairwise links in the fleet topology map by hop class",
            ["hop"], registry=self.registry,
        )
        self.topology_probe_rtt = Gauge(
            "dyn_topology_probe_rtt_seconds",
            "Probe round-trip EWMA by hop class",
            ["hop"], registry=self.registry,
        )
        self.topology_probe_bandwidth = Gauge(
            "dyn_topology_probe_bandwidth_bps",
            "Measured link bandwidth EWMA by hop class",
            ["hop"], registry=self.registry,
        )
        self.topology_map_age = Gauge(
            "dyn_topology_map_age_seconds",
            "Seconds since the topology map last changed",
            registry=self.registry,
        )
        self.topology_worker_info = Gauge(
            "dyn_topology_worker_info",
            "Per-worker placement facts (value always 1; slice and inbound "
            "hop class ride as labels)",
            ["worker", "slice", "hop"], registry=self.registry,
        )
        self._seen_topology_workers: set[tuple[str, str, str]] = set()
        self._topology = None          # TopologyMap (attached or watched)
        self._topology_watcher = None  # owned TopologyWatcher, when started
        from dynamo_tpu_torch.topology.metrics import HOP_CLASSES

        for hop in HOP_CLASSES:
            self.topology_links.labels(hop).set(0)
            self.topology_probe_rtt.labels(hop).set(0)
            self.topology_probe_bandwidth.labels(hop).set(0)
        self._planner_event: PlannerStateEvent | None = None
        self._planner_sub = None
        self._planner_task: asyncio.Task | None = None
        self._hit_sub = None
        self._hit_task: asyncio.Task | None = None
        self._runner: web.AppRunner | None = None

    def attach_topology(self, topo_map) -> None:
        """Mirror an externally-owned TopologyMap (fleet/test harnesses)
        instead of watching the control plane for cards ourselves."""
        self._topology = topo_map

    async def start(self) -> None:
        await self.aggregator.start()
        from dynamo_tpu_torch.utils import knobs

        if self._topology is None and knobs.get("DYN_TOPO"):
            from dynamo_tpu_torch.topology import TopologyWatcher

            self._topology_watcher = TopologyWatcher(self.component.runtime)
            await self._topology_watcher.start()
            self._topology = self._topology_watcher.map
        bus = self.component.runtime.plane.bus
        self._hit_sub = await bus.subscribe(self.component.event_subject(KV_HIT_RATE_SUBJECT))
        self._hit_task = spawn_logged(self._hit_loop())
        self._planner_sub = await bus.subscribe(
            self.component.event_subject(PLANNER_STATE_EVENT)
        )
        self._planner_task = spawn_logged(self._planner_loop())

        app = web.Application()
        app.router.add_get("/metrics", self._metrics)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        for s in site._server.sockets:
            self.port = s.getsockname()[1]
            break
        logger.info("metrics service on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        await self.aggregator.stop()
        if self._topology_watcher is not None:
            await self._topology_watcher.stop()
            self._topology_watcher = None
        if self._hit_sub is not None:
            await self._hit_sub.unsubscribe()
        if self._hit_task is not None:
            self._hit_task.cancel()
        if self._planner_sub is not None:
            await self._planner_sub.unsubscribe()
        if self._planner_task is not None:
            self._planner_task.cancel()
        if self._runner is not None:
            await self._runner.cleanup()

    async def _hit_loop(self) -> None:
        async for msg in self._hit_sub:
            try:
                event = KvHitRateEvent.from_json(msg.payload)
            except Exception:  # noqa: BLE001
                continue
            self.hit_blocks.inc(event.overlap_blocks)
            self.isl_blocks.inc(max(event.isl_blocks, 0))

    async def _planner_loop(self) -> None:
        async for msg in self._planner_sub:
            try:
                self._planner_event = PlannerStateEvent.from_json(msg.payload)
            except Exception:  # noqa: BLE001
                continue

    def _refresh_topology(self) -> None:
        from dynamo_tpu_torch.topology.metrics import HOP_CLASSES, hop_summaries

        topo = self._topology
        summaries = hop_summaries(topo)
        self.topology_nodes.set(len(topo.nodes) if topo is not None else 0)
        self.topology_map_age.set(topo.age_s() if topo is not None else 0.0)
        for hop in HOP_CLASSES:
            self.topology_links.labels(hop).set(summaries[hop]["links"])
            self.topology_probe_rtt.labels(hop).set(summaries[hop]["rtt_s"])
            self.topology_probe_bandwidth.labels(hop).set(summaries[hop]["bps"])
        # per-worker placement info series (value 1, facts in the labels) —
        # the dyn_top SLICE/HOP column reads these
        current: set[tuple[str, str, str]] = set()
        if topo is not None:
            for wid, card in topo.nodes.items():
                key = (
                    f"{wid:x}",
                    card.slice_label or "-",
                    topo.inbound_hop(wid) or "-",
                )
                self.topology_worker_info.labels(*key).set(1)
                current.add(key)
        for key in self._seen_topology_workers - current:
            try:
                self.topology_worker_info.remove(*key)
            except KeyError:
                pass
        self._seen_topology_workers = current

    def _refresh(self) -> None:
        self._refresh_topology()
        ev = self._planner_event
        if ev is not None:
            self.planner_target.labels("prefill").set(ev.target_prefill)
            self.planner_target.labels("decode").set(ev.target_decode)
            self.planner_capacity.labels("prefill").set(ev.observed_prefill_tok_s)
            self.planner_capacity.labels("decode").set(ev.observed_decode_tok_s)
            self.planner_burn.set(ev.burn_rate_input)
        for name, value in robustness_counters.snapshot().items():
            gauge = self.resilience.get(name)
            if gauge is not None:
                gauge.set(value)
        snapshot = self.aggregator.snapshot()
        live = {f"{wid:x}" for wid in snapshot.workers}
        # drop gauges for workers that fell out of the snapshot (lease
        # lost / TTL expired) — stale values must not look alive forever
        for label in self._seen_workers - live:
            for g in self._worker_gauges:
                try:
                    g.remove(label)
                except KeyError:
                    pass
        for label, phase in list(self._seen_phases):
            if label not in live:
                try:
                    self.phase_seconds.remove(label, phase)
                except KeyError:
                    pass
                self._seen_phases.discard((label, phase))
        for label, reason in list(self._seen_fallback_reasons):
            if label not in live:
                try:
                    self.unified_fallbacks.remove(label, reason)
                except KeyError:
                    pass
                self._seen_fallback_reasons.discard((label, reason))
        for label, reason in list(self._seen_flight_dumps):
            if label not in live:
                try:
                    self.flight_last_dump.remove(label, reason)
                except KeyError:
                    pass
                self._seen_flight_dumps.discard((label, reason))
        for label, tier in list(self._seen_tiers):
            if label not in live:
                for g in (
                    self.offload_blocks, self.offload_blocks_used,
                    self.offload_blocks_pinned,
                ):
                    try:
                        g.remove(label, tier)
                    except KeyError:
                        pass
                self._seen_tiers.discard((label, tier))
        self._seen_workers = live
        for wid, m in snapshot.workers.items():
            label = f"{wid:x}"
            self.kv_active.labels(label).set(m.kv_active_blocks)
            self.kv_total.labels(label).set(m.kv_total_blocks)
            self.cache_usage.labels(label).set(m.gpu_cache_usage_perc)
            self.waiting.labels(label).set(m.num_requests_waiting)
            self.running.labels(label).set(m.num_requests_running)
            self.batch_occupancy.labels(label).set(m.batch_occupancy_perc)
            self.preemptions.labels(label).set(m.num_preemptions_total)
            self.unified_windows.labels(label).set(m.decode_windows_unified_total)
            self.admission_drains.labels(label).set(m.admission_drains_total)
            reasons_now = set(m.unified_fallbacks or {})
            for reason, count in (m.unified_fallbacks or {}).items():
                self.unified_fallbacks.labels(label, reason).set(count)
                self._seen_fallback_reasons.add((label, reason))
            # a worker restart can clear a fallback reason (e.g. the knob
            # flipped): drop its stale series like the phase gauges do
            for seen_label, reason in list(self._seen_fallback_reasons):
                if seen_label == label and reason not in reasons_now:
                    try:
                        self.unified_fallbacks.remove(label, reason)
                    except KeyError:
                        pass
                    self._seen_fallback_reasons.discard((label, reason))
            self.prefix_hits.labels(label).set(m.prefix_hits_total)
            self.prefix_cached_tokens.labels(label).set(m.prefix_cached_tokens_total)
            self.spec_accepted.labels(label).set(m.spec_accepted_tokens_total)
            self.mfu.labels(label).set(m.mfu_perc)
            self.bandwidth_util.labels(label).set(m.bandwidth_util_perc)
            self.goodput.labels(label).set(m.goodput_tokens_per_second)
            self.prefill_rate.labels(label).set(m.prefill_tokens_per_second)
            self.prefill_tokens.labels(label).set(m.prefill_tokens_total)
            self.decode_tokens.labels(label).set(m.decode_tokens_total)
            self.tokens_emitted.labels(label).set(m.tokens_emitted_total)
            self.preempted_tokens.labels(label).set(m.preempted_tokens_total)
            self.spec_rejected.labels(label).set(m.spec_rejected_tokens_total)
            self.wasted_tokens.labels(label).set(m.wasted_tokens_total)
            self.prefetch_hits.labels(label).set(m.prefetch_hits_total)
            self.prefetch_misses.labels(label).set(m.prefetch_misses_total)
            self.prefetch_stale.labels(label).set(m.prefetch_stale_total)
            self.prefetch_hidden.labels(label).set(m.prefetch_hidden_seconds_total)
            self.disagg_remote_prefills.labels(label).set(
                m.disagg_remote_prefills_total
            )
            self.disagg_local_prefills.labels(label).set(
                m.disagg_local_prefills_total
            )
            self.disagg_prefill_timeouts.labels(label).set(
                m.disagg_prefill_timeouts_total
            )
            self.disagg_transfer_bytes.labels(label).set(
                m.disagg_kv_transfer_bytes_total
            )
            self.disagg_transfer_seconds.labels(label).set(
                m.disagg_kv_transfer_seconds_total
            )
            self.disagg_transfer_hidden.labels(label).set(
                m.disagg_kv_transfer_hidden_seconds_total
            )
            self.disagg_transfer_parts.labels(label).set(
                m.disagg_kv_transfer_parts_total
            )
            self.disagg_hidden_ratio.labels(label).set(
                m.disagg_transfer_hidden_ratio
            )
            self.disagg_bandwidth.labels(label).set(m.kv_transfer_bandwidth_bps)
            self.flight_records.labels(label).set(m.flight_records_total)
            self.flight_dropped.labels(label).set(m.flight_dropped_total)
            self.flight_dumps.labels(label).set(m.flight_dumps_total)
            self.flight_buffer.labels(label).set(m.flight_buffer_bytes)
            reason_now = m.flight_last_dump_reason or ""
            if reason_now:
                self.flight_last_dump.labels(label, reason_now).set(1)
                self._seen_flight_dumps.add((label, reason_now))
            # only the LATEST dump reason may stand per worker — a newer
            # trigger replaces the old series instead of accumulating
            for seen_label, reason in list(self._seen_flight_dumps):
                if seen_label == label and reason != reason_now:
                    try:
                        self.flight_last_dump.remove(label, reason)
                    except KeyError:
                        pass
                    self._seen_flight_dumps.discard((label, reason))
            for tier, row in (m.offload_tiers or {}).items():
                self.offload_blocks.labels(label, tier).set(row.get("blocks", 0))
                self.offload_blocks_used.labels(label, tier).set(row.get("used", 0))
                self.offload_blocks_pinned.labels(label, tier).set(
                    row.get("pinned", 0)
                )
                self._seen_tiers.add((label, tier))
            phases_now = set(m.phase_seconds or {})
            for phase, seconds in (m.phase_seconds or {}).items():
                self.phase_seconds.labels(label, phase).set(seconds)
                self._seen_phases.add((label, phase))
            # a worker that restarted with a different mode (e.g. overlap
            # toggled) stops reporting some phases: drop their stale series
            # instead of freezing pre-restart cumulative values forever
            for seen_label, phase in list(self._seen_phases):
                if seen_label == label and phase not in phases_now:
                    try:
                        self.phase_seconds.remove(label, phase)
                    except KeyError:
                        pass
                    self._seen_phases.discard((label, phase))

    async def _metrics(self, request: web.Request) -> web.Response:
        from prometheus_client import generate_latest

        self._refresh()
        return web.Response(body=generate_latest(self.registry), content_type="text/plain")


async def amain(args) -> int:
    configure_logging()
    runtime = await DistributedRuntime.create(
        RuntimeConfig(control_plane=args.control_plane)
    )
    component = runtime.namespace(args.namespace).component(args.component)
    service = MetricsService(component, host=args.host, port=args.port)
    await service.start()
    await runtime.wait_for_shutdown()
    await service.stop()
    await runtime.close()
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--control-plane", default="127.0.0.1:2379")
    parser.add_argument("--namespace", default="dynamo")
    parser.add_argument("--component", default="backend")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=9091)
    return asyncio.run(amain(parser.parse_args()))


if __name__ == "__main__":
    raise SystemExit(main())
