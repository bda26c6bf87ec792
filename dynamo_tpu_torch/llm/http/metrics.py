"""Frontend Prometheus metrics (a copy of dynamo_tpu/llm/http/metrics.py).

Per-model request/latency/token metrics under the ``dyn_llm`` prefix
(reference: lib/llm/src/http/service/metrics.rs:94-260, prefix ``nv_llm``).
``InflightGuard`` bumps the inflight gauge and records status + duration on
drop, like the reference's RAII guard.

Layered on top (one scrape surface, ``FrontendMetrics.render``):

- **SLO tracking** (observability/slo.py): every TTFT/ITL observation and
  request outcome also feeds the burn-rate tracker, rendered as
  ``dyn_slo_*`` families and served as JSON on the frontend's ``/slo``.
- **Exemplars** (:class:`ExemplarStore`): each latency observation records
  the request's ``x-request-id`` trace id against the histogram bucket it
  landed in — so the operator staring at a p99 bucket can jump straight to
  that request's span tree in the recorder.  Rendered as parse-safe
  ``# EXEMPLAR`` comment lines after the exposition, and structurally in
  the ``/slo`` payload.

``prometheus_client`` is imported where the families are made and
rendered, never when this module is imported.
"""

from __future__ import annotations

import time

from dynamo_tpu_torch.observability.slo import SloTracker
from dynamo_tpu_torch.robustness import counters as robustness_counters

PREFIX = "dyn_llm"

DURATION_BUCKETS = (0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
TTFT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
ITL_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)

TTFT_FAMILY = f"{PREFIX}_http_service_time_to_first_token_seconds"
ITL_FAMILY = f"{PREFIX}_http_service_inter_token_latency_seconds"
DURATION_FAMILY = f"{PREFIX}_http_service_request_duration_seconds"


class ExemplarStore:
    """Latest trace id per histogram bucket: the metric↔trace join point.

    Bounded by construction (one entry per (family, bucket) pair), so a
    long serve window cannot grow it.  The frontend runs single-threaded on
    the event loop — plain dict updates suffice."""

    def __init__(self) -> None:
        self._data: dict[str, dict[str, dict]] = {}

    def observe(
        self, family: str, buckets: tuple, value: float, trace_id: str | None
    ) -> None:
        if not trace_id:
            return
        from prometheus_client.utils import floatToGoString

        # same spelling prometheus_client uses for the histogram's own
        # _bucket le labels ("5.0", not "5") so the string join holds
        le = "+Inf"
        for b in buckets:
            if value <= b:
                le = floatToGoString(b)
                break
        self._data.setdefault(family, {})[le] = {
            "le": le,
            "trace_id": trace_id,
            "value": value,
            "ts": time.time(),
        }

    def snapshot(self) -> dict[str, list[dict]]:
        """{family: [exemplar, ...]} sorted by bucket bound (for /slo)."""
        def _key(e: dict) -> float:
            return float("inf") if e["le"] == "+Inf" else float(e["le"])

        return {
            family: sorted(by_le.values(), key=_key)
            for family, by_le in self._data.items()
        }

    def render(self) -> bytes:
        """Parse-safe comment lines appended to the text exposition (plain
        ``#`` comments are legal Prometheus text format; OpenMetrics-native
        exemplar syntax needs a different content type end-to-end)."""
        lines = []
        for family, exemplars in sorted(self.snapshot().items()):
            for e in exemplars:
                lines.append(
                    f'# EXEMPLAR {family}_bucket{{le="{e["le"]}"}} '
                    f'trace_id="{e["trace_id"]}" value={e["value"]:.6g} '
                    f"ts={e['ts']:.3f}"
                )
        if not lines:
            return b""
        return ("\n".join(lines) + "\n").encode()


class FrontendMetrics:
    def __init__(
        self,
        registry=None,
        slo: SloTracker | None = None,
    ):
        from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram

        self.registry = registry or CollectorRegistry()
        self.slo = slo or SloTracker()
        self.exemplars = ExemplarStore()
        # fleet TopologyMap (attach_topology): rendered as dyn_topology_*
        # families; None still declares the families with zero samples
        self.topology = None
        self.requests_total = Counter(
            f"{PREFIX}_http_service_requests_total",
            "Total HTTP LLM requests",
            ["model", "endpoint", "request_type", "status"],
            registry=self.registry,
        )
        self.inflight = Gauge(
            f"{PREFIX}_http_service_inflight_requests",
            "In-flight HTTP LLM requests",
            ["model", "endpoint"],
            registry=self.registry,
        )
        self.request_duration = Histogram(
            f"{PREFIX}_http_service_request_duration_seconds",
            "Request duration",
            ["model", "endpoint"],
            registry=self.registry,
            buckets=DURATION_BUCKETS,
        )
        self.time_to_first_token = Histogram(
            f"{PREFIX}_http_service_time_to_first_token_seconds",
            "Time to first streamed token",
            ["model"],
            registry=self.registry,
            buckets=TTFT_BUCKETS,
        )
        self.inter_token_latency = Histogram(
            f"{PREFIX}_http_service_inter_token_latency_seconds",
            "Latency between streamed tokens",
            ["model"],
            registry=self.registry,
            buckets=ITL_BUCKETS,
        )
        self.input_tokens = Histogram(
            f"{PREFIX}_http_service_input_sequence_tokens",
            "Prompt token count",
            ["model"],
            registry=self.registry,
            buckets=(16, 64, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 131072),
        )
        self.output_tokens = Histogram(
            f"{PREFIX}_http_service_output_sequence_tokens",
            "Completion token count",
            ["model"],
            registry=self.registry,
            buckets=(1, 4, 16, 64, 128, 256, 512, 1024, 2048, 8192),
        )

    def guard(
        self,
        model: str,
        endpoint: str,
        request_type: str,
        trace_id: str | None = None,
    ) -> "InflightGuard":
        return InflightGuard(self, model, endpoint, request_type, trace_id)

    def slo_status(self) -> dict:
        """The frontend ``/slo`` payload: burn rates + exemplars."""
        status = self.slo.status()
        status["exemplars"] = self.exemplars.snapshot()
        return status

    def attach_topology(self, topo_map) -> None:
        self.topology = topo_map

    def render(self) -> bytes:
        # one scrape surface: per-model serving metrics plus the process-
        # wide resilience counters (retries, sheds, control-plane
        # reconnects), the SLO burn-rate families, topology-map gauges,
        # flight-recorder summary, and bucket exemplars
        from prometheus_client import generate_latest

        from dynamo_tpu_torch.observability import flight
        from dynamo_tpu_torch.topology import metrics as topology_metrics

        return (
            generate_latest(self.registry)
            + robustness_counters.render()
            + self.slo.render()
            + topology_metrics.render(self.topology)
            + flight.render()
            + self.exemplars.render()
        )


class InflightGuard:
    def __init__(
        self,
        metrics: FrontendMetrics,
        model: str,
        endpoint: str,
        request_type: str,
        trace_id: str | None = None,
    ):
        self.metrics = metrics
        self.model = model
        self.endpoint = endpoint
        self.request_type = request_type
        self.trace_id = trace_id
        self.status = "error"
        self._start = time.monotonic()
        self._last_token: float | None = None
        # per-request lifecycle facts, readable after done() (span summary
        # + structured request log)
        self.ttft_s: float | None = None
        self.token_count = 0
        metrics.inflight.labels(model, endpoint).inc()

    def mark_ok(self) -> None:
        self.status = "success"

    def mark_client_error(self) -> None:
        """Request failed because of the caller (400-class): visible in
        requests_total, but not a server SLO violation."""
        self.status = "client_error"

    def mark_cancelled(self) -> None:
        """Caller went away (stream reset / request cancelled): not a
        server SLO violation."""
        self.status = "cancelled"

    def token_observed(self) -> None:
        now = time.monotonic()
        m = self.metrics
        if self._last_token is None:
            self.ttft_s = now - self._start
            m.time_to_first_token.labels(self.model).observe(self.ttft_s)
            m.slo.observe_latency("ttft", self.ttft_s)
            m.exemplars.observe(TTFT_FAMILY, TTFT_BUCKETS, self.ttft_s, self.trace_id)
        else:
            itl = now - self._last_token
            m.inter_token_latency.labels(self.model).observe(itl)
            m.slo.observe_latency("itl", itl)
            m.exemplars.observe(ITL_FAMILY, ITL_BUCKETS, itl, self.trace_id)
        self._last_token = now
        self.token_count += 1

    @property
    def duration_s(self) -> float:
        return time.monotonic() - self._start

    def done(self) -> None:
        duration = time.monotonic() - self._start
        m = self.metrics
        m.inflight.labels(self.model, self.endpoint).dec()
        m.requests_total.labels(
            self.model, self.endpoint, self.request_type, self.status
        ).inc()
        m.request_duration.labels(self.model, self.endpoint).observe(duration)
        m.exemplars.observe(DURATION_FAMILY, DURATION_BUCKETS, duration, self.trace_id)
        # error-rate SLO: only SERVER failures burn budget — client-caused
        # outcomes (client_error, cancelled) must not trip the shed hook
        m.slo.observe_outcome("error_rate", self.status != "error")
        # flight-recorder burn trigger: a worst-window burn rate above
        # DYN_FLIGHT_BURN auto-dumps every live recorder (rate-limited
        # inside — this runs per finished request)
        from dynamo_tpu_torch.observability import flight

        flight.check_burn(m.slo)
