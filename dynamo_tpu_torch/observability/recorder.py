"""Span recorder: bounded in-memory buffer + JSONL / Chrome-trace exporters.

Every layer records spans here (the HTTP frontend, the KV router, the push
dispatch, the worker ingress, and the engine's device thread — the recorder
is thread-safe).  Spans carry the propagated :class:`TraceContext`, so one
request's tree can be reassembled with :meth:`SpanRecorder.spans_for` and
summarized with :meth:`SpanRecorder.summary`.

Exports:

- ``export_jsonl`` — one JSON object per span (grep/jq-friendly).  Setting
  ``DYN_TRACE_JSONL=/path/file.jsonl`` streams every finished span there
  live.  ``DYN_TRACE_MAX_BYTES`` bounds it: when the file would exceed the
  limit it rotates to ``file.jsonl.1`` (replacing any previous rotation)
  and a fresh file starts — at most ~2x the limit on disk, newest spans
  always in the live file.  0/unset = unbounded (previous behavior).
- ``export_chrome_trace`` — Chrome trace-event format ("X" complete events,
  microsecond timestamps) loadable in ``chrome://tracing`` or Perfetto;
  components render as processes, requests as threads.

Buffer size: ``DYN_TRACE_BUFFER`` (spans, default 4096).  Per-process
singleton via :func:`get_recorder`; tests may install a fresh one with
:func:`set_recorder`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from dynamo_tpu_torch.observability.trace import TraceContext
from dynamo_tpu_torch.utils import knobs

_DEFAULT_BUFFER = 4096


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_span_id: str | None
    name: str
    component: str
    start_s: float              # unix epoch seconds
    end_s: float
    status: str = "ok"
    attrs: dict = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return max(0.0, self.end_s - self.start_s)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "name": self.name,
            "component": self.component,
            "start_s": self.start_s,
            "end_s": self.end_s,
            "duration_s": self.duration_s,
            "status": self.status,
            "attrs": self.attrs,
        }


class SpanHandle:
    """An open span; :meth:`end` records it.  ``.ctx`` is the context
    downstream work should parent to."""

    __slots__ = ("_recorder", "ctx", "name", "component", "start_s", "attrs", "_done")

    def __init__(self, recorder: "SpanRecorder", ctx: TraceContext, name: str,
                 component: str, attrs: dict | None):
        self._recorder = recorder
        self.ctx = ctx
        self.name = name
        self.component = component
        self.start_s = time.time()
        self.attrs = dict(attrs or {})
        self._done = False

    def end(self, status: str = "ok", **attrs) -> None:
        if self._done:  # idempotent: error paths may double-close
            return
        self._done = True
        self.attrs.update(attrs)
        self._recorder._record(
            Span(
                trace_id=self.ctx.trace_id,
                span_id=self.ctx.span_id,
                parent_span_id=self.ctx.parent_span_id,
                name=self.name,
                component=self.component,
                start_s=self.start_s,
                end_s=time.time(),
                status=status,
                attrs=self.attrs,
            )
        )

class SpanRecorder:
    def __init__(
        self,
        max_spans: int | None = None,
        jsonl_path: str | None = None,
        max_jsonl_bytes: int | None = None,
    ):
        if max_spans is None:
            max_spans = knobs.get("DYN_TRACE_BUFFER")
        self._spans: deque[Span] = deque(maxlen=max(max_spans, 1))
        self._lock = threading.Lock()
        self._jsonl_path = jsonl_path or knobs.get("DYN_TRACE_JSONL") or None
        if max_jsonl_bytes is None:
            max_jsonl_bytes = knobs.get("DYN_TRACE_MAX_BYTES")
        self._max_jsonl_bytes = max(max_jsonl_bytes, 0)
        self._file_lock = threading.Lock()
        self._jsonl_bytes = 0
        if self._jsonl_path and self._max_jsonl_bytes:
            try:
                self._jsonl_bytes = os.path.getsize(self._jsonl_path)
            except OSError:
                self._jsonl_bytes = 0

    # -- recording ---------------------------------------------------------
    def start(
        self,
        name: str,
        parent: TraceContext | None,
        *,
        component: str,
        root_trace_id: str | None = None,
        attrs: dict | None = None,
    ) -> SpanHandle | None:
        """Open a child span under ``parent`` (or a root span when ``parent``
        is None and ``root_trace_id`` is given).  Returns None — record
        nothing — when there is no trace to attach to: untraced requests
        stay zero-cost."""
        if parent is not None:
            ctx = parent.child()
        elif root_trace_id is not None:
            ctx = TraceContext.new_root(root_trace_id)
        else:
            return None
        return SpanHandle(self, ctx, name, component, attrs)

    def record(
        self,
        name: str,
        parent: TraceContext | None,
        start_s: float,
        end_s: float,
        *,
        component: str,
        status: str = "ok",
        attrs: dict | None = None,
    ) -> TraceContext | None:
        """Record a completed span with explicit timestamps (device-thread
        paths measure first, record after).  Returns the new span's context
        (for nesting) or None when untraced."""
        if parent is None:
            return None
        ctx = parent.child()
        self._record(
            Span(
                trace_id=ctx.trace_id,
                span_id=ctx.span_id,
                parent_span_id=ctx.parent_span_id,
                name=name,
                component=component,
                start_s=start_s,
                end_s=end_s,
                status=status,
                attrs=dict(attrs or {}),
            )
        )
        return ctx

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
        if self._jsonl_path:
            line = json.dumps(span.to_dict(), default=str) + "\n"
            with self._file_lock:
                try:
                    if (
                        self._max_jsonl_bytes
                        and self._jsonl_bytes
                        and self._jsonl_bytes + len(line) > self._max_jsonl_bytes
                    ):
                        # size-based rotation: keep one previous generation,
                        # newest spans always land in the live file
                        os.replace(self._jsonl_path, self._jsonl_path + ".1")
                        self._jsonl_bytes = 0
                    with open(self._jsonl_path, "a") as f:
                        f.write(line)
                    self._jsonl_bytes += len(line)
                except OSError:
                    pass  # live export is best-effort; the buffer still has it

    # -- querying ----------------------------------------------------------
    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def spans_for(self, trace_id: str) -> list[Span]:
        return sorted(
            (s for s in self.snapshot() if s.trace_id == trace_id),
            key=lambda s: s.start_s,
        )

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def summary(self, trace_id: str) -> dict:
        """Per-request lifecycle summary assembled from the span tree:
        queue wait, prefill time, decode time, TTFT, per-token ITL, and KV
        transfer bytes/latency (zeros for phases the request never hit)."""
        spans = self.spans_for(trace_id)

        def total(name: str) -> float:
            return sum(s.duration_s for s in spans if s.name == name)

        root = next((s for s in spans if s.parent_span_id is None), None)
        ttft = None
        for s in spans:
            if ttft is None and s.attrs.get("ttft_s") is not None:
                ttft = float(s.attrs["ttft_s"])
        decode_spans = [s for s in spans if s.name == "engine.decode"]
        decode_s = sum(s.duration_s for s in decode_spans)
        # ITL is averaged PER decode span (an n>1 fanout yields one decode
        # span per choice; summing time across spans but taking one span's
        # token count would inflate the figure n-fold)
        itl_gaps = sum(
            max(int(s.attrs.get("tokens_out", 0) or 0) - 1, 0) for s in decode_spans
        )
        tokens_out = int(root.attrs.get("tokens_out", 0) or 0) if root else 0
        if not tokens_out:
            tokens_out = sum(
                int(s.attrs.get("tokens_out", 0) or 0) for s in decode_spans
            )
        kv_spans = [s for s in spans if s.name == "kv.transfer"]
        summary = {
            "trace_id": trace_id,
            "spans": len(spans),
            "total_s": root.duration_s if root else sum(s.duration_s for s in spans),
            "status": root.status if root else ("ok" if spans else "missing"),
            "queue_wait_s": total("engine.queue"),
            "prefill_s": total("engine.prefill"),
            "decode_s": decode_s,
            "ttft_s": ttft,
            "tokens_out": tokens_out,
            "itl_avg_s": (decode_s / itl_gaps) if itl_gaps else None,
            "kv_transfer_bytes": sum(
                int(s.attrs.get("bytes", 0) or 0) for s in kv_spans
            ),
            "kv_transfer_s": sum(s.duration_s for s in kv_spans),
        }
        return summary

    # -- exporters ---------------------------------------------------------
    def to_jsonl(self, trace_id: str | None = None) -> str:
        spans = self.spans_for(trace_id) if trace_id else self.snapshot()
        return "".join(json.dumps(s.to_dict(), default=str) + "\n" for s in spans)

    def export_jsonl(self, path: str, trace_id: str | None = None) -> int:
        spans = self.spans_for(trace_id) if trace_id else self.snapshot()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.to_dict(), default=str) + "\n")
        return len(spans)

    def to_chrome_trace(self, trace_id: str | None = None) -> dict:
        """Chrome trace-event JSON: one "X" (complete) event per span, with
        components mapped to pids (named via metadata events) so Perfetto
        lays the request out frontend/router/worker/engine lanes."""
        spans = self.spans_for(trace_id) if trace_id else self.snapshot()
        components = sorted({s.component for s in spans})
        pid_of = {c: i + 1 for i, c in enumerate(components)}
        tids: dict[str, int] = {}
        events: list[dict] = [
            {
                "ph": "M", "pid": pid, "name": "process_name",
                "args": {"name": comp},
            }
            for comp, pid in pid_of.items()
        ]
        for s in spans:
            tid = tids.setdefault(s.trace_id, len(tids) + 1)
            events.append(
                {
                    "name": s.name,
                    "cat": s.component,
                    "ph": "X",
                    "ts": s.start_s * 1e6,       # microseconds
                    "dur": s.duration_s * 1e6,
                    "pid": pid_of[s.component],
                    "tid": tid,
                    "args": {
                        "trace_id": s.trace_id,
                        "span_id": s.span_id,
                        "parent_span_id": s.parent_span_id,
                        "status": s.status,
                        **{k: str(v) for k, v in s.attrs.items()},
                    },
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str, trace_id: str | None = None) -> int:
        doc = self.to_chrome_trace(trace_id)
        with open(path, "w") as f:
            json.dump(doc, f)
        return sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")


_global_lock = threading.Lock()
_global_recorder: SpanRecorder | None = None


def get_recorder() -> SpanRecorder:
    global _global_recorder
    with _global_lock:
        if _global_recorder is None:
            _global_recorder = SpanRecorder()
        return _global_recorder


def set_recorder(recorder: SpanRecorder) -> SpanRecorder:
    global _global_recorder
    with _global_lock:
        _global_recorder = recorder
        return recorder
