"""Trace context: the identity a request carries across layers.

W3C-trace-context-shaped (a 32-hex trace id, 16-hex span ids) but carried on
this stack's own wire envelopes rather than HTTP headers between internal
hops: the frontend mints the context (honoring an incoming ``x-request-id``
as the trace id), and every downstream layer derives child contexts from it.

The wire form is a tiny msgpack/json-safe dict (``{"t","s","p"}``) so it can
ride the control-plane request envelope (runtime/client.py), the data-plane
frame headers (runtime/codec.py), and control-plane RPC frames
(runtime/controlplane/wire.py) without schema machinery.
"""

from __future__ import annotations

import os
import re
import uuid
from dataclasses import dataclass


def new_trace_id() -> str:
    return uuid.uuid4().hex  # 32 hex chars


def new_span_id() -> str:
    return os.urandom(8).hex()  # 16 hex chars


# request ids become trace ids; keep them safe for logs/filenames/metrics
_SAFE_ID = re.compile(r"[^A-Za-z0-9._\-]")
_MAX_ID_LEN = 128


def sanitize_request_id(raw: str | None) -> str | None:
    """Clamp a client-supplied ``x-request-id`` to something safe to echo,
    log, and use as a trace id (None when unusable)."""
    if not raw:
        return None
    cleaned = _SAFE_ID.sub("_", raw.strip())[:_MAX_ID_LEN]
    return cleaned or None


# the one reserved key every transport uses to carry a TraceContext wire
# dict (control-plane RPC frames, the request envelope's control map,
# data-plane frame headers, the disagg prefill-queue item)
TRACE_WIRE_KEY = "tr"


def stamp_trace(mapping: dict, trace: "TraceContext | None") -> dict:
    """Stamp a TraceContext onto any wire mapping (no-op for None)."""
    if trace is not None:
        mapping[TRACE_WIRE_KEY] = trace.to_wire()
    return mapping


def read_trace(mapping: object) -> "TraceContext | None":
    """Decode a wire mapping's trace context (None when absent/malformed)."""
    if not isinstance(mapping, dict):
        return None
    return TraceContext.from_wire(mapping.get(TRACE_WIRE_KEY))


@dataclass(frozen=True)
class TraceContext:
    """The context of the *current enclosing span*: children derive from it
    via :meth:`child`, serialization via :meth:`to_wire`."""

    trace_id: str
    span_id: str
    parent_span_id: str | None = None

    @classmethod
    def new_root(cls, trace_id: str | None = None) -> "TraceContext":
        return cls(trace_id=trace_id or new_trace_id(), span_id=new_span_id())

    def child(self) -> "TraceContext":
        return TraceContext(
            trace_id=self.trace_id, span_id=new_span_id(), parent_span_id=self.span_id
        )

    def to_wire(self) -> dict:
        d = {"t": self.trace_id, "s": self.span_id}
        if self.parent_span_id:
            d["p"] = self.parent_span_id
        return d

    @classmethod
    def from_wire(cls, d: object) -> "TraceContext | None":
        """Lenient decode: malformed/absent contexts degrade to None (a
        broken peer must never fail a request over telemetry)."""
        if not isinstance(d, dict):
            return None
        trace_id, span_id = d.get("t"), d.get("s")
        if not isinstance(trace_id, str) or not isinstance(span_id, str):
            return None
        parent = d.get("p")
        return cls(
            trace_id=trace_id,
            span_id=span_id,
            parent_span_id=parent if isinstance(parent, str) else None,
        )
