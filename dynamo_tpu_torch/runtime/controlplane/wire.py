"""Wire protocol for the dynctl control-plane RPC: 4-byte length-prefixed
msgpack frames over TCP.

Frame shapes:
- request:  ``{"i": id, "m": method, "a": [args...]}``
- response: ``{"i": id, "ok": bool, "r": result}`` / ``{"i": id, "ok": False, "e": msg}``
- push:     ``{"s": stream_id, "t": kind, "d": data}`` (watch/subscription events)
"""

from __future__ import annotations

import asyncio
import struct

import msgpack

MAX_FRAME = 512 * 1024 * 1024  # 512 MiB (object store chunks stay well below)

_LEN = struct.Struct("!I")


def pack_frame(obj: dict) -> bytes:
    payload = msgpack.packb(obj, use_bin_type=True)
    return _LEN.pack(len(payload)) + payload


async def read_frame(reader: asyncio.StreamReader) -> dict | None:
    try:
        header = await reader.readexactly(_LEN.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    try:
        payload = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return msgpack.unpackb(payload, raw=False)


# RPC frames carry a TraceContext under the shared reserved key: request-
# scoped RPCs (the push router's envelope publish, via
# ``RpcConnection.call(..., trace=...)``) stamp it so the dynctl server can
# attribute failures to the request trace (``frame_trace`` server-side).
# Canonical stamp/decode pair lives in observability.trace.
from dynamo_tpu_torch.observability.trace import (  # noqa: E402 (re-export)
    read_trace as frame_trace,
    stamp_trace as with_trace,
)


def kv_entry_to_wire(entry) -> dict:
    return {"k": entry.key, "v": entry.value, "rev": entry.revision, "lease": entry.lease_id}


def kv_entry_from_wire(d: dict):
    from dynamo_tpu_torch.runtime.controlplane.interface import KVEntry

    return KVEntry(key=d["k"], value=d["v"], revision=d["rev"], lease_id=d["lease"])
