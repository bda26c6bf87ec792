"""Two-part frame codec.

Length-prefixed (header, payload) frames used on data-plane TCP streams
(reference: lib/runtime/src/pipeline/network/codec/two_part.rs).  The header
is a small msgpack map (control/typing), the payload is opaque bytes.

Layout: ``u32 header_len | u32 payload_len | header | payload`` (big-endian).
"""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass

import msgpack

_PREFIX = struct.Struct("!II")
MAX_HEADER = 1 << 20          # 1 MiB
MAX_PAYLOAD = 1 << 31         # 2 GiB

# Frame headers carry a TraceContext wire dict under the shared reserved
# key (observability.trace.TRACE_WIRE_KEY) so data-plane streams stay
# correlatable with the request that opened them.  One canonical
# stamp/decode pair serves every transport.
from dynamo_tpu_torch.observability.trace import (  # noqa: E402 (re-export)
    read_trace as extract_trace,
    stamp_trace as attach_trace,
)


@dataclass
class TwoPartMessage:
    header: dict
    payload: bytes = b""


def encode_frame(msg: TwoPartMessage) -> bytes:
    header = msgpack.packb(msg.header, use_bin_type=True)
    return _PREFIX.pack(len(header), len(msg.payload)) + header + msg.payload


def read_two_part_sync(sock) -> TwoPartMessage | None:
    """Blocking-socket twin of ``read_two_part`` (used by sync Storage
    clients that run under ``asyncio.to_thread``)."""

    def recv_exact(n: int) -> bytes | None:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                return None
            buf.extend(chunk)
        return bytes(buf)

    prefix = recv_exact(_PREFIX.size)
    if prefix is None:
        return None
    header_len, payload_len = _PREFIX.unpack(prefix)
    if header_len > MAX_HEADER or payload_len > MAX_PAYLOAD:
        raise ValueError(f"oversized frame: header={header_len} payload={payload_len}")
    header = recv_exact(header_len)
    if header is None:
        return None
    payload = recv_exact(payload_len) if payload_len else b""
    if payload is None:
        return None
    return TwoPartMessage(header=msgpack.unpackb(header, raw=False), payload=payload)


async def read_two_part(reader: asyncio.StreamReader) -> TwoPartMessage | None:
    try:
        prefix = await reader.readexactly(_PREFIX.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    header_len, payload_len = _PREFIX.unpack(prefix)
    if header_len > MAX_HEADER or payload_len > MAX_PAYLOAD:
        raise ValueError(f"oversized frame: header={header_len} payload={payload_len}")
    try:
        header = await reader.readexactly(header_len)
        payload = await reader.readexactly(payload_len) if payload_len else b""
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return TwoPartMessage(header=msgpack.unpackb(header, raw=False), payload=payload)
