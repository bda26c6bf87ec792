"""ctypes binding for the native data-plane codec (csrc/dataplane.cpp; a copy
of dynamo_tpu/native/dataplane.py).

``NativeFrameDecoder`` incrementally splits raw socket chunks into two-part
frames (the per-token response-stream hot path).  The pure-Python codec
(dynamo_tpu_torch/runtime/codec.py) remains the behavioral spec and fallback;
sender-side frame coalescing is already handled by the asyncio transport
write buffer, so only the read side is native.
"""

from __future__ import annotations

import ctypes

import msgpack

from dynamo_tpu_torch.native import load_native
from dynamo_tpu_torch.runtime.codec import TwoPartMessage


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dp_decoder_new.restype = ctypes.c_void_p
    lib.dp_decoder_free.argtypes = [ctypes.c_void_p]
    lib.dp_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.dp_feed.restype = ctypes.c_int
    lib.dp_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dp_next.restype = ctypes.c_int
    lib.dp_pending.argtypes = [ctypes.c_void_p]
    lib.dp_pending.restype = ctypes.c_int64
    lib.dp_drain.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dp_drain.restype = ctypes.c_int32
    return lib


def native_available() -> bool:
    return load_native("dataplane") is not None


class NativeFrameDecoder:
    """Incremental two-part frame decoder over raw byte chunks."""

    def __init__(self) -> None:
        lib = load_native("dataplane")
        if lib is None:
            raise RuntimeError("native dataplane codec unavailable")
        self._lib = _bind(lib)
        self._handle = ctypes.c_void_p(self._lib.dp_decoder_new())

    def __del__(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.dp_decoder_free(handle)
            self._handle = None

    def feed(self, chunk: bytes) -> None:
        if self._lib.dp_feed(self._handle, chunk, len(chunk)) != 0:
            raise ValueError("corrupt two-part stream (oversized frame)")

    def next(self) -> TwoPartMessage | None:
        """Complete frame, or None if more bytes are needed."""
        hdr = ctypes.c_void_p()
        hlen = ctypes.c_int64()
        pay = ctypes.c_void_p()
        plen = ctypes.c_int64()
        rc = self._lib.dp_next(
            self._handle, ctypes.byref(hdr), ctypes.byref(hlen),
            ctypes.byref(pay), ctypes.byref(plen),
        )
        if rc == 0:
            return None
        if rc < 0:
            raise ValueError("corrupt two-part stream (oversized frame)")
        header = msgpack.unpackb(ctypes.string_at(hdr, hlen.value), raw=False)
        payload = ctypes.string_at(pay, plen.value) if plen.value else b""
        return TwoPartMessage(header=header, payload=payload)

    _MAX_DRAIN = 512

    def drain(self) -> list[TwoPartMessage]:
        """All complete frames, via one C call + one region copy per batch."""
        out: list[TwoPartMessage] = []
        spans = (ctypes.c_int64 * (4 * self._MAX_DRAIN))()
        while True:
            region = ctypes.c_void_p()
            region_len = ctypes.c_int64()
            n = self._lib.dp_drain(
                self._handle, spans, self._MAX_DRAIN,
                ctypes.byref(region), ctypes.byref(region_len),
            )
            if n < 0:
                raise ValueError("corrupt two-part stream (oversized frame)")
            if n == 0:
                return out
            view = memoryview(ctypes.string_at(region, region_len.value))
            for i in range(n):
                ho, hl, po, pl = spans[i * 4 : i * 4 + 4]
                header = msgpack.unpackb(view[ho : ho + hl], raw=False)
                payload = bytes(view[po : po + pl]) if pl else b""
                out.append(TwoPartMessage(header=header, payload=payload))
            if n < self._MAX_DRAIN:
                return out

    @property
    def pending(self) -> int:
        return int(self._lib.dp_pending(self._handle))
