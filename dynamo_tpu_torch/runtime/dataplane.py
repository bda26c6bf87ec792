"""Data plane: direct TCP response streams.

Requests ride the control-plane bus (push), responses ride a direct TCP
byte-stream from worker back to caller — the reference's split transport
design (reference: lib/runtime/src/pipeline/network/egress/addressed_router.rs:59-65,
tcp/server.rs).

- ``ResponseStreamServer`` (caller side): ``register(stream_id)`` a pending
  stream before publishing the request; the worker connects back, sends a
  prologue identifying the stream, then pumps data frames.  The caller can
  send ``stop``/``kill`` control frames upstream on the same connection.
- ``ResponseStreamSender`` (worker side): connect-back handle that sends the
  prologue, streams responses, and surfaces incoming control frames on the
  request's EngineContext.

Frame headers: ``{"t": "prologue"|"data"|"complete"|"error"|"stop"|"kill"}``.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

import msgpack

from dynamo_tpu_torch import native
from dynamo_tpu_torch.robustness.faults import DP_CONNECT, DP_SEND, FAULTS
from dynamo_tpu_torch.runtime.codec import (
    TwoPartMessage,
    attach_trace,
    encode_frame,
    extract_trace,
    read_two_part,
)
from dynamo_tpu_torch.runtime.engine import EngineContext
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("runtime.dataplane")

STREAM_TIMEOUT = 600.0  # max seconds a registered stream waits for connect-back
READ_CHUNK = 1 << 16


async def iter_frames(reader: asyncio.StreamReader):
    """Yield two-part frames until EOF.

    Uses the native incremental decoder when available — one socket read per
    chunk with frame splitting in C++, instead of three awaits per frame —
    which matters on the per-token response hot path.  Falls back to the
    pure-Python codec.  Each stream and frame is counted by route in
    ``dynamo_tpu_torch.native.counters``."""
    decoder = None
    try:
        # imported here: native/dataplane.py imports the runtime's codec
        from dynamo_tpu_torch.native.dataplane import NativeFrameDecoder

        decoder = NativeFrameDecoder()
    except RuntimeError:
        pass
    counters = native.counters
    if decoder is None:
        counters["python_streams"] += 1
        while True:
            frame = await read_two_part(reader)
            if frame is None:
                return
            counters["python_frames"] += 1
            yield frame
    else:
        counters["native_streams"] += 1
        while True:
            try:
                chunk = await reader.read(READ_CHUNK)
            except ConnectionResetError:
                return  # same "connection lost" semantics as read_two_part
            if not chunk:
                return
            decoder.feed(chunk)
            msgs = decoder.drain()  # one C call per chunk
            counters["native_frames"] += len(msgs)
            for msg in msgs:
                yield msg


@dataclass
class ConnectionInfo:
    """Where the worker should connect back to (carried in the request
    control message, like the reference's ``connection_info``)."""

    host: str
    port: int
    stream_id: str

    def to_dict(self) -> dict:
        return {"host": self.host, "port": self.port, "stream_id": self.stream_id}

    @classmethod
    def from_dict(cls, d: dict) -> "ConnectionInfo":
        return cls(host=d["host"], port=d["port"], stream_id=d["stream_id"])


class PendingStream:
    """A registered response stream awaiting connect-back, then pumping items."""

    def __init__(self, stream_id: str, ctx: EngineContext):
        self.stream_id = stream_id
        self.ctx = ctx
        self.queue: asyncio.Queue[dict | None] = asyncio.Queue()
        self.connected = asyncio.Event()
        self.error: str | None = None
        # the worker's trace context from the connect-back prologue (None
        # until connected / when the worker is untraced)
        self.trace = None
        self._writer: asyncio.StreamWriter | None = None

    async def send_control(self, kind: str) -> None:
        if self._writer is None or self._writer.is_closing():
            return
        try:
            self._writer.write(encode_frame(TwoPartMessage(header={"t": kind})))
            await self._writer.drain()
        except (ConnectionError, RuntimeError):
            pass

    def __aiter__(self):
        return self

    async def __anext__(self) -> dict:
        item = await self.queue.get()
        if item is None:
            if self.error:
                raise RuntimeError(f"remote engine error: {self.error}")
            raise StopAsyncIteration
        return item


class ResponseStreamServer:
    """Caller-side TCP server that response streams rendezvous with."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._pending: dict[str, PendingStream] = {}
        self._server: asyncio.Server | None = None

    async def start(self) -> None:
        if self._server is not None:
            return
        # warm the native codec off-loop: first use otherwise triggers a
        # synchronous g++ compile inside a connection handler
        await native.warm_native("dataplane")
        # backlog: asyncio's default (100) overflows under request bursts —
        # a few hundred concurrent generates all dial connect-backs at
        # once, the kernel RSTs the overflow, and those requests die
        # (found by the runtime soak test)
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, backlog=1024
        )
        self.port = self._server.sockets[0].getsockname()[1]
        logger.debug("response stream server on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def register(self, stream_id: str, ctx: EngineContext) -> PendingStream:
        stream = PendingStream(stream_id, ctx)
        self._pending[stream_id] = stream
        return stream

    def unregister(self, stream_id: str) -> None:
        self._pending.pop(stream_id, None)

    def connection_info(self, stream_id: str) -> ConnectionInfo:
        return ConnectionInfo(host=self.host, port=self.port, stream_id=stream_id)

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        stream: PendingStream | None = None
        control_task: asyncio.Task | None = None
        try:
            prologue = await read_two_part(reader)
            if prologue is None or prologue.header.get("t") != "prologue":
                writer.close()
                return
            stream_id = prologue.header["stream_id"]
            stream = self._pending.get(stream_id)
            if stream is None:
                writer.write(encode_frame(TwoPartMessage(header={"t": "kill"})))
                await writer.drain()
                writer.close()
                return
            stream.trace = extract_trace(prologue.header)
            stream._writer = writer
            stream.connected.set()

            # forward caller-side cancellation upstream
            async def watch_cancel() -> None:
                await stream.ctx.stopped()
                await stream.send_control("kill" if stream.ctx.is_killed else "stop")

            control_task = spawn_logged(watch_cancel())

            finished = False
            async for frame in iter_frames(reader):
                kind = frame.header.get("t")
                if kind == "data":
                    stream.queue.put_nowait(msgpack.unpackb(frame.payload, raw=False))
                elif kind == "complete":
                    finished = True
                    break
                elif kind == "error":
                    stream.error = frame.header.get("message", "unknown remote error")
                    finished = True
                    break
            if not finished:
                stream.error = stream.error or "connection lost"
        finally:
            if control_task is not None:
                control_task.cancel()
            if stream is not None:
                self._pending.pop(stream.stream_id, None)
                stream.queue.put_nowait(None)
            writer.close()


class ResponseStreamSender:
    """Worker-side connect-back sender."""

    def __init__(self, info: ConnectionInfo, ctx: EngineContext):
        self.info = info
        self.ctx = ctx
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._control_task: asyncio.Task | None = None

    async def connect(self, attempts: int = 5) -> None:
        # chaos seam: a worker that dies before dialing back (the frontend
        # sees a rendezvous timeout and fails over)
        FAULTS.check(DP_CONNECT, stream=self.info.stream_id)
        # bounded retry: under a connect burst the frontend's accept queue
        # can momentarily overflow and the kernel RSTs the dial; without a
        # retry that request is silently lost and the frontend waits out
        # its rendezvous timeout (found by the runtime soak test)
        delay = 0.05
        for attempt in range(attempts):
            try:
                self._reader, self._writer = await asyncio.wait_for(
                    asyncio.open_connection(self.info.host, self.info.port),
                    timeout=5.0,
                )
                break
            except (OSError, asyncio.TimeoutError):
                if attempt + 1 == attempts:
                    raise
                await asyncio.sleep(delay)
                delay = min(delay * 2, 1.0)
        # the prologue carries the worker-side trace context so the caller
        # can correlate this byte stream with the request's span tree
        header = attach_trace(
            {"t": "prologue", "stream_id": self.info.stream_id},
            getattr(self.ctx, "trace", None),
        )
        self._writer.write(encode_frame(TwoPartMessage(header=header)))
        await self._writer.drain()
        self._control_task = spawn_logged(self._control_loop())

    async def _control_loop(self) -> None:
        """Surface caller stop/kill on the worker-side context."""
        assert self._reader is not None
        await native.warm_native("dataplane")  # a worker's first build runs off the loop
        # read through iter_frames, so a worker's control frames take the
        # native decoder as the caller's response frames do (the reference
        # reads them with read_two_part: the same frames, the same EOF)
        async for frame in iter_frames(self._reader):
            kind = frame.header.get("t")
            if kind == "stop":
                self.ctx.stop_generating()
            elif kind == "kill":
                self.ctx.kill()
                return
        # caller went away: treat as kill so the engine stops work
        self.ctx.kill()

    async def send(self, item: dict) -> None:
        # chaos seam: a mid-stream write failure (worker killed while
        # streaming; pre-first-token it is retried, after it truncates)
        FAULTS.check(DP_SEND, stream=self.info.stream_id)
        assert self._writer is not None
        self._writer.write(
            encode_frame(
                TwoPartMessage(header={"t": "data"}, payload=msgpack.packb(item, use_bin_type=True))
            )
        )
        await self._writer.drain()

    async def complete(self) -> None:
        await self._finish({"t": "complete"})

    async def error(self, message: str) -> None:
        await self._finish({"t": "error", "message": message})

    async def _finish(self, header: dict) -> None:
        if self._control_task is not None:
            self._control_task.cancel()
        if self._writer is None or self._writer.is_closing():
            return
        try:
            self._writer.write(encode_frame(TwoPartMessage(header=header)))
            await self._writer.drain()
        except ConnectionError:
            pass
        finally:
            self._writer.close()
