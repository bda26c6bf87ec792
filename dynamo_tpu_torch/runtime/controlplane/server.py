"""dynctl — the standalone control-plane server.

One lightweight TCP process replacing the reference's external etcd + NATS
deployment (reference: deploy/metrics/docker-compose.yml spins up both).  It
hosts the same state machine as ``MemoryControlPlane`` behind a msgpack-RPC
protocol, so memory mode and distributed mode behave identically.

Run: ``python -m dynamo_tpu_torch.cli.dynctl serve --port 2379``
"""

from __future__ import annotations

import asyncio
import itertools

from dynamo_tpu_torch.runtime.controlplane.interface import WATCH_SYNC, Subscription, Watch
from dynamo_tpu_torch.runtime.controlplane.memory import MemoryControlPlane
from dynamo_tpu_torch.runtime.controlplane.wire import (
    frame_trace,
    kv_entry_to_wire,
    pack_frame,
    read_frame,
)
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("runtime.controlplane.server")


class ControlPlaneServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 2379):
        self.host = host
        self.port = port
        self.state = MemoryControlPlane()
        self._server: asyncio.Server | None = None
        self._stream_ids = itertools.count(1)
        self._client_writers: set[asyncio.StreamWriter] = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        addr = self._server.sockets[0].getsockname()
        self.port = addr[1]
        logger.info("dynctl listening on %s:%d", self.host, self.port)

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        # drop established client connections too: stop() must look like a
        # dead server to clients (their reconnect logic depends on seeing
        # EOF), not like a server that merely stopped accepting
        for writer in list(self._client_writers):
            writer.close()
        self._client_writers.clear()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self._client_writers.add(writer)
        # per-connection resources torn down on disconnect
        watches: dict[int, Watch] = {}
        subs: dict[int, Subscription] = {}
        pumps: list[asyncio.Task] = []
        write_lock = asyncio.Lock()

        async def send(obj: dict) -> None:
            async with write_lock:
                writer.write(pack_frame(obj))
                await writer.drain()

        async def pump_watch(stream_id: int, watch: Watch) -> None:
            # Reads the raw queue (not __anext__, which swallows the sync
            # sentinel) so the end-of-snapshot boundary is forwarded on the
            # wire and the remote watch's ready() has true snapshot semantics.
            while True:
                item = await watch._queue.get()
                if item is None or watch._cancelled:
                    break
                if item is WATCH_SYNC:
                    await send({"s": stream_id, "t": "sync", "d": None})
                    continue
                await send(
                    {"s": stream_id, "t": "kv", "d": {"type": item.type.value, "entry": kv_entry_to_wire(item.entry)}}
                )
            await send({"s": stream_id, "t": "close", "d": None})

        async def pump_sub(stream_id: int, sub: Subscription) -> None:
            async for msg in sub:
                await send(
                    {"s": stream_id, "t": "bus", "d": {"subject": msg.subject, "payload": msg.payload, "reply_to": msg.reply_to}}
                )
            await send({"s": stream_id, "t": "close", "d": None})

        async def dispatch(method: str, args: list):
            kv, bus = self.state.kv, self.state.bus
            if method == "kv.put":
                return await kv.put(args[0], args[1], args[2])
            if method == "kv.create":
                return await kv.create(args[0], args[1], args[2])
            if method == "kv.get":
                entry = await kv.get(args[0])
                return kv_entry_to_wire(entry) if entry else None
            if method == "kv.get_prefix":
                return [kv_entry_to_wire(e) for e in await kv.get_prefix(args[0])]
            if method == "kv.delete":
                return await kv.delete(args[0])
            if method == "kv.delete_prefix":
                return await kv.delete_prefix(args[0])
            if method == "kv.grant_lease":
                lease = await kv.grant_lease(args[0])
                return lease.id
            if method == "kv.keep_alive":
                lease_entry = kv._leases.get(args[0])
                if lease_entry is None:
                    return False
                await kv.keep_alive(lease_entry[0])
                return True
            if method == "kv.revoke_lease":
                lease_entry = kv._leases.get(args[0])
                if lease_entry is not None:
                    await kv.revoke_lease(lease_entry[0])
                return True
            if method == "kv.watch_prefix":
                stream_id = next(self._stream_ids)
                watch = kv.watch_prefix(args[0])
                watches[stream_id] = watch
                pumps.append(spawn_logged(pump_watch(stream_id, watch)))
                return stream_id
            if method == "kv.cancel_watch":
                watch = watches.pop(args[0], None)
                if watch:
                    watch.cancel()
                return True
            if method == "bus.publish":
                # subscriber count, so remote publishers can detect a dark
                # subject (worker mid-resubscribe) and re-publish
                return await bus.publish(args[0], args[1], args[2])
            if method == "bus.subscribe":
                stream_id = next(self._stream_ids)
                sub = await bus.subscribe(args[0], args[1])
                subs[stream_id] = sub
                pumps.append(spawn_logged(pump_sub(stream_id, sub)))
                return stream_id
            if method == "bus.unsubscribe":
                sub = subs.pop(args[0], None)
                if sub:
                    await sub.unsubscribe()
                return True
            if method == "bus.request":
                return await bus.request(args[0], args[1], args[2])
            if method == "bus.queue_publish":
                await bus.queue_publish(args[0], args[1])
                return True
            if method == "bus.queue_pop":
                return await bus.queue_pop(args[0], args[1])
            if method == "bus.queue_pop_meta":
                item = await bus.queue_pop_meta(args[0], args[1])
                # tuple → list for the codec; age is the SERVER's own
                # enqueue→pop measurement (skew-free for remote consumers)
                return None if item is None else [item[0], item[1]]
            if method == "bus.queue_len":
                return await bus.queue_len(args[0])
            if method == "bus.object_put":
                await bus.object_put(args[0], args[1], args[2])
                return True
            if method == "bus.object_get":
                return await bus.object_get(args[0], args[1])
            if method == "bus.object_delete":
                return await bus.object_delete(args[0], args[1])
            if method == "ping":
                return "pong"
            raise ValueError(f"unknown method {method}")

        async def handle_request(frame: dict) -> None:
            try:
                result = await dispatch(frame["m"], frame.get("a", []))
                await send({"i": frame["i"], "ok": True, "r": result})
            except Exception as exc:  # noqa: BLE001
                # request-scoped RPCs carry a trace frame stamp: name the
                # request so a failed publish is attributable end-to-end
                trace = frame_trace(frame)
                logger.warning(
                    "rpc %s failed: %r%s", frame.get("m"), exc,
                    f" (trace {trace.trace_id})" if trace is not None else "",
                )
                await send({"i": frame["i"], "ok": False, "e": repr(exc)})

        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                # blocking calls (queue_pop, bus.request) must not stall the
                # connection; every request runs as its own task.
                spawn_logged(handle_request(frame))
        finally:
            self._client_writers.discard(writer)
            for watch in watches.values():
                watch.cancel()
            for sub in subs.values():
                await sub.unsubscribe()
            for pump in pumps:
                pump.cancel()
            writer.close()


async def run_server(host: str = "127.0.0.1", port: int = 2379) -> None:
    server = ControlPlaneServer(host, port)
    await server.start()
    await server.serve_forever()
