"""TCP client for the dynctl control-plane server.

Implements the same ``KeyValueStore`` / ``MessageBus`` interfaces as the
memory backend by msgpack-RPC over one multiplexed connection.  Leases are
kept alive by a background task at ttl/3 cadence (reference: etcd lease
keep-alive, lib/runtime/src/transports/etcd.rs:44-170).

Self-healing (on by default, ``DYN_CP_RECONNECT=0`` restores fail-fast):
a lost connection triggers automatic reconnect with capped exponential
backoff + jitter, and a successful reconnect runs *resync* before any
ordinary call is unblocked —

- leases are re-granted (new id, same TTL) and every key that was attached
  to them is re-put, so registered instances/models survive a control-plane
  restart instead of vanishing until their processes restart;
- watches are re-established with **snapshot resync**: consumers keep their
  original ``Watch`` handle and see the fresh snapshot replayed as PUTs
  plus synthetic DELETEs for keys that vanished while disconnected — a
  consistent view, never a dead stream;
- subscriptions re-subscribe (messages published during the gap are lost,
  matching NATS core semantics).

In-flight RPCs at the moment of loss fail with ``ConnectionError``; calls
issued while disconnected wait (within their timeout) for resync to finish.
"""

from __future__ import annotations

import asyncio
import itertools
import os

from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.robustness.faults import CP_RECV, CP_SEND, FAULTS
from dynamo_tpu_torch.robustness.retry import Backoff
from dynamo_tpu_torch.runtime.controlplane.interface import (
    WATCH_SYNC,
    ControlPlane,
    KVEntry,
    KeyValueStore,
    Lease,
    Message,
    MessageBus,
    Subscription,
    Watch,
    WatchEvent,
    WatchEventType,
)
from dynamo_tpu_torch.runtime.controlplane.wire import (
    kv_entry_from_wire,
    pack_frame,
    read_frame,
    with_trace,
)
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged
from dynamo_tpu_torch.utils import knobs

logger = get_logger("runtime.controlplane.client")


def _reconnect_default() -> bool:
    return knobs.get("DYN_CP_RECONNECT")


class RpcConnection:
    def __init__(self, host: str, port: int, *, reconnect: bool | None = None):
        self.host, self.port = host, port
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._req_ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._streams: dict[int, object] = {}  # stream_id -> Watch | Subscription
        self._unrouted: dict[int, list[dict]] = {}  # pushes racing registration
        self._read_task: asyncio.Task | None = None
        self._write_lock = asyncio.Lock()
        self._closed = False
        self.reconnect_enabled = (
            _reconnect_default() if reconnect is None else reconnect
        )
        # _transport_up: a socket is open (resync-internal calls may flow).
        # _ready: resync finished (ordinary calls may flow).  Split so the
        # re-grant/re-subscribe traffic cannot deadlock behind itself.
        self._transport_up = asyncio.Event()
        self._ready = asyncio.Event()
        self._gen = 0  # bumps on every successful (re)connect
        self._reconnect_task: asyncio.Task | None = None
        # insertion-ordered: the lease hook (registered at plane creation)
        # runs before every stream hook, so re-established watches snapshot
        # the re-put keys
        self._resync_hooks: dict[object, object] = {}
        self.reconnects_total = 0

    # -- resync registry ---------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def gen(self) -> int:
        return self._gen

    def add_resync_hook(self, key: object, hook) -> None:
        self._resync_hooks[key] = hook

    def remove_resync_hook(self, key: object) -> None:
        self._resync_hooks.pop(key, None)

    # -- lifecycle ---------------------------------------------------------
    async def connect(self) -> None:
        await self._open_transport()
        self._ready.set()

    async def _open_transport(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        self._gen += 1
        self._transport_up.set()
        self._read_task = spawn_logged(self._read_loop())

    async def _read_loop(self) -> None:
        reader = self._reader
        assert reader is not None
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                # chaos seam: a triggered cp.recv drops this frame AND the
                # connection (the cleanup below runs), exercising the full
                # reconnect/resync path deterministically
                FAULTS.check(CP_RECV)
                if "i" in frame:  # rpc response
                    fut = self._pending.pop(frame["i"], None)
                    if fut is not None and not fut.done():
                        if frame["ok"]:
                            fut.set_result(frame.get("r"))
                        else:
                            fut.set_exception(RuntimeError(frame.get("e", "rpc error")))
                elif "s" in frame:  # stream push
                    self._route_push(frame)
        except Exception as exc:  # noqa: BLE001 — nobody awaits this task;
            # an unswallowed socket/codec/injected error would surface as
            # "Task exception was never retrieved" at GC instead of here
            logger.warning("control-plane read loop ended: %r", exc)
        finally:
            # cleanup must run on ANY exit (clean EOF, socket errors read_frame
            # doesn't catch, corrupt frames) or pending calls and watches hang
            self._transport_up.clear()
            self._ready.clear()
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("control plane connection lost"))
            self._pending.clear()
            for target in self._streams.values():
                if isinstance(target, Watch):
                    # surface the loss to ready() waiters and iterators
                    # instead of ending the stream silently
                    target._fail(ConnectionError("control plane connection lost"))
                elif isinstance(target, Subscription):
                    target._closed = True
                    target._queue.put_nowait(None)
            self._streams.clear()
            self._unrouted.clear()
            if self._writer is not None:
                self._writer.close()
            if not self._closed:
                if self.reconnect_enabled:
                    self._ensure_reconnect()
                else:
                    self._closed = True  # fail-fast mode: terminal loss

    def _ensure_reconnect(self) -> None:
        if self._reconnect_task is None or self._reconnect_task.done():
            self._reconnect_task = spawn_logged(self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        backoff = Backoff.from_env("DYN_CP_RECONNECT", initial=0.05, max_delay=2.0)
        while not self._closed:
            await asyncio.sleep(backoff.next())
            try:
                await self._open_transport()
            except OSError as exc:
                if backoff.attempts in (1, 2) or backoff.attempts % 20 == 0:
                    logger.warning(
                        "control-plane reconnect to %s:%d failed (attempt %d): %r",
                        self.host, self.port, backoff.attempts, exc,
                    )
                continue
            try:
                await self.call("ping", timeout=5.0, wait_ready=False)
                for hook in list(self._resync_hooks.values()):
                    try:
                        await hook()
                    except (ConnectionError, OSError, asyncio.TimeoutError):
                        raise
                    except Exception:  # noqa: BLE001 — one buggy hook must
                        # not strand the connection in permanent
                        # "reconnecting" nor starve the remaining hooks
                        logger.exception("resync hook failed; continuing degraded")
            except (ConnectionError, OSError, asyncio.TimeoutError) as exc:
                logger.warning("control-plane resync interrupted (retrying): %r", exc)
                if self._writer is not None:
                    self._writer.close()
                await asyncio.sleep(0)  # let the read loop's cleanup run
                continue
            self.reconnects_total += 1
            counters.incr("dyn_cp_reconnects_total")
            self._ready.set()
            logger.info(
                "control plane reconnected to %s:%d after %d attempt(s) "
                "(%d lease/stream resync hooks)",
                self.host, self.port, backoff.attempts, len(self._resync_hooks),
            )
            return

    def register_stream(self, stream_id: int, target: object) -> None:
        """Attach a local stream handle; flush any pushes that raced it."""
        if self._closed or not self._transport_up.is_set():
            # the read loop already died (its cleanup ran before we got
            # here): fail the target now or it would hang forever
            if isinstance(target, Watch):
                target._fail(ConnectionError("control plane connection lost"))
            elif isinstance(target, Subscription):
                target._closed = True
                target._queue.put_nowait(None)
            return
        self._streams[stream_id] = target
        for frame in self._unrouted.pop(stream_id, []):
            self._route_push(frame)

    def _route_push(self, frame: dict) -> None:
        target = self._streams.get(frame["s"])
        if target is None:
            # push arrived before the caller registered the handle (the rpc
            # response and the first events race through the read loop)
            self._unrouted.setdefault(frame["s"], []).append(frame)
            return
        kind, data = frame["t"], frame["d"]
        if kind == "close":
            self._streams.pop(frame["s"], None)
            if isinstance(target, Watch):
                target._close()
            elif isinstance(target, Subscription):
                target._queue.put_nowait(None)
        elif kind == "kv" and isinstance(target, Watch):
            target._emit(
                WatchEvent(WatchEventType(data["type"]), kv_entry_from_wire(data["entry"]))
            )
        elif kind == "sync" and isinstance(target, Watch):
            target._emit_sync()
        elif kind == "bus" and isinstance(target, Subscription):
            target._deliver(
                Message(subject=data["subject"], payload=data["payload"], reply_to=data["reply_to"])
            )

    async def call(
        self, method: str, *args, timeout: float | None = 30.0, trace=None,
        wait_ready: bool = True,
    ):
        """Issue one RPC.  ``wait_ready=False`` is for resync-internal
        traffic: it requires only an open socket and never waits (waiting
        on ``_ready`` from inside resync would deadlock)."""
        FAULTS.check(CP_SEND, method=method)
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + timeout
        gate = self._ready if wait_ready else self._transport_up
        while not gate.is_set():
            if self._closed or not self.reconnect_enabled or not wait_ready:
                raise ConnectionError("control plane connection closed")
            remaining = None if deadline is None else deadline - loop.time()
            if remaining is not None and remaining <= 0:
                raise ConnectionError(
                    f"control plane unavailable after {timeout:.0f}s (reconnecting)"
                )
            try:
                # bounded wait so a close() while we sleep is noticed
                await asyncio.wait_for(
                    gate.wait(), 0.5 if remaining is None else min(remaining, 0.5)
                )
            except asyncio.TimeoutError:
                continue
        if self._closed:
            raise ConnectionError("control plane connection closed")
        req_id = next(self._req_ids)
        fut: asyncio.Future = loop.create_future()
        self._pending[req_id] = fut
        try:
            async with self._write_lock:
                writer = self._writer
                if writer is None or writer.is_closing():
                    raise ConnectionError("control plane connection lost")
                # request-scoped RPCs (e.g. the push router's envelope
                # publish) stamp their TraceContext on the frame so dynctl
                # can attribute failures to the request trace
                writer.write(
                    pack_frame(with_trace({"i": req_id, "m": method, "a": list(args)}, trace))
                )
                await writer.drain()
            if deadline is None:
                return await fut
            return await asyncio.wait_for(fut, max(deadline - loop.time(), 0.01))
        finally:
            self._pending.pop(req_id, None)

    async def close(self) -> None:
        self._closed = True
        if self._reconnect_task is not None:
            self._reconnect_task.cancel()
        if self._read_task is not None:
            self._read_task.cancel()
        if self._writer is not None:
            self._writer.close()


class _ReconnectingWatch:
    """Driver keeping one consumer-facing ``Watch`` alive across
    reconnects.

    It tracks the consumer's live key view (key → last seen value).  After
    a re-establishment, the fresh server snapshot is forwarded as ordinary
    PUTs (consumers upsert idempotently) and, at the snapshot boundary,
    keys that existed before the outage but not in the new snapshot are
    emitted as synthetic DELETEs carrying their last-known value — so a
    consumer that parses deleted entries (instance views, model watchers)
    can identify what vanished."""

    def __init__(self, conn: RpcConnection, prefix: str, outer: Watch):
        self.conn = conn
        self.prefix = prefix
        self.outer = outer
        self._known: dict[str, bytes] = {}
        self._inner: Watch | None = None
        self._inner_changed = asyncio.Event()
        self._stream_id: int | None = None
        self._established_once = False

    def install(self) -> None:
        original_cancel = self.outer.cancel

        def cancel() -> None:
            # release the server-side registration too; otherwise the server
            # keeps serializing and sending every matching event forever
            original_cancel()
            self.conn.remove_resync_hook(self)
            if self._stream_id is not None and not self.conn.closed:
                spawn_logged(self._release())

        self.outer.cancel = cancel  # type: ignore[method-assign]
        self.conn.add_resync_hook(self, self.resync)
        spawn_logged(self._run())

    async def _establish(self, *, wait_ready: bool) -> None:
        stream_id = await self.conn.call(
            "kv.watch_prefix", self.prefix, wait_ready=wait_ready
        )
        inner = Watch()
        self.conn.register_stream(stream_id, inner)
        self._stream_id = stream_id
        self._inner = inner
        self._inner_changed.set()
        if self.outer._cancelled:  # cancelled before registration completed
            await self._release()

    async def resync(self) -> None:
        """Called by the connection's reconnect loop (transport up, resync
        in progress)."""
        if self.outer._cancelled:
            self.conn.remove_resync_hook(self)
            return
        await self._establish(wait_ready=False)

    async def _release(self) -> None:
        stream_id, self._stream_id = self._stream_id, None
        if stream_id is None:
            return
        self.conn._streams.pop(stream_id, None)
        inner = self._inner
        if inner is not None:
            inner._close()  # wake the pump if it is blocked on this stream
        try:
            await self.conn.call("kv.cancel_watch", stream_id, wait_ready=False)
        except (ConnectionError, RuntimeError):
            pass

    async def _run(self) -> None:
        try:
            await self._establish(wait_ready=True)
        except Exception as exc:  # noqa: BLE001 — a dead plane at startup
            # must not leave ready() waiters hanging forever
            logger.warning("watch_prefix(%s) failed to start: %s", self.prefix, exc)
            self.conn.remove_resync_hook(self)
            self.outer._fail(exc)
            return
        await self._pump()

    async def _wait_inner(self) -> Watch | None:
        while self._inner is None:
            if self.outer._cancelled:
                return None
            if self.conn.closed:
                self.outer._fail(ConnectionError("control plane connection closed"))
                return None
            try:
                await asyncio.wait_for(self._inner_changed.wait(), 0.5)
            except asyncio.TimeoutError:
                continue
        return self._inner

    async def _pump(self) -> None:
        while True:
            inner = await self._wait_inner()
            if inner is None:
                return
            replay = self._established_once
            self._established_once = True
            snapshot: set[str] = set()
            in_snapshot = True
            while True:
                item = await inner._queue.get()
                if item is None or self.outer._cancelled:
                    break
                if item is WATCH_SYNC:
                    if in_snapshot:
                        in_snapshot = False
                        if replay:
                            # synthetic resync: anything the consumer still
                            # believes exists but the new snapshot lacks was
                            # deleted (or lease-reaped) during the outage
                            for key in [k for k in self._known if k not in snapshot]:
                                value = self._known.pop(key)
                                self.outer._emit(
                                    WatchEvent(
                                        WatchEventType.DELETE,
                                        KVEntry(key=key, value=value),
                                    )
                                )
                        self.outer._emit_sync()
                    continue
                entry = item.entry
                if item.type == WatchEventType.PUT:
                    if in_snapshot:
                        snapshot.add(entry.key)
                    self._known[entry.key] = entry.value
                else:
                    self._known.pop(entry.key, None)
                self.outer._emit(item)
            if self.outer._cancelled:
                self.conn.remove_resync_hook(self)
                await self._release()
                return
            if inner._error is None:
                # clean server-side close: propagate (not a failure)
                self.conn.remove_resync_hook(self)
                self.outer._close()
                return
            if self.conn.closed or not self.conn.reconnect_enabled:
                self.conn.remove_resync_hook(self)
                self.outer._fail(inner._error)
                return
            # connection lost: park until the reconnect loop re-establishes
            # this watch via resync().  Guarded — resync may already have
            # swapped a fresh inner in while we drained the dead one, and
            # clobbering it would park this pump forever.
            if self._inner is inner:
                self._inner = None
                self._inner_changed.clear()


class _ReconnectingSub:
    """Driver keeping one consumer-facing ``Subscription`` alive across
    reconnects (plain resubscribe; gap messages are lost, as with NATS
    core subscriptions)."""

    def __init__(
        self, conn: RpcConnection, subject: str, queue_group: str | None,
        outer: Subscription,
    ):
        self.conn = conn
        self.subject = subject
        self.queue_group = queue_group
        self.outer = outer
        self._inner: Subscription | None = None
        self._inner_changed = asyncio.Event()
        self._stream_id: int | None = None

    async def start(self) -> None:
        """First establishment; errors propagate to the subscribe() caller."""
        await self._establish(wait_ready=True)
        self.conn.add_resync_hook(self, self.resync)
        spawn_logged(self._pump())

        original_unsub = self.outer.unsubscribe

        async def _unsub() -> None:
            self.conn.remove_resync_hook(self)
            await self._release()
            await original_unsub()

        self.outer.unsubscribe = _unsub  # type: ignore[method-assign]

    async def _establish(self, *, wait_ready: bool) -> None:
        stream_id = await self.conn.call(
            "bus.subscribe", self.subject, self.queue_group, wait_ready=wait_ready
        )
        inner = Subscription(self.subject)
        self.conn.register_stream(stream_id, inner)
        self._stream_id = stream_id
        self._inner = inner
        self._inner_changed.set()
        if self.outer._closed:
            await self._release()

    async def resync(self) -> None:
        if self.outer._closed:
            self.conn.remove_resync_hook(self)
            return
        await self._establish(wait_ready=False)

    async def _release(self) -> None:
        stream_id, self._stream_id = self._stream_id, None
        if stream_id is None:
            return
        self.conn._streams.pop(stream_id, None)
        inner = self._inner
        if inner is not None and not inner._closed:
            inner._closed = True
            inner._queue.put_nowait(None)  # wake the pump
        try:
            await self.conn.call("bus.unsubscribe", stream_id, wait_ready=False)
        except (ConnectionError, RuntimeError):
            pass

    async def _wait_inner(self) -> Subscription | None:
        while self._inner is None:
            if self.outer._closed or self.conn.closed:
                return None
            try:
                await asyncio.wait_for(self._inner_changed.wait(), 0.5)
            except asyncio.TimeoutError:
                continue
        return self._inner

    async def _pump(self) -> None:
        while True:
            inner = await self._wait_inner()
            if inner is None:
                if not self.outer._closed:
                    self.outer._closed = True
                    self.outer._queue.put_nowait(None)
                self.conn.remove_resync_hook(self)
                return
            while True:
                msg = await inner._queue.get()
                if msg is None or self.outer._closed:
                    break
                self.outer._deliver(msg)
            if self.outer._closed:
                self.conn.remove_resync_hook(self)
                await self._release()
                return
            if not inner._closed or self.conn.closed or not self.conn.reconnect_enabled:
                # clean server-side close, or a terminal connection loss:
                # end the consumer stream
                self.conn.remove_resync_hook(self)
                self.outer._closed = True
                self.outer._queue.put_nowait(None)
                return
            # connection lost: park until resync() resubscribes (guarded —
            # resync may already have swapped a fresh inner in)
            if self._inner is inner:
                self._inner = None
                self._inner_changed.clear()


class _LeaseRecord:
    """Everything needed to resurrect one lease after a reconnect: the
    (mutable) Lease handle and the keys attached to it."""

    __slots__ = ("lease", "keys")

    def __init__(self, lease: Lease):
        self.lease = lease
        self.keys: dict[str, bytes] = {}


class RemoteKV(KeyValueStore):
    def __init__(self, conn: RpcConnection):
        self._conn = conn
        self._keepalive_tasks: dict[int, asyncio.Task] = {}  # id(lease) -> task
        self._lease_records: dict[int, _LeaseRecord] = {}  # id(lease) -> record
        # leases re-grant FIRST on reconnect (hook registered before any
        # watch/sub driver exists), so re-established watches snapshot the
        # re-put keys
        conn.add_resync_hook("kv.leases", self._resync_leases)

    def _record_for(self, lease_id: int) -> _LeaseRecord | None:
        for record in self._lease_records.values():
            if record.lease.id == lease_id and not record.lease.revoked:
                return record
        return None

    async def put(self, key: str, value: bytes, lease_id: int = 0) -> int:
        rev = await self._conn.call("kv.put", key, value, lease_id)
        if lease_id:
            record = self._record_for(lease_id)
            if record is not None:
                record.keys[key] = value
        return rev

    async def create(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        created = await self._conn.call("kv.create", key, value, lease_id)
        if created and lease_id:
            record = self._record_for(lease_id)
            if record is not None:
                record.keys[key] = value
        return created

    async def get(self, key: str) -> KVEntry | None:
        result = await self._conn.call("kv.get", key)
        return kv_entry_from_wire(result) if result else None

    async def get_prefix(self, prefix: str) -> list[KVEntry]:
        return [kv_entry_from_wire(d) for d in await self._conn.call("kv.get_prefix", prefix)]

    async def delete(self, key: str) -> bool:
        deleted = await self._conn.call("kv.delete", key)
        for record in self._lease_records.values():
            record.keys.pop(key, None)
        return deleted

    async def delete_prefix(self, prefix: str) -> int:
        n = await self._conn.call("kv.delete_prefix", prefix)
        for record in self._lease_records.values():
            for key in [k for k in record.keys if k.startswith(prefix)]:
                del record.keys[key]
        return n

    async def grant_lease(self, ttl: float) -> Lease:
        lease_id = await self._conn.call("kv.grant_lease", ttl)
        lease = Lease(id=lease_id, ttl=ttl)
        self._lease_records[id(lease)] = _LeaseRecord(lease)
        self._keepalive_tasks[id(lease)] = spawn_logged(
            self._keepalive_loop(lease)
        )
        return lease

    async def _regrant(self, record: _LeaseRecord, *, wait_ready: bool) -> None:
        """Grant a fresh lease for a record and re-attach its keys.  The
        Lease handle mutates in place (callers keep their reference; the
        keep-alive loop heartbeats whatever id it currently holds)."""
        lease = record.lease
        new_id = await self._conn.call("kv.grant_lease", lease.ttl, wait_ready=wait_ready)
        lease.id = new_id
        for key, value in list(record.keys.items()):
            await self._conn.call("kv.put", key, value, new_id, wait_ready=wait_ready)
        logger.info(
            "re-granted lease %d (ttl=%.1fs) with %d attached key(s)",
            new_id, lease.ttl, len(record.keys),
        )

    async def _resync_leases(self) -> None:
        for record in list(self._lease_records.values()):
            if record.lease.revoked:
                continue
            await self._regrant(record, wait_ready=False)

    async def _keepalive_loop(self, lease: Lease) -> None:
        """Auto keep-alive (the client owns the heartbeat, like etcd's
        lease keep-alive stream).  A dropped connection marks the lease for
        re-grant on reconnect (the resync hook performs it) instead of
        silently ending the heartbeat — pre-fix, workers stayed registered
        until TTL reap and then vanished forever."""
        record = self._lease_records.get(id(lease))
        try:
            while not lease.revoked:
                await asyncio.sleep(max(lease.ttl / 3.0, 0.1))
                try:
                    ok = await self._conn.call("kv.keep_alive", lease.id)
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    # TimeoutError covers the half-open-TCP partition: the
                    # transport never reports loss, the RPC just times out —
                    # the heartbeat must survive that too, not die silently
                    if self._conn.closed or not self._conn.reconnect_enabled:
                        lease._revoked.set()
                        return
                    continue  # reconnect's resync re-grants; keep beating
                except RuntimeError as exc:  # server-side error frame
                    logger.warning("keep_alive for lease %d failed: %s", lease.id, exc)
                    continue
                if not ok and record is not None and not lease.revoked:
                    # the server does not know this lease (restart raced
                    # resync, or TTL reaped during a partition): re-grant in
                    # place and re-attach our keys
                    try:
                        await self._regrant(record, wait_ready=True)
                    except (ConnectionError, OSError, asyncio.TimeoutError, RuntimeError):
                        continue
        except asyncio.CancelledError:
            lease._revoked.set()

    async def keep_alive(self, lease: Lease) -> None:
        await self._conn.call("kv.keep_alive", lease.id)

    async def revoke_lease(self, lease: Lease) -> None:
        task = self._keepalive_tasks.pop(id(lease), None)
        if task is not None:
            task.cancel()
        self._lease_records.pop(id(lease), None)
        lease._revoked.set()
        await self._conn.call("kv.revoke_lease", lease.id)

    def watch_prefix(self, prefix: str) -> Watch:
        watch = Watch()
        _ReconnectingWatch(self._conn, prefix, watch).install()
        return watch


class RemoteBus(MessageBus):
    def __init__(self, conn: RpcConnection):
        self._conn = conn
        # set once a server rejects bus.queue_pop_meta (older dynctl)
        self._pop_meta_unsupported = False

    async def publish(
        self, subject: str, payload: bytes, reply_to: str | None = None, trace=None
    ) -> int | None:
        result = await self._conn.call("bus.publish", subject, payload, reply_to, trace=trace)
        # current dynctl returns the delivered-subscriber count; an older
        # server returns True (bool — "unknown", NOT a hard zero)
        return result if type(result) is int else None

    async def subscribe(self, subject: str, queue_group: str | None = None) -> Subscription:
        sub = Subscription(subject)
        driver = _ReconnectingSub(self._conn, subject, queue_group, sub)
        await driver.start()
        return sub

    async def request(self, subject: str, payload: bytes, timeout: float = 5.0) -> bytes:
        return await self._conn.call("bus.request", subject, payload, timeout, timeout=timeout + 5)

    async def queue_publish(self, queue: str, payload: bytes) -> None:
        await self._conn.call("bus.queue_publish", queue, payload)

    async def queue_pop(self, queue: str, timeout: float | None = None) -> bytes | None:
        rpc_timeout = None if timeout is None else timeout + 5
        return await self._conn.call("bus.queue_pop", queue, timeout, timeout=rpc_timeout)

    async def queue_pop_meta(
        self, queue: str, timeout: float | None = None
    ) -> tuple[bytes, float | None] | None:
        rpc_timeout = None if timeout is None else timeout + 5
        if not self._pop_meta_unsupported:
            try:
                item = await self._conn.call(
                    "bus.queue_pop_meta", queue, timeout, timeout=rpc_timeout
                )
            except RuntimeError as err:
                if "unknown method" not in str(err):
                    raise
                # pre-queue_pop_meta dynctl server: degrade to the
                # documented (payload, None) contract and remember, so a
                # mixed-version fleet pays one failed round trip, not one
                # per pop
                self._pop_meta_unsupported = True
            else:
                # age is measured on the server's clock at pop time; the
                # reply's transit adds a little un-counted staleness, which
                # errs toward treating items as fresh (a wasted prefill,
                # never dropped traffic)
                return None if item is None else (item[0], item[1])
        payload = await self.queue_pop(queue, timeout)
        return None if payload is None else (payload, None)

    async def queue_len(self, queue: str) -> int:
        return await self._conn.call("bus.queue_len", queue)

    async def object_put(self, bucket: str, name: str, data: bytes) -> None:
        await self._conn.call("bus.object_put", bucket, name, data, timeout=120)

    async def object_get(self, bucket: str, name: str) -> bytes | None:
        return await self._conn.call("bus.object_get", bucket, name, timeout=120)

    async def object_delete(self, bucket: str, name: str) -> bool:
        return await self._conn.call("bus.object_delete", bucket, name)


class RemoteControlPlane(ControlPlane):
    def __init__(self, host: str, port: int, *, reconnect: bool | None = None):
        self._conn = RpcConnection(host, port, reconnect=reconnect)
        self.kv = RemoteKV(self._conn)
        self.bus = RemoteBus(self._conn)

    @property
    def reconnects_total(self) -> int:
        """Successful reconnects on this plane's connection (also counted
        process-wide in ``dyn_cp_reconnects_total``)."""
        return self._conn.reconnects_total

    async def connect(self) -> None:
        await self._conn.connect()
        await self._conn.call("ping")

    async def close(self) -> None:
        for task in self.kv._keepalive_tasks.values():
            task.cancel()
        await self._conn.close()
