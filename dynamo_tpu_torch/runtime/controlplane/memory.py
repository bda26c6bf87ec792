"""In-process control plane (static/dev mode and tests).

Implements full etcd/NATS-class semantics — revisions, CAS, leases with expiry
reaping, prefix watches, queue groups, request/reply, durable queues, object
store — entirely in process.  The ``dynctl`` TCP server wraps this same state
machine; memory mode is the reference's "static mode without discovery"
(reference: lib/runtime/src/distributed.rs:86) but with discovery working.
"""

from __future__ import annotations

import asyncio
import itertools
import time
import uuid
from collections import defaultdict

from dynamo_tpu_torch.runtime.controlplane.interface import (
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
    subject_matches,
)
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("runtime.controlplane.memory")


class MemoryKV(KeyValueStore):
    def __init__(self) -> None:
        self._data: dict[str, KVEntry] = {}
        self._revision = 0
        self._leases: dict[int, tuple[Lease, float]] = {}  # id -> (lease, deadline)
        self._lease_keys: dict[int, set[str]] = defaultdict(set)
        self._watches: list[tuple[str, Watch]] = []
        self._lease_counter = itertools.count(1)
        self._reaper: asyncio.Task | None = None

    # -- events ------------------------------------------------------------
    def _notify(self, event: WatchEvent) -> None:
        live = []
        for prefix, watch in self._watches:
            if watch._cancelled:
                continue  # prune dead registrations as we go
            if event.entry.key.startswith(prefix):
                watch._emit(event)
            live.append((prefix, watch))
        self._watches = live

    def _ensure_reaper(self) -> None:
        if self._reaper is None or self._reaper.done():
            self._reaper = spawn_logged(self._reap_loop())

    async def _reap_loop(self) -> None:
        while self._leases:
            await asyncio.sleep(0.2)
            now = time.monotonic()
            expired = [lid for lid, (_, deadline) in self._leases.items() if deadline < now]
            for lid in expired:
                await self._expire_lease(lid)
        self._reaper = None

    async def _expire_lease(self, lease_id: int) -> None:
        entry = self._leases.pop(lease_id, None)
        if entry is None:
            return
        lease, _ = entry
        lease._revoked.set()
        for key in self._lease_keys.pop(lease_id, set()):
            old = self._data.get(key)
            # only reap keys this lease still owns: a reconnect re-grant
            # re-puts the key under its NEW lease id, and the old lease
            # expiring afterwards must not take the live key with it
            if old is not None and old.lease_id == lease_id:
                del self._data[key]
                self._notify(WatchEvent(WatchEventType.DELETE, old))

    # -- KeyValueStore -----------------------------------------------------
    async def put(self, key: str, value: bytes, lease_id: int = 0) -> int:
        self._revision += 1
        prev = self._data.get(key)
        if prev is not None and prev.lease_id and prev.lease_id != lease_id:
            # re-put under a different (or no) lease transfers ownership;
            # leaving the key in the old lease's set would let that lease's
            # expiry delete a key it no longer owns
            self._lease_keys[prev.lease_id].discard(key)
        entry = KVEntry(key=key, value=value, revision=self._revision, lease_id=lease_id)
        self._data[key] = entry
        if lease_id:
            self._lease_keys[lease_id].add(key)
        self._notify(WatchEvent(WatchEventType.PUT, entry))
        return self._revision

    async def create(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        if key in self._data:
            return False
        await self.put(key, value, lease_id)
        return True

    async def get(self, key: str) -> KVEntry | None:
        return self._data.get(key)

    async def get_prefix(self, prefix: str) -> list[KVEntry]:
        return [e for k, e in sorted(self._data.items()) if k.startswith(prefix)]

    async def delete(self, key: str) -> bool:
        old = self._data.pop(key, None)
        if old is None:
            return False
        if old.lease_id:
            self._lease_keys[old.lease_id].discard(key)
        self._notify(WatchEvent(WatchEventType.DELETE, old))
        return True

    async def delete_prefix(self, prefix: str) -> int:
        keys = [k for k in self._data if k.startswith(prefix)]
        for k in keys:
            await self.delete(k)
        return len(keys)

    async def grant_lease(self, ttl: float) -> Lease:
        lease = Lease(id=next(self._lease_counter), ttl=ttl)
        self._leases[lease.id] = (lease, time.monotonic() + ttl)
        self._ensure_reaper()
        return lease

    async def keep_alive(self, lease: Lease) -> None:
        if lease.id in self._leases:
            self._leases[lease.id] = (lease, time.monotonic() + lease.ttl)

    async def revoke_lease(self, lease: Lease) -> None:
        await self._expire_lease(lease.id)

    def watch_prefix(self, prefix: str) -> Watch:
        watch = Watch()
        for entry in list(self._data.values()):
            if entry.key.startswith(prefix):
                watch._emit(WatchEvent(WatchEventType.PUT, entry))
        watch._emit_sync()  # snapshot boundary
        self._watches.append((prefix, watch))
        return watch


class MemoryBus(MessageBus):
    def __init__(self) -> None:
        # subject pattern -> {queue_group_or_None -> [subscriptions]}
        self._subs: list[tuple[str, str | None, Subscription]] = []
        self._rr: dict[tuple[str, str], int] = defaultdict(int)
        # work-queue items: (payload, enqueue instant on this bus's clock)
        self._queues: dict[str, asyncio.Queue[tuple[bytes, float]]] = defaultdict(
            asyncio.Queue
        )
        self._objects: dict[str, dict[str, bytes]] = defaultdict(dict)

    async def publish(
        self, subject: str, payload: bytes, reply_to: str | None = None, trace=None
    ) -> int:
        # trace: accepted for interface parity; in-process delivery needs no
        # frame-level correlation (the request envelope already carries it)
        msg = Message(subject=subject, payload=payload, reply_to=reply_to)
        delivered = 0
        # group -> matching members; None-group members all get a copy
        grouped: dict[str, list[Subscription]] = defaultdict(list)
        for pattern, group, sub in list(self._subs):
            if sub._closed or not subject_matches(pattern, subject):
                continue
            if group is None:
                sub._deliver(msg)
                delivered += 1
            else:
                grouped[f"{pattern}|{group}"].append(sub)
        for key, members in grouped.items():
            idx = self._rr[(key, "")] % len(members)
            self._rr[(key, "")] += 1
            members[idx]._deliver(msg)
            delivered += 1
        return delivered

    async def subscribe(self, subject: str, queue_group: str | None = None) -> Subscription:
        sub = Subscription(subject)
        self._subs.append((subject, queue_group, sub))
        return sub

    async def request(self, subject: str, payload: bytes, timeout: float = 5.0) -> bytes:
        inbox = f"_inbox.{uuid.uuid4().hex}"
        sub = await self.subscribe(inbox)
        try:
            await self.publish(subject, payload, reply_to=inbox)
            msg = await asyncio.wait_for(sub.__anext__(), timeout)
            return msg.payload
        finally:
            await sub.unsubscribe()

    async def queue_publish(self, queue: str, payload: bytes) -> None:
        # items carry their enqueue instant (this bus's monotonic clock) so
        # queue_pop_meta can report broker-measured age: when this bus lives
        # in a dynctl server, publish and pop both happen here, making the
        # age immune to producer/consumer wall-clock skew
        self._queues[queue].put_nowait((payload, time.monotonic()))

    async def queue_pop(self, queue: str, timeout: float | None = None) -> bytes | None:
        item = await self.queue_pop_meta(queue, timeout)
        return None if item is None else item[0]

    async def queue_pop_meta(
        self, queue: str, timeout: float | None = None
    ) -> tuple[bytes, float | None] | None:
        q = self._queues[queue]
        try:
            if timeout is None:
                payload, enq = await q.get()
            else:
                payload, enq = await asyncio.wait_for(q.get(), timeout)
        except asyncio.TimeoutError:
            return None
        return payload, time.monotonic() - enq

    async def queue_len(self, queue: str) -> int:
        return self._queues[queue].qsize()

    async def object_put(self, bucket: str, name: str, data: bytes) -> None:
        self._objects[bucket][name] = data

    async def object_get(self, bucket: str, name: str) -> bytes | None:
        return self._objects[bucket].get(name)

    async def object_delete(self, bucket: str, name: str) -> bool:
        return self._objects[bucket].pop(name, None) is not None


class MemoryControlPlane(ControlPlane):
    """A fully in-process control plane instance."""

    _named: dict[str, "MemoryControlPlane"] = {}

    def __init__(self) -> None:
        self.kv: MemoryKV = MemoryKV()
        self.bus: MemoryBus = MemoryBus()

    @classmethod
    def named(cls, name: str) -> "MemoryControlPlane":
        """Process-wide shared instance (so runtimes in one process discover
        each other, like pointing at the same etcd)."""
        if name not in cls._named:
            cls._named[name] = cls()
        return cls._named[name]

    @classmethod
    def reset_named(cls) -> None:
        cls._named.clear()

    async def close(self) -> None:
        pass
