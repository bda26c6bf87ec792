"""Abstract control-plane interfaces (etcd-class KV + NATS-class bus)."""

from __future__ import annotations

import asyncio
import enum
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import AsyncIterator


# --------------------------------------------------------------------------
# Key-value store (discovery, leases, config watch)
# --------------------------------------------------------------------------


@dataclass
class KVEntry:
    key: str
    value: bytes
    revision: int = 0
    lease_id: int = 0


class WatchEventType(enum.Enum):
    PUT = "put"
    DELETE = "delete"


@dataclass
class WatchEvent:
    type: WatchEventType
    entry: KVEntry


@dataclass
class Lease:
    """A liveness lease; keys attached to it vanish when it expires.

    (Reference: etcd leases, lib/runtime/src/transports/etcd.rs:51-88 — the
    liveness primitive for failure detection.)
    """

    id: int
    ttl: float
    _revoked: asyncio.Event = field(default_factory=asyncio.Event)

    @property
    def revoked(self) -> bool:
        return self._revoked.is_set()


class KeyValueStore(ABC):
    @abstractmethod
    async def put(self, key: str, value: bytes, lease_id: int = 0) -> int:
        """Put; returns new revision."""

    @abstractmethod
    async def create(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        """Atomically create iff absent (etcd CAS kv_create). False if exists."""

    @abstractmethod
    async def get(self, key: str) -> KVEntry | None:
        ...

    @abstractmethod
    async def get_prefix(self, prefix: str) -> list[KVEntry]:
        ...

    @abstractmethod
    async def delete(self, key: str) -> bool:
        ...

    @abstractmethod
    async def delete_prefix(self, prefix: str) -> int:
        ...

    @abstractmethod
    async def grant_lease(self, ttl: float) -> Lease:
        """Grant a lease; caller must keep it alive via ``keep_alive``."""

    @abstractmethod
    async def keep_alive(self, lease: Lease) -> None:
        """Refresh lease TTL once."""

    @abstractmethod
    async def revoke_lease(self, lease: Lease) -> None:
        ...

    @abstractmethod
    def watch_prefix(self, prefix: str) -> "Watch":
        """Watch a prefix: yields initial snapshot as PUTs, then live events."""


# In-queue marker separating the initial snapshot from live events.  It is
# swallowed by ``Watch.__anext__`` (consumers never see it); dequeueing it
# sets the watch's ready event, so ``await watch.ready()`` means "the
# consumer has drained the full snapshot" — not merely "it was enqueued".
WATCH_SYNC = object()


class Watch:
    """Async stream of WatchEvents with a cancel handle and an
    end-of-snapshot ``ready()`` signal."""

    def __init__(self) -> None:
        self._queue: asyncio.Queue[object | None] = asyncio.Queue()
        self._cancelled = False
        self._ready = asyncio.Event()
        self._error: BaseException | None = None

    def _emit(self, event: WatchEvent) -> None:
        if not self._cancelled:
            self._queue.put_nowait(event)

    def _emit_sync(self) -> None:
        if not self._cancelled:
            self._queue.put_nowait(WATCH_SYNC)

    def _close(self) -> None:
        self._ready.set()  # never leave ready() waiters hanging
        self._queue.put_nowait(None)

    def _fail(self, exc: BaseException) -> None:
        """Mark the watch broken (e.g. the connection dropped during
        startup): ``ready()`` waiters and iterators re-raise instead of
        hanging forever.  Non-connection causes (rpc errors, timeouts) are
        normalized to ConnectionError so consumers handle one type."""
        if self._cancelled:
            return
        if not isinstance(exc, ConnectionError):
            exc = ConnectionError(f"watch failed: {exc!r}")
        self._error = exc
        self._ready.set()
        self._queue.put_nowait(None)

    def cancel(self) -> None:
        self._cancelled = True
        self._ready.set()
        self._queue.put_nowait(None)

    async def ready(self) -> None:
        """Resolves once the initial snapshot has been consumed from this
        watch (or the watch closed); raises if the watch failed to start."""
        await self._ready.wait()
        if self._error is not None:
            raise self._error

    def __aiter__(self) -> AsyncIterator[WatchEvent]:
        return self

    async def __anext__(self) -> WatchEvent:
        while True:
            event = await self._queue.get()
            if event is None or self._cancelled:
                self._ready.set()
                if self._error is not None and not self._cancelled:
                    raise self._error
                raise StopAsyncIteration
            if event is WATCH_SYNC:
                self._ready.set()
                continue
            return event  # type: ignore[return-value]


# --------------------------------------------------------------------------
# Message bus (request push, work queues, object store, stats)
# --------------------------------------------------------------------------


@dataclass
class Message:
    subject: str
    payload: bytes
    reply_to: str | None = None


class Subscription:
    """Async stream of Messages for a subject (optionally queue-grouped)."""

    def __init__(self, subject: str) -> None:
        self.subject = subject
        self._queue: asyncio.Queue[Message | None] = asyncio.Queue()
        self._closed = False

    def _deliver(self, msg: Message) -> None:
        if not self._closed:
            self._queue.put_nowait(msg)

    async def unsubscribe(self) -> None:
        self._closed = True
        self._queue.put_nowait(None)

    def pending(self) -> int:
        return self._queue.qsize()

    def __aiter__(self) -> AsyncIterator[Message]:
        return self

    async def __anext__(self) -> Message:
        msg = await self._queue.get()
        if msg is None or self._closed:
            raise StopAsyncIteration
        return msg


@dataclass
class Bucket:
    """Object-store bucket handle (model artifacts; reference:
    lib/runtime/src/transports/nats.rs:123-211)."""

    name: str


class MessageBus(ABC):
    @abstractmethod
    async def publish(
        self, subject: str, payload: bytes, reply_to: str | None = None, trace=None
    ) -> int | None:
        """Returns the number of subscribers the message reached, or None
        when the backend cannot tell (e.g. an older dynctl server).  A hard
        0 lets publishers detect a dark subject — a worker mid-resubscribe
        after a control-plane reconnect, or dead — and re-publish instead
        of waiting out a rendezvous timeout on a message nobody received.

        ``trace``: optional TraceContext stamped on the transport frame
        by remote implementations (request-scoped publishes only); purely
        advisory — delivery semantics never depend on it."""
        ...

    @abstractmethod
    async def subscribe(self, subject: str, queue_group: str | None = None) -> Subscription:
        """Wildcard ``*`` (one token) and ``>`` (rest) are supported.

        Within a queue group, each message goes to exactly one subscriber.
        """

    @abstractmethod
    async def request(self, subject: str, payload: bytes, timeout: float = 5.0) -> bytes:
        """Request/reply (service stats scraping)."""

    # ---- durable work queue (JetStream work-queue analog; prefill queue) --
    @abstractmethod
    async def queue_publish(self, queue: str, payload: bytes) -> None:
        ...

    @abstractmethod
    async def queue_pop(self, queue: str, timeout: float | None = None) -> bytes | None:
        """Pop one item; None on timeout. Exactly-one-consumer semantics."""

    async def queue_pop_meta(
        self, queue: str, timeout: float | None = None
    ) -> tuple[bytes, float | None] | None:
        """Pop one item with its broker-measured age in seconds.

        The age is enqueue→pop elapsed ON THE BROKER'S OWN CLOCK (NATS
        JetStream exposes the same via server-side message timestamps), so
        consumers can bound item staleness without trusting cross-host
        wall-clock agreement.  Backends that don't track enqueue times
        return ``(payload, None)`` — this default just wraps queue_pop.
        """
        payload = await self.queue_pop(queue, timeout)
        return None if payload is None else (payload, None)

    @abstractmethod
    async def queue_len(self, queue: str) -> int:
        ...

    # ---- object store -----------------------------------------------------
    @abstractmethod
    async def object_put(self, bucket: str, name: str, data: bytes) -> None:
        ...

    @abstractmethod
    async def object_get(self, bucket: str, name: str) -> bytes | None:
        ...

    @abstractmethod
    async def object_delete(self, bucket: str, name: str) -> bool:
        ...


def subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style subject matching: ``a.*.c`` and ``a.>``."""
    p_tokens = pattern.split(".")
    s_tokens = subject.split(".")
    for i, tok in enumerate(p_tokens):
        if tok == ">":
            return True
        if i >= len(s_tokens):
            return False
        if tok != "*" and tok != s_tokens[i]:
            return False
    return len(p_tokens) == len(s_tokens)


class ControlPlane(ABC):
    """A connected control plane: KV store + message bus + lifecycle."""

    kv: KeyValueStore
    bus: MessageBus

    @abstractmethod
    async def close(self) -> None:
        ...
