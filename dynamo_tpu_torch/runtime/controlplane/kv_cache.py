"""Write-through watch cache over a control-plane KV prefix.

Local reads served from memory, kept fresh by a prefix watch; writes go
through to the store and update the local view optimistically (reference:
``EtcdKvCache`` — lib/runtime/src/transports/etcd.rs:474-599 — used for
hot-reloaded runtime config such as the disagg router threshold).

Usage:
    cache = await KvWatchCache.create(plane.kv, "config/router/")
    value = cache.get("threshold")          # no network IO
    await cache.put("threshold", b"512")    # write-through
    await cache.close()
"""

from __future__ import annotations

import asyncio

from dynamo_tpu_torch.runtime.controlplane.interface import (
    KeyValueStore,
    Watch,
    WatchEventType,
)
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("runtime.controlplane.kv_cache")


class KvWatchCache:
    """A prefix-scoped KV view: snapshot-primed, watch-maintained,
    write-through."""

    def __init__(self, kv: KeyValueStore, prefix: str):
        self.kv = kv
        self.prefix = prefix
        self._data: dict[str, bytes] = {}
        self._watch: Watch | None = None
        self._task: asyncio.Task | None = None
        self._changed = asyncio.Event()
        self._stale = False
        self._closing = False

    @classmethod
    async def create(cls, kv: KeyValueStore, prefix: str) -> "KvWatchCache":
        cache = cls(kv, prefix)
        cache._watch = kv.watch_prefix(prefix)
        cache._task = asyncio.ensure_future(cache._pump())
        # the watch's initial snapshot (applied by the pump) IS the prime —
        # ready() resolves once the view is complete
        await cache._watch.ready()
        return cache

    async def _pump(self) -> None:
        assert self._watch is not None
        try:
            # against a self-healing remote plane this loop survives
            # connection loss transparently: the watch resyncs (snapshot
            # PUTs + synthetic DELETEs) and the view converges — `stale`
            # only trips on a TERMINAL watch death (reconnect disabled,
            # plane closed, or a memory-backend watch cancelled externally)
            async for event in self._watch:
                key = event.entry.key
                if not key.startswith(self.prefix):
                    continue
                short = key[len(self.prefix):]
                if event.type == WatchEventType.PUT:
                    self._data[short] = event.entry.value
                else:
                    self._data.pop(short, None)
                self._changed.set()
                self._changed = asyncio.Event()
        except ConnectionError:
            pass  # handled below: the finally marks the view stale
        finally:
            # watch ended for good: the view stops updating — flag it and
            # wake any waiters so callers never block forever on a dead cache
            if not self._closing:
                self._stale = True
                logger.warning(
                    "watch for prefix %r ended; cached view is stale", self.prefix
                )
            self._changed.set()

    @property
    def stale(self) -> bool:
        """True once the backing watch has died (view no longer updates)."""
        return self._stale

    # -- local reads -------------------------------------------------------
    def get(self, key: str, default: bytes | None = None) -> bytes | None:
        return self._data.get(key, default)

    def keys(self) -> list[str]:
        return sorted(self._data)

    def items(self) -> dict[str, bytes]:
        return dict(self._data)

    def __len__(self) -> int:
        return len(self._data)

    async def wait_changed(self, timeout: float | None = None) -> bool:
        """Block until the view changes (True) or timeout (False)."""
        changed = self._changed
        try:
            await asyncio.wait_for(changed.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    # -- write-through -----------------------------------------------------
    async def put(self, key: str, value: bytes, lease_id: int = 0) -> None:
        await self.kv.put(self.prefix + key, value, lease_id)
        self._data[key] = value  # optimistic; the watch confirms

    async def delete(self, key: str) -> None:
        await self.kv.delete(self.prefix + key)
        self._data.pop(key, None)

    async def close(self) -> None:
        self._closing = True
        if self._watch is not None:
            self._watch.cancel()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
