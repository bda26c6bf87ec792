"""DistributedRuntime — the node-global handle.

Bundles the control-plane connection (KV + bus), the lazy TCP response-stream
server, lease keep-alives and the supervised task group (reference:
lib/runtime/src/lib.rs:77-100, src/distributed.rs:34-86).
"""

from __future__ import annotations

import asyncio

from dynamo_tpu_torch.runtime.component import Namespace
from dynamo_tpu_torch.runtime.controlplane import connect_control_plane
from dynamo_tpu_torch.runtime.controlplane.interface import ControlPlane, Lease
from dynamo_tpu_torch.runtime.dataplane import ResponseStreamServer
from dynamo_tpu_torch.utils.config import RuntimeConfig
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger
from dynamo_tpu_torch.utils.tasks import CriticalTaskGroup
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("runtime.distributed")


class DistributedRuntime:
    """One per process.  ``await DistributedRuntime.create()``."""

    def __init__(self, config: RuntimeConfig, plane: ControlPlane):
        self.config = config
        self.plane = plane
        self.tasks = CriticalTaskGroup(on_failure=self._on_critical_failure)
        self._data_server: ResponseStreamServer | None = None
        self._data_server_lock = asyncio.Lock()
        self._keepalive_loops: dict[int, asyncio.Task] = {}
        self._shutdown_event = asyncio.Event()

    @classmethod
    async def create(cls, config: RuntimeConfig | None = None, **overrides) -> "DistributedRuntime":
        configure_logging()
        config = config or RuntimeConfig.from_env(**overrides)
        plane = await connect_control_plane(config.control_plane)
        return cls(config, plane)

    # -- components --------------------------------------------------------
    def namespace(self, name: str | None = None) -> Namespace:
        return Namespace(self, name or self.config.namespace)

    # -- data plane --------------------------------------------------------
    async def data_server(self) -> ResponseStreamServer:
        """Lazily started TCP response-stream server (reference: lazy TCP
        server in DistributedRuntime)."""
        async with self._data_server_lock:
            if self._data_server is None:
                self._data_server = ResponseStreamServer(
                    self.config.data_host, self.config.data_port
                )
                await self._data_server.start()
            return self._data_server

    # -- leases ------------------------------------------------------------
    def register_keepalive(self, lease: Lease) -> None:
        """Keep a lease alive until revoked (memory backend has no client-side
        keep-alive loop; remote backend already self-heartbeats)."""
        if hasattr(self.plane.kv, "_keepalive_tasks"):
            return  # RemoteKV heartbeats on grant

        async def loop() -> None:
            while not lease.revoked:
                await asyncio.sleep(max(lease.ttl / 3.0, 0.05))
                await self.plane.kv.keep_alive(lease)

        self._keepalive_loops[lease.id] = spawn_logged(loop())

    # -- lifecycle ---------------------------------------------------------
    def _on_critical_failure(self, exc: BaseException) -> None:
        logger.error("critical task failure, shutting down runtime: %r", exc)
        self._shutdown_event.set()

    def shutdown(self) -> None:
        self._shutdown_event.set()

    async def wait_for_shutdown(self) -> None:
        await self._shutdown_event.wait()

    async def close(self) -> None:
        self._shutdown_event.set()
        for task in self._keepalive_loops.values():
            task.cancel()
        await self.tasks.cancel_all()
        if self._data_server is not None:
            await self._data_server.stop()
            self._data_server = None
        await self.plane.close()
