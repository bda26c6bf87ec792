"""Component model: Namespace → Component → Endpoint → Instance.

Mirrors the reference's hierarchy and etcd layout (reference:
lib/runtime/src/component.rs:70-133): instances register under
``dynamo://{ns}/components/{comp}/endpoints/{ep}/instances/{id}`` with a
liveness lease; clients watch the prefix and fail over when leases lapse.
"""

from __future__ import annotations

import asyncio
import json
import secrets
from dataclasses import dataclass
from typing import TYPE_CHECKING

from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.utils.logging import get_logger

if TYPE_CHECKING:
    from dynamo_tpu_torch.runtime.client import Client
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.ingress import EndpointService

logger = get_logger("runtime.component")

ROOT_PATH = "dynamo://"


@dataclass(frozen=True)
class Instance:
    """A live endpoint instance (one worker process serving one endpoint)."""

    namespace: str
    component: str
    endpoint: str
    instance_id: int
    subject: str

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "namespace": self.namespace,
                "component": self.component,
                "endpoint": self.endpoint,
                "instance_id": self.instance_id,
                "subject": self.subject,
            }
        ).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "Instance":
        d = json.loads(data)
        return cls(
            namespace=d["namespace"],
            component=d["component"],
            endpoint=d["endpoint"],
            instance_id=d["instance_id"],
            subject=d["subject"],
        )


def instances_prefix(namespace: str, component: str, endpoint: str) -> str:
    return f"{ROOT_PATH}{namespace}/components/{component}/endpoints/{endpoint}/instances/"


def instance_key(inst: Instance) -> str:
    return instances_prefix(inst.namespace, inst.component, inst.endpoint) + f"{inst.instance_id:016x}"


def endpoint_subject(namespace: str, component: str, endpoint: str, instance_id: int) -> str:
    return f"{namespace}.{component}.{endpoint}.{instance_id:x}"


def stats_subject(subject: str) -> str:
    """Request/reply subject for per-instance stats scraping (the reference's
    NATS ``$SRV`` service-stats analog, lib/runtime/src/service.rs)."""
    return f"_stats.{subject}"


def ctl_subject(subject: str) -> str:
    """Request/reply subject for per-instance control verbs (drain)."""
    return f"_ctl.{subject}"


class Namespace:
    def __init__(self, runtime: "DistributedRuntime", name: str):
        self.runtime = runtime
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self, name)

    async def delete(self) -> int:
        """Tear down everything registered under this namespace."""
        return await self.runtime.plane.kv.delete_prefix(f"{ROOT_PATH}{self.name}/")


class Component:
    def __init__(self, namespace: Namespace, name: str):
        self.namespace = namespace
        self.name = name

    @property
    def runtime(self) -> "DistributedRuntime":
        return self.namespace.runtime

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self, name)

    def event_subject(self, event: str) -> str:
        """Component-scoped event subject (e.g. KV events; reference:
        lib/llm/src/kv_router.rs:43)."""
        return f"{self.namespace.name}.{self.name}._events.{event}"


class Endpoint:
    def __init__(self, component: Component, name: str):
        self.component = component
        self.name = name

    @property
    def runtime(self) -> "DistributedRuntime":
        return self.component.runtime

    @property
    def path(self) -> str:
        return f"{self.component.namespace.name}.{self.component.name}.{self.name}"

    async def serve(
        self,
        engine: AsyncEngine,
        *,
        instance_id: int | None = None,
        lease_ttl: float = 3.0,
        stats_handler=None,
        topo_role: str = "",
        topo_transfer_address: str = "",
        topo_slice: str | None = None,
    ) -> "EndpointService":
        """Register an instance and start serving requests pushed to it.

        ``topo_*`` feed the instance's TopologyCard (fleet topology plane):
        role (``prefill``/``decode``), the KV-transfer data-plane address,
        and an explicit slice label for emulated multi-slice fleets.
        """
        from dynamo_tpu_torch.runtime.ingress import EndpointService

        inst_id = instance_id if instance_id is not None else secrets.randbits(63)
        instance = Instance(
            namespace=self.component.namespace.name,
            component=self.component.name,
            endpoint=self.name,
            instance_id=inst_id,
            subject=endpoint_subject(
                self.component.namespace.name, self.component.name, self.name, inst_id
            ),
        )
        service = EndpointService(
            self.runtime, instance, engine, stats_handler=stats_handler,
            topo_role=topo_role, topo_transfer_address=topo_transfer_address,
            topo_slice=topo_slice,
        )
        await service.start(lease_ttl=lease_ttl)
        return service

    async def client(self, *, static_instances: list[Instance] | None = None) -> "Client":
        from dynamo_tpu_torch.runtime.client import Client

        client = Client(self.runtime, self, static_instances=static_instances)
        await client.start()
        return client
