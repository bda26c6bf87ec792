"""Control-plane address resolution.

- ``memory`` or ``memory://<name>`` — shared in-process instance.
- ``host:port``                     — TCP client to a dynctl server.
"""

from __future__ import annotations

from dynamo_tpu_torch.runtime.controlplane.interface import ControlPlane
from dynamo_tpu_torch.runtime.controlplane.memory import MemoryControlPlane


async def connect_control_plane(address: str) -> ControlPlane:
    if address == "memory" or address.startswith("memory://"):
        name = address.removeprefix("memory://") or "default"
        if name == "memory":
            name = "default"
        return MemoryControlPlane.named(name)
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"invalid control plane address: {address!r}")
    from dynamo_tpu_torch.runtime.controlplane.client import RemoteControlPlane

    plane = RemoteControlPlane(host, int(port))
    await plane.connect()
    return plane
