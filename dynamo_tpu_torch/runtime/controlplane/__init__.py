"""Control plane: service discovery + messaging.

The reference delegates its control plane to external infra — etcd for
discovery/leases/config-watch and NATS for request push, work queues, object
store and service stats (reference: lib/runtime/src/transports/{etcd,nats}.rs).
dynamo_tpu_torch ships its own native control plane with the same semantics:

- ``KeyValueStore`` — etcd-class: versioned KV, compare-and-create, prefix
  get/watch with initial snapshot, leases with TTL + keep-alive; lease expiry
  deletes attached keys and emits delete events to watchers.
- ``MessageBus``   — NATS-class: subjects, queue-group subscriptions,
  request/reply, durable work queues (JetStream-analog), object store.

Backends:
- ``memory://``    — in-process singletons (static/dev mode and tests).
- ``host:port``    — msgpack-RPC TCP client to a ``dynctl`` server process
  (the distributed mode; see ``dynamo_tpu_torch.runtime.controlplane.server``).
  Self-healing by default: lost connections reconnect with backoff and
  resync leases/watches/subscriptions (docs/robustness.md).
"""

from dynamo_tpu_torch.runtime.controlplane.interface import (
    Bucket,
    KVEntry,
    KeyValueStore,
    Lease,
    MessageBus,
    Message,
    Subscription,
    WatchEvent,
    WatchEventType,
)
from dynamo_tpu_torch.runtime.controlplane.kv_cache import KvWatchCache
from dynamo_tpu_torch.runtime.controlplane.memory import MemoryControlPlane
from dynamo_tpu_torch.runtime.controlplane.connect import connect_control_plane

__all__ = [
    "Bucket",
    "KVEntry",
    "KeyValueStore",
    "KvWatchCache",
    "Lease",
    "Message",
    "MessageBus",
    "MemoryControlPlane",
    "Subscription",
    "WatchEvent",
    "WatchEventType",
    "connect_control_plane",
]
