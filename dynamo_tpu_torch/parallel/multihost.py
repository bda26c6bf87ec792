"""Multi-host bootstrap (counterpart of dynamo_tpu/parallel/multihost.py).

Joins one ``torch.distributed`` process group across hosts through the
control plane, as the reference joins ``jax.distributed``: the leader
(node_rank 0) publishes its TCPStore address (``host:port``) through a
``LeaderBarrier``; the workers take it through a ``WorkerBarrier``; every
process then calls ``init_process_group`` over ``tcp://`` that address, off
the event loop (it blocks until every rank has joined, and the leader's
barrier and the runtime's lease keep-alives need the loop meanwhile).
``make_mesh`` then takes the initialised group's rank and size; an engine
on node 0 with ``EngineConfig.mesh`` finds the group joined and starts no
workers of its own (the other nodes run ``python -m
dynamo_tpu_torch.engine.shard_worker --control-plane HOST:PORT``).
"""

from __future__ import annotations

import asyncio
import socket
from dataclasses import dataclass
from datetime import timedelta

from dynamo_tpu_torch.runtime.barrier import LeaderBarrier, WorkerBarrier
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("parallel.multihost")


@dataclass
class MultiNodeConfig:
    num_nodes: int = 1
    node_rank: int = 0
    leader_addr: str | None = None   # host:port of the process group's TCPStore

    @property
    def is_leader(self) -> bool:
        return self.node_rank == 0


async def bootstrap_multihost(
    kv,
    config: MultiNodeConfig,
    *,
    barrier_id: str = "torch-bootstrap",
    coordinator_port: int = 8476,
    backend: str = "gloo",
    timeout: float = 300.0,
) -> None:
    """Rendezvous through ``kv`` (the control plane's key-value store), then
    ``init_process_group``: rank = node_rank, world = num_nodes.  No-op for
    a single node."""
    if config.num_nodes <= 1:
        return
    import torch.distributed as dist

    loop = asyncio.get_running_loop()

    def initialize(addr: str, rank: int) -> None:
        dist.init_process_group(backend, init_method=f"tcp://{addr}", rank=rank,
                                world_size=config.num_nodes,
                                timeout=timedelta(seconds=timeout))

    if config.is_leader:
        addr = config.leader_addr or \
            f"{socket.gethostbyname(socket.gethostname())}:{coordinator_port}"
        leader = LeaderBarrier(kv, barrier_id, num_workers=config.num_nodes - 1)
        # publish before initialising: the workers join while the leader waits
        sync_task = asyncio.ensure_future(leader.sync({"coordinator": addr}, timeout=timeout))
        try:
            await loop.run_in_executor(None, initialize, addr, 0)
        except BaseException:
            sync_task.cancel()
            raise
        await sync_task
    else:
        worker = WorkerBarrier(kv, barrier_id, worker_id=str(config.node_rank))
        data = await worker.sync(timeout=timeout)
        await loop.run_in_executor(None, initialize, data["coordinator"], config.node_rank)
    logger.info("multihost up: rank %d/%d over %s", config.node_rank, config.num_nodes, backend)
