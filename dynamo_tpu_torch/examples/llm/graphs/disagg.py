"""Disaggregated prefill/decode: decode worker with remote-prefill decision,
prefill workers pumping the shared queue, KV blocks shipped decode←prefill
(reference: examples/llm/graphs/disagg.py)."""

from __future__ import annotations

from dynamo_tpu_torch.llm.disagg import PrefillQueue
from dynamo_tpu_torch.runtime.client import RouterMode
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

from dynamo_tpu_torch.examples.llm.common import (
    GraphHandle,
    LlmGraphConfig,
    launch_disagg_decode_worker,
    launch_frontend,
    launch_prefill_workers,
)


async def launch(
    rt: DistributedRuntime, cfg: LlmGraphConfig, router_mode: RouterMode = RouterMode.ROUND_ROBIN
) -> GraphHandle:
    queue = PrefillQueue(rt, rt.config.namespace, "backend")
    decode = await launch_disagg_decode_worker(rt, cfg, queue)
    prefills = await launch_prefill_workers(rt, cfg, queue)
    frontend, watcher = await launch_frontend(rt, cfg, router_mode)
    return GraphHandle(
        frontend=frontend, watcher=watcher, workers=[decode], extras=prefills
    )
