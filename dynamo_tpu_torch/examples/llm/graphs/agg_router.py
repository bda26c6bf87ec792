"""Aggregated serving with KV-cache-aware routing: the frontend's model
watcher builds a KvPushRouter per model, fed by worker KV events
(reference: examples/llm/graphs/agg_router.py)."""

from __future__ import annotations

from dynamo_tpu_torch.runtime.client import RouterMode
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

from dynamo_tpu_torch.examples.llm.common import GraphHandle, LlmGraphConfig, launch_frontend, launch_workers


async def launch(rt: DistributedRuntime, cfg: LlmGraphConfig) -> GraphHandle:
    workers = await launch_workers(rt, cfg)
    frontend, watcher = await launch_frontend(rt, cfg, RouterMode.KV)
    return GraphHandle(frontend=frontend, watcher=watcher, workers=workers)
