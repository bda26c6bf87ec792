"""Disaggregated prefill/decode + KV-aware routing at the frontend
(reference: examples/llm/graphs/disagg_router.py:16-24)."""

from __future__ import annotations

from dynamo_tpu_torch.runtime.client import RouterMode
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

from dynamo_tpu_torch.examples.llm.common import GraphHandle, LlmGraphConfig
from dynamo_tpu_torch.examples.llm.graphs import disagg


async def launch(rt: DistributedRuntime, cfg: LlmGraphConfig) -> GraphHandle:
    return await disagg.launch(rt, cfg, router_mode=RouterMode.KV)
