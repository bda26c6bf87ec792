"""KV-cache-aware routing.

The feedback loop (reference: SURVEY.md §3.3, lib/llm/src/kv_router/):
engines publish block stored/removed events + load metrics onto the bus; the
router maintains a global radix index of block hashes per worker and a load
view, and scores workers as

    logit = overlap_weight * overlap_norm
          - usage_weight * cache_usage
          - waiting_weight * waiting_norm
          - transfer_cost_weight * transfer_cost

(reference: lib/llm/src/kv_router/scheduler.rs:248-330, weights
kv_router.rs:59-82), picking the argmax with random tie-break.  The
``transfer_cost`` term is the normalized KV-transfer cost of the missing
prefix blocks over the candidate's link (cost.TransferCostModel: ICI-vs-DCN
hop class + measured bandwidth EWMA); it is zero until any worker's link
has been characterized.
"""

from dynamo_tpu_torch.llm.kv_router.cost import LinkEstimate, TransferCostModel
from dynamo_tpu_torch.llm.kv_router.hashing import compute_block_hashes
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, RadixTree
from dynamo_tpu_torch.llm.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    OverlapScores,
    RouterEvent,
)
from dynamo_tpu_torch.llm.kv_router.scheduler import KvRouterConfig, KvScheduler
from dynamo_tpu_torch.llm.kv_router.router import KvPushRouter, KvRouter

__all__ = [
    "compute_block_hashes",
    "ForwardPassMetrics",
    "KvCacheEvent",
    "KvIndexer",
    "KvPushRouter",
    "KvRouter",
    "KvRouterConfig",
    "KvScheduler",
    "LinkEstimate",
    "OverlapScores",
    "RadixTree",
    "RouterEvent",
    "TransferCostModel",
]
