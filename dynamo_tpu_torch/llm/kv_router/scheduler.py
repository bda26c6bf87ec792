"""KV-aware worker selection.

Scoring (reference: lib/llm/src/kv_router/scheduler.rs:202-330, weights
lib/llm/src/kv_router.rs:59-82):

    logit = overlap_weight * (matched_blocks / request_blocks)
          - usage_weight   * cache_usage
          - waiting_weight * (waiting / total_slots)
          - transfer_cost_weight * transfer_cost        # 0 when unknown

argmax with random tie-break.  ``transfer_cost`` is the normalized
KV-transfer cost of the candidate's missing prefix blocks over its link
(kv_router/cost.TransferCostModel — NetKV-style selection); the router
passes None until any link has been characterized, leaving selection
exactly overlap/load-driven.  Load comes from ForwardPassMetrics events
pushed by workers; staleness beyond ``metrics_ttl`` zeroes a worker's load
contribution rather than excluding it (prefer availability).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics, OverlapScores
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("llm.kv_router.scheduler")


@dataclass
class KvRouterConfig:
    overlap_score_weight: float = 2.0
    gpu_cache_usage_weight: float = 1.0
    waiting_requests_weight: float = 1.0
    metrics_ttl_s: float = 10.0
    # weight on the normalized estimated KV-transfer cost of the missing
    # prefix blocks over the candidate's link (ICI-vs-DCN hop class +
    # measured bandwidth); only applies when the router's cost model has
    # link information for at least one worker
    transfer_cost_weight: float = 1.0


class KvScheduler:
    def __init__(self, config: KvRouterConfig | None = None, *, rng: random.Random | None = None):
        self.config = config or KvRouterConfig()
        self._metrics: dict[int, tuple[ForwardPassMetrics, float]] = {}
        self._rng = rng or random.Random()

    # -- load view ---------------------------------------------------------
    def update_metrics(self, metrics: ForwardPassMetrics) -> None:
        self._metrics[metrics.worker_id] = (metrics, time.monotonic())

    def remove_worker(self, worker_id: int) -> None:
        self._metrics.pop(worker_id, None)

    def _load(self, worker_id: int) -> tuple[float, float]:
        """(cache_usage, waiting_norm) with staleness handling."""
        entry = self._metrics.get(worker_id)
        if entry is None:
            return 0.0, 0.0
        metrics, stamp = entry
        if time.monotonic() - stamp > self.config.metrics_ttl_s:
            return 0.0, 0.0
        waiting_norm = (
            metrics.num_requests_waiting / metrics.request_total_slots
            if metrics.request_total_slots
            else float(metrics.num_requests_waiting)
        )
        return metrics.gpu_cache_usage_perc, waiting_norm

    # -- selection ---------------------------------------------------------
    def select_worker(
        self,
        worker_ids: list[int],
        overlap: OverlapScores,
        request_blocks: int,
        transfer_costs: dict[int, float] | None = None,
    ) -> tuple[int, float]:
        """Returns (worker_id, matched_block_ratio_of_winner).

        ``transfer_costs``: normalized [0,1] per-candidate KV-transfer cost
        (TransferCostModel.costs); None or a missing key contributes 0."""
        if not worker_ids:
            raise RuntimeError("no workers available")
        cfg = self.config
        best: list[int] = []
        best_logit = float("-inf")
        denom = max(request_blocks, 1)
        for wid in worker_ids:
            overlap_norm = overlap.scores.get(wid, 0) / denom
            usage, waiting = self._load(wid)
            logit = (
                cfg.overlap_score_weight * overlap_norm
                - cfg.gpu_cache_usage_weight * usage
                - cfg.waiting_requests_weight * waiting
            )
            if transfer_costs is not None:
                logit -= cfg.transfer_cost_weight * transfer_costs.get(wid, 0.0)
            if logit > best_logit + 1e-12:
                best, best_logit = [wid], logit
            elif abs(logit - best_logit) <= 1e-12:
                best.append(wid)
        winner = self._rng.choice(best)
        return winner, overlap.scores.get(winner, 0) / denom
