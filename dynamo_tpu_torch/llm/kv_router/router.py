"""KvRouter: the routing decision plane.

Subscribes the component's KV-event and load-metrics subjects, feeds the
radix indexer and scheduler, and picks a worker per request (reference:
lib/llm/src/kv_router.rs:104 KvRouter, :220 KvPushRouter).
"""

from __future__ import annotations

import asyncio
from dynamo_tpu_torch.llm.kv_router.cost import TransferCostModel
from dynamo_tpu_torch.llm.kv_router.hashing import compute_block_hashes
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.llm.kv_router.protocols import (
    KV_EVENT_SUBJECT,
    KV_HIT_RATE_SUBJECT,
    LOAD_METRICS_SUBJECT,
    ForwardPassMetrics,
    KvHitRateEvent,
    RouterEvent,
)
from dynamo_tpu_torch.llm.kv_router.scheduler import KvRouterConfig, KvScheduler
from dynamo_tpu_torch.observability import get_recorder
from dynamo_tpu_torch.runtime.client import InstanceNotFound, PushRouter
from dynamo_tpu_torch.runtime.component import Component
from dynamo_tpu_torch.runtime.engine import Context, ResponseStream
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("llm.kv_router")


class KvRouter:
    """Indexer + scheduler fed by bus subscriptions."""

    def __init__(
        self,
        component: Component,
        *,
        block_size: int = 16,
        config: KvRouterConfig | None = None,
        enable_prefetch: bool | None = None,
    ):
        self.component = component
        self.block_size = block_size
        self.indexer = KvIndexer()
        self.scheduler = KvScheduler(config)
        # KV-locality/link-cost selection: fed link fields from the workers'
        # load metrics (transfer_hop + measured inbound bandwidth); until any
        # link is characterized, scheduling stays overlap/load-only
        self.cost_model = TransferCostModel()
        self.topology = None  # TopologyMap, via attach_topology()
        self._subs = []
        self._tasks: list[asyncio.Task] = []
        # predictive prefetch (prefetch/forwarder.py): hints forwarded to
        # the worker whose radix index holds the offloaded prefix, plus
        # session next-turn prediction.  None = DYN_PREFETCH env gate.
        from dynamo_tpu_torch.prefetch.hints import prefetch_enabled

        if enable_prefetch is None:
            enable_prefetch = prefetch_enabled()
        self.prefetch_forwarder = None
        if enable_prefetch:
            from dynamo_tpu_torch.prefetch.forwarder import PrefetchForwarder

            self.prefetch_forwarder = PrefetchForwarder(component, self.indexer)

    async def start(self) -> None:
        bus = self.component.runtime.plane.bus
        self.indexer.start()
        kv_sub = await bus.subscribe(self.component.event_subject(KV_EVENT_SUBJECT))
        load_sub = await bus.subscribe(self.component.event_subject(LOAD_METRICS_SUBJECT))
        self._subs = [kv_sub, load_sub]
        self._tasks = [
            spawn_logged(self._kv_loop(kv_sub)),
            spawn_logged(self._load_loop(load_sub)),
        ]
        if self.prefetch_forwarder is not None:
            await self.prefetch_forwarder.start()

    async def stop(self) -> None:
        if self.prefetch_forwarder is not None:
            await self.prefetch_forwarder.stop()
        for sub in self._subs:
            await sub.unsubscribe()
        for task in self._tasks:
            task.cancel()
        await self.indexer.stop()

    async def _kv_loop(self, sub) -> None:
        async for msg in sub:
            try:
                self.indexer.push(RouterEvent.from_json(msg.payload))
            except Exception:  # noqa: BLE001
                logger.exception("bad kv event")

    async def _load_loop(self, sub) -> None:
        async for msg in sub:
            try:
                metrics = ForwardPassMetrics.from_json(msg.payload)
                self.scheduler.update_metrics(metrics)
                self.cost_model.update_from_metrics(metrics)
            except Exception:  # noqa: BLE001
                logger.exception("bad load metrics")

    def attach_topology(self, topo_map) -> None:
        """Let the cost model resolve unknown links from the discovered
        fleet TopologyMap (no-op for selection until the map is
        informative — an all-local map changes nothing)."""
        self.topology = topo_map
        self.cost_model.attach_topology(topo_map)

    def remove_worker(self, worker_id: int) -> None:
        self.indexer.remove_worker(worker_id)
        self.scheduler.remove_worker(worker_id)
        self.cost_model.remove_worker(worker_id)

    async def schedule(self, token_ids: list[int], worker_ids: list[int]) -> tuple[int, int]:
        """Pick a worker for a tokenized request.  Returns
        (worker_id, matched_prefix_blocks)."""
        hashes = compute_block_hashes(token_ids, self.block_size)
        overlap = self.indexer.find_matches(hashes)
        costs = None
        if self.cost_model.known():
            # a candidate's transfer bill is the prefix blocks it does NOT
            # already hold, priced by its link (hop prior or measured bps)
            missing = {
                wid: len(hashes) - overlap.scores.get(wid, 0)
                for wid in worker_ids
            }
            costs = self.cost_model.costs(worker_ids, missing)
        worker_id, ratio = self.scheduler.select_worker(
            worker_ids, overlap, len(hashes), transfer_costs=costs
        )
        matched = overlap.scores.get(worker_id, 0)
        # hit-rate observability event (best-effort)
        try:
            await self.component.runtime.plane.bus.publish(
                self.component.event_subject(KV_HIT_RATE_SUBJECT),
                KvHitRateEvent(
                    worker_id=worker_id, isl_blocks=len(hashes), overlap_blocks=matched
                ).to_json(),
            )
        except Exception:  # noqa: BLE001
            pass
        return worker_id, matched


class KvPushRouter:
    """AsyncEngine facade: schedules KV-aware, then dispatches direct to the
    chosen instance through a PushRouter (wire-dict PreprocessedRequests)."""

    def __init__(self, push_router: PushRouter, kv_router: KvRouter):
        self.push_router = push_router
        self.kv_router = kv_router

    def _candidates(self, tried: set[int]) -> list[int]:
        """Schedulable workers under PushRouter's shared routing policy
        (exclusion hard, quarantine soft): a dead worker stays in the
        instance view until its lease is reaped and would win tie-breaks
        again, costing every affine request a connect timeout."""
        return self.push_router.healthy_ids(tried)

    async def generate(self, request: Context[dict]) -> ResponseStream[dict]:
        token_ids = request.data.get("token_ids", [])
        # re-schedule-excluding-failed failover: direct dispatch disables
        # PushRouter's own re-pick (affinity must stay with the scheduler),
        # so a silently-dead worker — lease not yet reaped, subject dark —
        # is excluded here and the scheduler picks the next-best cache fit
        tried: set[int] = set()
        last_err: Exception | None = None
        while True:
            worker_ids = self._candidates(tried)
            if not worker_ids:
                raise last_err or RuntimeError(
                    "no instances available for kv-routed dispatch"
                )
            # routing-decision span: which worker, how much prefix it holds
            span = get_recorder().start(
                "router.schedule", getattr(request.ctx, "trace", None),
                component="router", attrs={"candidates": len(worker_ids)},
            )
            try:
                worker_id, matched = await self.kv_router.schedule(token_ids, worker_ids)
            except BaseException as exc:
                if span is not None:
                    span.end(status="error", error=repr(exc))
                raise
            if span is not None:
                span.end(worker=f"{worker_id:x}", overlap_blocks=matched)
            request.data["estimated_prefix_hit_blocks"] = matched
            try:
                return await self.push_router.generate(request, instance_id=worker_id)
            # InstanceNotFound: the worker deregistered between the
            # instance_ids snapshot and dispatch — same remedy as a dark
            # worker (which PushRouter already quarantined): reschedule.
            # Deliberately NOT a broad RuntimeError — a systemic plane
            # failure must surface, not darken the whole fleet worker by
            # worker.
            except (TimeoutError, InstanceNotFound) as err:
                tried.add(worker_id)
                last_err = err
                # drop the worker's blocks/load from the router state so
                # FOLLOWING requests don't also pay the timeout to discover
                # it (self-healing: a live worker's next KV event / metrics
                # publish re-adds it)
                self.kv_router.remove_worker(worker_id)
                logger.warning(
                    "kv-routed worker %x dark (%s); rescheduling", worker_id, err
                )
