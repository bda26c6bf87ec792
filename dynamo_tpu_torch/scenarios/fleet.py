"""SoakFleet: a live, scalable mocker fleet for scenario soaks.

Named pools ("prefill"/"decode") of MockerEngine (or, with
``FleetSpec.engine="torch"``, TorchLlmEngine) workers served on one
control-plane endpoint with real KV-event and load publishers, dispatched
through PushRouter (optionally KV-affine via KvRouter), with a real
in-process MetricsService and a minimal frontend surface exposing
``/slo`` + ``/metrics`` — so ``scripts.dyn_top.collect_snapshot`` works
against the soak exactly as against production.

The fleet IS the planner's supervisor: it implements the
``set_replicas(name, n)`` / ``replica_count(name)`` duck-type that
``planner.connectors.LocalConnector`` drives, spawning and retiring live
workers mid-soak.  That closes the loop the soak exists to prove — a
planner decision becomes real capacity while traffic is in flight.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from aiohttp import web

from dynamo_tpu_torch.components.metrics_service import MetricsService
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher, WorkerMetricsPublisher
from dynamo_tpu_torch.llm.kv_router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.llm.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.observability.slo import SloTracker
from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.runtime.client import PushRouter, RouterMode
from dynamo_tpu_torch.runtime.controlplane.memory import MemoryControlPlane
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.scenarios.spec import ScenarioSpec
from dynamo_tpu_torch.utils.config import RuntimeConfig
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("scenarios.fleet")


@dataclass
class _Worker:
    pool: str
    engine: object                  # MockerEngine or TorchLlmEngine
    service: object
    kv_pub: KvEventPublisher
    metrics_pub: WorkerMetricsPublisher
    slice_label: str = ""

    @property
    def worker_id(self) -> int:
        return self.service.instance.instance_id


@dataclass
class SoakFleet:
    spec: ScenarioSpec
    slo: SloTracker
    sim_now: object                     # () -> simulated seconds
    name: str = "soak"

    rt: DistributedRuntime = None
    comp: object = None
    ep: object = None
    dispatcher: object = None
    push: PushRouter = None
    kv_router: KvRouter | None = None
    metrics_service: MetricsService | None = None
    frontend_url: str = ""
    worker_url: str = ""
    _pools: dict = field(default_factory=dict)     # pool → [_Worker]
    _frontend_runner: web.AppRunner | None = None
    _scale_lock: asyncio.Lock = field(default_factory=asyncio.Lock)
    scale_log: list = field(default_factory=list)  # executed scale ops
    # multi-slice emulation (FleetSpec.slices): per-worker selection counts
    # from the router's hit-rate events + the discovered TopologyMap
    topo_watch: object = None
    near_slice: str = ""
    selection_counts: dict = field(default_factory=dict)  # worker_id → picks
    _spawned: dict = field(default_factory=dict)   # pool → spawn counter
    # torch engine mode: the model (None = LlamaConfig.llama3_8b on the
    # card, LlamaConfig.tiny on the CPU) and the device every worker runs on
    # (None = the CUDA card, "cpu" for tests)
    model_config: object = None
    device: str | None = None
    # torch engine mode: one param init on the device shared by every worker
    # (engines never mutate params, and N random inits would hold N copies)
    _params_cache: dict = field(default_factory=dict)
    _slice_by_worker: dict = field(default_factory=dict)  # survives retirement
    _hit_sub: object = None
    _hit_task: object = None

    # -- bring-up / teardown -------------------------------------------------
    async def start(self) -> None:
        fl = self.spec.fleet
        MemoryControlPlane.reset_named()
        self.rt = await DistributedRuntime.create(
            RuntimeConfig(control_plane=f"memory://{self.name}")
        )
        self.comp = self.rt.namespace("soak").component("backend")
        self.ep = self.comp.endpoint("generate")
        if fl.slices:
            # NEAR = the prefill pool's slice: decode selection is judged by
            # how far the prefix blocks must travel from where prefill ran
            labels = fl.slices.get("prefill") or next(iter(fl.slices.values()))
            self.near_slice = labels[0]
        for pool, n in fl.pools.items():
            self._pools[pool] = []
            for _ in range(n):
                self._pools[pool].append(await self._spawn(pool))
        self.push = await PushRouter.from_endpoint(self.ep, mode=RouterMode.RANDOM)
        if fl.policy == "kv":
            self.kv_router = KvRouter(
                self.comp, block_size=fl.block_size, enable_prefetch=False
            )
            await self.kv_router.start()
            self.dispatcher = KvPushRouter(self.push, self.kv_router)
        else:
            self.dispatcher = self.push
        await self.push.client.wait_for_instances(self.worker_count(), timeout=10)

        if fl.slices:
            await self._start_topology()

        # real metrics service (scrapeable by dyn_top / check_metrics)
        self.metrics_service = MetricsService(self.comp, host="127.0.0.1", port=0)
        if self.topo_watch is not None:
            self.metrics_service.attach_topology(self.topo_watch.map)
        await self.metrics_service.start()
        self.worker_url = f"http://127.0.0.1:{self.metrics_service.port}"

        # minimal frontend surface: /slo + /metrics on the simulated clock
        app = web.Application()
        app.router.add_get("/slo", self._handle_slo)
        app.router.add_get("/metrics", self._handle_metrics)
        self._frontend_runner = web.AppRunner(app, access_log=None)
        await self._frontend_runner.setup()
        site = web.TCPSite(self._frontend_runner, "127.0.0.1", 0)
        await site.start()
        port = next(iter(site._server.sockets)).getsockname()[1]
        self.frontend_url = f"http://127.0.0.1:{port}"

    async def stop(self) -> None:
        if self._frontend_runner is not None:
            await self._frontend_runner.cleanup()
        if self.metrics_service is not None:
            await self.metrics_service.stop()
        if self._hit_task is not None:
            self._hit_task.cancel()
        if self._hit_sub is not None:
            await self._hit_sub.unsubscribe()
        if self.topo_watch is not None:
            await self.topo_watch.stop()
        if self.kv_router is not None:
            await self.kv_router.stop()
        for pool in list(self._pools):
            for worker in self._pools[pool]:
                await self._retire(worker)
            self._pools[pool] = []
        if self.rt is not None:
            await self.rt.close()

    # -- topology plane (FleetSpec.slices) -----------------------------------
    async def _start_topology(self) -> None:
        """Discover the emulated multi-slice fleet and wire its consumers:
        the KV router prices candidates by discovered link class, and the
        router's per-request hit-rate events feed the near-slice selection
        ledger the ``min_near_slice_fraction`` assertion reads."""
        from dynamo_tpu_torch.llm.kv_router.protocols import (
            KV_HIT_RATE_SUBJECT,
            KvHitRateEvent,
        )
        from dynamo_tpu_torch.topology import TopologyWatcher, local_card
        from dynamo_tpu_torch.utils.tasks import spawn_logged

        self.topo_watch = TopologyWatcher(self.rt)
        await self.topo_watch.start()
        await self._await_nodes()
        if len(self.topo_watch.map.nodes) < self.worker_count():
            # DYN_TOPO is off, so the workers didn't self-publish — the spec
            # asked for slices explicitly, so publish their cards here
            for pool, ws in self._pools.items():
                for w in ws:
                    card = local_card(
                        w.worker_id, role=pool,
                        slice_label=w.slice_label or None,
                    )
                    await self.rt.plane.kv.put(
                        card.key(), card.to_json(), w.service._lease.id
                    )
            await self._await_nodes()
        if self.kv_router is not None:
            self.kv_router.attach_topology(self.topo_watch.map)
        self._hit_sub = await self.rt.plane.bus.subscribe(
            self.comp.event_subject(KV_HIT_RATE_SUBJECT)
        )

        async def _count() -> None:
            async for msg in self._hit_sub:
                try:
                    ev = KvHitRateEvent.from_json(msg.payload)
                except Exception:  # noqa: BLE001
                    continue
                self.selection_counts[ev.worker_id] = (
                    self.selection_counts.get(ev.worker_id, 0) + 1
                )

        self._hit_task = spawn_logged(_count())

    async def _await_nodes(self) -> None:
        for _ in range(200):
            if len(self.topo_watch.map.nodes) >= self.worker_count():
                return
            await asyncio.sleep(0.01)

    def slice_of(self, worker_id: int) -> str:
        return self._slice_by_worker.get(worker_id, "")

    # -- frontend surface ----------------------------------------------------
    async def _handle_slo(self, request: web.Request) -> web.Response:
        return web.json_response(self.slo.status(self.sim_now()))

    async def _handle_metrics(self, request: web.Request) -> web.Response:
        body = self.slo.render(self.sim_now()) + counters.render()
        return web.Response(body=body, content_type="text/plain")

    # -- worker lifecycle ----------------------------------------------------
    def _mocker_config(self, pool: str) -> MockerConfig:
        fl = self.spec.fleet
        overrides = dict(fl.mocker)
        return MockerConfig(
            num_blocks=fl.num_blocks,
            block_size=fl.block_size,
            max_batch_size=fl.max_batch_size,
            speedup=self.spec.speedup,
            role=pool,
            **overrides,
        )

    def _torch_engine(self):
        """A real TorchLlmEngine worker (FleetSpec.engine='torch'): the actual
        model/scheduler/allocator hot path behind the same endpoint surface
        the mocker serves, so one scenario spec drives either."""
        import torch

        from dynamo_tpu_torch.device import resolve_device
        from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
        from dynamo_tpu_torch.models.llama import LlamaConfig, init_params

        fl = self.spec.fleet
        dev = resolve_device(self.device)
        mcfg = self.model_config or (
            LlamaConfig.llama3_8b() if dev.type == "cuda" else LlamaConfig.tiny()
        )
        if "params" not in self._params_cache:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            self._params_cache["params"] = init_params(mcfg, gen, device=dev)
        # bucket ladder sized to the context window (routed_fleet idiom):
        # every serving program is warmed before traffic, so fewer buckets
        # = faster bring-up, and the top bucket covers max_model_len
        buckets = tuple(
            b for b in (128, 256, 512, 1024, 2048) if b < fl.max_model_len
        ) + (fl.max_model_len,)
        return TorchLlmEngine(
            EngineConfig(
                model=mcfg,
                num_blocks=fl.num_blocks,
                block_size=fl.block_size,
                max_batch_size=fl.max_batch_size,
                prefill_buckets=buckets,
                max_model_len=fl.max_model_len,
            ),
            params=self._params_cache["params"],
            device=dev,
        )

    async def _spawn(self, pool: str) -> _Worker:
        fl = self.spec.fleet
        slice_label = ""
        labels = fl.slices.get(pool) or []
        if labels:
            slice_label = labels[self._spawned.get(pool, 0) % len(labels)]
        self._spawned[pool] = self._spawned.get(pool, 0) + 1
        if fl.engine == "torch":
            engine = self._torch_engine()
        else:
            cfg = self._mocker_config(pool)
            if slice_label:
                # mocker-side per-pair latency: a worker off the prefill
                # slice pays the DCN-class transfer bill on every prefill
                far = bool(self.near_slice) and slice_label != self.near_slice
                hop = "dcn" if far else "local"
                cfg.transfer_delay_s = float(
                    fl.link_delay_s.get(hop, cfg.transfer_delay_s)
                )
            engine = MockerEngine(cfg)
        service = await self.ep.serve(
            engine, stats_handler=engine.stats,
            topo_role=pool, topo_slice=slice_label or None,
        )
        self._slice_by_worker[service.instance.instance_id] = slice_label
        kv_pub = KvEventPublisher(self.comp, worker_id=service.instance.instance_id)
        kv_pub.start()
        engine._event_sink = kv_pub.sink
        metrics_pub = WorkerMetricsPublisher(
            self.comp, service.instance.instance_id, engine.stats,
            period_s=self.spec.fleet.metrics_period_s / self.spec.speedup,
        )
        metrics_pub.start()
        engine.start()
        if fl.engine == "torch":
            # capture every serving graph before traffic: lazy captures
            # mid-phase would dominate TTFT and fail the SLO assertions
            # for reasons that have nothing to do with the system under test
            await engine.warmup()
        return _Worker(pool, engine, service, kv_pub, metrics_pub, slice_label)

    async def _retire(self, worker: _Worker) -> None:
        # graceful scale-down IS the drain state machine: admissions stop,
        # stragglers hand off via resume-redispatch instead of being killed
        await worker.service.drain(2.0)
        # the drain leaves the service's control loop up to publish its reply;
        # close it too, so no task holds the stopped engine (and with it the
        # engine's cache and graph pool on the card)
        await worker.service.shutdown()
        await worker.metrics_pub.stop()
        await worker.kv_pub.stop()
        worker.engine.stop()

    async def kill_worker(self, pool: str, *, mode: str = "kill") -> int | None:
        """Chaos seam for worker-kill scenarios: take one live worker out of
        ``pool`` mid-soak.  ``kill`` is abrupt (lease revoked, handlers
        cancelled mid-stream — the dispatcher's generation journal must
        resume those streams on a peer); ``drain`` runs the graceful state
        machine.  Returns the removed worker id, or None if the pool is
        empty."""
        async with self._scale_lock:
            workers = self._pools.get(pool) or []
            if not workers:
                return None
            # oldest first: it holds the most in-flight work and the
            # warmest KV — the hardest worker to lose
            worker = workers.pop(0)
        if mode == "drain":
            await worker.service.drain()
            await worker.service.shutdown()  # its control loop, as _retire
        else:
            await worker.service.abort()
        await worker.metrics_pub.stop()
        await worker.kv_pub.stop()
        worker.engine.stop()
        self.scale_log.append(
            {"t": self.sim_now(), "pool": pool, "op": mode,
             "worker": f"{worker.worker_id:x}"}
        )
        return worker.worker_id

    # -- planner supervisor duck-type (connectors.LocalConnector) ------------
    def replica_count(self, pool: str) -> int:
        return len(self._pools.get(pool, []))

    def worker_count(self) -> int:
        return sum(len(ws) for ws in self._pools.values())

    async def set_replicas(self, pool: str, n: int) -> None:
        async with self._scale_lock:
            workers = self._pools.setdefault(pool, [])
            before = len(workers)
            if n == before:
                return
            if n > before:
                for _ in range(n - before):
                    workers.append(await self._spawn(pool))
                try:
                    await self.push.client.wait_for_instances(
                        self.worker_count(), timeout=5
                    )
                except TimeoutError:
                    logger.warning("scale-up of %s not fully visible yet", pool)
            else:
                # retire newest-first: the oldest workers hold the warmest
                # KV and the most session affinity
                while len(workers) > n:
                    await self._retire(workers.pop())
            self.scale_log.append(
                {"t": self.sim_now(), "pool": pool, "from": before, "to": n}
            )
            logger.info("pool %s: %d → %d replicas", pool, before, n)

    # -- sampling ------------------------------------------------------------
    def roles(self) -> dict[int, str]:
        return {
            w.worker_id: pool
            for pool, ws in self._pools.items() for w in ws
        }

    def stat_sum(self, key: str) -> float:
        return sum(
            w.engine.stats().get(key, 0)
            for ws in self._pools.values() for w in ws
        )
