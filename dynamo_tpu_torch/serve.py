"""Serving assembly for the port (counterpart of dynamo_tpu/serve.py).

``serve_worker`` = engine + endpoint + model registration + KV/metrics
publishers (what the reference's engine subprocesses do on startup);
``serve_frontend`` = HTTP service + model watcher (the ``in=http`` frontend).
Both run over a ``DistributedRuntime``: the memory control plane in one
process, or a ``dynctl serve`` control-plane server across processes.

``serve_http`` wires HTTP → preprocessor → backend → engine in one process,
with no runtime between them.
"""

from __future__ import annotations

import asyncio
import json
import signal
from dataclasses import dataclass
from pathlib import Path

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.discovery import ModelWatcher, register_llm
from dynamo_tpu_torch.llm.engines import EchoEngineCore
from dynamo_tpu_torch.llm.http import HttpService, ModelManager
from dynamo_tpu_torch.llm.hub import resolve_model
from dynamo_tpu_torch.llm.kv_router.publisher import (
    ClearKvListener,
    KvEventPublisher,
    WorkerMetricsPublisher,
)
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import ChatPreprocessor, CompletionPreprocessor
from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
from dynamo_tpu_torch.runtime.client import RouterMode
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("serve")


@dataclass
class WorkerHandle:
    service: object
    engine: object
    publishers: list
    _closed: bool = False

    async def shutdown(self) -> None:
        await self.service.shutdown()
        await self._close()

    async def drain(self, timeout_s: float | None = None) -> dict:
        """Gracefully empty this worker: admissions stop at once, in-flight
        requests finish or hand off (resume-redispatch), the lease is
        revoked — then the engine stops."""
        result = await self.service.drain(timeout_s)
        await self._close()
        return result

    async def _close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for pub in self.publishers:
            await pub.stop()
        if hasattr(self.engine, "stop"):
            self.engine.stop()


def install_drain_on_sigterm(handle: WorkerHandle, *, timeout_s: float | None = None):
    """Opt-in SIGTERM → graceful drain for CLI launch paths.  Must run on
    the main thread of a live event loop (``loop.add_signal_handler``
    constraint), so library/test embedders call ``handle.drain()``
    directly instead.  Returns the scheduled drain task holder (a
    one-element list filled when the signal fires)."""
    loop = asyncio.get_running_loop()
    fired: list = []

    def _on_term() -> None:
        if not fired:
            logger.info("SIGTERM: draining worker before exit")
            fired.append(spawn_logged(handle.drain(timeout_s), name="sigterm-drain"))

    try:
        loop.add_signal_handler(signal.SIGTERM, _on_term)
    except (NotImplementedError, RuntimeError) as exc:
        logger.warning("SIGTERM drain handler unavailable: %r", exc)
    return fired


def build_torch_engine(
    model_dir: str | Path, mdc: ModelDeploymentCard, *, device=None, params=None,
    **overrides,
):
    """A TorchLlmEngine from a local model dir: ``config.json``, weights
    from ``params`` when given (engines of one process sharing a set),
    else from safetensors when present, else random-initialized on the
    device from the engine seed.  ``overrides`` go to EngineConfig, but for
    ``warmup``, a launch-time behaviour that callers read back as
    ``engine.wants_warmup`` after ``start()`` (as the reference's
    ``build_jax_engine`` pops it).  Runs on the CUDA card unless
    ``device="cpu"``.  Guided JSON decoding is enabled from the model
    directory's tokenizer wherever the engine can guide (every launch path
    then serves ``response_format: json_object``); a table that fails to
    build is logged and the engine serves unguided, refusing guided
    requests one by one.  ``mesh=MeshConfig(tp=..., ep=..., pp=..., sp=...)``
    (an override like any other) serves on a mesh: the engine is rank 0
    and starts its shard workers; the checkpoint is read into host memory
    and reaches the ranks one leaf at a time, each keeping its slice, so no
    card holds the whole model."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
    from dynamo_tpu_torch.models.registry import get_family, known_families

    dev = resolve_device(device)
    model_dir = Path(model_dir)
    hf_config = json.loads((model_dir / "config.json").read_text())
    model_type = hf_config.get("model_type", "llama")
    family_name = model_type if model_type in known_families() else "llama"
    family = get_family(family_name)
    cfg = family.config_from_hf(hf_config)
    defaults = dict(
        model=cfg,
        model_family=family_name,
        block_size=mdc.kv_block_size,
        num_blocks=overrides.pop("num_blocks", 256),
        max_batch_size=overrides.pop("max_batch_size", 8),
        max_model_len=overrides.pop("max_model_len", mdc.context_length),
    )
    wants_warmup = bool(overrides.pop("warmup", False))
    defaults.update(overrides)
    config = EngineConfig(**defaults)
    on_mesh = config.mesh is not None and config.mesh.total() > 1
    if params is None and family.load_weights is not None:
        try:
            params = family.load_weights(cfg, model_dir, "cpu" if on_mesh else dev)
            logger.info("loaded weights from %s", model_dir)
        except FileNotFoundError:
            logger.warning("no safetensors in %s — random-initializing weights", model_dir)
    engine = TorchLlmEngine(config, params=params, device=dev)
    engine.wants_warmup = wants_warmup
    # guided JSON decoding needs the tokenizer-compiled mask table; enabled
    # here so EVERY launch path (serve_worker, serve_http, the CLI, the
    # disaggregated workers) supports response_format json_object.  Engines
    # that cannot guide (fused decode, speculation) still serve and refuse
    # guided requests one by one; a failed table build serves unguided.
    if config.decode_steps <= 1 and not engine.spec_enabled:
        try:
            engine.enable_guided_json(HfTokenizer.from_model_dir(model_dir))
        except Exception as exc:  # noqa: BLE001 — serving works unguided
            logger.warning("guided-json table build failed: %r", exc)
    return engine


async def serve_worker(
    runtime: DistributedRuntime,
    model_dir: str | Path,
    *,
    model_name: str | None = None,
    namespace: str | None = None,
    component: str = "backend",
    endpoint: str = "generate",
    engine_kind: str = "torch",
    model_types: list[str] | None = None,
    device=None,
    warmup_prompt_lens=None,
    **engine_overrides,
) -> WorkerHandle:
    """Serve a model on an endpoint and register it (worker side).

    ``engine_kind="torch"`` builds a TorchLlmEngine (on the card unless
    ``device="cpu"``; ``engine_overrides`` go to EngineConfig, ``warmup=True``
    captures every serving graph before the model registers, and
    ``warmup_prompt_lens`` narrows the split prefill's keys as in
    ``serve_http``); ``"echo"`` the token echo engine; ``"mocker"`` the
    simulated engine (``llm/mocker.py``: the real allocator and scheduler, a
    cost model in place of the device), publishing KV events and load
    metrics as a torch worker does.  The KV event,
    load-metrics and cache-flush publishers are wired before the engine
    starts, so no early event is lost; the model registers last, so a
    frontend's pipeline appears only once the engine is warm.  ``model_dir``
    is a local directory or a hub repo id (``org/name``), resolved through
    the cache (``llm/hub.py`` ``resolve_model``) off the event loop: a
    download takes minutes, and other endpoints of this runtime keep
    running."""
    model_dir = await asyncio.to_thread(resolve_model, model_dir)
    mdc = ModelDeploymentCard.from_local_path(model_dir, name=model_name)
    ep = runtime.namespace(namespace).component(component).endpoint(endpoint)

    publishers: list = []
    if engine_kind == "echo":
        engine = EchoEngineCore()
        service = await ep.serve(engine)
    elif engine_kind == "mocker":
        from dynamo_tpu_torch.llm.mocker import MockerConfig, MockerEngine

        engine = MockerEngine(MockerConfig(block_size=mdc.kv_block_size))
        service = await ep.serve(engine, stats_handler=engine.stats)
        # mockers exist to exercise routers at scale, so they publish the
        # same KV events + load metrics as the real engine (the mocker's
        # allocator is the real BlockAllocator — its stored/removed events
        # feed the KV router's radix index exactly like serving traffic).
        # Same wiring order as the torch branch: sink attached BEFORE the
        # engine loop starts, so no early request's events are dropped.
        kv_pub = KvEventPublisher(ep.component, worker_id=service.instance.instance_id)
        kv_pub.start()
        engine._event_sink = kv_pub.sink
        metrics_pub = WorkerMetricsPublisher(
            ep.component, service.instance.instance_id, engine.stats
        )
        metrics_pub.start()
        publishers = [kv_pub, metrics_pub]
        engine.start()
    elif engine_kind == "torch":
        # built off the event loop: weight loading takes seconds and a G4
        # remote tier's mount does blocking TCP — heartbeats and endpoints
        # on this loop must keep running meanwhile
        engine = await asyncio.to_thread(
            build_torch_engine, model_dir, mdc, device=device, **engine_overrides
        )
        service = await ep.serve(engine, stats_handler=engine.stats)
        kv_pub = KvEventPublisher(ep.component, worker_id=service.instance.instance_id)
        kv_pub.start()
        engine._event_sink = kv_pub.sink
        metrics_pub = WorkerMetricsPublisher(
            ep.component, service.instance.instance_id, engine.stats
        )
        metrics_pub.start()
        clear_listener = ClearKvListener(ep.component, engine)
        clear_listener.start()
        publishers = [kv_pub, metrics_pub, clear_listener]
        if engine.prefetch_pager is not None:
            # the router's targeted hints reach this engine's pager
            from dynamo_tpu_torch.prefetch.worker import PrefetchListener

            prefetch_listener = PrefetchListener(
                ep.component, engine, service.instance.instance_id
            )
            prefetch_listener.start()
            publishers.append(prefetch_listener)
        engine.start()
        if engine.wants_warmup:
            # capture every serving graph before the model registers: the
            # first user request must not pay a capture
            try:
                await engine.warmup(warmup_prompt_lens)
            except BaseException:
                await WorkerHandle(service, engine, publishers).shutdown()
                raise
    else:
        raise ValueError(f"unknown engine kind {engine_kind!r} (want torch|echo|mocker)")

    await register_llm(service, mdc, model_types=model_types)
    return WorkerHandle(service=service, engine=engine, publishers=publishers)


@dataclass
class DisaggWorkerHandle:
    """A disaggregated decode worker: its endpoint service, the
    ``DisaggDecodeEngine`` wrapper and its ``DisaggRouter``."""
    service: object
    engine: object
    router: object

    async def shutdown(self) -> None:
        await self.service.shutdown()
        await self.engine.stop()
        await self.router.stop()
        self.engine.engine.stop()


@dataclass
class PrefillHandle:
    """One prefill engine and the pump that feeds it from the queue; with
    the topology plane on, the lease its card lives under and the map its
    prober measures."""
    pump: object
    engine: object
    runtime: object = None
    lease: object = None
    watcher: object = None

    async def stop(self) -> None:
        await self.pump.stop()
        if self.watcher is not None:
            await self.watcher.stop()
        if self.lease is not None:
            await self.runtime.plane.kv.revoke_lease(self.lease)  # the card goes
        self.engine.stop()


async def launch_disagg_decode_worker(
    runtime: DistributedRuntime,
    model_dir: str | Path,
    queue,
    *,
    model_name: str | None = None,
    max_local_prefill_length: int = 512,
    max_prefill_queue_size: int = 16,
    device=None,
    params=None,
    **engine_overrides,
) -> DisaggWorkerHandle:
    """The decode worker of a disaggregated pair (the reference's
    ``examples/llm/common.py`` ``launch_disagg_decode_worker``): a
    TorchLlmEngine behind the remote-prefill decision wrapper, its KV
    transfer server started, warmed when ``warmup=True``, served on
    ``backend.generate`` with its topology card naming the transfer
    address, and the model registered."""
    from dynamo_tpu_torch.llm.disagg import DisaggConfig, DisaggDecodeEngine, DisaggRouter

    model_dir = Path(model_dir)
    mdc = ModelDeploymentCard.from_local_path(model_dir, name=model_name)
    engine = await asyncio.to_thread(
        build_torch_engine, model_dir, mdc, device=device, params=params, **engine_overrides
    )
    disagg_router = DisaggRouter(runtime, mdc.name, DisaggConfig(
        max_local_prefill_length=max_local_prefill_length,
        max_prefill_queue_size=max_prefill_queue_size,
    ))
    await disagg_router.start()
    decode = DisaggDecodeEngine(runtime, engine, disagg_router, queue)
    await decode.start()
    engine.start()
    if engine.wants_warmup:
        await engine.warmup()
    ep = runtime.namespace(None).component("backend").endpoint("generate")
    service = await ep.serve(decode, stats_handler=decode.stats, topo_role="decode",
                             topo_transfer_address=decode.transfer_server.address)
    await register_llm(service, mdc)
    return DisaggWorkerHandle(service=service, engine=decode, router=disagg_router)


async def launch_prefill_workers(
    runtime: DistributedRuntime,
    model_dir: str | Path,
    queue,
    *,
    num_workers: int = 1,
    model_name: str | None = None,
    device=None,
    params=None,
    lease_ttl: float = 3.0,
    **engine_overrides,
) -> list[PrefillHandle]:
    """The prefill side of a disaggregated pair (the reference's
    ``launch_prefill_workers``): ``num_workers`` TorchLlmEngines, each
    warmed when ``warmup=True`` and fed by a ``PrefillWorker`` pump.  With
    ``DYN_TOPO`` on, each publishes a ``prefill`` topology card under a
    lease of its own and runs the topology prober against the decode
    workers' cards."""
    from dynamo_tpu_torch.llm.disagg import PrefillWorker
    from dynamo_tpu_torch.utils import knobs

    model_dir = Path(model_dir)
    mdc = ModelDeploymentCard.from_local_path(model_dir, name=model_name)
    handles = []
    for _ in range(num_workers):
        engine = await asyncio.to_thread(
            build_torch_engine, model_dir, mdc, device=device, params=params,
            **engine_overrides,
        )
        engine.start()
        if engine.wants_warmup:
            await engine.warmup()
        pump = PrefillWorker(runtime, engine, queue)
        handle = PrefillHandle(pump=pump, engine=engine, runtime=runtime)
        if knobs.get("DYN_TOPO"):
            from dynamo_tpu_torch.topology import TopologyWatcher, local_card

            handle.lease = await runtime.plane.kv.grant_lease(lease_ttl)
            runtime.register_keepalive(handle.lease)
            card = local_card(handle.lease.id, role="prefill")
            await runtime.plane.kv.put(card.key(), card.to_json(), handle.lease.id)
            handle.watcher = TopologyWatcher(runtime)
            await handle.watcher.start()
            pump.attach_topology(handle.watcher.map, self_worker_id=card.worker_id)
        pump.start()
        handles.append(handle)
    return handles


async def serve_frontend(
    runtime: DistributedRuntime,
    *,
    host: str = "0.0.0.0",
    port: int = 8080,
    router_mode: RouterMode = RouterMode.ROUND_ROBIN,
    request_template: str | Path | None = None,
    admission=None,
) -> tuple[HttpService, ModelWatcher]:
    """HTTP service + model watcher: a pipeline (preprocessor → backend →
    router) for every model a worker registers, removed with its last
    instance.  ``admission`` (an ``AdmissionConfig``; default: the
    ``DYN_ADMISSION_*`` knobs) gates the inference routes.  Under KV
    routing with ``DYN_PREFETCH`` on, every request's prefix is hinted to
    the worker that holds it before dispatch (``FrontendHinter``).  With
    ``DYN_TOPO`` on, the watcher's live topology map prices the KV router's
    transfers and feeds the frontend's ``dyn_topology_*`` families."""
    from dynamo_tpu_torch.llm.request_template import RequestTemplate

    template = RequestTemplate.load(request_template) if request_template else None
    manager = ModelManager()
    # arrival-hint source for predictive prefetch: only meaningful when a
    # KV router is in the path (it owns the radix index that targets the
    # hint), gated by DYN_PREFETCH like the rest of the subsystem
    hinter = None
    if router_mode == RouterMode.KV:
        from dynamo_tpu_torch.prefetch.frontend import FrontendHinter
        from dynamo_tpu_torch.prefetch.hints import prefetch_enabled

        if prefetch_enabled():
            hinter = FrontendHinter()
    watcher = ModelWatcher(runtime, manager, router_mode=router_mode, prefetch_hinter=hinter)
    service = HttpService(
        manager, host=host, port=port, request_template=template,
        clear_kv=watcher.clear_kv_blocks, admission=admission, prefetch_hinter=hinter,
    )
    await watcher.start()
    # the frontend's /metrics renders the live map's dyn_topology_* families
    # (DYN_TOPO; with the plane off they render at zero, as the reference's)
    service.metrics.attach_topology(watcher.topology)
    await service.start()
    return service, watcher


@dataclass
class HttpHandle:
    service: HttpService
    engine: object

    async def shutdown(self) -> None:
        await self.service.stop()
        self.engine.stop()


async def serve_http(
    model_dir: str | Path,
    *,
    model_name: str | None = None,
    host: str = "0.0.0.0",
    port: int = 8080,
    device=None,
    warmup_prompt_lens=None,
    admission=None,
    **engine_overrides,
) -> HttpHandle:
    """Start the engine and an OpenAI HTTP frontend over it, in process.
    ``engine_overrides`` go to EngineConfig (e.g. ``speculative="ngram",
    spec_tokens=4``, ``host_offload_blocks=64``).  Weight loading, and the
    mount of a remote KV store, run off the event loop.  Every serving
    graph is captured (``TorchLlmEngine.warmup``) before the frontend takes
    a request, as the reference warms before its model registers: the first
    request pays no capture.  ``warmup_prompt_lens`` (the prompt lengths the
    traffic brings) warms the split prefill's keys of those lengths alone,
    as the reference's ``aot_precompile(prompt_lens)``; by default every
    key whose activations fit the free device memory is warmed.
    ``admission`` (an ``AdmissionConfig``) gates the inference routes, as
    in ``serve_frontend``."""
    mdc = ModelDeploymentCard.from_local_path(model_dir, name=model_name)
    engine = await asyncio.to_thread(
        build_torch_engine, model_dir, mdc, device=device, **engine_overrides
    )
    engine.start()
    try:
        await engine.warmup(warmup_prompt_lens)
    except BaseException:
        engine.stop()
        raise
    tokenizer = HfTokenizer.from_model_dir(model_dir)
    backend = Backend(tokenizer)
    manager = ModelManager()
    manager.add_chat_model(mdc.name, ChatPreprocessor(mdc, tokenizer).wrap(backend.wrap(engine)))
    manager.add_completion_model(
        mdc.name, CompletionPreprocessor(mdc, tokenizer).wrap(backend.wrap(engine))
    )
    service = HttpService(manager, host=host, port=port, admission=admission)
    try:
        await service.start()
    except BaseException:
        engine.stop()
        raise
    return HttpHandle(service=service, engine=engine)
