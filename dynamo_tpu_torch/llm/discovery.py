"""Frontend-side model discovery.

Workers register their models under ``dynamo://models/`` with their liveness
lease; the frontend's ModelWatcher builds/tears down the per-model client
pipeline (preprocessor → backend → remote push router) as entries come and go
(reference: lib/llm/src/discovery/{model_entry.rs,watcher.rs},
model_manager.rs; registration lib/bindings register_llm).

With ``DYN_TOPO`` on (its default) the watcher keeps a live TopologyMap off
the workers' cards and hands it to every KV router and migration
coordinator it builds.  A frontend's prefetch hinter gets each model's
tokenizer as its pipeline is built.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from pathlib import Path

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.http.service import ModelManager
from dynamo_tpu_torch.llm.kv_router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import ChatPreprocessor, CompletionPreprocessor
from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
from dynamo_tpu_torch.runtime.client import PushRouter, RemoteEngine, RouterMode
from dynamo_tpu_torch.runtime.component import ROOT_PATH
from dynamo_tpu_torch.runtime.controlplane.interface import WatchEventType
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.utils import knobs
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("llm.discovery")

MODELS_PREFIX = f"{ROOT_PATH}models/"


@dataclass
class ModelEntry:
    name: str
    namespace: str
    component: str
    endpoint: str
    instance_id: int
    model_types: list[str] = field(default_factory=lambda: ["chat", "completions"])
    mdc: dict | None = None

    def key(self) -> str:
        return (
            f"{MODELS_PREFIX}{self.name}/"
            f"{self.namespace}.{self.component}.{self.endpoint}/{self.instance_id:016x}"
        )

    def endpoint_path(self) -> str:
        return f"{self.namespace}.{self.component}.{self.endpoint}"

    def to_json(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "ModelEntry":
        return cls(**json.loads(data))


async def register_llm(
    service,  # EndpointService returned by Endpoint.serve
    mdc: ModelDeploymentCard,
    *,
    model_types: list[str] | None = None,
) -> ModelEntry:
    """Register a served endpoint as an LLM model (worker side)."""
    instance = service.instance
    entry = ModelEntry(
        name=mdc.name,
        namespace=instance.namespace,
        component=instance.component,
        endpoint=instance.endpoint,
        instance_id=instance.instance_id,
        model_types=model_types or ["chat", "completions"],
        mdc=json.loads(mdc.to_json()),
    )
    # artifacts first, registration second: a frontend that sees the entry
    # can always complete the fetch (reference: transports/nats.rs:123-211)
    try:
        n = await mdc.publish_artifacts(service.runtime.plane.bus)
        logger.info("published %d artifact(s) for %s", n, mdc.name)
    except Exception:  # noqa: BLE001 — same-filesystem serving still works
        logger.exception("artifact publish failed for %s", mdc.name)
    # registered under the instance's lease: model entries vanish with the worker
    await service.runtime.plane.kv.put(entry.key(), entry.to_json(), service._lease.id)
    logger.info("registered model %s on %s", mdc.name, instance.subject)
    return entry


class ModelWatcher:
    """Watches model registrations and maintains the ModelManager."""

    def __init__(
        self,
        runtime: DistributedRuntime,
        manager: ModelManager,
        *,
        router_mode: RouterMode = RouterMode.ROUND_ROBIN,
        prefetch_hinter=None,
    ):
        self.runtime = runtime
        self.manager = manager
        self.router_mode = router_mode
        self._watch = None
        self._task: asyncio.Task | None = None
        # model name -> set of entry keys backing it
        self._backing: dict[str, set[str]] = {}
        self._entries: dict[str, ModelEntry] = {}  # entry key -> entry
        self._pipelines: dict[str, dict] = {}  # model name -> {"router": ..., "kv": ...}
        # prefetch/frontend.py FrontendHinter: each model pipeline registers
        # its tokenizer + chat template here so arrival hints hash exactly
        # the token stream the preprocessor will produce
        self.prefetch_hinter = prefetch_hinter
        # fleet topology plane: one card watcher shared by every KV router
        # this frontend builds (DYN_TOPO; started alongside model discovery)
        self._topology_watcher = None

    @property
    def topology(self):
        """The live TopologyMap, or None when the plane is off."""
        return (
            self._topology_watcher.map
            if self._topology_watcher is not None else None
        )

    async def start(self) -> None:
        self._watch = self.runtime.plane.kv.watch_prefix(MODELS_PREFIX)
        self._task = spawn_logged(self._loop())
        if knobs.get("DYN_TOPO"):
            from dynamo_tpu_torch.topology import TopologyWatcher

            self._topology_watcher = TopologyWatcher(self.runtime)
            await self._topology_watcher.start()

    async def stop(self) -> None:
        if self._watch is not None:
            self._watch.cancel()
        if self._task is not None:
            self._task.cancel()
        for state in self._pipelines.values():
            kv_router = state.get("kv")
            if kv_router is not None:
                await kv_router.stop()
            router = state.get("router")
            if router is not None and router.migrations is not None:
                await router.migrations.stop()
        if self._topology_watcher is not None:
            await self._topology_watcher.stop()
            self._topology_watcher = None

    async def _loop(self) -> None:
        try:
            async for event in self._watch:
                try:
                    entry = ModelEntry.from_json(event.entry.value)
                except Exception:  # noqa: BLE001
                    continue
                if event.type == WatchEventType.PUT:
                    await self._handle_put(event.entry.key, entry)
                else:
                    await self._handle_delete(event.entry.key, entry)
        except ConnectionError as exc:
            # keep serving the pipelines we already built on a lost watch
            logger.warning("model discovery watch lost: %s", exc)

    async def clear_kv_blocks(self) -> list[str]:
        """Broadcast a KV-cache flush to every worker component backing a
        registered model; each worker's ClearKvListener flushes its engine
        and re-announces the cleared state to the indexers (reference:
        lib/llm/src/http/service/clear_kv_blocks.rs)."""
        from dynamo_tpu_torch.llm.kv_router.protocols import CLEAR_KV_SUBJECT

        subjects = sorted(
            {
                self.runtime.namespace(e.namespace)
                .component(e.component)
                .event_subject(CLEAR_KV_SUBJECT)
                for e in self._entries.values()
            }
        )
        bus = self.runtime.plane.bus
        for subject in subjects:
            await bus.publish(subject, b"{}")
        return subjects

    async def _handle_put(self, key: str, entry: ModelEntry) -> None:
        backing = self._backing.setdefault(entry.name, set())
        backing.add(key)
        self._entries[key] = entry
        if entry.name in self._pipelines:
            return
        try:
            await self._build_pipeline(entry)
        except Exception:  # noqa: BLE001
            logger.exception("failed to build pipeline for model %s", entry.name)
            backing.discard(key)

    async def _handle_delete(self, key: str, entry: ModelEntry) -> None:
        self._entries.pop(key, None)
        backing = self._backing.get(entry.name)
        if backing is None:
            return
        backing.discard(key)
        if backing:
            return
        # last instance gone: tear down
        self._backing.pop(entry.name, None)
        state = self._pipelines.pop(entry.name, None)
        if state is not None and state.get("kv") is not None:
            await state["kv"].stop()
        if state is not None and state.get("router") is not None:
            router = state["router"]
            if router.migrations is not None:
                await router.migrations.stop()
        self.manager.remove_model(entry.name)
        if self.prefetch_hinter is not None:
            self.prefetch_hinter.remove_model(entry.name)
        logger.info("model %s removed (no instances left)", entry.name)

    async def _build_pipeline(self, entry: ModelEntry) -> None:
        mdc = ModelDeploymentCard(**entry.mdc)
        if not mdc.path or not (
            Path(mdc.path, "tokenizer.json").exists()
            or Path(mdc.path, "tokenizer.model").exists()
        ):
            # no shared filesystem with the worker: pull the tokenizer/config
            # artifacts the worker published to the object store
            fetched = await mdc.fetch_artifacts(self.runtime.plane.bus)
            if fetched is None:
                raise FileNotFoundError(f"model artifacts not found at {mdc.path}")
            logger.info("fetched artifacts for %s into %s", entry.name, fetched)
        tokenizer = HfTokenizer.from_model_dir(mdc.path)

        ns = self.runtime.namespace(entry.namespace)
        endpoint = ns.component(entry.component).endpoint(entry.endpoint)
        push_router = await PushRouter.from_endpoint(endpoint, self.router_mode)
        if push_router.migrations is not None:
            # live-migration control verb (dynctl migrate) + topology-priced
            # destination picking; the lambda keeps reading the watcher's
            # map as probes refine it
            if self._topology_watcher is not None:
                push_router.migrations.attach_topology(lambda: self.topology)
            await push_router.migrations.serve_ctl(self.runtime.plane.bus)

        kv_router = None
        if self.router_mode == RouterMode.KV:
            kv_router = KvRouter(endpoint.component, block_size=mdc.kv_block_size)
            if self._topology_watcher is not None:
                kv_router.attach_topology(self._topology_watcher.map)
            await kv_router.start()
            engine: object = KvPushRouter(push_router, kv_router)
        else:
            engine = RemoteEngine(push_router)

        backend = Backend(tokenizer)
        if "chat" in entry.model_types:
            self.manager.add_chat_model(
                entry.name, ChatPreprocessor(mdc, tokenizer).wrap(backend.wrap(engine))
            )
        if "completions" in entry.model_types:
            self.manager.add_completion_model(
                entry.name, CompletionPreprocessor(mdc, tokenizer).wrap(backend.wrap(engine))
            )
        self._pipelines[entry.name] = {"router": push_router, "kv": kv_router}
        if self.prefetch_hinter is not None:
            self._register_hinter(entry, mdc, tokenizer, endpoint)
        logger.info(
            "model %s wired to %s (mode=%s)", entry.name, entry.endpoint_path(), self.router_mode.value
        )

    def _register_hinter(self, entry: ModelEntry, mdc, tokenizer, endpoint) -> None:
        """Wire this model into the frontend's prefetch hinter: tokenize a
        validated request the same way the preprocessor will (chat template
        for chat, raw prompt for completions) and publish the hash chain on
        the component's hint subject."""
        from dynamo_tpu_torch.llm.preprocessor import PromptFormatter
        from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
        from dynamo_tpu_torch.prefetch.hints import PREFETCH_HINT_SUBJECT

        formatter = PromptFormatter(mdc.chat_template)
        bus = self.runtime.plane.bus
        subject = endpoint.component.event_subject(PREFETCH_HINT_SUBJECT)
        # hint tokenization runs synchronously on the frontend event loop
        # (it must leave before dispatch starts): cap the rendered text so a
        # long-context prompt costs bounded work.  The hint then covers the
        # prompt's leading blocks, and truncation can at worst invalidate
        # the final partial block's hash
        max_chars = knobs.get("DYN_PREFETCH_HINT_CHARS")

        def tokenize(request_model) -> list[int] | None:
            if isinstance(request_model, ChatCompletionRequest):
                text = formatter.render(request_model)
            elif isinstance(getattr(request_model, "prompt", None), str):
                text = request_model.prompt
            else:
                return None
            return tokenizer.encode(text[:max_chars])

        async def publish(payload: bytes) -> None:
            await bus.publish(subject, payload)

        self.prefetch_hinter.register_model(entry.name, tokenize, mdc.kv_block_size, publish)
