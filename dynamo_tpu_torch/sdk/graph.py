"""Service-graph DSL (a copy of dynamo_tpu/sdk/graph.py; replicas get GPUs
from sdk/allocator.py).

Declarative component graphs (reference: deploy/sdk/.../core/lib.py —
``@service`` :88, ``@endpoint``, ``depends()`` :121, lifecycle hooks
:149-175):

    @service(workers=2, resources={"gpu": 1})
    class Worker:
        @endpoint()
        async def generate(self, request, ctx):
            yield {...}

    @service()
    class Processor:
        worker = depends(Worker)          # client to Worker.generate
        @endpoint()
        async def generate(self, request, ctx):
            async for item in await self.worker.generate(request):
                yield item

Deployment modes:
- ``deploy_inprocess(Entry, runtime)`` — whole graph in one process
  (tests/dev; descriptors resolve to direct engine calls over the memory
  control plane);
- ``ProcessSupervisor`` specs via ``to_process_specs`` — one OS process per
  service replica running ``dynamo_tpu_torch.sdk.runner`` (the serve_dynamo.py
  analog), discovering each other through the control plane.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable

from dynamo_tpu_torch.runtime.client import PushRouter, RemoteEngine, RouterMode
from dynamo_tpu_torch.runtime.engine import Context, FnEngine, ResponseStream
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("sdk.graph")


@dataclass
class ServiceConfig:
    name: str
    workers: int = 1
    resources: dict[str, Any] = field(default_factory=dict)
    namespace: str = "dynamo"
    # deploy-plane kind (deploy/crds.py COMPONENT_KINDS): how the builder
    # renders this service into a DynamoComponentDeployment
    component_type: str = "worker"


@dataclass
class EndpointDef:
    name: str
    method_name: str


class Depends:
    """Declares a dependency on another service; resolves to a client."""

    def __init__(self, target: type):
        self.target = target
        self.attr_name: str | None = None

    def __set_name__(self, owner, name):
        self.attr_name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        resolved = getattr(obj, f"_dyn_dep_{self.attr_name}", None)
        if resolved is None:
            raise RuntimeError(
                f"dependency {self.attr_name} not wired (service not deployed)"
            )
        return resolved


def service(name: str | None = None, *, workers: int = 1, resources: dict | None = None,
            namespace: str = "dynamo",
            component_type: str = "worker") -> Callable[[type], type]:
    def wrap(cls: type) -> type:
        cls._dyn_service = ServiceConfig(
            name=name or cls.__name__.lower(),
            workers=workers,
            resources=resources or {},
            namespace=namespace,
            component_type=component_type,
        )
        cls._dyn_endpoints = [
            EndpointDef(name=m._dyn_endpoint_name, method_name=attr)
            for attr, m in vars(cls).items()
            if callable(m) and hasattr(m, "_dyn_endpoint_name")
        ]
        cls._dyn_deps = {
            attr: dep for attr, dep in vars(cls).items() if isinstance(dep, Depends)
        }
        return cls

    return wrap


def endpoint(name: str | None = None):
    def wrap(fn):
        fn._dyn_endpoint_name = name or fn.__name__
        return fn

    return wrap


def depends(target: type) -> Depends:
    return Depends(target)


def async_on_start(fn):
    fn._dyn_on_start = True
    return fn


def resolve_entry(entry: str) -> type:
    """``pkg.module:ClassName`` → the class object (shared by the runner
    and the deploy-plane builder so the two paths cannot drift)."""
    import importlib

    module_name, _, qualname = entry.partition(":")
    if not qualname:
        raise ValueError(f"entry {entry!r} must look like module:ClassName")
    obj = importlib.import_module(module_name)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def dependency_closure(entry: type) -> list[type]:
    """Entry service + transitive dependencies, dependency-first order."""
    seen: dict[type, None] = {}

    def visit(cls: type):
        for dep in getattr(cls, "_dyn_deps", {}).values():
            visit(dep.target)
        if cls not in seen:
            seen[cls] = None

    visit(entry)
    return list(seen)


class _BoundEndpointEngine:
    """Adapts a service method (async generator) to the AsyncEngine shape."""

    def __init__(self, instance, method):
        self._instance = instance
        self._method = method

    async def generate(self, request: Context[dict]) -> ResponseStream[dict]:
        sig = inspect.signature(self._method)
        if len(sig.parameters) >= 3:
            gen = self._method(self._instance, request.data, request.ctx)
        else:
            gen = self._method(self._instance, request.data)
        return ResponseStream(gen, request.ctx)


async def deploy_service(runtime, cls: type, *, instance=None) -> list:
    """Instantiate one service, wire deps to control-plane clients, serve
    its endpoints.  Returns the EndpointService handles."""
    config: ServiceConfig = cls._dyn_service
    obj = instance if instance is not None else cls()
    # wire dependencies: clients to the dep's first endpoint
    for attr, dep in cls._dyn_deps.items():
        dep_config: ServiceConfig = dep.target._dyn_service
        dep_endpoints = dep.target._dyn_endpoints
        if not dep_endpoints:
            raise ValueError(f"{dep.target.__name__} has no endpoints to depend on")
        ep = (
            runtime.namespace(dep_config.namespace)
            .component(dep_config.name)
            .endpoint(dep_endpoints[0].name)
        )
        router = await PushRouter.from_endpoint(ep, RouterMode.ROUND_ROBIN)
        setattr(obj, f"_dyn_dep_{attr}", RemoteEngine(router))

    # lifecycle hook
    for attr, member in vars(cls).items():
        if callable(member) and getattr(member, "_dyn_on_start", False):
            await member(obj)

    services = []
    for ep_def in cls._dyn_endpoints:
        ep = (
            runtime.namespace(config.namespace)
            .component(config.name)
            .endpoint(ep_def.name)
        )
        method = getattr(cls, ep_def.method_name)
        handle = await ep.serve(_BoundEndpointEngine(obj, method))
        services.append(handle)
    logger.info("deployed service %s (%d endpoints)", config.name, len(services))
    return services


async def deploy_inprocess(entry: type, runtime) -> dict[type, list]:
    """Deploy the whole dependency closure in one process."""
    handles: dict[type, list] = {}
    for cls in dependency_closure(entry):
        handles[cls] = await deploy_service(runtime, cls)
    return handles


def to_process_specs(
    entry: type, *, control_plane: str, python=None, gpu_inventory=None,
) -> list:
    """One ProcessSpec per service for the supervisor (subprocess mode).

    Services declaring ``resources={"gpu": n}`` get per-replica
    ``CUDA_VISIBLE_DEVICES`` overlays from the resource allocator
    (sdk/allocator.py) so replicas claim disjoint cards; ``gpu_inventory``
    overrides host detection (tests, explicit topologies).  Spec replica
    targets come from the @service ``workers`` count."""
    import sys

    from dynamo_tpu_torch.sdk.allocator import plan_resource_envs
    from dynamo_tpu_torch.sdk.supervisor import ProcessSpec

    closure = dependency_closure(entry)
    gpu_envs = plan_resource_envs(closure, inventory=gpu_inventory)
    specs = []
    for cls in closure:
        config: ServiceConfig = cls._dyn_service
        specs.append(
            ProcessSpec(
                name=config.name,
                cmd=[
                    python or sys.executable, "-m", "dynamo_tpu_torch.sdk.runner",
                    f"{cls.__module__}:{cls.__qualname__}",
                    "--control-plane", control_plane,
                ],
                replica_env=gpu_envs.get(config.name, []),
                replicas=config.workers,
            )
        )
    return specs


class DynamoService:
    """Convenience base class (optional; plain classes work too)."""
