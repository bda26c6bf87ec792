"""Deployment plane glue: SDK graph → api-store artifact → operator CR.

The reference ships a ``dynamo build`` / ``dynamo deploy`` pair
(reference: deploy/sdk/src/dynamo/sdk/cli/deployment.py — Typer CLI over a
DeploymentManager that stores artifacts and creates deployments); here the
same path is three composable functions plus ``cli/deployctl.py``:

- :func:`build_graph_manifest` — walk an SDK entry service's dependency
  closure (sdk/graph.py) and render a ``DynamoGraphDeployment`` manifest:
  one ComponentSpec per service, each running ``dynamo_tpu_torch.sdk.runner``
  exactly like local subprocess serving does (sdk/graph.py
  ``to_process_specs``), with replicas/resources from the @service config.
- :func:`push_artifact` / :func:`fetch_artifact` — versioned records in
  the api-store (deploy/api_store.py).
- :func:`deploy_artifact` — apply the stored manifest as a graph CR
  through a :class:`deploy.operator.KubeClient`; the running operator's
  watch reconciles it into component CRs and Deployments.
"""

from __future__ import annotations

from dynamo_tpu_torch.deploy.crds import (
    DEFAULT_IMAGE,
    ComponentSpec,
    DynamoGraphDeployment,
    Resources,
)
from dynamo_tpu_torch.sdk.graph import ServiceConfig, dependency_closure, resolve_entry
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("deploy.deployment")

__all__ = [
    "build_graph_manifest", "push_artifact", "fetch_artifact",
    "deploy_artifact", "resolve_entry",
]


def build_graph_manifest(
    entry: type | str,
    *,
    name: str | None = None,
    namespace: str = "default",
    image: str = DEFAULT_IMAGE,
    control_plane: str = "dynctl:2379",
) -> dict:
    """Render an SDK service graph into a DynamoGraphDeployment manifest."""
    cls = resolve_entry(entry) if isinstance(entry, str) else entry
    services: dict[str, ComponentSpec] = {}
    for svc_cls in dependency_closure(cls):
        config: ServiceConfig = svc_cls._dyn_service
        if config.name in services:
            # two classes sharing a service name would silently overwrite
            # each other in the rendered graph — fail at build time instead
            raise ValueError(
                f"duplicate service name {config.name!r} in the dependency "
                f"closure of {cls.__qualname__} (from {svc_cls.__qualname__})"
            )
        services[config.name] = ComponentSpec(
            component_type=config.component_type,
            replicas=config.workers,
            image=image,
            # the same runner invocation local subprocess serving uses —
            # a container with this repo installed serves the service
            command=["python", "-m", "dynamo_tpu_torch.sdk.runner"],
            args=[
                f"{svc_cls.__module__}:{svc_cls.__qualname__}",
                "--control-plane", control_plane,
            ],
            resources=Resources.from_dict(config.resources or None),
            config={"entry": f"{svc_cls.__module__}:{svc_cls.__qualname__}"},
        )
    graph = DynamoGraphDeployment(
        name=name or cls._dyn_service.name,
        namespace=namespace,
        services=services,
    )
    graph.validate()
    return graph.to_manifest()


async def push_artifact(
    api_store_url: str, name: str, version: str, manifest: dict,
    *, description: str = "",
) -> dict:
    """POST a built graph manifest to the api-store as ``name:version``."""
    import aiohttp

    async with aiohttp.ClientSession() as session:
        async with session.post(
            f"{api_store_url.rstrip('/')}/api/v1/graphs",
            json={
                "name": name,
                "version": version,
                "manifest": manifest,
                "description": description,
            },
        ) as resp:
            if resp.status not in (200, 201):
                # a proxy's HTML 502 must not surface as ContentTypeError
                raise RuntimeError(
                    f"api-store rejected artifact ({resp.status}): "
                    f"{(await resp.text())[:300]}"
                )
            return await resp.json()


async def fetch_artifact(api_store_url: str, name: str, version: str) -> dict:
    """GET a stored record; returns the record dict (manifest under
    ``manifest``)."""
    import aiohttp

    async with aiohttp.ClientSession() as session:
        async with session.get(
            f"{api_store_url.rstrip('/')}/api/v1/graphs/{name}/{version}"
        ) as resp:
            if resp.status == 404:
                raise KeyError(f"artifact {name}:{version} not in the api-store")
            resp.raise_for_status()
            return await resp.json()


async def deploy_artifact(
    kube, record: dict, *, namespace: str | None = None
) -> dict:
    """Apply a stored artifact's graph manifest as a CR; the operator's
    watch takes it from there.  Returns the manifest applied."""
    manifest = record.get("manifest") if "manifest" in record else record
    graph = DynamoGraphDeployment.from_manifest(manifest)
    if namespace:
        graph.namespace = namespace
    graph.validate()
    out = graph.to_manifest()
    await kube.apply(out)
    logger.info(
        "deployed graph %s (%d services) to namespace %s",
        graph.name, len(graph.services), graph.namespace,
    )
    return out
