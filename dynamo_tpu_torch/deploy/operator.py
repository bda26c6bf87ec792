"""Reconciling operator: graph CR → component CRs → Kubernetes manifests
(reference: deploy/cloud/operator/internal/controller/
dynamographdeployment_controller.go:263 fan-out and
dynamocomponentdeployment_controller.go:2025 manifest construction, plus the
graph translation in internal/dynamo/graph.go:556).

The reconcile loop is substrate-agnostic: it computes desired objects and
applies the diff through a :class:`KubeClient`.  ``FakeKube`` keeps objects
in memory (tests / dry-run); ``KubectlClient`` shells out to ``kubectl``
when a real cluster is reachable.
"""

from __future__ import annotations

import asyncio
import json
import time
from abc import ABC, abstractmethod

from dynamo_tpu_torch.deploy.crds import (
    API_VERSION,
    ComponentSpec,
    DynamoComponentDeployment,
    DynamoGraphDeployment,
)
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("deploy.operator")

MANAGED_BY = "dynamo-tpu-operator"


def _obj_key(manifest: dict) -> tuple[str, str, str]:
    meta = manifest.get("metadata", {})
    return (manifest.get("kind", ""), meta.get("namespace", "default"), meta.get("name", ""))


class KubeClient(ABC):
    """Minimal apply/list/get/delete/status/watch surface the operator needs."""

    @abstractmethod
    async def apply(self, manifest: dict) -> None: ...

    @abstractmethod
    async def list(self, kind: str, namespace: str, labels: dict[str, str]) -> list[dict]: ...

    @abstractmethod
    async def delete(self, kind: str, namespace: str, name: str) -> None: ...

    @abstractmethod
    async def get(self, kind: str, namespace: str, name: str) -> dict | None: ...

    @abstractmethod
    async def list_all(self, kind: str) -> list[dict]:
        """List a kind across ALL namespaces (resync source)."""

    @abstractmethod
    async def update_status(
        self, kind: str, namespace: str, name: str, status: dict
    ) -> None:
        """Write the object's .status subresource (no spec churn)."""

    @abstractmethod
    def watch(self, kind: str):
        """Async iterator of ``(event_type, manifest)``; event_type in
        ADDED/MODIFIED/DELETED.  May be level-based (poll) per client."""


class FakeKube(KubeClient):
    """In-memory object store (the envtest analog for our reconciler tests)
    with a broadcast watch channel."""

    def __init__(self) -> None:
        self.objects: dict[tuple[str, str, str], dict] = {}
        self.applies = 0
        self.deletes = 0
        self._watchers: list[tuple[str, asyncio.Queue]] = []

    def _notify(self, event: str, manifest: dict) -> None:
        kind = manifest.get("kind", "")
        for want_kind, q in self._watchers:
            if want_kind == kind:
                q.put_nowait((event, json.loads(json.dumps(manifest))))

    async def apply(self, manifest: dict) -> None:
        key = _obj_key(manifest)
        existing = self.objects.get(key)
        stored = json.loads(json.dumps(manifest))
        if existing is not None:  # preserve status across spec applies
            stored.setdefault("status", existing.get("status", {}))
        if existing == stored:
            return  # no-op apply: no event (k8s bumps resourceVersion only on change)
        self.objects[key] = stored
        self.applies += 1
        self._notify("MODIFIED" if existing is not None else "ADDED", stored)

    async def list(self, kind: str, namespace: str, labels: dict[str, str]) -> list[dict]:
        out = []
        for (k, ns, _), obj in self.objects.items():
            if k != kind or ns != namespace:
                continue
            obj_labels = obj.get("metadata", {}).get("labels", {})
            if all(obj_labels.get(lk) == lv for lk, lv in labels.items()):
                out.append(json.loads(json.dumps(obj)))
        return out

    async def delete(self, kind: str, namespace: str, name: str) -> None:
        obj = self.objects.pop((kind, namespace, name), None)
        self.deletes += 1
        if obj is not None:
            self._notify("DELETED", obj)

    async def get(self, kind: str, namespace: str, name: str) -> dict | None:
        # return a COPY, like the API server serializes a response: a caller
        # mutating the result in place must not silently edit the store
        # (that made apply's no-op detection eat a planner scale decision)
        obj = self.objects.get((kind, namespace, name))
        return None if obj is None else json.loads(json.dumps(obj))

    async def list_all(self, kind: str) -> list[dict]:
        return [
            json.loads(json.dumps(obj))
            for (k, _, _), obj in self.objects.items()
            if k == kind
        ]

    async def update_status(
        self, kind: str, namespace: str, name: str, status: dict
    ) -> None:
        obj = self.objects.get((kind, namespace, name))
        if obj is None:
            return
        obj["status"] = json.loads(json.dumps(status))

    def set_deployment_ready(self, namespace: str, name: str, ready: int) -> None:
        """Test hook: simulate the kubelet bringing replicas up."""
        obj = self.objects.get(("Deployment", namespace, name))
        if obj is not None:
            obj.setdefault("status", {})["readyReplicas"] = ready
            self._notify("MODIFIED", obj)

    async def watch(self, kind: str):
        q: asyncio.Queue = asyncio.Queue()
        self._watchers.append((kind, q))
        try:
            # replay current state first (a watch always starts with a list)
            for (k, _, _), obj in list(self.objects.items()):
                if k == kind:
                    yield ("ADDED", json.loads(json.dumps(obj)))
            while True:
                yield await q.get()
        finally:
            self._watchers.remove((kind, q))


class KubectlClient(KubeClient):
    """Shells out to kubectl; used only when a cluster is configured."""

    async def _run(self, *args: str, stdin: bytes | None = None) -> bytes:
        proc = await asyncio.create_subprocess_exec(
            "kubectl", *args,
            stdin=asyncio.subprocess.PIPE if stdin is not None else None,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
        )
        out, err = await proc.communicate(stdin)
        if proc.returncode != 0:
            raise RuntimeError(f"kubectl {' '.join(args)} failed: {err.decode()}")
        return out

    async def apply(self, manifest: dict) -> None:
        await self._run("apply", "-f", "-", stdin=json.dumps(manifest).encode())

    async def list(self, kind: str, namespace: str, labels: dict[str, str]) -> list[dict]:
        selector = ",".join(f"{k}={v}" for k, v in labels.items())
        out = await self._run(
            "get", kind, "-n", namespace, "-l", selector, "-o", "json"
        )
        return json.loads(out).get("items", [])

    async def delete(self, kind: str, namespace: str, name: str) -> None:
        await self._run("delete", kind, name, "-n", namespace, "--ignore-not-found")

    async def get(self, kind: str, namespace: str, name: str) -> dict | None:
        try:
            out = await self._run("get", kind, name, "-n", namespace, "-o", "json")
        except RuntimeError:
            return None
        return json.loads(out)

    async def list_all(self, kind: str) -> list[dict]:
        out = await self._run("get", kind, "-A", "-o", "json")
        return json.loads(out).get("items", [])

    async def update_status(
        self, kind: str, namespace: str, name: str, status: dict
    ) -> None:
        patch = json.dumps({"status": status})
        await self._run(
            "patch", kind, name, "-n", namespace, "--subresource=status",
            "--type=merge", "-p", patch,
        )

    async def watch(self, kind: str, poll_s: float = 10.0):
        """Level-based watch: periodic list-diff (no kubectl watch parsing
        machinery; the operator's reconcile is level-triggered anyway)."""
        known: dict[tuple[str, str, str], dict] = {}  # key -> last full object
        while True:
            out = await self._run("get", kind, "-A", "-o", "json")
            seen: dict[tuple[str, str, str], dict] = {}
            for obj in json.loads(out).get("items", []):
                seen[_obj_key(obj)] = obj
            for key, obj in seen.items():
                prev = known.get(key)
                fingerprint = obj.get("metadata", {}).get("resourceVersion", "")
                if prev is None:
                    yield ("ADDED", obj)
                elif prev.get("metadata", {}).get("resourceVersion", "") != fingerprint:
                    yield ("MODIFIED", obj)
                known[key] = obj
            for key in [k for k in known if k not in seen]:
                # yield the last-seen object so consumers keep its labels
                yield ("DELETED", known.pop(key))
            await asyncio.sleep(poll_s)


# ---------------------------------------------------------------- rendering


def _component_labels(cd: DynamoComponentDeployment) -> dict[str, str]:
    return {
        "app.kubernetes.io/managed-by": MANAGED_BY,
        "dynamo.tpu/graph": cd.graph,
        "dynamo.tpu/service": cd.service_name,
        "dynamo.tpu/component-type": cd.spec.component_type,
    }


def render_component_manifests(cd: DynamoComponentDeployment) -> list[dict]:
    """One component CR → Deployment (+ Service when a port is exposed,
    + ConfigMap when it carries config).  The reference emits the same trio
    per component (dynamocomponentdeployment_controller.go)."""
    spec: ComponentSpec = cd.spec
    labels = _component_labels(cd)
    manifests: list[dict] = []

    env = [{"name": k, "value": v} for k, v in sorted(spec.envs.items())]
    volume_mounts = []
    volumes = []
    if spec.config:
        cm_name = f"{cd.name}-config"
        manifests.append(
            {
                "apiVersion": "v1",
                "kind": "ConfigMap",
                "metadata": {"name": cm_name, "namespace": cd.namespace, "labels": labels},
                "data": {"service.yaml": json.dumps(spec.config, indent=2, sort_keys=True)},
            }
        )
        volumes.append({"name": "service-config", "configMap": {"name": cm_name}})
        volume_mounts.append({"name": "service-config", "mountPath": "/etc/dynamo"})
        env.append({"name": "DYN_SERVICE_CONFIG", "value": "/etc/dynamo/service.yaml"})

    resources: dict = {
        "requests": {"cpu": spec.resources.cpu, "memory": spec.resources.memory},
        "limits": {"memory": spec.resources.memory},
    }
    if spec.resources.gpu > 0:
        # whole cards are scheduled through the NVIDIA device plugin's
        # nvidia.com/gpu extended resource (no topology node selector)
        resources["requests"]["nvidia.com/gpu"] = str(spec.resources.gpu)
        resources["limits"]["nvidia.com/gpu"] = str(spec.resources.gpu)

    container = {
        "name": cd.service_name,
        "image": spec.image,
        "env": env,
        "resources": resources,
    }
    if spec.command:
        container["command"] = list(spec.command)
    if spec.args:
        container["args"] = list(spec.args)
    if volume_mounts:
        container["volumeMounts"] = volume_mounts
    if spec.port:
        container["ports"] = [{"containerPort": spec.port}]
        container["readinessProbe"] = {
            "httpGet": {"path": "/health", "port": spec.port},
            "periodSeconds": 5,
        }

    pod_spec: dict = {"containers": [container]}
    if volumes:
        pod_spec["volumes"] = volumes

    manifests.append(
        {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": cd.name, "namespace": cd.namespace, "labels": labels},
            "spec": {
                "replicas": spec.replicas,
                "selector": {"matchLabels": {"dynamo.tpu/service": cd.service_name,
                                             "dynamo.tpu/graph": cd.graph}},
                "template": {
                    "metadata": {"labels": labels},
                    "spec": pod_spec,
                },
            },
        }
    )

    if spec.port:
        manifests.append(
            {
                "apiVersion": "v1",
                "kind": "Service",
                "metadata": {"name": cd.name, "namespace": cd.namespace, "labels": labels},
                "spec": {
                    "selector": {"dynamo.tpu/service": cd.service_name,
                                 "dynamo.tpu/graph": cd.graph},
                    "ports": [{"port": spec.port, "targetPort": spec.port}],
                },
            }
        )
    if spec.ingress and spec.port:
        rule = {
            "host": spec.ingress.get("host", ""),
            "http": {
                "paths": [
                    {
                        "path": spec.ingress.get("path", "/"),
                        "pathType": spec.ingress.get("pathType", "Prefix"),
                        "backend": {
                            "service": {
                                "name": cd.name,
                                "port": {"number": spec.port},
                            }
                        },
                    }
                ]
            },
        }
        ingress_spec: dict = {"rules": [rule]}
        if spec.ingress.get("className"):
            ingress_spec["ingressClassName"] = spec.ingress["className"]
        manifests.append(
            {
                "apiVersion": "networking.k8s.io/v1",
                "kind": "Ingress",
                "metadata": {"name": cd.name, "namespace": cd.namespace, "labels": labels},
                "spec": ingress_spec,
            }
        )
    return manifests


# ---------------------------------------------------------------- reconciler


class GraphReconciler:
    """Level-triggered reconcile of graph CRs: fan out component CRs, render
    their manifests, apply, and prune children whose service disappeared."""

    def __init__(self, kube: KubeClient):
        self.kube = kube

    @staticmethod
    def component_name(graph: DynamoGraphDeployment, service_name: str) -> str:
        return f"{graph.name}-{service_name}"

    def fan_out(self, graph: DynamoGraphDeployment) -> list[DynamoComponentDeployment]:
        graph.validate()
        return [
            DynamoComponentDeployment(
                name=self.component_name(graph, svc_name),
                namespace=graph.namespace,
                graph=graph.name,
                service_name=svc_name,
                spec=spec,
                graph_uid=graph.uid,
            )
            for svc_name, spec in graph.services.items()
        ]

    async def reconcile(self, graph: DynamoGraphDeployment) -> dict:
        """Returns a status summary {applied: n, pruned: n, components: [...]}."""
        children = self.fan_out(graph)
        desired: set[tuple[str, str]] = set()  # (kind, name) of every applied object
        component_names = set()
        applied = 0
        for child in children:
            component_names.add(child.name)
            desired.add((DynamoComponentDeployment.kind, child.name))
            await self.kube.apply(child.to_manifest())
            for manifest in render_component_manifests(child):
                desired.add((manifest["kind"], manifest["metadata"]["name"]))
                await self.kube.apply(manifest)
                applied += 1

        # Prune by exact object identity: anything graph-labelled that this
        # pass did not render is stale — including a ConfigMap/Service left
        # behind when a service dropped its config/port.
        pruned = 0
        graph_selector = {"dynamo.tpu/graph": graph.name}
        for kind in (DynamoComponentDeployment.kind, "Deployment", "Service", "ConfigMap", "Ingress"):
            for obj in await self.kube.list(kind, graph.namespace, graph_selector):
                name = obj["metadata"]["name"]
                if (kind, name) not in desired:
                    await self.kube.delete(kind, graph.namespace, name)
                    pruned += 1

        status = {
            "applied": applied,
            "pruned": pruned,
            "components": sorted(component_names),
        }
        logger.info("reconciled graph %s: %s", graph.name, status)
        return status

    async def teardown(self, graph: DynamoGraphDeployment) -> int:
        """Delete everything owned by the graph (graph CR deletion path,
        incl. the reference's etcd cleanup analog)."""
        removed = 0
        selector = {"dynamo.tpu/graph": graph.name}
        for kind in (DynamoComponentDeployment.kind, "Deployment", "Service", "ConfigMap", "Ingress"):
            for obj in await self.kube.list(kind, graph.namespace, selector):
                await self.kube.delete(kind, graph.namespace, obj["metadata"]["name"])
                removed += 1
        return removed


# ---------------------------------------------------------------- operator


def _condition(ctype: str, status: bool, reason: str, message: str) -> dict:
    return {
        "type": ctype,
        "status": "True" if status else "False",
        "reason": reason,
        "message": message,
        "lastTransitionTime": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def merge_conditions(existing: list[dict], new: list[dict]) -> list[dict]:
    """Controller-runtime semantics: lastTransitionTime changes only when
    the condition's status flips."""
    by_type = {c["type"]: c for c in existing}
    out = []
    for cond in new:
        prev = by_type.get(cond["type"])
        if prev is not None and prev["status"] == cond["status"]:
            cond = {**cond, "lastTransitionTime": prev["lastTransitionTime"]}
        out.append(cond)
    return out


class Operator:
    """Watch-driven controller for DynamoGraphDeployment CRs (reference:
    dynamographdeployment_controller.go — watch → workqueue → level-triggered
    reconcile with status conditions, requeue-with-backoff on error, and a
    periodic resync).

    Deleted graphs tear down their children; live graphs reconcile and get a
    ``status`` with observedGeneration + Progressing/Ready conditions, Ready
    flipping once every child Deployment reports its replicas ready.
    """

    def __init__(self, kube: KubeClient, *, resync_s: float = 30.0, backoff_s: float = 0.5):
        self.kube = kube
        self.reconciler = GraphReconciler(kube)
        self.resync_s = resync_s
        self.backoff_s = backoff_s
        self.reconciles = 0
        self.errors = 0
        self._queue: asyncio.Queue = asyncio.Queue()
        self._tasks: list[asyncio.Task] = []
        self._requeues: set[asyncio.Task] = set()
        self._failures: dict[tuple[str, str], int] = {}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._tasks = [
            spawn_logged(self._watch_loop(DynamoGraphDeployment.kind)),
            # child Deployment changes (readiness) feed back into status
            spawn_logged(self._watch_loop("Deployment")),
            spawn_logged(self._resync_loop()),
            spawn_logged(self._worker()),
        ]

    async def stop(self) -> None:
        for t in [*self._tasks, *self._requeues]:
            t.cancel()
        for t in [*self._tasks, *self._requeues]:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._tasks = []
        self._requeues.clear()

    # -- event sources -----------------------------------------------------
    async def _watch_loop(self, kind: str) -> None:
        while True:
            try:
                async for event, manifest in self.kube.watch(kind):
                    meta = manifest.get("metadata", {})
                    ns = meta.get("namespace", "default")
                    if kind == DynamoGraphDeployment.kind:
                        self._queue.put_nowait((event, ns, meta.get("name", "")))
                    else:
                        # map child → owning graph via its labels
                        graph = meta.get("labels", {}).get("dynamo.tpu/graph")
                        if graph:
                            self._queue.put_nowait(("CHILD", ns, graph))
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — watch dropped: back off, re-list
                logger.exception("watch for %s lost; restarting", kind)
                await asyncio.sleep(1.0)

    async def _resync_loop(self) -> None:
        while True:
            await asyncio.sleep(self.resync_s)
            for obj in await self._all_graphs():
                meta = obj.get("metadata", {})
                self._queue.put_nowait(
                    ("RESYNC", meta.get("namespace", "default"), meta.get("name", ""))
                )

    async def _all_graphs(self) -> list[dict]:
        try:
            return await self.kube.list_all(DynamoGraphDeployment.kind)
        except Exception:  # noqa: BLE001
            return []

    # -- work queue --------------------------------------------------------
    async def _worker(self) -> None:
        while True:
            event, ns, name = await self._queue.get()
            key = (ns, name)
            try:
                if event == "DELETED":
                    # teardown selects children by label; no spec needed
                    graph = DynamoGraphDeployment(name=name, namespace=ns)
                    removed = await self.reconciler.teardown(graph)
                    logger.info("graph %s deleted: removed %d children", name, removed)
                else:
                    await self._reconcile_one(ns, name)
                self._failures.pop(key, None)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — requeue with backoff
                self.errors += 1
                n = self._failures[key] = self._failures.get(key, 0) + 1
                delay = min(self.backoff_s * (2 ** (n - 1)), 30.0)
                logger.exception("reconcile %s/%s failed (attempt %d); requeue in %.1fs", ns, name, n, delay)

                async def requeue(ev=event, ns_=ns, nm=name, d=delay) -> None:
                    await asyncio.sleep(d)
                    self._queue.put_nowait((ev, ns_, nm))

                task = asyncio.ensure_future(requeue())
                self._requeues.add(task)
                task.add_done_callback(self._requeues.discard)

    async def _reconcile_one(self, ns: str, name: str) -> None:
        manifest = await self.kube.get(DynamoGraphDeployment.kind, ns, name)
        if manifest is None:
            return  # deleted since enqueue
        graph = DynamoGraphDeployment.from_manifest(manifest)
        summary = await self.reconciler.reconcile(graph)
        self.reconciles += 1

        # readiness: every child Deployment reports its replicas ready
        ready_parts, total_parts = 0, 0
        for obj in await self.kube.list(
            "Deployment", ns, {"dynamo.tpu/graph": graph.name}
        ):
            total_parts += 1
            want = obj.get("spec", {}).get("replicas", 1)
            have = obj.get("status", {}).get("readyReplicas", 0)
            if have >= want:
                ready_parts += 1
        ready = total_parts > 0 and ready_parts == total_parts
        new_conditions = [
            _condition(
                "Progressing", not ready,
                "Reconciling" if not ready else "Stable",
                f"{ready_parts}/{total_parts} deployments ready",
            ),
            _condition(
                "Ready", ready,
                "AllComponentsReady" if ready else "ComponentsPending",
                f"{ready_parts}/{total_parts} deployments ready",
            ),
        ]
        prev = (manifest.get("status") or {}).get("conditions", [])
        status = {
            "observedGeneration": manifest.get("metadata", {}).get("generation", 0),
            "conditions": merge_conditions(prev, new_conditions),
            "components": summary["components"],
        }
        await self.kube.update_status(DynamoGraphDeployment.kind, ns, name, status)
