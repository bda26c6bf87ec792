"""CRD-shaped deployment specs (reference:
deploy/cloud/operator/api/v1alpha1/dynamographdeployment_types.go:33-141 and
dynamocomponentdeployment_types.go — a graph CR fans out into one component
CR per service).

Group/version ``dynamo.tpu/v1alpha1`` (the reference's API, so the planner,
the operator and the CRs speak it); the port's YAML CRD definitions for a
real cluster live under ``dynamo_tpu_torch/deploy/crds/``: their
``resources`` schema declares ``gpu`` where the reference's declares the TPU
fields, so a cluster keeps the GPU count instead of pruning it.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any

GROUP = "dynamo.tpu"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"

# the port's container image (the reference's is dynamo-tpu:latest)
DEFAULT_IMAGE = "dynamo-tpu-torch:latest"

COMPONENT_KINDS = ("frontend", "worker", "prefill-worker", "router", "planner", "metrics")


# the reference's TPU resource keys: a spec naming one was written for a TPU
# slice, so it is refused rather than scheduled without its chips
TPU_RESOURCE_KEYS = ("tpu", "tpu_topology", "tpuTopology")


@dataclass
class Resources:
    """Per-replica resource requests. ``gpu`` counts whole cards (the SDK's
    ``resources={"gpu": n}``, as ``sdk/allocator.py`` reads it)."""

    cpu: str = "1"
    memory: str = "2Gi"
    gpu: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict | None) -> "Resources":
        d = d or {}
        tpu = [k for k in TPU_RESOURCE_KEYS if k in d]
        if tpu:
            raise ValueError(
                f"resources {tpu} name TPU chips; this deployment plane "
                f"schedules GPUs: use resources={{'gpu': n}}"
            )
        return cls(
            cpu=str(d.get("cpu", "1")),
            memory=str(d.get("memory", "2Gi")),
            gpu=int(d.get("gpu", 0)),
        )


@dataclass
class ComponentSpec:
    """One service in the graph (reference: operator service spec,
    internal/dynamo/graph.go:556 translation input)."""

    component_type: str = "worker"  # one of COMPONENT_KINDS
    replicas: int = 1
    image: str = DEFAULT_IMAGE
    command: list[str] = field(default_factory=list)
    args: list[str] = field(default_factory=list)
    envs: dict[str, str] = field(default_factory=dict)
    resources: Resources = field(default_factory=Resources)
    config: dict[str, Any] = field(default_factory=dict)  # service YAML payload
    port: int = 0  # exposed service port (frontend/router/metrics)
    # ingress: {"host": "...", "path": "/", "className": "..."} — renders a
    # networking.k8s.io/v1 Ingress in front of the Service (reference:
    # operator VirtualService/Ingress wiring,
    # deploy/cloud/operator/internal/controller/dynamocomponentdeployment_controller.go)
    ingress: dict[str, Any] = field(default_factory=dict)

    def validate(self, name: str) -> None:
        if self.component_type not in COMPONENT_KINDS:
            raise ValueError(
                f"service {name!r}: unknown componentType {self.component_type!r} "
                f"(expected one of {COMPONENT_KINDS})"
            )
        if self.replicas < 0:
            raise ValueError(f"service {name!r}: negative replicas")

    def to_dict(self) -> dict:
        d = asdict(self)
        d["componentType"] = d.pop("component_type")
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ComponentSpec":
        return cls(
            component_type=d.get("componentType", d.get("component_type", "worker")),
            replicas=int(d.get("replicas", 1)),
            image=d.get("image", DEFAULT_IMAGE),
            command=list(d.get("command", [])),
            args=list(d.get("args", [])),
            envs=dict(d.get("envs", {})),
            resources=Resources.from_dict(d.get("resources")),
            config=dict(d.get("config", {})),
            port=int(d.get("port", 0)),
            ingress=dict(d.get("ingress", {})),
        )


@dataclass
class DynamoGraphDeployment:
    """The graph CR: a named set of services deployed together."""

    name: str
    namespace: str = "default"
    services: dict[str, ComponentSpec] = field(default_factory=dict)
    labels: dict[str, str] = field(default_factory=dict)
    uid: str = ""  # server-assigned metadata.uid (present once applied to a cluster)

    kind = "DynamoGraphDeployment"

    def validate(self) -> None:
        if not self.name:
            raise ValueError("graph deployment needs metadata.name")
        if not self.services:
            raise ValueError(f"graph {self.name!r} has no services")
        for name, svc in self.services.items():
            svc.validate(name)

    def to_manifest(self) -> dict:
        return {
            "apiVersion": API_VERSION,
            "kind": self.kind,
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                "labels": self.labels,
            },
            "spec": {"services": {n: s.to_dict() for n, s in self.services.items()}},
        }

    @classmethod
    def from_manifest(cls, manifest: dict) -> "DynamoGraphDeployment":
        if manifest.get("kind") != cls.kind:
            raise ValueError(f"expected kind {cls.kind}, got {manifest.get('kind')!r}")
        meta = manifest.get("metadata", {})
        spec = manifest.get("spec", {})
        obj = cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            services={
                n: ComponentSpec.from_dict(s) for n, s in spec.get("services", {}).items()
            },
            labels=dict(meta.get("labels", {})),
            uid=meta.get("uid", ""),
        )
        obj.validate()
        return obj

    @classmethod
    def from_yaml(cls, text: str) -> "DynamoGraphDeployment":
        import yaml  # where a YAML manifest is read: importing the port leaves it out

        return cls.from_manifest(yaml.safe_load(text))


@dataclass
class DynamoComponentDeployment:
    """Child CR: one service of a graph (reference:
    dynamocomponentdeployment_controller.go reconciles these into
    Deployments/Services)."""

    name: str
    namespace: str
    graph: str  # owning DynamoGraphDeployment name
    service_name: str
    spec: ComponentSpec
    graph_uid: str = ""  # owner CR uid, when known (required for a valid ownerReference)

    kind = "DynamoComponentDeployment"

    def to_manifest(self) -> dict:
        metadata: dict = {
            "name": self.name,
            "namespace": self.namespace,
            "labels": {
                "dynamo.tpu/graph": self.graph,
                "dynamo.tpu/service": self.service_name,
                "dynamo.tpu/component-type": self.spec.component_type,
            },
        }
        # The API server rejects ownerReferences without uid, so only emit
        # one when the owning CR's uid is known (garbage collection); the
        # reconciler's label-based prune covers the uid-less case.
        if self.graph_uid:
            metadata["ownerReferences"] = [
                {
                    "apiVersion": API_VERSION,
                    "kind": DynamoGraphDeployment.kind,
                    "name": self.graph,
                    "uid": self.graph_uid,
                    "controller": True,
                }
            ]
        return {
            "apiVersion": API_VERSION,
            "kind": self.kind,
            "metadata": metadata,
            "spec": self.spec.to_dict(),
        }

    @classmethod
    def from_manifest(cls, manifest: dict) -> "DynamoComponentDeployment":
        meta = manifest.get("metadata", {})
        labels = meta.get("labels", {})
        return cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            graph=labels.get("dynamo.tpu/graph", ""),
            service_name=labels.get("dynamo.tpu/service", ""),
            spec=ComponentSpec.from_dict(manifest.get("spec", {})),
        )
