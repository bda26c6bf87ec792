"""Planner connectors: apply scaling decisions to a deployment substrate
(reference: components/planner local_connector.py (circus) and
kubernetes_connector.py (CRD scaling)).  A copy of
dynamo_tpu/planner/connectors.py over the port's ``deploy/`` plane."""

from __future__ import annotations

from dynamo_tpu_torch.planner.planner import PlannerDecision
from dynamo_tpu_torch.sdk.supervisor import ProcessSupervisor
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("planner.connectors")


class LocalConnector:
    """Scales prefill/decode worker replicas under the local supervisor."""

    def __init__(
        self,
        supervisor: ProcessSupervisor,
        *,
        prefill_watcher: str = "prefill",
        decode_watcher: str = "decode",
    ):
        self.supervisor = supervisor
        self.prefill_watcher = prefill_watcher
        self.decode_watcher = decode_watcher

    async def scale(self, decision: PlannerDecision) -> None:
        await self.supervisor.set_replicas(self.prefill_watcher, decision.num_prefill)
        await self.supervisor.set_replicas(self.decode_watcher, decision.num_decode)


class RecordingConnector:
    """Test/dry-run connector: records decisions."""

    def __init__(self) -> None:
        self.decisions: list[PlannerDecision] = []

    async def scale(self, decision: PlannerDecision) -> None:
        self.decisions.append(decision)


class KubernetesConnector:
    """Scales a DynamoGraphDeployment by patching ``spec.services.<name>
    .replicas`` on the GRAPH CR through a :class:`deploy.operator.KubeClient`
    (FakeKube in tests, KubectlClient against a cluster) — the operator's
    watch then reconciles the change into component CRs and Deployments.

    Patching the graph (not the child component CRs) mirrors the reference
    (components/planner/src/dynamo/planner/kubernetes_connector.py:36-43
    update_graph_replicas) and is what makes the change durable: the
    operator re-renders children from the graph spec on every reconcile,
    so a child-level patch would be overwritten at the next resync.
    """

    def __init__(
        self,
        kube,
        *,
        namespace: str = "default",
        graph: str = "dynamo",
        prefill_service: str = "prefill-worker",
        decode_service: str = "decode-worker",
    ):
        self.kube = kube
        self.namespace = namespace
        self.graph = graph
        self.prefill_service = prefill_service
        self.decode_service = decode_service

    async def scale(self, decision: PlannerDecision) -> None:
        import copy

        from dynamo_tpu_torch.deploy.crds import DynamoGraphDeployment

        fetched = await self.kube.get(
            DynamoGraphDeployment.kind, self.namespace, self.graph
        )
        if fetched is None:
            raise ValueError(
                f"graph {self.graph!r} not found in namespace {self.namespace!r}"
            )
        # re-apply only what a client owns: apiVersion/kind/name/labels/spec.
        # Echoing back server-populated fields (status, resourceVersion,
        # managedFields from a kubectl get) would turn this read-modify-write
        # into a lost-update/conflict hazard against a live cluster.
        manifest = {
            "apiVersion": fetched.get("apiVersion", "dynamo.tpu/v1alpha1"),
            "kind": fetched.get("kind", DynamoGraphDeployment.kind),
            "metadata": {
                "name": self.graph,
                "namespace": self.namespace,
                **(
                    {"labels": fetched["metadata"]["labels"]}
                    if fetched.get("metadata", {}).get("labels")
                    else {}
                ),
            },
            "spec": copy.deepcopy(fetched.get("spec", {})),
        }
        services = manifest["spec"].setdefault("services", {})
        changed = False
        for svc_name, replicas in (
            (self.prefill_service, decision.num_prefill),
            (self.decode_service, decision.num_decode),
        ):
            svc = services.get(svc_name)
            if svc is None:
                logger.warning(
                    "graph %s has no service %r; skipping scale", self.graph, svc_name
                )
                continue
            if svc.get("replicas", 1) != replicas:
                svc["replicas"] = replicas
                changed = True
        if changed:
            await self.kube.apply(manifest)
