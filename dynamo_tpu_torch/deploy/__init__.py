"""Deployment plane: CRD-shaped graph/component specs, the reconciling
operator that translates them into Kubernetes manifests, and the graph
artifact registry (api-store).

Reference: deploy/cloud/operator (Go k8s operator, CRDs
DynamoGraphDeployment/DynamoComponentDeployment,
deploy/cloud/operator/api/v1alpha1/*_types.go:33-141) and
deploy/cloud/api-store.  Re-expressed in Python: the reconcile loop is pure
manifest translation + diffing, testable without a cluster via FakeKube.
"""

from dynamo_tpu_torch.deploy.crds import (
    ComponentSpec,
    DynamoComponentDeployment,
    DynamoGraphDeployment,
)
from dynamo_tpu_torch.deploy.operator import FakeKube, GraphReconciler, render_component_manifests

__all__ = [
    "ComponentSpec",
    "DynamoComponentDeployment",
    "DynamoGraphDeployment",
    "FakeKube",
    "GraphReconciler",
    "render_component_manifests",
]
