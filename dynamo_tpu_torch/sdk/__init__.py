"""Service-graph SDK: declare components, run them locally under a process
supervisor, deploy to k8s (reference: deploy/sdk — @service/@endpoint/
depends DSL + circus-based ``dynamo serve``; a copy of dynamo_tpu/sdk, with
the allocator on CUDA cards)."""

from dynamo_tpu_torch.sdk.supervisor import ProcessSpec, ProcessSupervisor
from dynamo_tpu_torch.sdk.graph import DynamoService, depends, endpoint, service

__all__ = [
    "ProcessSpec",
    "ProcessSupervisor",
    "DynamoService",
    "depends",
    "endpoint",
    "service",
]
