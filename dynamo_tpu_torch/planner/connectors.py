"""Planner connectors: apply scaling decisions to a deployment substrate
(reference: components/planner local_connector.py (circus) and
kubernetes_connector.py (CRD scaling)).  A copy of
dynamo_tpu/planner/connectors.py's local and recording connectors; its
``KubernetesConnector`` comes with the port's ``deploy/`` plane."""

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
