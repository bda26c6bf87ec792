"""TopologyCard: what each worker publishes about where it sits.

A card is the discovery half of the topology plane: a small, lease-scoped
control-plane entry describing the worker's physical placement — host
fingerprint, process/slice identity, accelerator coords, and the
data-plane address its KV-transfer server listens on.  A copy of
dynamo_tpu/topology/card.py whose identity comes from CUDA and
``torch.distributed`` (``_cuda_identity``) instead of JAX devices; the
card's JSON keys are the reference's, so each stack reads the other's
cards.  The aggregator
(:class:`dynamo_tpu_torch.topology.map.TopologyWatcher`) assembles cards into a
live :class:`TopologyMap`; cards vanish with the worker's lease so churn is
observable the same way instance churn is.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket

from dynamo_tpu_torch.runtime.component import ROOT_PATH
from dynamo_tpu_torch.utils import knobs

CARDS_PREFIX = f"{ROOT_PATH}topology/cards/"


@dataclasses.dataclass
class TopologyCard:
    """One worker's placement facts, as published to the control plane."""

    worker_id: int
    host: str = ""
    pid: int = 0
    process_index: int = -1
    slice_label: str = ""
    coords: list = dataclasses.field(default_factory=list)
    transfer_address: str = ""
    role: str = ""

    def key(self) -> str:
        return f"{CARDS_PREFIX}{self.worker_id:016x}"

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @classmethod
    def from_json(cls, data: bytes | str) -> "TopologyCard":
        d = json.loads(data)
        # filter unknown keys so newer publishers stay readable by older
        # aggregators (same wire posture as ForwardPassMetrics.from_json)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def _cuda_identity() -> tuple[int, str, list]:
    """(process_index, slice_label, coords) of this process on a GPU host,
    the counterpart of the reference's JAX identity: the
    ``torch.distributed`` rank when a process group is initialised (else
    0), no slice label (``DYN_TOPO_SLICE`` sets one), and the current
    device's index as the coords only where CUDA is already initialised.
    It never initialises the accelerator itself."""
    try:
        import torch

        process_index = 0
        dist = getattr(torch, "distributed", None)
        if dist is not None and dist.is_available() and dist.is_initialized():
            process_index = int(dist.get_rank())
        coords: list = []
        if torch.cuda.is_initialized():
            coords = [int(torch.cuda.current_device())]
        return process_index, "", coords
    except Exception:
        return -1, "", []


def local_card(
    worker_id: int,
    *,
    transfer_address: str = "",
    role: str = "",
    slice_label: str | None = None,
) -> TopologyCard:
    """Build this process's card.

    Slice label precedence: explicit ``slice_label`` argument (benches and
    soaks that emulate several slices in one process) > ``DYN_TOPO_SLICE``
    knob > empty (the classifier falls back to host/pid fingerprints: on a
    GPU host the reference's ``ici`` class means "same host").
    """
    process_index, detected_slice, coords = _cuda_identity()
    if slice_label is None:
        slice_label = knobs.get("DYN_TOPO_SLICE") or detected_slice
    return TopologyCard(
        worker_id=worker_id,
        host=socket.gethostname(),
        pid=os.getpid(),
        process_index=process_index,
        slice_label=slice_label,
        coords=coords,
        transfer_address=transfer_address,
        role=role,
    )


async def publish_card(service, card: TopologyCard) -> None:
    """Publish ``card`` under the service's registration lease.

    Same idiom as ``register_llm``: a lease-scoped put means the card is
    reaped with the worker, and the aggregator's watch sees a DELETE.
    """
    await service.runtime.plane.kv.put(
        card.key(), card.to_json(), service._lease.id
    )
