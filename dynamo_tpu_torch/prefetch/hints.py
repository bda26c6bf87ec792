"""Prefetch hint wire protocol.

Hints ride the control-plane bus on component-scoped event subjects, the
same transport as KV events (``kv_router/protocols.py``):

- ``prefetch_hints``   — hint sources (frontend arrival hints, predicted
  next-turn hints) → the router's forwarder
- ``prefetch_targets`` — forwarder → workers, attributed to the worker
  whose radix index showed prefix overlap (every worker of the component
  receives the message and filters on its own id — subjects are
  component-scoped, exactly like ``clear_kv_blocks``)

A hint carries block *hashes*, not tokens: hashes are the cross-layer
currency (allocator registry, radix index, offload tiers all key on the
same chained xxh3), and a hint must never carry prompt content over the
bus.
"""

from __future__ import annotations

import json
import os
import time
from dynamo_tpu_torch.utils import knobs
from dataclasses import asdict, dataclass, field

PREFETCH_HINT_SUBJECT = "prefetch_hints"
PREFETCH_TARGET_SUBJECT = "prefetch_targets"

# hint sources, in descending urgency: a request already queued on this
# worker > a request entering the frontend's admission path > a predicted
# next-turn arrival
SOURCE_QUEUED = "queued"
SOURCE_ARRIVAL = "arrival"
SOURCE_PREDICTED = "predicted"

# smaller = sooner in the pager's priority queue
SOURCE_PRIORITY = {SOURCE_QUEUED: 0, SOURCE_ARRIVAL: 10, SOURCE_PREDICTED: 20}


def prefetch_enabled(default: bool = True) -> bool:
    """The ``DYN_PREFETCH`` gate (0/false/off disables; default on).
    ``DYN_PREFETCH=0`` restores fully demand-driven paging everywhere."""
    value = knobs.get_raw("DYN_PREFETCH")
    if value is None:
        return default
    return knobs.parse_bool(value, default)


@dataclass
class PrefetchHint:
    """A prefix expected to be requested soon."""

    block_hashes: list[int] = field(default_factory=list)
    source: str = SOURCE_ARRIVAL
    ts: float = field(default_factory=time.time)

    def to_json(self) -> bytes:
        return json.dumps(asdict(self)).encode()

    @classmethod
    def from_dict(cls, d: dict) -> "PrefetchHint":
        """Unknown keys dropped: a newer peer may add fields, and an older
        listener must keep decoding (same contract for nested hints)."""
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, data: bytes) -> "PrefetchHint":
        return cls.from_dict(json.loads(data))


@dataclass
class TargetedPrefetchHint:
    """A hint resolved to the worker holding the offloaded prefix."""

    worker_id: int
    hint: PrefetchHint

    def to_json(self) -> bytes:
        return json.dumps(
            {"worker_id": self.worker_id, "hint": asdict(self.hint)}
        ).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "TargetedPrefetchHint":
        d = json.loads(data)
        return cls(worker_id=d["worker_id"], hint=PrefetchHint.from_dict(d["hint"]))
