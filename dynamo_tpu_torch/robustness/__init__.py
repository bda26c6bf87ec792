"""Fault injection + self-healing runtime primitives (counterpart of
dynamo_tpu/robustness/).

- :mod:`faults`   — named fault points checked at the runtime's seams, armed
  via ``DYN_FAULTS`` with deterministic triggers.
- :mod:`retry`    — capped exponential backoff with jitter.
- :mod:`counters` — process-global recovery counters.
- :mod:`admission` — the frontend's load shedding (429/503 + Retry-After).
"""

from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.robustness.admission import (
    AdmissionConfig,
    AdmissionController,
    Overloaded,
)
from dynamo_tpu_torch.robustness.faults import FAULTS, FaultRegistry, get_faults
from dynamo_tpu_torch.robustness.retry import Backoff

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "FAULTS",
    "Backoff",
    "FaultRegistry",
    "Overloaded",
    "counters",
    "get_faults",
]
