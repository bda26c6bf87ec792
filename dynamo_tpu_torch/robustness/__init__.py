"""Fault injection + self-healing runtime primitives (counterpart of
dynamo_tpu/robustness/).

- :mod:`faults`   — named fault points checked at the runtime's seams, armed
  via ``DYN_FAULTS`` with deterministic triggers.
- :mod:`retry`    — capped exponential backoff with jitter.
- :mod:`counters` — process-global recovery counters.

The frontend's admission control (``admission``) comes with the HTTP
service's slice.
"""

from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.robustness.faults import FAULTS, FaultRegistry, get_faults
from dynamo_tpu_torch.robustness.retry import Backoff

__all__ = [
    "FAULTS",
    "Backoff",
    "FaultRegistry",
    "counters",
    "get_faults",
]
