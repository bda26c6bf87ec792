"""Predictive KV prefetch over the offload tiers.

Turns offload paging from reactive to predictive (PRESERVE, arxiv
2501.08192; packing-prefetch scheduling, arxiv 2508.08457): hint sources
announce soon-to-arrive prefixes, the kv_router targets the worker whose
radix index holds the prefix, and the engine's pager onboards the hinted
blocks disk/host→HBM *while the current batch computes* — so a returning
multi-turn session's page-in latency is hidden instead of paid on TTFT.

Pieces (each usable alone):

- :mod:`hints`     — wire protocol + subjects + the ``DYN_PREFETCH`` gate
- :mod:`session`   — SessionPredictor: inter-turn-gap model over prefix
  hash chains, predicting next-turn arrivals
- :mod:`frontend`  — FrontendHinter: emits an arrival hint the moment a
  request enters the HTTP admission path, before dispatch
- :mod:`forwarder` — PrefetchForwarder: router-side targeting (radix
  overlap → worker) + predicted-hint firing
- :mod:`worker`    — PrefetchListener: worker-side subscriber feeding the
  engine's pager
- :mod:`pager`     — PrefetchPager: the engine's priority-ordered job
  queue with stale cancellation and hit/miss/hidden-latency accounting
"""

from dynamo_tpu_torch.prefetch.hints import (
    PREFETCH_HINT_SUBJECT,
    PREFETCH_TARGET_SUBJECT,
    PrefetchHint,
    TargetedPrefetchHint,
    prefetch_enabled,
)
from dynamo_tpu_torch.prefetch.pager import PrefetchPager
from dynamo_tpu_torch.prefetch.session import SessionPredictor

__all__ = [
    "PREFETCH_HINT_SUBJECT",
    "PREFETCH_TARGET_SUBJECT",
    "PrefetchHint",
    "TargetedPrefetchHint",
    "PrefetchPager",
    "SessionPredictor",
    "prefetch_enabled",
]
