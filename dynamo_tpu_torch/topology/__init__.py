"""Fleet topology plane: discovery, link probing, and network-aware placement.

Three layers (see docs/topology.md):

- ``card``: each worker publishes a :class:`TopologyCard` (host fingerprint,
  process/slice identity from CUDA and ``torch.distributed``, data-plane
  address) through the control plane,
  lease-scoped like model registration so churn is visible as watch DELETEs.
- ``map``: :class:`TopologyMap` aggregates cards into nodes + pairwise links
  classified ``local``/``ici``/``dcn``; :class:`TopologyWatcher` keeps a map
  live off a ``watch_prefix`` the same way ``ModelWatcher`` tracks models.
- ``prober``: :class:`TopologyProber` measures pairwise RTT/bandwidth over the
  existing KV-transfer transport and folds results — plus ``KvTransferClient``
  per-destination send EWMAs — into the map, so priors decay into measurements.

Consumers (TransferCostModel, disagg router, planner rebalance, prefetch
pager) only act on a map that is *informative* — a single-host fleet discovers
an all-``local`` map and behaves byte-identically to a fleet with no topology
plane at all.
"""

from dynamo_tpu_torch.topology.card import (
    CARDS_PREFIX,
    TopologyCard,
    local_card,
    publish_card,
)
from dynamo_tpu_torch.topology.map import (
    TopologyLink,
    TopologyMap,
    TopologyWatcher,
    classify_link,
)
from dynamo_tpu_torch.topology.prober import TopologyProber

# hop classes keep the reference's names and the link model its default
# bandwidths (llm/kv_router/cost.py HOP_BANDWIDTH_BPS), for the cost
# model's parity: on a GPU host "ici" means "same host", and those defaults
# are the reference's TPU constants, not the card's, until the prober's
# measured bandwidth replaces them

__all__ = [
    "CARDS_PREFIX",
    "TopologyCard",
    "TopologyLink",
    "TopologyMap",
    "TopologyProber",
    "TopologyWatcher",
    "classify_link",
    "local_card",
    "publish_card",
]
