"""Transfer-cost model for KV-locality decode selection.

Network-aware decode-instance selection (NetKV, arxiv 2606.03910): a
candidate that already holds the request's prefix blocks needs fewer KV
bytes shipped to it, and a candidate behind an ICI-class hop receives them
far faster than one behind DCN.  The model estimates, per candidate, the
relative cost of moving the MISSING prefix blocks over its link:

    cost(w) = missing_blocks(w) * bytes_per_block / bandwidth(w)

normalized to [0, 1] across the candidate set, which the scheduler folds
into its logit with ``transfer_cost_weight``.  Bandwidth per worker is the
measured EWMA when available (KvTransferClient exchanges, or the decode
worker's own inbound accounting published via ForwardPassMetrics) and a
hop-class prior until then.
"""

from __future__ import annotations

from dataclasses import dataclass

from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("llm.kv_router.cost")

# hop-class bandwidth priors, bytes/second: same-chip HBM copy, ICI
# slice-neighbor, and cross-host DCN — order-of-magnitude placements whose
# RATIO is what the normalized cost consumes (measurement replaces them)
HOP_BANDWIDTH_BPS = {
    "local": 400e9,
    "ici": 100e9,
    "dcn": 10e9,
}
DEFAULT_HOP = "dcn"  # assume the worst link until told otherwise


@dataclass
class LinkEstimate:
    """What the model knows about one worker's inbound link."""

    hop: str = ""                 # "local" | "ici" | "dcn" | "" (unknown)
    measured_bps: float = 0.0     # EWMA of observed transfers; 0 = unmeasured

    def bandwidth_bps(self) -> float:
        if self.measured_bps > 0:
            return self.measured_bps
        return HOP_BANDWIDTH_BPS.get(self.hop, HOP_BANDWIDTH_BPS[DEFAULT_HOP])


class TransferCostModel:
    """Per-worker link estimates + normalized transfer-cost scoring.

    Link state layers, per candidate, cheapest-information-first:

    1. explicit per-worker estimates (`DYN_TRANSFER_HOP` override published
       through metrics, observed transfers) — exactly the pre-topology model;
    2. an attached :class:`TopologyMap` (discovery + probing), consulted only
       while it is *informative* (at least one non-local pair) — a
       single-host all-local map changes nothing;
    3. the ``DEFAULT_HOP`` worst-case prior.
    """

    def __init__(self, *, ewma_alpha: float = 0.25) -> None:
        self._links: dict[int, LinkEstimate] = {}
        self._ewma_alpha = ewma_alpha
        self._topology = None          # TopologyMap, when attached
        self._self_worker_id: int | None = None

    def attach_topology(self, topo_map, *, self_worker_id: int | None = None) -> None:
        """Resolve unknown links from a discovered TopologyMap.

        ``self_worker_id`` names the node transfers originate from (a decode
        engine scoring its own inbound link); routers scoring many
        candidates leave it unset and each candidate is priced by its best
        link from the fleet's prefill nodes.
        """
        self._topology = topo_map
        self._self_worker_id = self_worker_id

    def _topology_bandwidth(self, worker_id: int) -> float | None:
        topo = self._topology
        if topo is None or not topo.informative():
            return None
        if worker_id not in topo.nodes:
            return None
        if self._self_worker_id is not None:
            return topo.pair_bandwidth(self._self_worker_id, worker_id)
        sources = [
            c.worker_id for c in topo.nodes.values()
            if c.role == "prefill" and c.worker_id != worker_id
        ] or [wid for wid in topo.nodes if wid != worker_id]
        if not sources:
            return None
        # a candidate is as near as its best prefill source
        return max(topo.pair_bandwidth(src, worker_id) for src in sources)

    # -- link state --------------------------------------------------------
    def update_link(
        self, worker_id: int, *, hop: str | None = None,
        bandwidth_bps: float | None = None,
    ) -> None:
        link = self._links.setdefault(worker_id, LinkEstimate())
        if hop:
            link.hop = hop
        if bandwidth_bps is not None and bandwidth_bps > 0:
            # already-smoothed source (a worker's cumulative mean): set
            link.measured_bps = bandwidth_bps

    def observe_transfer(self, worker_id: int, nbytes: int, seconds: float) -> None:
        """Fold one raw transfer observation into the worker's EWMA."""
        if nbytes <= 0 or seconds <= 0:
            return
        link = self._links.setdefault(worker_id, LinkEstimate())
        bps = nbytes / seconds
        link.measured_bps = (
            bps if link.measured_bps <= 0
            else link.measured_bps + self._ewma_alpha * (bps - link.measured_bps)
        )

    def update_from_metrics(self, metrics) -> None:
        """Ingest a ForwardPassMetrics load snapshot's link fields."""
        hop = getattr(metrics, "transfer_hop", "") or None
        bps = getattr(metrics, "kv_transfer_bandwidth_bps", 0.0)
        if hop or bps > 0:
            self.update_link(
                metrics.worker_id, hop=hop,
                bandwidth_bps=bps if bps > 0 else None,
            )

    def remove_worker(self, worker_id: int) -> None:
        self._links.pop(worker_id, None)

    def known(self) -> bool:
        """True once ANY worker has link information — before that, costs
        would be uniform noise and selection stays overlap/load-only.  An
        attached topology map counts only while informative: an all-local
        map leaves selection exactly overlap/load-only."""
        if any(link.hop or link.measured_bps > 0 for link in self._links.values()):
            return True
        return self._topology is not None and self._topology.informative()

    def bandwidth_bps(self, worker_id: int) -> float:
        link = self._links.get(worker_id)
        if link is not None and (link.hop or link.measured_bps > 0):
            return link.bandwidth_bps()
        topo_bps = self._topology_bandwidth(worker_id)
        if topo_bps is not None:
            return topo_bps
        return HOP_BANDWIDTH_BPS[DEFAULT_HOP]

    def estimate_seconds(self, worker_id: int, transfer_bytes: int) -> float:
        return transfer_bytes / self.bandwidth_bps(worker_id)

    # -- scoring -----------------------------------------------------------
    def costs(
        self, worker_ids: list[int], missing_blocks: dict[int, int],
        *, bytes_per_block: float = 1.0,
    ) -> dict[int, float]:
        """Normalized [0, 1] relative transfer cost per candidate (0 =
        cheapest possible, 1 = the worst candidate in this set)."""
        bpb = bytes_per_block if bytes_per_block > 0 else 1.0
        raw = {
            wid: missing_blocks.get(wid, 0) * bpb / self.bandwidth_bps(wid)
            for wid in worker_ids
        }
        worst = max(raw.values(), default=0.0)
        if worst <= 0:
            return {wid: 0.0 for wid in worker_ids}
        return {wid: v / worst for wid, v in raw.items()}
