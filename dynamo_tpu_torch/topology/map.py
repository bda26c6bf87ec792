"""TopologyMap: live fleet network map assembled from TopologyCards.

Nodes are workers (keyed by worker id); links are unordered pairs classified
``local``/``ici``/``dcn`` from card fingerprints, then refined by probe and
transfer measurements (EWMA — priors decay into measurements).

The parity gate for a single-host fleet is :meth:`TopologyMap.informative`:
a map whose every pair classifies ``local`` carries no placement signal, so
consumers ignore it entirely and behave byte-identically to a fleet with no
topology plane.
"""

from __future__ import annotations

import dataclasses
import logging
import time

from dynamo_tpu_torch.llm.kv_router.cost import DEFAULT_HOP, HOP_BANDWIDTH_BPS
from dynamo_tpu_torch.runtime.controlplane.interface import WatchEventType
from dynamo_tpu_torch.topology.card import CARDS_PREFIX, TopologyCard
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = logging.getLogger(__name__)


def classify_link(a: TopologyCard, b: TopologyCard) -> str:
    """Hop class between two cards from placement fingerprints alone.

    Explicit slice labels win over host fingerprints: an emulated two-slice
    fleet on one laptop must classify cross-slice pairs ``dcn`` even though
    every worker shares a hostname.
    """
    if a.worker_id == b.worker_id:
        return "local"
    if a.slice_label and b.slice_label and a.slice_label != b.slice_label:
        return "dcn"
    if a.host and a.host == b.host and a.pid == b.pid:
        return "local"
    if a.slice_label and a.slice_label == b.slice_label:
        return "ici"
    if a.host and a.host == b.host:
        return "ici"
    return "dcn"


@dataclasses.dataclass
class TopologyLink:
    """Per-pair state: classified hop + measured RTT/bandwidth EWMAs."""

    hop: str = ""
    rtt_s: float = 0.0
    measured_bps: float = 0.0
    probes_total: int = 0

    def bandwidth_bps(self) -> float:
        if self.measured_bps > 0:
            return self.measured_bps
        return HOP_BANDWIDTH_BPS.get(self.hop, HOP_BANDWIDTH_BPS[DEFAULT_HOP])


class TopologyMap:
    """Nodes + pairwise links; the aggregator's single mutable artifact."""

    def __init__(self, *, ewma_alpha: float = 0.25, clock=time.monotonic):
        self.ewma_alpha = ewma_alpha
        self._clock = clock
        self.nodes: dict[int, TopologyCard] = {}
        self._links: dict[tuple[int, int], TopologyLink] = {}
        self._updated_at: float = clock()

    # -- membership ----------------------------------------------------------
    def upsert(self, card: TopologyCard) -> None:
        self.nodes[card.worker_id] = card
        for other_id, other in self.nodes.items():
            if other_id == card.worker_id:
                continue
            link = self._links.setdefault(
                self._pair(card.worker_id, other_id), TopologyLink()
            )
            link.hop = classify_link(card, other)
        self._updated_at = self._clock()

    def remove(self, worker_id: int) -> None:
        self.nodes.pop(worker_id, None)
        for pair in [p for p in self._links if worker_id in p]:
            del self._links[pair]
        self._updated_at = self._clock()

    # -- lookup --------------------------------------------------------------
    @staticmethod
    def _pair(a: int, b: int) -> tuple[int, int]:
        return (a, b) if a <= b else (b, a)

    def link(self, a: int, b: int) -> TopologyLink | None:
        if a == b:
            return TopologyLink(hop="local")
        return self._links.get(self._pair(a, b))

    def hop(self, a: int, b: int) -> str:
        link = self.link(a, b)
        return link.hop if link is not None else ""

    def pair_bandwidth(self, a: int, b: int) -> float:
        link = self.link(a, b)
        if link is None:
            return HOP_BANDWIDTH_BPS[DEFAULT_HOP]
        return link.bandwidth_bps()

    def worker_by_address(self, address: str) -> int | None:
        for wid, card in self.nodes.items():
            if card.transfer_address and card.transfer_address == address:
                return wid
        return None

    def inbound_hop(self, worker_id: int, *, src_role: str = "prefill") -> str:
        """Best (cheapest) hop class from any ``src_role`` node to this
        worker — the discovered analogue of the old per-worker
        ``DYN_TRANSFER_HOP`` self-report."""
        order = {"local": 0, "ici": 1, "dcn": 2}
        sources = [
            c for c in self.nodes.values()
            if c.role == src_role and c.worker_id != worker_id
        ] or [c for c in self.nodes.values() if c.worker_id != worker_id]
        best = ""
        for src in sources:
            hop = self.hop(src.worker_id, worker_id)
            if hop and (not best or order.get(hop, 3) < order.get(best, 3)):
                best = hop
        return best

    # -- measurement ---------------------------------------------------------
    def observe(
        self,
        a: int,
        b: int,
        *,
        rtt_s: float | None = None,
        nbytes: int | None = None,
        seconds: float | None = None,
        bandwidth_bps: float | None = None,
    ) -> None:
        """Fold one probe/transfer observation into the pair's EWMAs."""
        if a == b:
            return
        link = self._links.setdefault(self._pair(a, b), TopologyLink())
        alpha = self.ewma_alpha
        if rtt_s is not None and rtt_s > 0:
            link.rtt_s = (
                rtt_s if link.rtt_s <= 0
                else (1 - alpha) * link.rtt_s + alpha * rtt_s
            )
        bps = bandwidth_bps
        if bps is None and nbytes and seconds and seconds > 0:
            bps = nbytes / seconds
        if bps is not None and bps > 0:
            link.measured_bps = (
                bps if link.measured_bps <= 0
                else (1 - alpha) * link.measured_bps + alpha * bps
            )
        link.probes_total += 1
        self._updated_at = self._clock()

    # -- summaries -----------------------------------------------------------
    def informative(self) -> bool:
        """True iff the map carries placement signal — at least one pair is
        non-``local``.  A single-host all-local map is NOT informative, so
        consumers fall through to their pre-topology behavior exactly."""
        return any(link.hop not in ("", "local") for link in self._links.values())

    def links_by_class(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for link in self._links.values():
            hop = link.hop or "unknown"
            out[hop] = out.get(hop, 0) + 1
        return out

    def age_s(self) -> float:
        return max(0.0, self._clock() - self._updated_at)

    def to_dict(self) -> dict:
        """JSON-friendly dump (dynctl topology, tests)."""
        return {
            "nodes": {
                f"{wid:016x}": dataclasses.asdict(card)
                for wid, card in sorted(self.nodes.items())
            },
            "links": [
                {
                    "a": f"{a:016x}",
                    "b": f"{b:016x}",
                    "hop": link.hop,
                    "rtt_s": link.rtt_s,
                    "measured_bps": link.measured_bps,
                    "prior_bps": HOP_BANDWIDTH_BPS.get(
                        link.hop, HOP_BANDWIDTH_BPS[DEFAULT_HOP]
                    ),
                    "probes_total": link.probes_total,
                }
                for (a, b), link in sorted(self._links.items())
            ],
            "informative": self.informative(),
            "age_s": self.age_s(),
        }


class TopologyWatcher:
    """Keeps a TopologyMap live off the control plane's card prefix.

    Same shape as ``ModelWatcher``: ``watch_prefix`` replays existing cards
    as PUTs before streaming live events, so no seed read is needed.
    """

    def __init__(self, runtime, *, map: TopologyMap | None = None):
        self.runtime = runtime
        self.map = map if map is not None else TopologyMap()
        self._watch = None
        self._task = None

    async def start(self) -> None:
        self._watch = self.runtime.plane.kv.watch_prefix(CARDS_PREFIX)
        self._task = spawn_logged(self._loop(), name="topology-watcher")

    async def stop(self) -> None:
        if self._watch is not None:
            self._watch.cancel()
            self._watch = None
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        try:
            async for event in self._watch:
                if event.type == WatchEventType.PUT:
                    try:
                        card = TopologyCard.from_json(event.entry.value)
                    except (ValueError, TypeError) as exc:
                        logger.warning("topology: bad card %s: %s", event.entry.key, exc)
                        continue
                    self.map.upsert(card)
                elif event.type == WatchEventType.DELETE:
                    suffix = event.entry.key[len(CARDS_PREFIX):]
                    try:
                        self.map.remove(int(suffix, 16))
                    except ValueError:
                        logger.warning("topology: bad card key %s", event.entry.key)
        except ConnectionError as exc:
            # keep serving off the last good map; reconnect is the runtime's
            # problem, staleness shows up in dyn_topology_map_age_seconds
            logger.warning("topology watch lost: %s", exc)
