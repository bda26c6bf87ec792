"""TopologyProber: bounded active measurement over the KV-transfer plane.

The prober reuses the data-plane transport (KvTransferClient → peer's
KvTransferServer) so measured RTT/bandwidth reflect the path real KV blocks
take — staging, framing, ack — not a synthetic ping.  Probe payloads carry a
reserved seq-id prefix; servers ack them without delivering to the engine
sink, so probing is invisible to decode state.

Budget: one tick every ``DYN_TOPO_PROBE_PERIOD_S`` probes at most
``DYN_TOPO_PROBE_MAX_PER_TICK`` peers (round-robin cursor), each with a
``DYN_TOPO_PROBE_BYTES`` payload.  Passive measurements — the
``KvTransferClient`` per-destination send EWMAs that real transfers already
maintain — are folded in by :meth:`merge_client_ewmas`, so a busy fleet
barely needs active probes at all.
"""

from __future__ import annotations

import logging
import time
import uuid

import torch

from dynamo_tpu_torch.parallel.kv_transfer import (
    PROBE_SEQ_PREFIX,
    KvTransferClient,
    KvTransferPayload,
)
from dynamo_tpu_torch.topology.map import TopologyMap
from dynamo_tpu_torch.utils import knobs
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = logging.getLogger(__name__)


class TopologyProber:
    def __init__(
        self,
        topo_map: TopologyMap,
        *,
        self_worker_id: int,
        client: KvTransferClient | None = None,
        period_s: float | None = None,
        probe_bytes: int | None = None,
        max_per_tick: int | None = None,
        clock=time.monotonic,
    ):
        self.map = topo_map
        self.self_worker_id = self_worker_id
        self.client = client if client is not None else KvTransferClient()
        self.period_s = (
            period_s if period_s is not None
            else knobs.get("DYN_TOPO_PROBE_PERIOD_S")
        )
        self.probe_bytes = (
            probe_bytes if probe_bytes is not None
            else knobs.get("DYN_TOPO_PROBE_BYTES")
        )
        self.max_per_tick = (
            max_per_tick if max_per_tick is not None
            else knobs.get("DYN_TOPO_PROBE_MAX_PER_TICK")
        )
        self._clock = clock
        self._cursor = 0
        self._task = None
        self.probes_sent = 0
        self.probe_failures = 0

    async def start(self) -> None:
        import asyncio

        async def _loop() -> None:
            while True:
                await asyncio.sleep(self.period_s)
                await self.probe_once()
                self.merge_client_ewmas()

        self._task = spawn_logged(_loop(), name="topology-prober")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def _peers(self) -> list:
        return [
            card for wid, card in sorted(self.map.nodes.items())
            if wid != self.self_worker_id and card.transfer_address
        ]

    async def probe_once(self) -> int:
        """Probe up to ``max_per_tick`` peers; returns probes completed."""
        peers = self._peers()
        if not peers:
            return 0
        done = 0
        n = min(self.max_per_tick, len(peers))
        for i in range(n):
            card = peers[(self._cursor + i) % len(peers)]
            payload = KvTransferPayload(
                seq_id=f"{PROBE_SEQ_PREFIX}{uuid.uuid4().hex}",
                first_token=-1,
                block_ids=[],
                blocks={"probe": torch.zeros(self.probe_bytes, dtype=torch.uint8)},
            )
            start = self._clock()
            try:
                await self.client.send(card.transfer_address, payload)
            except (OSError, ConnectionError) as exc:
                self.probe_failures += 1
                logger.debug(
                    "topology probe to %s failed: %s", card.transfer_address, exc
                )
                continue
            elapsed = self._clock() - start
            self.map.observe(
                self.self_worker_id,
                card.worker_id,
                rtt_s=elapsed,
                nbytes=self.probe_bytes,
                seconds=elapsed,
            )
            self.probes_sent += 1
            done += 1
        self._cursor = (self._cursor + n) % max(1, len(peers))
        return done

    def merge_client_ewmas(self, client: KvTransferClient | None = None) -> int:
        """Fold a KvTransferClient's per-address bandwidth EWMAs into the
        map (the ROADMAP's "feed the per-destination client EWMA back into
        the router" — the router reads the map).  Returns links updated."""
        source = client if client is not None else self.client
        merged = 0
        for address, bps in list(source.bandwidth_bps.items()):
            if bps <= 0:
                continue
            peer = self.map.worker_by_address(address)
            if peer is None or peer == self.self_worker_id:
                continue
            self.map.observe(self.self_worker_id, peer, bandwidth_bps=bps)
            merged += 1
        return merged

    def stats(self) -> dict:
        return {
            "topo_probes_sent": self.probes_sent,
            "topo_probe_failures": self.probe_failures,
        }
