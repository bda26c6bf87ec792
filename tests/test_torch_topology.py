"""The port's topology plane (dynamo_tpu_torch/topology/) against the
reference's (dynamo_tpu/topology/):
- cards read both ways between the stacks (the same JSON keys), through
  each stack's watcher over one control plane of each kind;
- ``classify_link`` and ``TopologyMap`` equal to the reference's on the
  same card and measurement events (links, hops, bandwidths, dumps);
- the prober against the reference's over each stack's transfer server
  (probes acked, never delivered; RTT and bandwidth folded in; passive
  client EWMAs merged; failures counted);
- ``_cuda_identity`` on a CPU-only host returns without touching CUDA;
- the wiring: a worker's ingress publishes its card at ``DYN_TOPO=1`` and
  none at 0, the frontend's watcher builds a live map, and the frontend's
  ``/metrics`` renders it."""

import asyncio
import itertools
import json
import random

import pytest
import torch

from dynamo_tpu import topology as jax_topo
from dynamo_tpu.parallel import kv_transfer as jax_xfer
from dynamo_tpu.topology import card as jax_card
from dynamo_tpu.topology import metrics as jax_topo_metrics
from dynamo_tpu_torch import topology as topo
from dynamo_tpu_torch.llm.discovery import ModelWatcher
from dynamo_tpu_torch.llm.http import ModelManager
from dynamo_tpu_torch.llm.http.metrics import FrontendMetrics
from dynamo_tpu_torch.parallel import kv_transfer as xfer
from dynamo_tpu_torch.topology import card as card_mod
from dynamo_tpu_torch.topology import metrics as topo_metrics

_names = itertools.count()


def random_cards(seed: int, n: int = 6):
    """The same cards for both stacks: hosts, pids, slices, roles."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        fields = dict(worker_id=i + 1, host=rng.choice(["h0", "h1", ""]), pid=rng.choice([1, 2]),
                      process_index=rng.randint(0, 3), slice_label=rng.choice(["", "s0", "s1"]),
                      coords=[rng.randint(0, 7)], transfer_address=f"10.0.0.{i}:7000",
                      role=rng.choice(["prefill", "decode", ""]))
        out.append((topo.TopologyCard(**fields), jax_topo.TopologyCard(**fields)))
    return out


def test_cards_read_both_ways():
    for ours, ref in random_cards(0):
        assert json.loads(ours.to_json()) == json.loads(ref.to_json())
        assert ours.key() == ref.key()
        assert jax_topo.TopologyCard.from_json(ours.to_json()) == ref
        assert topo.TopologyCard.from_json(ref.to_json()) == ours
    # an unknown key from a newer publisher is ignored on both sides
    extra = json.dumps({**json.loads(ours.to_json()), "future": 1})
    assert topo.TopologyCard.from_json(extra) == ours
    assert topo.CARDS_PREFIX == jax_topo.CARDS_PREFIX


@pytest.mark.parametrize("seed", range(4))
def test_classify_and_map_equal_the_reference(seed):
    cards = random_cards(seed)
    for (a, ra), (b, rb) in itertools.product(cards, cards):
        assert topo.classify_link(a, b) == jax_topo.classify_link(ra, rb)
    ticks = itertools.count()
    ours = topo.TopologyMap(clock=lambda: float(next(ticks)))
    rticks = itertools.count()
    ref = jax_topo.TopologyMap(clock=lambda: float(next(rticks)))
    rng = random.Random(seed)
    for step in range(40):
        op = rng.random()
        if op < 0.4:
            c, rc = rng.choice(cards)
            ours.upsert(c)
            ref.upsert(rc)
        elif op < 0.5:
            wid = rng.randint(1, len(cards))
            ours.remove(wid)
            ref.remove(wid)
        else:
            a, b = rng.randint(1, len(cards)), rng.randint(1, len(cards))
            kw = rng.choice([dict(rtt_s=rng.random() / 100, nbytes=4096, seconds=rng.random()),
                             dict(bandwidth_bps=rng.random() * 1e10)])
            ours.observe(a, b, **kw)
            ref.observe(a, b, **kw)
        assert ours.to_dict() == ref.to_dict()
        assert ours.links_by_class() == ref.links_by_class()
        assert ours.informative() == ref.informative()
        for wid in range(1, len(cards) + 1):
            assert ours.inbound_hop(wid) == ref.inbound_hop(wid)
            for other in range(1, len(cards) + 1):
                assert ours.pair_bandwidth(wid, other) == ref.pair_bandwidth(wid, other)
    assert topo_metrics.render(ours) == jax_topo_metrics.render(ref)


def test_cuda_identity_on_a_cpu_host_never_touches_cuda(monkeypatch):
    assert not torch.cuda.is_initialized()
    monkeypatch.setattr(torch.cuda, "init", lambda: pytest.fail("CUDA initialised"))
    process_index, slice_label, coords = card_mod._cuda_identity()
    assert (process_index, slice_label, coords) == (0, "", [])
    assert not torch.cuda.is_initialized()
    monkeypatch.setenv("DYN_TOPO_SLICE", "rack7")
    card = topo.local_card(9, transfer_address="a:1", role="decode")
    assert (card.worker_id, card.slice_label, card.process_index, card.coords, card.role) == (
        9, "rack7", 0, [], "decode")
    assert topo.local_card(9, slice_label="s2").slice_label == "s2"
    # the reference's card of the same worker classifies the same against it
    ref = jax_card.TopologyCard(**json.loads(card.to_json()))
    assert topo.classify_link(card, card) == jax_topo.classify_link(ref, ref) == "local"


def _pair(mod, address):
    m = mod.TopologyMap()
    m.upsert(mod.TopologyCard(worker_id=1, host="h0", pid=1, role="prefill"))
    m.upsert(mod.TopologyCard(worker_id=2, host="h0", pid=1, role="decode",
                              transfer_address=address))
    return m


@pytest.mark.parametrize("server_stack", ["port", "jax"])
async def test_prober_measures_like_the_reference(server_stack):
    """Both stacks' probers probe the same server once: each link gains one
    probe with RTT and bandwidth, nothing is delivered to the sink."""
    delivered = []

    async def sink(p):
        delivered.append(p)

    server_mod = xfer if server_stack == "port" else jax_xfer
    server = server_mod.KvTransferServer(sink)
    await server.start()
    try:
        results = {}
        for name, mod, client_mod in (("port", topo, xfer), ("jax", jax_topo, jax_xfer)):
            m = _pair(mod, server.address)
            prober = mod.TopologyProber(m, self_worker_id=1, client=client_mod.KvTransferClient(),
                                        period_s=999.0, probe_bytes=4096, max_per_tick=4)
            assert await prober.probe_once() == 1
            link = m.link(1, 2)
            assert link.rtt_s > 0 and link.measured_bps > 0
            results[name] = (link.probes_total, prober.probes_sent, prober.probe_failures)
            await prober.client.close()
        assert results["port"] == results["jax"] == (1, 1, 0)
        assert delivered == []
    finally:
        await server.stop()


async def test_prober_failures_and_passive_merge_equal_the_reference():
    out = {}
    for name, mod, client_mod in (("port", topo, xfer), ("jax", jax_topo, jax_xfer)):
        m = mod.TopologyMap()
        m.upsert(mod.TopologyCard(worker_id=1, slice_label="s0", role="prefill"))
        m.upsert(mod.TopologyCard(worker_id=2, slice_label="s1", role="decode",
                                  transfer_address="127.0.0.1:1"))  # a dead port
        client = client_mod.KvTransferClient()
        prober = mod.TopologyProber(m, self_worker_id=1, client=client, period_s=999.0,
                                    probe_bytes=16, max_per_tick=4)
        prior = m.pair_bandwidth(1, 2)
        done = await prober.probe_once()
        client.bandwidth_bps["127.0.0.1:1"] = 2e9
        client.bandwidth_bps["unknown:1"] = 9e9  # no card: ignored
        merged = prober.merge_client_ewmas()
        client.bandwidth_bps["127.0.0.1:1"] = 4e9
        prober.merge_client_ewmas()
        out[name] = (prior, done, prober.probe_failures, merged, m.pair_bandwidth(1, 2),
                     prober.stats())
        await client.close()
    assert out["port"] == out["jax"]
    assert out["port"][:5] == (10e9, 0, 1, 1, 0.75 * 2e9 + 0.25 * 4e9)


async def test_prefill_pump_hosts_the_prober():
    from dynamo_tpu_torch.llm.disagg import PrefillWorker

    m = _pair(topo, "10.0.0.2:7000")
    pump = PrefillWorker(None, None, None)
    pump.attach_topology(m, self_worker_id=1)
    assert pump._prober.client is pump.client
    pump.client.bandwidth_bps["10.0.0.2:7000"] = 3e9
    assert pump._prober.merge_client_ewmas() == 1
    assert m.pair_bandwidth(1, 2) == 3e9
    await pump.stop()
    assert pump._prober is None


async def _published_cards(pkg_topo_on: bool):
    """A port worker endpoint served with topology facts: the cards the
    port's own watcher and the reference's watcher see over the plane."""
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    rt = await DistributedRuntime.create(RuntimeConfig(
        control_plane=f"memory://topo-{next(_names)}"))

    class Echo:
        async def generate(self, request):
            raise NotImplementedError

    try:
        ep = rt.namespace("ns").component("backend").endpoint("generate")
        service = await ep.serve(Echo(), topo_role="decode",
                                 topo_transfer_address="127.0.0.1:7100", topo_slice="s3")
        # the frontend's model watcher keeps the live map (DYN_TOPO) and its
        # /metrics renders it, as serve_frontend wires them
        watcher = ModelWatcher(rt, ModelManager())
        await watcher.start()
        metrics = FrontendMetrics()
        metrics.attach_topology(watcher.topology)
        for _ in range(100):
            if not pkg_topo_on or watcher.topology.nodes:
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.05)
        cards = dict(watcher.topology.nodes) if watcher.topology is not None else {}
        raw = [e.value for e in await rt.plane.kv.get_prefix(topo.CARDS_PREFIX)]
        rendered = metrics.render().decode()
        await watcher.stop()
        await service.shutdown()
        return cards, raw, service.instance.instance_id, rendered
    finally:
        await rt.close()


async def test_ingress_publishes_the_card_at_dyn_topo(monkeypatch):
    monkeypatch.setenv("DYN_TOPO", "1")
    cards, raw, wid, rendered = await _published_cards(True)
    assert list(cards) == [wid]
    assert "dyn_topology_nodes 1.0" in rendered
    card = cards[wid]
    assert (card.role, card.transfer_address, card.slice_label) == ("decode", "127.0.0.1:7100", "s3")
    # the reference reads the port's published card
    (value,) = raw
    assert jax_topo.TopologyCard.from_json(value).worker_id == wid
    monkeypatch.setenv("DYN_TOPO", "0")
    cards, raw, _, rendered = await _published_cards(False)
    assert cards == {} and raw == []
    assert "dyn_topology_nodes 0.0" in rendered
