"""The port's standalone services against the reference's, each over its
own memory control plane: the metrics service's Prometheus text after the
same worker load, KV-hit-rate and planner-state events (timestamps masked;
the counterpart of tests/llm/test_metrics_service.py), and the KV router
service's choices for the same requests over the same published blocks (the
counterpart of tests/llm/test_embeddings_and_router_service.py).

The metrics text is compared with the topology plane off on both (the
services would otherwise watch maps of different worker ids); the watcher
itself is held apart: each service starts one at ``DYN_TOPO=1`` and renders
its live map, none at 0."""

import asyncio
import re

import httpx
import numpy as np
import pytest

from dynamo_tpu.components import metrics_service as ref_metrics
from dynamo_tpu.components import router_service as ref_router_service
from dynamo_tpu.engine.kv_manager import KvEvent as RefKvEvent
from dynamo_tpu.llm.kv_router import compute_block_hashes as ref_hashes
from dynamo_tpu.llm.kv_router import protocols as ref_protocols
from dynamo_tpu.llm.kv_router import publisher as ref_publisher
from dynamo_tpu.planner import state as ref_state
from dynamo_tpu.robustness import counters as ref_counters
from dynamo_tpu.runtime import client as ref_client
from dynamo_tpu.runtime import distributed as ref_distributed
from dynamo_tpu.runtime import engine as ref_engine
from dynamo_tpu.runtime.controlplane.memory import MemoryControlPlane as RefMemoryPlane
from dynamo_tpu.utils import config as ref_config
from dynamo_tpu import topology as ref_topology
from dynamo_tpu_torch import topology
from dynamo_tpu_torch.components import metrics_service, router_service
from dynamo_tpu_torch.engine.kv_manager import KvEvent
from dynamo_tpu_torch.llm.kv_router import compute_block_hashes
from dynamo_tpu_torch.llm.kv_router import protocols, publisher
from dynamo_tpu_torch.planner import state
from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.runtime import client as rt_client
from dynamo_tpu_torch.runtime import distributed
from dynamo_tpu_torch.runtime import engine as rt_engine
from dynamo_tpu_torch.runtime.controlplane.memory import MemoryControlPlane
from dynamo_tpu_torch.utils import config

SIDES = {
    "port": dict(metrics=metrics_service, router=router_service, protocols=protocols,
                 publisher=publisher, state=state, counters=counters, client=rt_client,
                 distributed=distributed, engine=rt_engine, plane=MemoryControlPlane,
                 config=config, KvEvent=KvEvent, hashes=compute_block_hashes),
    "ref": dict(metrics=ref_metrics, router=ref_router_service, protocols=ref_protocols,
                publisher=ref_publisher, state=ref_state, counters=ref_counters,
                client=ref_client, distributed=ref_distributed, engine=ref_engine,
                plane=RefMemoryPlane, config=ref_config, KvEvent=RefKvEvent,
                hashes=ref_hashes),
}


def worker_stats(rng: np.random.Generator) -> dict:
    """One worker's engine stats: every family the service mirrors."""
    used = int(rng.integers(0, 64))
    return {
        "kv_active_blocks": used, "kv_total_blocks": 64, "gpu_cache_usage_perc": used / 64,
        "num_requests_waiting": int(rng.integers(0, 5)),
        "num_requests_running": int(rng.integers(0, 9)), "request_total_slots": 8,
        "iterations_total": int(rng.integers(0, 1000)),
        "prefix_hits_total": int(rng.integers(0, 50)),
        "prefix_cached_tokens_total": int(rng.integers(0, 5000)),
        "spec_accepted_tokens_total": int(rng.integers(0, 99)),
        "batch_occupancy_perc": float(rng.integers(0, 9)) / 8,
        "num_preemptions_total": int(rng.integers(0, 4)),
        "decode_windows_unified_total": int(rng.integers(0, 300)),
        "admission_drains_total": int(rng.integers(0, 30)),
        "unified_fallbacks": {"speculative": int(rng.integers(1, 3))},
        "mfu_perc": 0.25, "bandwidth_util_perc": 0.5, "goodput_tokens_per_second": 120.5,
        "prefill_tokens_per_second": 900.0, "prefill_tokens_total": 4096,
        "decode_tokens_total": 800, "tokens_emitted_total": 790,
        "preempted_tokens_total": 10, "spec_rejected_tokens_total": 3,
        "wasted_tokens_total": 13, "phase_seconds": {"decode.dispatch": 1.5},
        "offload_tiers": {"host": {"blocks": 128, "used": 9, "pinned": 2}},
        "prefetch_hits_total": 4, "prefetch_misses_total": 1, "prefetch_stale_total": 0,
        "prefetch_hidden_seconds_total": 0.75,
        "flight_records_total": 77, "flight_dropped_total": 0, "flight_dumps_total": 1,
        "flight_buffer_bytes": 2048, "flight_last_dump_reason": "drain",
    }


def mask(text: str) -> str:
    """Prometheus text with the per-process parts masked: ``_created``
    timestamps."""
    return re.sub(r"^(\S+_created(\{[^}]*\})?) \S+$", r"\1 <ts>", text, flags=re.M)


async def metrics_text(side: str, seed: int) -> str:
    m = SIDES[side]
    m["plane"].reset_named()
    m["counters"].reset()
    rt = await m["distributed"].DistributedRuntime.create(
        m["config"].RuntimeConfig(control_plane=f"memory://services-metrics-{seed}"))
    comp = rt.namespace("ns").component("backend")
    service = m["metrics"].MetricsService(comp, host="127.0.0.1", port=0)
    rng = np.random.default_rng(seed)
    pubs = [m["publisher"].WorkerMetricsPublisher(comp, worker_id=w, stats_fn=lambda s=st: s)
            for w, st in ((0xAB, worker_stats(rng)), (0x1CD, worker_stats(rng)))]
    try:
        await service.start()
        for pub in pubs:
            await pub.publish_once()
        bus = rt.plane.bus
        isl_total = 0
        for _ in range(3):
            isl = int(rng.integers(1, 20))
            isl_total += isl
            await bus.publish(
                comp.event_subject(m["protocols"].KV_HIT_RATE_SUBJECT),
                m["protocols"].KvHitRateEvent(worker_id=0xAB, isl_blocks=isl,
                                              overlap_blocks=int(rng.integers(0, 10))).to_json())
        await bus.publish(
            comp.event_subject(m["state"].PLANNER_STATE_EVENT),
            m["state"].PlannerStateEvent(target_prefill=2, target_decode=3,
                                         observed_prefill_tok_s=1234.5,
                                         observed_decode_tok_s=321.0, burn_rate_input=1.75,
                                         reason="test", ts=1.0).to_json())
        m["counters"].incr("dyn_retries_total", 2)
        # wait for the service to have taken in every message
        for _ in range(1000):
            if (len(service.aggregator.snapshot().workers) == 2
                    and service._planner_event is not None
                    and service.isl_blocks._value.get() == isl_total):
                break
            await asyncio.sleep(0.01)
        async with httpx.AsyncClient() as client:
            r = await client.get(f"http://127.0.0.1:{service.port}/metrics")
        assert r.status_code == 200
        return r.text
    finally:
        for pub in pubs:
            await pub.stop()
        await service.stop()
        await rt.close()
        m["counters"].reset()


@pytest.mark.parametrize("seed", range(2))
async def test_metrics_text_equals_the_reference(monkeypatch, seed):
    monkeypatch.setenv("DYN_TOPO", "0")
    ours = await metrics_text("port", seed)
    ref = await metrics_text("ref", seed)
    assert mask(ours) == mask(ref)
    assert 'dyn_worker_kv_active_blocks{worker="ab"}' in ours
    assert 'dyn_planner_target_replicas{pool="decode"} 3.0' in ours
    assert "kv_hit_blocks_total" in ours
    assert "\ndyn_retries_total 2.0\n" in ours
    # the topology plane off: the families render, at zero
    assert 'dyn_topology_links{hop="dcn"} 0.0' in ours
    assert "dyn_topology_nodes 0.0" in ours


@pytest.mark.parametrize("topo_on", ["1", "0"])
async def test_metrics_service_starts_no_topology_watcher(monkeypatch, topo_on):
    """Both stacks' services start a TopologyWatcher at DYN_TOPO=1 (and
    render the card published on the plane) and none at 0."""
    monkeypatch.setenv("DYN_TOPO", topo_on)
    out = {}
    for name, ms, dist, cfg, plane_cls in (
            ("port", metrics_service, distributed, config, MemoryControlPlane),
            ("ref", ref_metrics, ref_distributed, ref_config, RefMemoryPlane)):
        plane_cls.reset_named()
        rt = await dist.DistributedRuntime.create(
            cfg.RuntimeConfig(control_plane=f"memory://services-topo-{name}"))
        service = ms.MetricsService(rt.namespace("ns").component("backend"),
                                    host="127.0.0.1", port=0)
        try:
            await service.start()
            watching = service._topology_watcher is not None
            out[name] = (watching, service._topology is not None)
            if watching:
                card = (topology if name == "port" else ref_topology).TopologyCard(
                    worker_id=0xAB, host="h", pid=1, role="decode")
                await rt.plane.kv.put(card.key(), card.to_json())
                for _ in range(200):
                    if service._topology.nodes:
                        break
                    await asyncio.sleep(0.01)
                async with httpx.AsyncClient() as client:
                    text = (await client.get(f"http://127.0.0.1:{service.port}/metrics")).text
                out[name] += ("dyn_topology_nodes 1.0" in text,)
        finally:
            await service.stop()
            await rt.close()
    want = (True, True, True) if topo_on == "1" else (False, False)
    assert out["port"] == out["ref"] == want


class Noop:
    def __init__(self, engine_mod):
        self.engine_mod = engine_mod

    async def generate(self, request):
        async def gen():
            yield {}

        return self.engine_mod.ResponseStream(gen(), request.ctx)


async def router_choices(side: str, prompts: list[list[int]], holders: list[list[int]]):
    """Serve three no-op workers (ids 11, 22, 33), publish each prompt's
    blocks for the workers ``holders`` names, and ask the router service
    for each prompt."""
    m = SIDES[side]
    m["plane"].reset_named()
    rt = await m["distributed"].DistributedRuntime.create(
        m["config"].RuntimeConfig(control_plane="memory://services-router"))
    workers, pubs = [], []
    service = kv_router = router_client = None
    try:
        backend = rt.namespace("dynamo").component("backend")
        for wid in (11, 22, 33):
            workers.append(await backend.endpoint("generate").serve(
                Noop(m["engine"]), instance_id=wid))
        service, kv_router, router_client = await m["router"].serve_router(rt, block_size=4)
        assert sorted(router_client.instance_ids) == [11, 22, 33]
        for wid in (11, 22, 33):
            pub = m["publisher"].KvEventPublisher(backend, worker_id=wid)
            pub.start()
            pubs.append(pub)
        stored = 0
        for prompt, hold in zip(prompts, holders):
            for wid, pub in zip((11, 22, 33), pubs):
                if wid in hold:
                    pub.sink(m["KvEvent"](kind="stored",
                                          block_hashes=m["hashes"](prompt, 4)))
                    stored += 1
        for _ in range(1000):  # wait for the router's index to apply every event
            if kv_router.indexer.events_applied >= stored:
                break
            await asyncio.sleep(0.01)
        router_ep = rt.namespace("dynamo").component("router").endpoint("generate")
        client = await m["client"].PushRouter.from_endpoint(router_ep)
        await client.client.wait_for_instances(1, timeout=5)
        out = []
        for prompt in prompts:
            (reply,) = await (await client.generate(
                m["engine"].Context({"token_ids": prompt}))).collect()
            out.append((reply["worker_id"], reply["overlap_blocks"]))
        return out
    finally:
        for pub in pubs:
            await pub.stop()
        for w in workers:
            await w.shutdown(drain_timeout=1)
        if service is not None:
            await service.shutdown(drain_timeout=1)
        if router_client is not None:
            await router_client.close()
        if kv_router is not None:
            await kv_router.stop()
        await rt.close()


async def test_router_service_routes_as_the_reference():
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 5000, int(rng.integers(8, 40))).tolist() for _ in range(6)]
    # each prompt cached on one worker; the last prompt on none
    holders = [[11], [22], [33], [22], [11], []]
    ours = await router_choices("port", prompts, holders)
    ref = await router_choices("ref", prompts, holders)
    assert ours[:5] == ref[:5]
    for (wid, overlap), prompt, hold in zip(ours[:5], prompts, holders):
        assert wid == hold[0] and overlap == len(prompt) // 4
    assert ours[5][1] == ref[5][1] == 0 and ours[5][0] in (11, 22, 33)
