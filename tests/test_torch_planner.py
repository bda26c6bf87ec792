"""The port's planner (dynamo_tpu_torch/planner) and KV event recorder
against the reference's (dynamo_tpu/planner, llm/kv_router/recorder.py).

- The WorkloadSample sequences of tests/planner/test_planner.py and
  test_autopilot.py, fed to both planners with RecordingConnectors on the
  same clock, give decisions equal field by field (load scaling, SLA
  escalation, the card budget, observed utilization, burn escalation, the
  burn hold, the cooldown, the rebalance and its donor rule), and the
  state events made from them are equal; ``sample_from_endpoints`` and
  ``burn_rates_from_slo`` give equal samples.
- Every predictor of tests/planner/test_load_predictor.py walked over the
  same bursty and diurnal series predicts the same numbers, one step and
  several ahead; ``replay_trace`` fits the same predictor from the same
  flight dump (each package's own recorder writing it).
- The defragmenter picks the same moves over the same occupancy snapshots.
- The KV recorder writes byte-equal files, and replays them into equal
  radix trees.
"""

import dataclasses
import math
from types import SimpleNamespace

import pytest

from dynamo_tpu import planner as ref_planner
from dynamo_tpu.llm.kv_router import protocols as ref_protocols
from dynamo_tpu.llm.kv_router import recorder as ref_recorder
from dynamo_tpu.observability import flight as ref_flight
from dynamo_tpu.planner import connectors as ref_connectors
from dynamo_tpu.planner import defrag as ref_defrag
from dynamo_tpu.planner import load_predictor as ref_lp
from dynamo_tpu.planner import state as ref_state
from dynamo_tpu_torch import planner
from dynamo_tpu_torch.llm.kv_router import protocols
from dynamo_tpu_torch.llm.kv_router import recorder
from dynamo_tpu_torch.observability import flight
from dynamo_tpu_torch.planner import connectors, defrag
from dynamo_tpu_torch.planner import load_predictor as lp
from dynamo_tpu_torch.planner import state

PKGS = {"ours": (planner, connectors, state), "ref": (ref_planner, ref_connectors, ref_state)}

PROFILE = [dict(isl=512, osl=64, prefill_tok_s=10_000, decode_tok_s=1_000, ttft_s=0.1,
                itl_s=0.02),
           dict(isl=2048, osl=128, prefill_tok_s=8_000, decode_tok_s=800, ttft_s=0.3,
                itl_s=0.025)]
GENEROUS = [dict(isl=16, osl=8, prefill_tok_s=1e6, decode_tok_s=1e5, ttft_s=0.01, itl_s=0.005),
            dict(isl=8192, osl=1024, prefill_tok_s=1e6, decode_tok_s=1e5, ttft_s=0.01,
                 itl_s=0.005)]
AUTOPILOT = dict(min_prefill=1, max_prefill=8, min_decode=1, max_decode=8,
                 max_total_chips=16, cooldown_s=60.0)
LOAD = dict(predictor="constant", max_prefill=16, max_decode=16, max_total_chips=64,
            scale_down_headroom=1.0)


def ap(**kw):
    """An autopilot sample (test_autopilot.py's ``_sample``)."""
    return {**dict(request_rate=1.0, avg_isl=64, avg_osl=16, num_prefill_replicas=2,
                   num_decode_replicas=2), **kw}


# name -> (profile, config, [(now, sample kwargs, "step" | "plan"), ...])
SCENARIOS = {
    "scale_up": (PROFILE, LOAD, [(0.0, dict(request_rate=10, avg_isl=512, avg_osl=64), "step"),
                                 (1.0, dict(request_rate=100, avg_isl=512, avg_osl=64),
                                  "step")]),
    "sla_escalation": (PROFILE, dict(predictor="constant", ttft_target_s=0.15,
                                     scale_down_headroom=1.0),
                       [(0.0, dict(request_rate=1, avg_isl=512, avg_osl=64, ttft_s=0.4),
                         "step")]),
    "card_budget": (PROFILE, dict(LOAD, max_total_chips=4),
                    [(0.0, dict(request_rate=1000, avg_isl=512, avg_osl=64), "step")]),
    "observed_utilization": (PROFILE, LOAD, [(0.0, dict(
        request_rate=10, avg_isl=512, avg_osl=64, observed_prefill_tok_s=4000,
        observed_decode_tok_s=400, num_prefill_replicas=2, num_decode_replicas=2,
        avg_occupancy=1.0), "step")]),
    "idle_fleet": (PROFILE, LOAD, [(0.0, dict(
        request_rate=10, avg_isl=512, avg_osl=64, observed_prefill_tok_s=100,
        observed_decode_tok_s=10, num_prefill_replicas=2, num_decode_replicas=2,
        avg_occupancy=0.1), "step")]),
    "ttft_burn": (GENEROUS, AUTOPILOT, [(0.0, ap(ttft_burn_rate=3.0), "plan")]),
    "itl_burn": (GENEROUS, AUTOPILOT, [(0.0, ap(itl_burn_rate=2.5), "plan")]),
    "error_burn": (GENEROUS, AUTOPILOT, [(0.0, ap(error_burn_rate=4.0), "plan")]),
    "zero_burn": (GENEROUS, AUTOPILOT, [(0.0, ap(), "plan")]),
    "burn_hold": (GENEROUS, AUTOPILOT, [(0.0, ap(ttft_burn_rate=0.5, num_prefill_replicas=3,
                                                 num_decode_replicas=4), "plan")]),
    "cooldown": (GENEROUS, AUTOPILOT, [
        (0.0, ap(ttft_burn_rate=3.0), "plan"),
        (10.0, ap(num_prefill_replicas=3, num_decode_replicas=2), "plan"),
        (120.0, ap(num_prefill_replicas=3, num_decode_replicas=2), "plan")]),
    "rebalance": (GENEROUS, dict(AUTOPILOT, max_total_chips=4), [(0.0, ap(
        ttft_burn_rate=2.0, prefill_occupancy=0.95, decode_occupancy=0.1), "plan")]),
    "rebalance_donor_burn": (GENEROUS, dict(AUTOPILOT, max_total_chips=4), [(0.0, ap(
        ttft_burn_rate=2.0, itl_burn_rate=2.0, prefill_occupancy=0.95,
        decode_occupancy=0.1), "plan")]),
    # a burst and its ebb through the step path, as phase plane drives it
    "burst_and_ebb": (PROFILE, dict(LOAD, cooldown_s=5.0, max_decode=2), [
        (0.0, dict(request_rate=1, avg_isl=512, avg_osl=64), "step"),
        (1.0, dict(request_rate=18, avg_isl=512, avg_osl=64, num_decode_replicas=1), "step"),
        (2.0, dict(request_rate=18, avg_isl=512, avg_osl=64, num_decode_replicas=2), "step"),
        (4.0, dict(request_rate=1, avg_isl=512, avg_osl=64, num_decode_replicas=2), "step"),
        (9.0, dict(request_rate=1, avg_isl=512, avg_osl=64, num_decode_replicas=2), "step")]),
}


async def drive(pkg: str, name: str) -> tuple[list, list, list]:
    mod, conn_mod, state_mod = PKGS[pkg]
    points, cfg, ops = SCENARIOS[name]
    clock = {"now": 0.0}
    profile = mod.PerfProfile([mod.ProfilePoint(**p) for p in points])
    p = mod.Planner(profile, conn_mod.RecordingConnector(), mod.PlannerConfig(**cfg),
                    clock=lambda: clock["now"])
    decisions, events = [], []
    for now, sample, how in ops:
        clock["now"] = now
        s = mod.WorkloadSample(**sample)
        if how == "step":
            d = await p.step(s)
        else:
            p.observe(s)
            d = p.plan()
        decisions.append(dataclasses.asdict(d))
        events.append(dataclasses.asdict(state_mod.event_from_planner(p, d, ts=now)))
    return decisions, [dataclasses.asdict(d) for d in p.connector.decisions], events


@pytest.mark.parametrize("name", sorted(SCENARIOS))
async def test_planner_decisions_equal_the_reference(name):
    ours, ref = await drive("ours", name), await drive("ref", name)
    assert ours == ref
    assert ours[0]  # a decision per sample


async def test_the_burst_scenario_scales_up_then_down():
    decisions, _, _ = await drive("ours", "burst_and_ebb")
    assert [d["num_decode"] for d in decisions] == [1, 2, 2, 2, 1]


def metrics(cls, role="", goodput=0.0, prefill=0.0, occ=0.0, mfu=0.0, worker_id=0):
    return cls(worker_id=worker_id, role=role, goodput_tokens_per_second=goodput,
               prefill_tokens_per_second=prefill, batch_occupancy_perc=occ, mfu_perc=mfu)


@pytest.mark.parametrize("case", ["roles", "role_override", "burn", "endpoints"])
def test_samples_from_endpoints_equal_the_reference(case):
    status = None
    roles = None
    if case == "burn":
        fleets = {}
        status = {"objectives": {
            "ttft": {"worst_burn_rate": 2.5},
            "itl": {"windows": {"60": {"burn_rate": 0.4}, "300": {"burn_rate": 0.9}}},
            "error_rate": {"worst_burn_rate": 0.1}}}
    elif case == "role_override":
        fleets = {1: dict(role="decode", goodput=100.0, prefill=900.0),
                  2: dict(role="decode", goodput=300.0)}
        roles = {1: "prefill"}
    else:
        fleets = {1: dict(role="prefill", prefill=1000.0, occ=0.9, mfu=0.5),
                  2: dict(role="decode", goodput=400.0, occ=0.3, mfu=0.2),
                  3: dict(role="decode", goodput=600.0, occ=0.5, mfu=0.3)}
    out = []
    for mod, proto in ((planner, protocols), (ref_planner, ref_protocols)):
        cls = proto.ForwardPassMetrics if case == "endpoints" else SimpleNamespace
        workers = {w: metrics(cls, **kw) for w, kw in fleets.items()}
        s = mod.sample_from_endpoints(SimpleNamespace(workers=workers), request_rate=5,
                                      avg_isl=100, avg_osl=20, slo_status=status, roles=roles)
        out.append(dataclasses.asdict(s))
    assert out[0] == out[1]
    assert planner.burn_rates_from_slo(status) == ref_planner.burn_rates_from_slo(status)


# ---------------------------------------------------------------- predictors


def diurnal(n, period=12, base=20.0, amp=15.0):
    return [base + amp * math.sin(2 * math.pi * t / period) for t in range(n)]


def bursty(n, base=5.0, burst=50.0, every=10, length=3):
    return [burst if (t % every) < length else base for t in range(n)]


def trend_diurnal(n, period=12):
    return [v + 0.5 * t for t, v in enumerate(diurnal(n, period))]


PREDICTORS = [("constant", {}), ("ewma", dict(alpha=0.5)), ("ewma", dict(alpha=1.0)),
              ("linear", dict(window=8)), ("ar", dict(p=3, d=1)), ("arima", {}),
              ("ar", dict(p=3, d=0, window=64)), ("seasonal", dict(period=12)),
              ("prophet", dict(period=8, window=64))]


@pytest.mark.parametrize("series", ["bursty", "diurnal", "trend"])
@pytest.mark.parametrize("kind,kw", PREDICTORS,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(PREDICTORS)])
def test_predictors_equal_the_reference(kind, kw, series):
    values = {"bursty": bursty(60), "diurnal": diurnal(72), "trend": trend_diurnal(72)}[series]
    ours, ref = lp.make_predictor(kind, **kw), ref_lp.make_predictor(kind, **kw)
    assert type(ours).__name__ == type(ref).__name__
    for v in values:
        assert ours.predict() == ref.predict()
        assert [ours.predict_ahead(h) for h in (1, 4, 13)] == [
            ref.predict_ahead(h) for h in (1, 4, 13)]
        ours.observe(v)
        ref.observe(v)
    assert ours.predict() == ref.predict()


def record_trace(flight_mod, path):
    """A flight recorder fed a diurnal load at 1 Hz on an explicit clock
    (test_load_predictor.py's ``_record_diurnal_trace``), dumped."""
    clock_t = [0.0]
    rec = flight_mod.FlightRecorder(source="soak", capacity_bytes=1 << 20, enabled=True,
                                    clock=lambda: clock_t[0])
    for t in range(82):
        clock_t[0] = float(t)
        load = 20.0 + 15.0 * math.sin(2 * math.pi * t / 12.0)
        rec.record_step(iteration=t, num_running=load, decode_tokens=load * 4.0)
    rec.record_event("preemption", victim="r-1")
    return rec.dump("soak_end", path=path)


@pytest.mark.parametrize("kind,field,agg", [("seasonal", "num_running", "mean"),
                                            ("constant", "num_running", "mean"),
                                            ("ar", "decode_tokens", "sum")])
def test_replay_trace_equals_the_reference(tmp_path, kind, field, agg):
    ours_path = record_trace(flight, tmp_path / "ours.jsonl")
    ref_path = record_trace(ref_flight, tmp_path / "ref.jsonl")
    kw = dict(period=12) if kind == "seasonal" else {}
    ours = lp.replay_trace(ours_path, kind=kind, field=field, bucket_s=1.0, agg=agg, **kw)
    ref = ref_lp.replay_trace(ref_path, kind=kind, field=field, bucket_s=1.0, agg=agg, **kw)
    assert [ours.predict_ahead(h) for h in range(1, 13)] == [
        ref.predict_ahead(h) for h in range(1, 13)]
    records = [{"kind": "step", "t": 0.2, "decode_tokens": 3.0},
               {"kind": "event", "t": 0.9, "event": "preemption"},
               {"kind": "step", "t": 2.1, "decode_tokens": 5.0}]
    assert lp.replay_trace(records, kind="constant", field="decode_tokens",
                           agg="sum").predict() == 5.0
    for mod in (lp, ref_lp):
        with pytest.raises(ValueError, match="agg"):
            mod.replay_trace(records, field="decode_tokens", agg="median")


# ---------------------------------------------------------------- defrag


class FakeCoordinator:
    """The migration coordinator as the defragmenter sees it: sessions by
    worker, the healthy set, hop classes, and migrations that commit (or
    abort for the listed requests)."""

    def __init__(self, sessions, hops, unhealthy=(), aborts=()):
        self._sessions = dict(sessions)
        self._hops = hops
        self.router = SimpleNamespace(
            healthy_ids=lambda exclude: [w for w in {*self._sessions.values(), *hops}
                                         if w not in unhealthy])
        self.aborts = set(aborts)
        self.calls = []

    def sessions(self):
        return dict(self._sessions)

    def sessions_on(self, worker):
        return [r for r, w in self._sessions.items() if w == worker]

    def hop(self, src, dst):
        return self._hops.get(dst, "")

    async def migrate(self, rid, dst, reason=""):
        self.calls.append((rid, dst, reason))
        src = self._sessions[rid]
        if rid in self.aborts:
            return {"ok": False, "src": src, "dst": dst, "reason": "aborted"}
        self._sessions[rid] = dst
        return {"ok": True, "src": src, "dst": dst, "hop": self._hops.get(dst, "")}


DEFRAG_CASES = {
    "moves_to_coldest_local": ({"a": 1, "b": 1, "c": 2}, {1: "", 2: "local", 3: "ici", 4: ""},
                               (), (), [{1: 0.9, 2: 0.6, 3: 0.2, 4: 0.1}]),
    "skips_dcn": ({"a": 1}, {2: "dcn", 3: "ici"}, (), (), [{1: 0.9, 2: 0.1, 3: 0.5}]),
    "cold_fleet": ({"a": 1}, {2: "local"}, (), (), [{1: 0.4, 2: 0.0}]),
    "unhealthy_and_abort": ({"a": 1, "b": 1}, {2: "local", 3: "local"}, (2,), ("a",),
                            [{1: 0.95, 2: 0.0, 3: 0.3}, {1: 0.95, 2: 0.0, 3: 0.3}]),
    "cooldown": ({"a": 1, "b": 1, "c": 1}, {2: "local"}, (), (),
                 [{1: 0.9, 2: 0.1}, {1: 0.8, 2: 0.2}, {1: 0.8, 2: 0.2}]),
}


@pytest.mark.parametrize("case", sorted(DEFRAG_CASES))
async def test_defrag_decisions_equal_the_reference(case):
    sessions, hops, unhealthy, aborts, snapshots = DEFRAG_CASES[case]
    out = []
    for mod in (defrag, ref_defrag):
        coord = FakeCoordinator(sessions, hops, unhealthy, aborts)
        d = mod.Defragmenter(coord, mod.DefragConfig(enabled=True, max_per_step=2,
                                                     cooldown_s=8.0), clock=lambda: 0.0)
        results = [await d.step(snap, now=float(5 * i)) for i, snap in enumerate(snapshots)]
        out.append((results, d.moves, coord.calls))
    assert out[0] == out[1]


# ---------------------------------------------------------------- recorder


def router_events(proto):
    return [proto.RouterEvent(worker_id=w, event=proto.KvCacheEvent(
        kind=kind, block_hashes=hashes, parent_hash=parent, token_count=n))
        for w, kind, hashes, parent, n in (
            (1, "stored", [11, 12, 13], None, 48), (2, "stored", [11, 21], None, 32),
            (1, "stored", [14], 13, 16), (2, "removed", [21], None, 0),
            (1, "cleared", [], None, 0), (3, "stored", [31, 32], None, 32))]


def test_recorder_files_are_byte_equal_and_replay_alike(tmp_path, monkeypatch):
    paths = []
    for mod, proto, name in ((recorder, protocols, "ours"), (ref_recorder, ref_protocols, "ref")):
        ticks = iter(range(100, 200))  # each recorder reads the same clock
        monkeypatch.setattr(mod.time, "time", lambda: float(next(ticks)) / 4)
        path = tmp_path / f"{name}.jsonl"
        rec = mod.KvRecorder(path)
        for ev in router_events(proto):
            rec.record(ev)
        rec.flush()
        rec.close()
        assert rec.count == 6
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    ours = [(t, dataclasses.asdict(e)) for t, e in recorder.iter_events(paths[0])]
    ref = [(t, dataclasses.asdict(e)) for t, e in ref_recorder.iter_events(paths[1])]
    assert ours == ref
    tree, ref_tree = recorder.replay_into_tree(paths[0]), ref_recorder.replay_into_tree(paths[1])
    for hashes in ([11, 12, 13, 14], [11, 21], [31, 32], [99]):
        a, b = tree.find_matches(hashes), ref_tree.find_matches(hashes)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
