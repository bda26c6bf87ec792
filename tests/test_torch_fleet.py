"""The port's routed-fleet bench (``bench/routed_fleet.py``) and the
headline's KV routing rung against the reference's: a mocker fleet's
prefix hits and the ordering kv > random (the counterpart of
tests/bench/test_bench_tools.py's routing tests), ``engine="torch"``
workers on the CPU against the reference's ``engine="jax"`` (each turn's
greedy ids equal), the parked-session mode held as
tests/bench/test_prefetch_bench.py holds the reference's, and the rung's
result keys and arithmetic.  Sessions come from a seed; each file runs well
under a minute on one worker."""

import asyncio
import contextvars
import importlib.util
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest

from dynamo_tpu.bench import routed_fleet as ref_fleet
from dynamo_tpu.bench.data_generator import SessionConfig as RefSessionConfig
from dynamo_tpu.bench.data_generator import generate_sessions as ref_generate
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu_torch.bench import headline
from dynamo_tpu_torch.bench import routed_fleet as fleet
from dynamo_tpu_torch.bench.data_generator import SessionConfig, generate_sessions
from dynamo_tpu_torch.models.llama import LlamaConfig, params_from_jax

ROOT = Path(__file__).resolve().parent.parent


async def test_mocker_fleet_prefix_hits_and_kv_beats_random():
    cfg = dict(num_sessions=24, turns_per_session=3, system_tokens=512,
               user_tokens_per_turn=64, osl=16, turn_gap_mean_s=2.0, seed=3)
    sessions = generate_sessions(SessionConfig(**cfg))
    ref_sessions = ref_generate(RefSessionConfig(**cfg))
    assert [s.system_tokens for s in sessions] == [s.system_tokens for s in ref_sessions]
    ours = {p: await fleet.run_fleet(p, sessions, fleet.FleetConfig(num_workers=4))
            for p in ("random", "kv")}
    ref = {p: await ref_fleet.run_fleet(p, ref_sessions, ref_fleet.FleetConfig(num_workers=4))
           for p in ("random", "kv")}
    assert ours["kv"].keys() == ref["kv"].keys() | {"tokens_streamed_total", "turns_short"}
    assert ours["kv"]["tokens_streamed_total"] == 72 * 16 and ours["kv"]["turns_short"] == 0
    # affinity: every follow-up turn is a prefix hit under KV routing, in both
    assert ours["kv"]["prefix_hits_total"] == ref["kv"]["prefix_hits_total"] == 24 * 2
    # (the TTFT ordering is a timing claim: the compressed sleeps skew on a
    # loaded CPU, so it is measured on the card, chip_smoke.py phase fleet)
    for side in (ours, ref):
        assert side["kv"]["prefix_hits_total"] > side["random"]["prefix_hits_total"]
    assert ours["kv"]["num_turns"] == ref["kv"]["num_turns"] == 72


def test_fleet_config_rules_as_the_reference():
    with pytest.raises(ValueError, match="speedup=1.0"):
        fleet.FleetConfig(engine="torch")
    with pytest.raises(ValueError, match="speedup=1.0"):
        ref_fleet.FleetConfig(engine="jax")
    with pytest.raises(ValueError, match="unknown fleet engine"):
        fleet._make_fleet_engine(fleet.FleetConfig(engine="jax", speedup=1.0), {})


# -- real engines: the port's torch workers against the reference's jax ones ---

TURNS = dict(num_sessions=3, turns_per_session=3, system_tokens=40, user_tokens_per_turn=12,
             osl=4, turn_gap_mean_s=0.3, session_rate=50.0, vocab_size=480, seed=5)
REAL = dict(num_blocks=64, max_batch_size=4, max_model_len=128, speedup=1.0)


def spy_turns(module, monkeypatch) -> dict:
    """Record each request's prompt and the ids streamed back to it, through
    the bench module's own ``Context`` and ``Annotated`` names (a context
    variable ties a stream's items to the session task that sent it)."""
    turns: dict = {}
    current = contextvars.ContextVar("turn")
    real_context, real_annotated = module.Context, module.Annotated

    def context(data, *args):
        key = tuple(data["token_ids"])
        turns[key] = []
        current.set(key)
        return real_context(data, *args)

    class Annotated:
        @staticmethod
        def from_wire(item, fn):
            ann = real_annotated.from_wire(item, fn)
            if ann.data is not None and ann.data.token_ids:
                turns[current.get()].extend(ann.data.token_ids)
            return ann

    monkeypatch.setattr(module, "Context", context)
    monkeypatch.setattr(module, "Annotated", Annotated)
    return turns


async def test_torch_workers_give_the_reference_jax_workers_greedy_ids(monkeypatch):
    jparams = jax_llama.init_params(jax_llama.LlamaConfig.tiny(), jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    ours_turns = spy_turns(fleet, monkeypatch)
    ref_turns = spy_turns(ref_fleet, monkeypatch)
    sessions = generate_sessions(SessionConfig(**TURNS))
    ours = await fleet.run_fleet("kv", sessions, fleet.FleetConfig(
        engine="torch", num_workers=2, device="cpu", params=params, **REAL))
    ref = await ref_fleet.run_fleet("kv", ref_generate(RefSessionConfig(**TURNS)),
                                    ref_fleet.FleetConfig(engine="jax", num_workers=1, **REAL))
    assert ours["engine"] == "torch" and ours["num_turns"] == ref["num_turns"] == 9
    assert ours["tokens_streamed_total"] == 9 * TURNS["osl"] and ours["turns_short"] == 0
    assert len(ours_turns) == len(ref_turns) == 9
    assert ours_turns == ref_turns
    assert all(len(ids) == TURNS["osl"] for ids in ours_turns.values())
    # the reference's single worker finds every follow-up's prefix; the
    # port's two workers hit as far as the KV events beat the next turn
    assert ref["prefix_hits_total"] >= 6 and ours["prefix_hits_total"] >= 1


def test_torch_fleet_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet._make_fleet_engine(fleet.FleetConfig(engine="torch", speedup=1.0), {})


def test_torch_fleet_shares_one_set_of_parameters():
    cfg = fleet.FleetConfig(engine="torch", speedup=1.0, device="cpu", num_blocks=16,
                            max_batch_size=2, max_model_len=256)
    cache: dict = {}
    a = fleet._make_fleet_engine(cfg, cache)
    b = fleet._make_fleet_engine(cfg, cache)

    def ptrs(tree):
        if isinstance(tree, dict):
            return [p for k in sorted(tree) for p in ptrs(tree[k])]
        return [tree.data_ptr()]

    # the engines hold the same tensors: one copy of the weights
    assert ptrs(a.params) == ptrs(b.params) == ptrs(cache["params"])
    assert a.config.model == LlamaConfig.tiny()
    assert a.config.prefill_buckets == (128, 256)


# -- parked sessions (the counterpart of tests/bench/test_prefetch_bench.py) ---

PARK_SESSIONS = dict(num_sessions=5, turns_per_session=2, system_tokens=48,
                     user_tokens_per_turn=16, osl=4, vocab_size=480, seed=3)
PARK_FLEET = dict(engine="torch", num_workers=1, num_blocks=24, speedup=1.0, device="cpu",
                  max_model_len=128, host_offload_blocks=128, page_delay_ms=1.0)


async def test_parked_sessions_demand_vs_prefetch():
    sessions = generate_sessions(SessionConfig(**PARK_SESSIONS))
    cfg = fleet.FleetConfig(**PARK_FLEET)
    demand = await fleet.run_parked("demand", sessions, replace(cfg, prefetch=False),
                                    hint_lead_s=0.2, wave=2)
    # demand paging: the returning turns page in on the critical path
    assert demand["host_restores_total"] > 0
    assert demand["prefetch_hits_total"] == 0
    assert demand["returning_ttft_p50_ms"] > 0
    prefetch = await fleet.run_parked("prefetch", sessions, replace(cfg, prefetch=True),
                                      hint_lead_s=0.2, wave=2)
    # hints pre-restored blocks and real requests consumed them
    assert prefetch["prefetch_blocks_restored_total"] > 0
    assert prefetch["prefetch_hits_total"] > 0
    assert prefetch["prefetch_hidden_seconds_total"] > 0
    # prefetch never preempts running sequences
    assert prefetch["preemptions_total"] == 0
    assert prefetch["returning_ttft_p50_ms"] > 0
    ref_keys = {"mode", "num_workers", "num_sessions", "hbm_blocks_per_worker",
                "host_blocks_per_worker", "emulated_page_delay_ms_per_block",
                "returning_ttft_p50_ms", "returning_ttft_p99_ms", "returning_ttft_mean_ms",
                "prefix_hits_total", "host_restores_total", "preemptions_total",
                "prefetch_hits_total", "prefetch_misses_total",
                "prefetch_blocks_restored_total", "prefetch_hidden_seconds_total"}
    assert demand.keys() == prefetch.keys() == ref_keys


def test_parked_mode_refusals_as_the_reference():
    cfg = fleet.FleetConfig(engine="torch", num_workers=1, num_blocks=4096, speedup=1.0,
                            device="cpu", host_offload_blocks=64)
    with pytest.raises(ValueError, match="must overflow HBM"):
        asyncio.run(fleet.compare_parked(SessionConfig(**PARK_SESSIONS), cfg))
    with pytest.raises(ValueError, match="engine='torch'"):
        asyncio.run(fleet.run_parked("demand", [], fleet.FleetConfig()))


# -- the headline's KV routing rung ---------------------------------------------


def _load_bench():
    spec = importlib.util.spec_from_file_location("bench_rung_under_test", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


def test_kv_routing_rung_equals_the_reference_on_the_same_fleet_results(monkeypatch):
    """The same run_fleet results (seeded, per call) through both rungs give
    the same dict: keys, medians, ratios and the score against 3x."""

    def stub():
        rng = np.random.default_rng(0)

        async def run_fleet(policy, sessions, cfg=None, **_):
            scale = 3.0 if policy == "random" else 1.0
            return {"ttft_p50_ms": float(rng.uniform(10, 20) * scale),
                    "followup_ttft_p50_ms": float(rng.uniform(5, 10) * scale),
                    "prefix_hits_total": 40 if policy == "random" else 72}
        return run_fleet

    monkeypatch.setattr(fleet, "run_fleet", stub())
    ours = asyncio.run(headline.measure_kv_routing())
    monkeypatch.setattr(ref_fleet, "run_fleet", stub())
    ref = asyncio.run(_load_bench()._measure_kv_routing())
    assert ours == ref
    assert ours.keys() == {"ttft_p50_speedup", "ttft_p50_speedup_runs",
                           "followup_ttft_p50_speedup", "vs_baseline", "kv_prefix_hits",
                           "random_prefix_hits"}
    assert headline.BASELINE_ROUTING_SPEEDUP == _load_bench().BASELINE_ROUTING_SPEEDUP
    assert headline.RUNGS_NOT_PORTED == {}


def test_kv_routing_rung_runs_a_mocker_fleet():
    out = asyncio.run(headline.measure_kv_routing(
        SessionConfig(num_sessions=6, turns_per_session=3, turn_gap_mean_s=1.0, seed=1),
        fleet.FleetConfig(num_workers=4)))
    assert 6 * 2 >= out["kv_prefix_hits"] > out["random_prefix_hits"]
    assert len(out["ttft_p50_speedup_runs"]) == 3 and out["ttft_p50_speedup"] > 0
