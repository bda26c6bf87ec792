"""The port's scenario soaks (dynamo_tpu_torch/scenarios/) against the JAX
package's (dynamo_tpu/scenarios/).

- Every shipped spec loads, validates and round-trips to the reference's
  ``to_dict()`` (``torch_soak`` against ``jax_soak``: only ``name`` and
  ``engine`` differ); a ``"jax"`` engine is refused with the accepted values.
- ``plan_phase`` gives the reference's arrivals, sessions and prompts for
  every phase of every shipped spec.
- The mocker soaks hold what tests/scenarios/test_{soak_smoke,worker_kill,
  migration_soak,multi_slice}.py hold of the reference, on the same specs.
- ``torch_soak`` on the CPU (``LlamaConfig.tiny()``, the parameters carried
  from the reference's ``init_params(PRNGKey(0))``) completes 8 of 8, and the
  fleet's greedy stream for each of the plan's prompts, taken through the
  dispatcher, equals ``JaxLlmEngine``'s on the same parameters; a stopped
  worker's engine is released.
- One engine holding two live streams of one request id (a stream resumed
  after its worker died and a migration's pre-admitted copy of it): the
  copy killed, the other streams on in full."""

import asyncio
import gc
import json
import random
import weakref

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.scenarios import spec as ref_spec
from dynamo_tpu.scenarios import traffic as ref_traffic
from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    LLMEngineOutput,
    PreprocessedRequest,
    StopConditions,
)
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.observability.slo import SloTracker
from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.robustness.faults import FAULTS
from dynamo_tpu_torch.runtime.engine import Context, EngineContext
from dynamo_tpu_torch.scenarios import traffic
from dynamo_tpu_torch.scenarios.fleet import SoakFleet
from dynamo_tpu_torch.scenarios.runner import _slo_config, run_scenario
from dynamo_tpu_torch.scenarios.spec import (
    FleetSpec,
    ScenarioSpec,
    WorkerKillEvent,
    builtin_spec_path,
)
from tests.scenarios import test_soak_smoke, test_worker_kill
from tests.test_torch_engine import collect

SHIPPED = sorted(p.stem for p in builtin_spec_path("_").parent.glob("*.json"))
REF_NAME = {"torch_soak": "jax_soak"}


@pytest.fixture(autouse=True)
def _clean_state(tmp_path, monkeypatch):
    monkeypatch.setenv("DYN_FLIGHT_DIR", str(tmp_path / "flight"))
    counters.reset()
    FAULTS.reset()
    yield
    counters.reset()
    FAULTS.reset()


def test_shipped_specs_are_the_references():
    ref_names = sorted(p.stem for p in ref_spec.builtin_spec_path("_").parent.glob("*.json"))
    assert sorted(REF_NAME.get(n, n) for n in SHIPPED) == ref_names


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_spec_round_trips_to_the_reference(name):
    ours = ScenarioSpec.load(builtin_spec_path(name))
    ref = ref_spec.ScenarioSpec.load(ref_spec.builtin_spec_path(REF_NAME.get(name, name)))
    assert ScenarioSpec.from_dict(ours.to_dict()).to_dict() == ours.to_dict()
    mine, theirs = ours.to_dict(), ref.to_dict()
    if name == "torch_soak":
        assert (mine.pop("name"), theirs.pop("name")) == ("torch_soak", "jax_soak")
        assert (mine["fleet"].pop("engine"), theirs["fleet"].pop("engine")) == ("torch", "jax")
    assert mine == theirs
    # every other shipped file is a byte copy
    if name != "torch_soak":
        assert builtin_spec_path(name).read_bytes() == \
            ref_spec.builtin_spec_path(name).read_bytes()


def test_jax_engine_refused_and_torch_keeps_real_time():
    data = json.loads(builtin_spec_path("torch_soak").read_text())
    data["fleet"]["engine"] = "jax"
    with pytest.raises(ValueError, match=r"mocker\|torch, got 'jax'"):
        ScenarioSpec.from_dict(data)
    with pytest.raises(ValueError, match=r"mocker\|torch"):
        FleetSpec(engine="jax").validate()
    spec = ScenarioSpec.load(builtin_spec_path("torch_soak"))
    assert spec.fleet.engine == "torch" and spec.speedup == 1.0 and spec.verify_outputs
    spec.speedup = 10.0
    with pytest.raises(ValueError, match="engine='torch' requires speedup=1.0"):
        spec.validate()


def phase_prompts(seed: int, phase, plan) -> list[list[int]]:
    """The prompts the runner sends for a phase's open-loop arrivals (its
    ``_run_phase`` rng, the arrivals in order)."""
    rng = random.Random((seed, phase.name, "prompts").__repr__())
    return [traffic.prompt_tokens(a.isl, rng) for a in plan.arrivals]


@pytest.mark.parametrize("name", SHIPPED)
def test_plans_are_the_references(name):
    ours = ScenarioSpec.load(builtin_spec_path(name))
    ref = ref_spec.ScenarioSpec.load(ref_spec.builtin_spec_path(REF_NAME.get(name, name)))
    assert traffic.VOCAB == ref_traffic.VOCAB
    for phase, ref_phase in zip(ours.phases, ref.phases, strict=True):
        plan = traffic.plan_phase(phase, ours.seed)
        ref_plan = ref_traffic.plan_phase(ref_phase, ref.seed)
        assert [vars(a) for a in plan.arrivals] == [vars(a) for a in ref_plan.arrivals]
        assert [repr(s) for s in plan.sessions] == [repr(s) for s in ref_plan.sessions]
        assert plan.expected_requests == ref_plan.expected_requests
        rng = random.Random((ref.seed, ref_phase.name, "prompts").__repr__())
        assert phase_prompts(ours.seed, phase, plan) == [
            ref_traffic.prompt_tokens(a.isl, rng) for a in ref_plan.arrivals]


def test_bad_kill_mode_refused():
    with pytest.raises(ValueError, match="kill|drain"):
        WorkerKillEvent(at_s=1.0, mode="explode").validate()


# -- mocker soaks: what tests/scenarios/ holds of the reference ---------------

async def test_soak_smoke_end_to_end():
    artifact = await run_scenario(ScenarioSpec.from_dict(test_soak_smoke.SMOKE),
                                  name="soak-smoke-test")
    assert artifact["passed"], artifact["phases"]
    assert [p["name"] for p in artifact["phases"]] == ["burst", "chaos"]
    for phase in artifact["phases"]:
        assert phase["assertions"]["passed"], phase["assertions"]["failures"]
        assert phase["requests"]["completed"] > 0
        assert phase["ttft_sim_ms"]["p50"] is not None
    assert artifact["phases"][0]["burn_rates"]["ttft"] > 1.0
    assert artifact["planner"]["steering_decisions"] >= 1
    assert [e for e in artifact["planner"]["scale_events"] if e["to"] > e["from"]]
    reasons = {d["reason"] for d in artifact["planner"]["decisions"] if d["reason"] != "load"}
    assert any("burn" in r or "sla" in r for r in reasons), reasons
    chaos = artifact["phases"][1]
    assert chaos["faults"]["armed"] and chaos["faults"]["injected"] >= 1
    assert chaos["faults"]["fired"].get("worker.generate", 0) >= 1
    assert len(artifact["dyn_top_snapshots"]) == 2
    views = [s.get("planner") for s in artifact["dyn_top_snapshots"] if s.get("planner")]
    assert views, "dyn_planner_* gauges never reached dyn_top"
    pools = views[-1]["pools"]
    assert {"prefill", "decode"} <= set(pools)
    assert all("target_replicas" in p for p in pools.values())
    assert len(artifact["ticks"]) >= 10
    assert all("worst_burn" in t for t in artifact["ticks"])


async def test_worker_kill_soak_zero_client_visible_failures():
    spec = ScenarioSpec.load(builtin_spec_path("worker_kill"))
    assert [p.name for p in spec.phases] == ["kill_mid_stream", "drain_survivor"]
    assert not spec.autopilot.enabled
    artifact = await run_scenario(ScenarioSpec.from_dict(test_worker_kill.SMOKE),
                                  name="worker-kill-test")
    assert artifact["passed"], artifact["phases"]
    phase = artifact["phases"][0]
    assert phase["assertions"]["passed"], phase["assertions"]["failures"]
    assert phase["worker_kills"] and phase["worker_kills"][0]["mode"] == "kill"
    assert phase["worker_kills"][0]["worker"] is not None
    assert phase["requests"]["failed"] == 0
    assert phase["requests"]["completed"] >= 10
    assert "attempts" in phase["resumes"] and "succeeded" in phase["resumes"]


async def test_migration_soak_zero_loss_and_byte_identical_outputs():
    spec = ScenarioSpec.load(builtin_spec_path("migration"))
    spec.speedup = 12.0  # the reference test's cut: same phases, less simulated time
    for phase, duration, floor in zip(spec.phases, (8.0, 8.0, 10.0), (24, 24, 12)):
        phase.duration_s = duration
        phase.assertions.min_completed = floor
    artifact = await run_scenario(spec.validate(), name="migration-soak-test")
    assert artifact["passed"], [(p["name"], p["assertions"]["failures"])
                                for p in artifact["phases"]]
    by_name = {p["name"]: p for p in artifact["phases"]}
    assert by_name["live_migrate"]["migrations"]["committed"] >= 2
    drain = by_name["drain_under_load"]
    assert drain["worker_kills"] and drain["worker_kills"][0]["mode"] == "drain"
    assert drain["migrations"]["committed"] >= 1
    assert by_name["defrag"]["migrations"]["committed"] >= 1
    assert artifact["migrations"]["defrag_moves"], "defrag never moved a session"
    assert all(p["requests"]["failed"] == 0 and p["outputs"]["corrupt"] == 0
               for p in artifact["phases"])
    assert artifact["migrations"]["committed"] >= 4
    assert all("kv_occ_var" in t for t in artifact["ticks"])


async def test_multi_slice_near_slice_routing():
    data = json.loads(builtin_spec_path("multi_slice").read_text())
    data["speedup"] = 16.0  # the reference test's cut
    data["phases"][0]["duration_s"] = 12.0
    data["phases"][0]["assertions"]["min_completed"] = 10
    artifact = await run_scenario(ScenarioSpec.from_dict(data), name="multi-slice-smoke")
    assert artifact["passed"], artifact["phases"]
    topo = artifact["topology"]
    assert topo is not None and topo["informative"] and len(topo["nodes"]) == 3
    assert sorted(link["hop"] for link in topo["links"]) == ["dcn", "dcn", "local"]
    view = artifact["phases"][0]["topology"]
    assert view["near_slice"] == "s0" and view["near_fraction"] >= 0.7, view


# -- torch_soak on the CPU ---------------------------------------------------

@pytest.fixture(scope="module")
def carried():
    """The reference's tiny-model parameters and the port's copy of them."""
    jparams = jax_llama.init_params(jax_llama.LlamaConfig.tiny(), jax.random.PRNGKey(0))
    return jparams, llama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


async def test_torch_soak_completes_on_the_cpu(carried):
    spec = ScenarioSpec.load(builtin_spec_path("torch_soak"))
    artifact = await run_scenario(spec, name="torch-soak-test", fleet_options={
        "device": "cpu", "_params_cache": {"params": carried[1]}})
    assert artifact["passed"], artifact["phases"]
    phase = artifact["phases"][0]
    assert phase["requests"]["completed"] == 8 and phase["requests"]["failed"] == 0
    assert phase["outputs"] == {"verified": 8, "corrupt": 0}
    assert artifact["flight"]["enabled"] and artifact["flight"]["dumps"]
    workers = artifact["dyn_top_snapshots"][-1]["workers"]
    assert len(workers) == 2
    assert sum(w["tokens_emitted"] for w in workers.values()) == 8 * 8


async def _dispatch(fleet, tokens, osl):
    wire = PreprocessedRequest(token_ids=list(tokens),
                               stop=StopConditions(max_tokens=osl, ignore_eos=True),
                               eos_token_ids=[]).to_wire()
    stream = await fleet.dispatcher.generate(Context(dict(wire)))
    got = []
    async for item in stream:
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is not None:
            got.extend(ann.data.token_ids)
    return got


async def test_torch_fleet_streams_equal_the_reference_engine(carried):
    """The plan's prompts (ids up to 8000 over a vocabulary of 512) through
    the torch fleet's dispatcher, two at a time, against one JaxLlmEngine
    with the same parameters; then each stopped worker's engine is freed
    (its cache and graphs go with it)."""
    spec = ScenarioSpec.load(builtin_spec_path("torch_soak"))
    phase = spec.phases[0]
    plan = traffic.plan_phase(phase, spec.seed)
    prompts = phase_prompts(spec.seed, phase, plan)
    osl = phase.traffic.osl
    assert len(prompts) == 8 and max(max(p) for p in prompts) >= 512

    fleet = SoakFleet(spec=spec, slo=SloTracker(_slo_config(spec)), sim_now=lambda: 0.0,
                      name="torch-streams", device="cpu",
                      _params_cache={"params": carried[1]})
    await fleet.start()
    engines = [weakref.ref(w.engine) for ws in fleet._pools.values() for w in ws]
    try:
        ours = []
        for pair in (prompts[i:i + 2] for i in range(0, len(prompts), 2)):
            ours += await asyncio.gather(*[_dispatch(fleet, p, osl) for p in pair])
    finally:
        await fleet.stop()
    del fleet
    await asyncio.sleep(0.1)  # the cancelled service tasks run to their end
    gc.collect()
    assert [e() for e in engines] == [None, None]

    fl = spec.fleet
    ref_engine = JaxLlmEngine(JaxEngineConfig(
        model=jax_llama.LlamaConfig.tiny(), num_blocks=fl.num_blocks,
        block_size=fl.block_size, max_batch_size=fl.max_batch_size,
        prefill_buckets=(128, fl.max_model_len), max_model_len=fl.max_model_len),
        params=carried[0])
    ref_engine.start()
    try:
        ref = []
        for p in prompts:
            wire = PreprocessedRequest(token_ids=p,
                                       stop=StopConditions(max_tokens=osl, ignore_eos=True),
                                       eos_token_ids=[]).to_wire()
            ref.append((await collect(ref_engine, wire, JaxContext))[0])
    finally:
        ref_engine.stop()
    assert ours == ref
    assert all(len(tokens) == osl for tokens in ours)


async def test_one_request_id_twice_on_one_engine(carried):
    """A worker kill can put two live streams of one request on one engine:
    the dispatcher's resumed replay and the migration coordinator's
    pre-admitted copy, each its own worker-side context under the request's
    id.  The coordinator then kills one; the other must stream on.  Under
    one sequence key (the reference's engine keys by ``ctx.id``) the killed
    one frees the survivor's blocks and its next decode step fails (seen on
    the card in phase ``soak``); the port keys the second by a fresh id."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine

    engine = TorchLlmEngine(EngineConfig(
        model=llama.LlamaConfig.tiny(), num_blocks=64, block_size=16, max_batch_size=4,
        prefill_buckets=(128,), max_model_len=128), params=carried[1], device="cpu")
    prompt = list(range(10, 74))
    wire = PreprocessedRequest(token_ids=prompt, stop=StopConditions(max_tokens=48,
                               ignore_eos=True), eos_token_ids=[]).to_wire()
    engine.start()
    try:
        alone = (await collect(engine, wire, Context))[0]
        survivor_ctx, doomed_ctx = EngineContext("req-1"), EngineContext("req-1")
        survivor = await engine.generate(Context(dict(wire), survivor_ctx))
        doomed = await engine.generate(Context(dict(wire), doomed_ctx))
        got, finish = [], None
        async for item in survivor:
            ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
            if ann.data is None:
                continue
            got.extend(ann.data.token_ids)
            finish = ann.data.finish_reason or finish
            if len(got) >= 8 and not doomed_ctx.is_killed:
                doomed_ctx.kill()
        async for _ in doomed:
            pass
    finally:
        engine.stop()
    assert doomed_ctx.is_killed
    assert finish is not None and finish.value == "length"
    assert got == alone and len(got) == 48
