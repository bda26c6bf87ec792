"""The port's benchmark toolkit (dynamo_tpu_torch/bench/, planner/) against
the JAX package's and bench.py: the copied trace synthesizer, performance
profile, SLA planner and Pareto frontier give the reference's results on the
same seeds and points; the headline bench's engine configuration, prompts,
parameter count and FLOP count are bench.py's; its CPU run prints one JSON
line with the prefix and pipeline rungs; without a card it refuses to run."""

import asyncio
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.bench import data_generator as jax_gen
from dynamo_tpu.bench import profile_sla as jax_sla
from dynamo_tpu.bench import sweep as jax_sweep
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.models.registry import get_family as jax_family
from dynamo_tpu.ops.quant import QuantizedMatrix as JaxQuantizedMatrix
from dynamo_tpu.ops.quant import quantize_params as jax_quantize_params
from dynamo_tpu.planner import perf_interpolation as jax_perf
from dynamo_tpu_torch.bench import data_generator as gen
from dynamo_tpu_torch.bench import headline
from dynamo_tpu_torch.bench import profile_sla as sla
from dynamo_tpu_torch.bench import sweep
from dynamo_tpu_torch.engine import TorchLlmEngine
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.planner import perf_interpolation as perf

ROOT = Path(__file__).resolve().parent.parent

# the keys of bench.py's result line (:405-474) that the port keeps: all
# but cpu_fallback (the port never falls back); the KV routing rung's are
# in detail["kv_routing"]
REFERENCE_KEYS = {"metric", "value", "unit", "vs_baseline"}
REFERENCE_DETAIL_KEYS = {
    "model", "quantize", "kv_cache_dtype", "n_params", "num_requests", "isl", "osl",
    "wall_s", "mfu", "mfu_basis", "peak_flops", "achieved_tflops_per_s", "total_tflops",
    "ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms", "itl_p99_ms", "decode_phase_tok_s",
    "vs_baseline_decode_phase", "prefix_hits_total", "spec_accepted_tokens_total", "req_s",
    "decode_steps", "batch", "platform", "device_kind", "prefix_ttft_miss_ms",
    "prefix_ttft_hit_ms", "prefix_ttft_speedup", "pipeline_tok_s", "pipeline_wall_s",
    "pipeline_requests", "pipeline_overhead_pct", "kv_xfer_gbps_device",
    "kv_xfer_gbps_host_tcp", "kv_xfer_block_mb",
}


# -- the copies against the JAX modules ----------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_trace_synthesizer_matches_reference(seed, tmp_path):
    ours = gen.TraceSynthesizer(gen.SynthesizerConfig(num_requests=48, seed=seed)).generate()
    ref = jax_gen.TraceSynthesizer(jax_gen.SynthesizerConfig(num_requests=48, seed=seed)).generate()
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in ref]
    assert gen.analyze_prefix_sharing(ours) == jax_gen.analyze_prefix_sharing(ref)
    assert gen.analyze_prefix_sharing(ours)["sharing_ratio"] > 0.2
    path = tmp_path / "trace.jsonl"
    written = gen.TraceSynthesizer(gen.SynthesizerConfig(num_requests=48, seed=seed)).write_jsonl(path)
    assert gen.load_trace(path) == written
    assert [dataclasses.asdict(r) for r in jax_gen.load_trace(path)] == [
        dataclasses.asdict(r) for r in written]


def test_sessions_match_reference():
    kw = dict(num_sessions=6, turns_per_session=3, system_tokens=40, seed=3)
    ours = gen.generate_sessions(gen.SessionConfig(**kw))
    ref = jax_gen.generate_sessions(jax_gen.SessionConfig(**kw))
    assert [dataclasses.asdict(s) for s in ours] == [dataclasses.asdict(s) for s in ref]


def _points(mod):
    return [
        mod.ProfilePoint(isl=isl, osl=osl, concurrency=c, prefill_tok_s=1000.0 * c + isl,
                         decode_tok_s=100.0 * c + osl, ttft_s=0.01 * isl / c,
                         itl_s=0.002 * c + 0.0001 * osl)
        for isl in (128, 512, 2048) for osl in (32, 128) for c in (1, 4)
    ]


def test_perf_profile_interpolates_as_reference(tmp_path):
    ours, ref = perf.PerfProfile(_points(perf)), jax_perf.PerfProfile(_points(jax_perf))
    for isl, osl, c in [(128, 32, None), (300, 70, 1), (1000, 100, 4), (4096, 8, 4)]:
        for getter in ("prefill_tok_s", "decode_tok_s", "ttft_s", "itl_s"):
            assert getattr(ours, getter)(isl, osl, c) == getattr(ref, getter)(isl, osl, c)
    ours.save(tmp_path / "p.json")
    loaded = jax_perf.PerfProfile.load(tmp_path / "p.json")
    assert loaded.decode_tok_s(700, 50, 4) == ref.decode_tok_s(700, 50, 4)
    with pytest.raises(ValueError, match="no profiled points"):
        ours.ttft_s(128, 32, 2)


@pytest.mark.parametrize("shape", ["best", "tight", "infeasible"])
def test_plan_deployment_matches_reference(shape):
    sla_s = {"best": (60.0, 60.0), "tight": (2.0, 0.009), "infeasible": (1e-9, 1e-9)}[shape]
    kw = dict(isl=512, osl=128, target_rps=25.0, ttft_sla_s=sla_s[0], itl_sla_s=sla_s[1])
    ours = sla.plan_deployment(perf.PerfProfile(_points(perf)), **kw)
    assert ours == jax_sla.plan_deployment(jax_perf.PerfProfile(_points(jax_perf)), **kw)
    if shape == "infeasible":
        assert ours["status"] == "infeasible" and ours["replicas"] == 0
    with pytest.raises(ValueError, match="never profiled"):
        sla.plan_deployment(perf.PerfProfile(_points(perf)), **{**kw, "isl": 100})


def test_pareto_frontier_matches_reference():
    rng = np.random.default_rng(5)
    rows = [dict(concurrency=int(c), requests=8, wall_s=1.0, output_tokens=64,
                 tok_s_total=float(t), tok_s_per_user=float(u), req_s=1.0, ttft_p50_ms=1.0,
                 ttft_p99_ms=2.0, itl_mean_ms=1.0)
            for c, t, u in zip(range(1, 13), rng.integers(10, 60, 12), rng.integers(1, 9, 12))]
    ours = sweep.pareto_frontier([sweep.SweepPoint(**r) for r in rows])
    ref = jax_sweep.pareto_frontier([jax_sweep.SweepPoint(**r) for r in rows])
    assert [dataclasses.asdict(p) for p in ours] == [dataclasses.asdict(p) for p in ref]
    assert 0 < len(ours) < len(rows)


# -- the headline bench against bench.py ---------------------------------------


def _load_reference_bench():
    spec = importlib.util.spec_from_file_location("bench_reference", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


class _Captured(Exception):
    pass


def _reference_config(monkeypatch, env: dict, model: str, quant, cpu: bool):
    """The EngineConfig bench.py's _run_model builds for ``env`` (the engine
    class is replaced by one that hands its config back unbuilt)."""
    import dynamo_tpu.engine as jax_engine

    def capture(config, params=None):
        raise _Captured(config)

    monkeypatch.setattr(jax_engine, "JaxLlmEngine", capture)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    bench = _load_reference_bench()
    with pytest.raises(_Captured) as info:
        asyncio.run(bench._run_model(model, quant, fallback_cpu=cpu))
    return info.value.args[0]


@pytest.mark.parametrize("case", ["card", "cpu", "card_overrides", "cpu_chunked"])
def test_bench_engine_config_is_bench_py(monkeypatch, case):
    for name in list(os.environ):
        if name.startswith("DYN_BENCH_"):
            monkeypatch.delenv(name)
    # random init: bench.py's constant fill would build 8B host arrays
    env = {"DYN_BENCH_INIT": "random"}
    if case == "card_overrides":
        env |= {"DYN_BENCH_KV_DTYPE": "model", "DYN_BENCH_QUANT": "none", "DYN_BENCH_BATCH": "8",
                "DYN_BENCH_DECODE_STEPS": "1", "DYN_BENCH_CHUNK": "256", "DYN_BENCH_ISL": "1000"}
    if case == "cpu_chunked":
        env |= {"DYN_BENCH_CHUNK": "16", "DYN_BENCH_BLOCKS": "77"}
    cpu = case.startswith("cpu")
    ours = headline.engine_config(headline.settings_from_env(
        {**env, **({"DYN_BENCH_DEVICE": "cpu"} if cpu else {})}))
    model = "tiny" if cpu else "llama3_8b"
    quant = None if cpu or case == "card_overrides" else "int8"
    ref = _reference_config(monkeypatch, env, model, quant, cpu)
    for name in ("num_blocks", "block_size", "max_batch_size", "max_model_len",
                 "prefill_buckets", "decode_steps", "prefill_chunk_tokens", "logit_bias_k",
                 "quantize", "kv_cache_dtype"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.logit_bias_k == 0
    for f in dataclasses.fields(ours.model):  # the reference's config has more fields
        ours_v, ref_v = getattr(ours.model, f.name), getattr(ref.model, f.name)
        if f.name == "dtype":
            assert str(ours_v).removeprefix("torch.") == np.dtype(ref_v).name
        else:
            assert ours_v == ref_v, f.name


@pytest.mark.parametrize("env", [
    {"DYN_BENCH_QUANT": "fp8"}, {"DYN_BENCH_DEVICE": "tpu"}, {"DYN_BENCH_MODEL": "llama9"},
    {"DYN_BENCH_KV_DTYPE": "int4"}, {"DYN_BENCH_ISL": "3k"}, {"DYN_BENCH_INIT": "zeros"},
])
def test_unknown_setting_raises_before_an_engine_is_built(monkeypatch, env):
    def refuse(*args, **kwargs):
        raise AssertionError("an engine was built")

    monkeypatch.setattr(headline, "TorchLlmEngine", refuse)
    for name in list(os.environ):
        if name.startswith("DYN_BENCH_"):
            monkeypatch.delenv(name)
    for name, value in {"DYN_BENCH_DEVICE": "cpu", **env}.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=next(iter(env))):
        headline.settings_from_env(env)
    assert headline.main() == 2


def test_unknown_quant_exits_before_an_engine_is_built():
    out = _run_headline({"DYN_BENCH_DEVICE": "cpu", "DYN_BENCH_QUANT": "fp8"})
    assert out.returncode == 2 and out.stdout == ""
    assert "DYN_BENCH_QUANT='fp8' not understood" in out.stderr


@pytest.mark.parametrize("quant", [None, "int8"])
def test_param_count_and_flops_are_bench_py(quant):
    cfg = LlamaConfig.llama3_8b()
    ours = headline.count_params(headline.param_shapes(cfg, quant))
    jcfg = jax_llama.LlamaConfig.llama3_8b()
    family = jax_family("llama")

    def shaped(key):
        p = family.init_params(jcfg, key)
        return jax_quantize_params(p, family.quant_leaves) if quant else p

    shapes = jax.eval_shape(shaped, jax.random.PRNGKey(0))
    ref = sum(  # bench.py:363-369
        int(np.prod(x.q.shape if isinstance(x, JaxQuantizedMatrix) else x.shape))
        for x in jax.tree.leaves(shapes, is_leaf=lambda x: isinstance(x, JaxQuantizedMatrix)))
    assert ours == ref
    assert 8.0e9 < ours < 8.1e9
    # bench.py:383-387 at the headline traffic
    total_len = 3150
    attn = 4.0 * jcfg.num_layers * jcfg.num_heads * jcfg.head_dim
    assert headline.model_flops(cfg, ours, 3000, 150) == (
        2.0 * ref * total_len + attn * total_len * (total_len - 1) / 2.0)


def test_const_params_fill_as_bench_py():
    cfg = LlamaConfig.tiny()
    plain = headline.const_params(cfg, None, "cpu")
    assert plain["layers"]["wq"].dtype == torch.float32
    assert torch.all(plain["layers"]["wq"] == 0.01) and torch.all(plain["final_norm"] == 0.01)
    quant = headline.const_params(cfg, "int8", "cpu")
    wq = quant["layers"]["wq"]
    assert wq.q.dtype == torch.int8 and torch.all(wq.q == 1) and torch.all(wq.s == 0.01)
    assert headline.count_params(quant) == headline.count_params(plain)


async def test_bench_requests_are_the_reference_draws(monkeypatch):
    """The run's requests in order: bench.py's warm prompt and burst from
    default_rng(0) (:275-283), the pipeline rung's from default_rng(1)
    (:543-547), then the prefix rung's four prompts, each twice, from where
    the burst left rng 0."""
    seen = []
    generate = TorchLlmEngine.generate

    async def record(self, request):
        seen.append((list(request.data["token_ids"]), request.data["stop"]["max_tokens"]))
        return await generate(self, request)

    monkeypatch.setattr(TorchLlmEngine, "generate", record)
    s = headline.settings_from_env({"DYN_BENCH_DEVICE": "cpu", "DYN_BENCH_ISL": "512",
                                    "DYN_BENCH_OSL": "3", "DYN_BENCH_REQUESTS": "2"})
    result = await headline.run_bench(s)
    vocab = LlamaConfig.tiny().vocab_size
    rng0, rng1 = np.random.default_rng(0), np.random.default_rng(1)
    draw0 = [rng0.integers(10, vocab - 10, size=512).tolist() for _ in range(7)]
    draw1 = [rng1.integers(10, vocab - 10, size=512).tolist() for _ in range(3)]
    want = [(p, 3) for p in draw0[:3]] + [(p, 3) for p in draw1]
    want += [(p, 1) for p in draw0[3:] for _ in range(2)]
    assert seen[:4] == want[:4]
    assert sorted(seen[4:6]) == sorted(want[4:6])  # concurrent HTTP requests
    assert seen[6:] == want[6:]
    assert result["detail"]["outputs_ok"]


def _run_headline(env: dict) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if not k.startswith("DYN_BENCH_")} | env
    return subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.bench.headline"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=240)


def test_headline_cpu_run_prints_one_json_line():
    out = _run_headline({"DYN_BENCH_DEVICE": "cpu", "DYN_BENCH_ISL": "512",
                         "DYN_BENCH_OSL": "4", "DYN_BENCH_REQUESTS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    detail = result["detail"]
    assert REFERENCE_KEYS <= result.keys()
    assert REFERENCE_DETAIL_KEYS <= detail.keys(), REFERENCE_DETAIL_KEYS - detail.keys()
    assert detail["platform"] == "cpu" and detail["device_kind"] == "cpu"
    assert detail["vs_baseline_decode_phase"] is None
    assert detail["mfu_basis"] == "measured_matmul_peak" and 0 < detail["mfu"] <= 1
    assert detail["tokens_direct"] == detail["pipeline_tokens"] == 2 * 4
    assert detail["tokens_expected"] == 8 and detail["outputs_ok"] is True
    assert detail["ttft_samples"] == detail["itl_samples"] == 2
    assert detail["prefix_tokens"] == 512 and detail["prefix_ttft_speedup"] > 0
    assert detail["graphs_captured_after_warmup"] == 0
    assert detail["rungs_not_ported"] == {}
    assert detail["kv_xfer_gbps_device"] > 0 and detail["kv_xfer_gbps_host_tcp"] > 0
    # bench.py's KV routing rung (a mocker fleet) in the detail
    assert detail["kv_routing"].keys() == {
        "ttft_p50_speedup", "ttft_p50_speedup_runs", "followup_ttft_p50_speedup",
        "vs_baseline", "kv_prefix_hits", "random_prefix_hits"}
    assert detail["kv_routing"]["kv_prefix_hits"] > detail["kv_routing"]["random_prefix_hits"]
    assert "Backend" in detail["pipeline_path"]


def test_headline_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = _run_headline({})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA card" in out.stderr


def test_pctile_is_bench_py():
    # bench.py defines pctile inside _measure (:373): its formula, restated
    xs = list(np.random.default_rng(2).random(32))
    for q in (0.5, 0.99):
        assert headline.pctile(xs, q) == sorted(xs)[min(31, int(32 * q))]
    assert headline.pctile(xs, 0.99) == max(xs)  # p99 of 32 samples is the maximum
    assert headline.pctile([], 0.5) is None
