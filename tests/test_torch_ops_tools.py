"""The port's operator tools (dynamo_tpu_torch/scripts/) against the
repository's scripts/ of the same names.

- ``dyn_top`` and ``check_metrics`` parse the same exposition text as the
  reference's, and take the same snapshot of the same live endpoints;
- both pass live against the port's frontend and metrics service (fed by a
  worker's stats, a ``TorchLlmEngine``'s among them), as
  tests/llm/test_{dyn_top,check_metrics}.py hold of the reference; every
  family the port's registries expose is in the lists;
- importing either leaves torch, jax and the JAX package out;
- ``dyn_top``'s flight directory is the port's;
- the port's ``chaos_smoke`` passes (echo workers, the shipped schedule);
- ``migration_bench`` writes where it is told, and its default is the
  port's git-ignored artifact."""

import asyncio
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import httpx
import pytest

from dynamo_tpu_torch.components.metrics_service import MetricsService
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.http.metrics import FrontendMetrics
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.kv_router.publisher import WorkerMetricsPublisher
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.observability import flight
from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.robustness.faults import FAULTS
from dynamo_tpu_torch.runtime.controlplane.memory import MemoryControlPlane
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.scripts import chaos_smoke, check_metrics, dyn_top, migration_bench
from dynamo_tpu_torch.utils.config import RuntimeConfig

ROOT = Path(__file__).resolve().parent.parent


def reference_script(name: str):
    """scripts/<name>.py (not a package), loaded under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"_reference_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF_TOP = reference_script("dyn_top")
REF_CHECK = reference_script("check_metrics")

# tests/llm/test_dyn_top.py's worker stats
STATS = {
    "kv_active_blocks": 7, "kv_total_blocks": 64, "gpu_cache_usage_perc": 7 / 64,
    "num_requests_waiting": 2, "num_requests_running": 3, "batch_occupancy_perc": 3 / 8,
    "mfu_perc": 0.42, "bandwidth_util_perc": 0.63, "goodput_tokens_per_second": 123.5,
    "prefill_tokens_per_second": 20.0, "prefill_tokens_total": 4096,
    "decode_tokens_total": 1024, "tokens_emitted_total": 1000, "preempted_tokens_total": 128,
    "spec_rejected_tokens_total": 8, "wasted_tokens_total": 136, "prefetch_hits_total": 9,
    "prefetch_misses_total": 3, "prefetch_stale_total": 1,
    "prefetch_hidden_seconds_total": 1.25,
    "offload_tiers": {"g2": {"blocks": 32, "used": 10, "pinned": 2}},
}


@pytest.fixture(autouse=True)
def _clean_state():
    counters.reset()
    FAULTS.reset()
    yield
    counters.reset()
    FAULTS.reset()


def test_importing_the_tools_pulls_in_no_torch_or_jax():
    code = ("import sys\n"
            "import dynamo_tpu_torch.scripts.dyn_top, dynamo_tpu_torch.scripts.check_metrics\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'dynamo_tpu', 'numpy')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_family_lists_are_the_references():
    for name in ("FRONTEND_FAMILIES", "WORKER_FAMILIES"):
        assert getattr(check_metrics, name) == getattr(REF_CHECK, name)


def test_flight_directory_is_the_ports(monkeypatch):
    for var in ("DYN_FLIGHT_DIR", "DYN_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    assert dyn_top.flight_dump_dir() == flight.flight_dir()
    assert dyn_top.flight_dump_dir().parts[-2:] == ("dynamo_tpu_torch", "flight")
    assert REF_TOP.flight_dump_dir().parts[-2:] == ("dynamo_tpu", "flight")
    monkeypatch.setenv("DYN_CACHE_DIR", "/x")
    assert dyn_top.flight_dump_dir() == flight.flight_dir() == Path("/x/flight")


def test_parse_prometheus_lines_like_the_reference():
    text = ("# HELP dyn_worker_mfu_perc x\n# TYPE dyn_worker_mfu_perc gauge\n"
            'dyn_worker_mfu_perc{worker="ab"} 0.5\ndyn_shed_total 3\n'
            "garbage line without value\n")
    samples = dyn_top.parse_prometheus(text)
    assert ("dyn_worker_mfu_perc", {"worker": "ab"}, 0.5) in samples
    assert ("dyn_shed_total", {}, 3.0) in samples
    assert samples == REF_TOP.parse_prometheus(text)


def test_frontend_registry_exposes_every_expected_family():
    text = FrontendMetrics().render().decode()
    assert check_metrics.missing_families(text, check_metrics.FRONTEND_FAMILIES) == []
    assert check_metrics.missing_families(text, ("dyn_llm_nonexistent_family",)) == [
        "dyn_llm_nonexistent_family"]
    assert check_metrics.exposed_families(text) == REF_CHECK.exposed_families(text)


async def _fleet(name: str, stats_fn):
    MemoryControlPlane.reset_named()
    rt = await DistributedRuntime.create(RuntimeConfig(control_plane=f"memory://{name}"))
    frontend = HttpService(host="127.0.0.1", port=0)
    comp = rt.namespace("ns").component("backend")
    metrics_svc = MetricsService(comp, host="127.0.0.1", port=0)
    pub = WorkerMetricsPublisher(comp, worker_id=0xAB, stats_fn=stats_fn)
    await frontend.start()
    await metrics_svc.start()
    await pub.publish_once()
    await asyncio.sleep(0.1)

    async def close():
        await pub.stop()
        await metrics_svc.stop()
        await frontend.stop()
        await rt.close()

    return (f"http://127.0.0.1:{frontend.port}", f"http://127.0.0.1:{metrics_svc.port}",
            frontend, close)


async def test_dyn_top_once_json_against_the_ports_fleet(capsys):
    frontend_url, worker_url, frontend, close = await _fleet("dyn-top", lambda: STATS)
    try:
        g = frontend.metrics.guard("m", "chat_completions", "stream", trace_id="t1")
        g.token_observed()
        g.mark_ok()
        g.done()
        counters.incr("dyn_migration_committed_total", 2)
        counters.incr("dyn_migration_aborted_total")
        rc = await asyncio.to_thread(dyn_top.main, ["--frontend", frontend_url, "--worker",
                                                    worker_url, "--once", "--json"])
        assert rc == 0
        snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        worker = snap["workers"]["ab"]
        assert (worker["mfu_perc"], worker["bandwidth_util_perc"]) == (0.42, 0.63)
        assert worker["goodput_tokens_per_second"] == 123.5
        assert (worker["waiting"], worker["running"]) == (2.0, 3.0)
        assert (worker["prefetch_hits"], worker["prefetch_hit_ratio"]) == (9.0, 0.75)
        assert worker["offload_tiers"]["g2"] == {"blocks": 32.0, "used": 10.0, "pinned": 2.0}
        assert snap["fleet"]["workers"] == 1
        assert snap["frontend"]["requests_total"] == 1.0
        assert snap["frontend"]["migrations_committed"] == 2.0
        assert set(snap["frontend"]["slo"]["objectives"]) == {"ttft", "itl", "error_rate"}
        table = dyn_top.render_table(snap)
        assert "WORKER" in table and "tiers: g2 10/32 (pin 2)" in table
        # the reference's dyn_top takes the same snapshot of the same surfaces
        ours = await asyncio.to_thread(dyn_top.collect_snapshot, frontend_url, worker_url, 2.0)
        ref = await asyncio.to_thread(REF_TOP.collect_snapshot, frontend_url, worker_url, 2.0)
        ours.pop("ts"), ref.pop("ts")
        assert ours == ref
        assert dyn_top.render_table(snap) == REF_TOP.render_table(snap)
    finally:
        await close()


async def test_dyn_top_degrades_when_surfaces_are_down():
    snap = await asyncio.to_thread(dyn_top.collect_snapshot, "http://127.0.0.1:9",
                                   "http://127.0.0.1:9", 0.3)
    assert snap["workers"] == {} and "workers_error" in snap and "error" in snap["frontend"]
    rc = await asyncio.to_thread(dyn_top.main, ["--frontend", "http://127.0.0.1:9", "--once",
                                                "--json", "--timeout", "0.3"])
    assert rc == 1


async def test_check_metrics_live_against_a_torch_engine_worker():
    """The metrics service fed by ``TorchLlmEngine.stats()`` exposes every
    ``WORKER_FAMILIES`` family, and every family it exposes is listed (so
    none of the port's goes unchecked); the frontend likewise."""
    cfg = llama.LlamaConfig.tiny()
    import torch

    engine = TorchLlmEngine(
        EngineConfig(model=cfg, num_blocks=32, block_size=4, max_batch_size=2,
                     prefill_buckets=(16,), max_model_len=16),
        params=llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
        device="cpu")
    frontend_url, worker_url, _, close = await _fleet("check-metrics", engine.stats)
    try:
        async with httpx.AsyncClient() as client:
            front = (await client.get(f"{frontend_url}/metrics")).text
            work = (await client.get(f"{worker_url}/metrics")).text
        assert check_metrics.missing_families(front, check_metrics.FRONTEND_FAMILIES) == []
        assert check_metrics.missing_families(work, check_metrics.WORKER_FAMILIES) == []
        assert check_metrics.duplicate_families(work) == []
        # every family exposed is listed (prometheus_client also writes a
        # counter's creation time as a family ``<name>_created``)
        def families(text):
            return {f for f in check_metrics.exposed_families(text)
                    if f.startswith("dyn_") and not f.endswith("_created")}

        assert families(work) <= set(check_metrics.WORKER_FAMILIES)
        assert families(front) <= set(check_metrics.FRONTEND_FAMILIES)
        assert REF_CHECK.missing_families(work, REF_CHECK.WORKER_FAMILIES) == []
        for url in (f"{frontend_url}/metrics", f"{worker_url}/metrics"):
            # urllib is blocking: keep it off the loop serving the scrape
            assert await asyncio.to_thread(check_metrics.check_url, url, ()) == \
                await asyncio.to_thread(REF_CHECK.check_url, url, ())
        assert await asyncio.to_thread(check_metrics.main, [
            "--frontend", f"{frontend_url}/metrics", "--worker", f"{worker_url}/metrics"]) == 0
        assert await asyncio.to_thread(check_metrics.main, [
            "--frontend", "http://127.0.0.1:9/metrics", "--timeout", "0.5"]) == 1
    finally:
        await close()


async def test_chaos_smoke_passes():
    assert Path(chaos_smoke.MODEL_DIR).is_dir()
    assert chaos_smoke._canned() == (6, 20, chaos_smoke.DEFAULT_SCHEDULE)
    assert await chaos_smoke.amain(requests=6, burst=12) == 0


def test_migration_bench_writes_where_it_is_told(tmp_path, monkeypatch):
    """The bench's default artifact is the port's git-ignored
    MIGRATION_BENCH_CUDA.json at the repository root, never the root
    MIGRATION_BENCH.json; the run itself (two soaks of the shipped
    migration spec, at a high compression) writes only its ``--out``."""
    seen = {}

    async def fake_amain(out, speedup):
        seen["out"], seen["speedup"] = out, speedup
        return 0

    monkeypatch.setattr(migration_bench, "amain", fake_amain)
    assert migration_bench.main([]) == 0
    assert seen["out"] == ROOT / "MIGRATION_BENCH_CUDA.json"
    assert "MIGRATION_BENCH_CUDA.json" in (ROOT / ".gitignore").read_text().split()
    monkeypatch.undo()
    monkeypatch.setenv("DYN_FLIGHT_DIR", str(tmp_path / "flight"))

    before = sorted(p.name for p in ROOT.iterdir())
    out = tmp_path / "bench.json"
    assert migration_bench.main(["--out", str(out), "--speedup", "40"]) in (0, 1)
    record = json.loads(out.read_text())
    assert record["scenario"] == "migration"
    assert record["requests"]["completed"] > 0 and record["outputs"]["verified"] > 0
    assert sorted(p.name for p in ROOT.iterdir()) == before
