"""Import hygiene and the no-fallback rules of the port: dynamo_tpu_torch and
chip_smoke.py import neither JAX nor the JAX package (and importing the port
leaves prometheus_client out: the frontend's /metrics imports it where it
renders); the default device is
the CUDA card and its absence raises; the chip smoke refuses to report a
result without a card or without the package beside it."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "dynamo_tpu_torch"


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dynamo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__, 'dynamo_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'dynamo_tpu' or k.startswith('dynamo_tpu.')\n"
        "             or k == 'yaml' or k.startswith('yaml.')\n"
        "             or k == 'prometheus_client' or k.startswith('prometheus_client.'))\n"
        "print(' '.join(names))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names, bad = out.stdout.strip().splitlines()[-2:]
    names = set(names.split())
    assert len(names) > 30
    assert {"dynamo_tpu_torch.models.deepseek", "dynamo_tpu_torch.ops.moe",
            # the other model families: the MoE families, Gemma-2 and Gemma-3
            "dynamo_tpu_torch.models.mixtral", "dynamo_tpu_torch.models.gemma2",
            "dynamo_tpu_torch.models.gemma3",
            "dynamo_tpu_torch.ops.kernels.mla_attention",
            "dynamo_tpu_torch.ops.block_copy", "dynamo_tpu_torch.ops.kernels.block_copy",
            "dynamo_tpu_torch.llm.block_manager.storage",
            "dynamo_tpu_torch.llm.block_manager.pool",
            "dynamo_tpu_torch.llm.block_manager.offload",
            "dynamo_tpu_torch.llm.block_manager.manager",
            "dynamo_tpu_torch.llm.block_manager.remote",
            "dynamo_tpu_torch.runtime.codec",
            "dynamo_tpu_torch.engine.offload",
            "dynamo_tpu_torch.planner.perf_interpolation",
            "dynamo_tpu_torch.bench.data_generator", "dynamo_tpu_torch.bench.sweep",
            "dynamo_tpu_torch.bench.profile_sla", "dynamo_tpu_torch.bench.headline",
            "dynamo_tpu_torch.bench.trace_summary",
            "dynamo_tpu_torch.utils.profiling",
            # the distributed runtime and the orchestration plane above the
            # engine: importing them leaves PyYAML out too (a YAML config is
            # read only where one is given)
            "dynamo_tpu_torch.runtime.controlplane.interface",
            "dynamo_tpu_torch.runtime.controlplane.wire",
            "dynamo_tpu_torch.runtime.controlplane.memory",
            "dynamo_tpu_torch.runtime.controlplane.kv_cache",
            "dynamo_tpu_torch.runtime.controlplane.server",
            "dynamo_tpu_torch.runtime.controlplane.client",
            "dynamo_tpu_torch.runtime.controlplane.connect",
            "dynamo_tpu_torch.runtime.dataplane", "dynamo_tpu_torch.runtime.component",
            "dynamo_tpu_torch.runtime.ingress", "dynamo_tpu_torch.runtime.resume",
            "dynamo_tpu_torch.runtime.migration", "dynamo_tpu_torch.runtime.client",
            "dynamo_tpu_torch.runtime.distributed", "dynamo_tpu_torch.runtime.pipeline",
            "dynamo_tpu_torch.runtime.barrier",
            # the tensor and expert mesh, its shard workers, bootstrap and dryrun
            "dynamo_tpu_torch.parallel.mesh", "dynamo_tpu_torch.parallel.multihost",
            "dynamo_tpu_torch.parallel.dryrun", "dynamo_tpu_torch.engine.shard_worker",
            # pipeline stages and the sequence ring
            "dynamo_tpu_torch.parallel.pipeline", "dynamo_tpu_torch.ops.ring_attention",
            "dynamo_tpu_torch.llm.kv_router.protocols",
            "dynamo_tpu_torch.llm.kv_router.indexer",
            "dynamo_tpu_torch.llm.kv_router.scheduler",
            "dynamo_tpu_torch.llm.kv_router.cost", "dynamo_tpu_torch.llm.kv_router.router",
            "dynamo_tpu_torch.llm.kv_router.publisher",
            "dynamo_tpu_torch.llm.kv_router.metrics_aggregator",
            "dynamo_tpu_torch.llm.discovery", "dynamo_tpu_torch.llm.engines",
            "dynamo_tpu_torch.llm.hub", "dynamo_tpu_torch.llm.request_template",
            "dynamo_tpu_torch.robustness.counters", "dynamo_tpu_torch.robustness.faults",
            "dynamo_tpu_torch.robustness.retry", "dynamo_tpu_torch.robustness.admission",
            # the full HTTP service and the prefetch pager
            "dynamo_tpu_torch.llm.http.metrics", "dynamo_tpu_torch.llm.http.service",
            "dynamo_tpu_torch.observability.slo",
            "dynamo_tpu_torch.prefetch", "dynamo_tpu_torch.prefetch.hints",
            "dynamo_tpu_torch.prefetch.session", "dynamo_tpu_torch.prefetch.pager",
            "dynamo_tpu_torch.prefetch.frontend", "dynamo_tpu_torch.prefetch.forwarder",
            "dynamo_tpu_torch.prefetch.worker",
            # the native host codecs, the mocker and the routed fleet, the
            # services (the metrics service imports prometheus_client where
            # it builds its registry) and the planner and topology copies
            "dynamo_tpu_torch.native", "dynamo_tpu_torch.native.dataplane",
            "dynamo_tpu_torch.native.radix", "dynamo_tpu_torch.llm.mocker",
            "dynamo_tpu_torch.bench.routed_fleet",
            "dynamo_tpu_torch.components.metrics_service",
            "dynamo_tpu_torch.components.router_service",
            "dynamo_tpu_torch.planner.state", "dynamo_tpu_torch.topology.metrics",
            "dynamo_tpu_torch.observability.trace", "dynamo_tpu_torch.observability.recorder",
            "dynamo_tpu_torch.observability.flight",
            "dynamo_tpu_torch.utils.config", "dynamo_tpu_torch.utils.knobs",
            "dynamo_tpu_torch.serve", "dynamo_tpu_torch.cli.run",
            "dynamo_tpu_torch.cli.dynctl",
            # guided JSON decoding, the KV transfer plane, disaggregated
            # prefill/decode, its bench and the topology plane
            "dynamo_tpu_torch.llm.guided", "dynamo_tpu_torch.parallel",
            "dynamo_tpu_torch.parallel.kv_transfer", "dynamo_tpu_torch.llm.disagg",
            "dynamo_tpu_torch.bench.disagg_bench", "dynamo_tpu_torch.topology",
            "dynamo_tpu_torch.topology.card", "dynamo_tpu_torch.topology.map",
            "dynamo_tpu_torch.topology.prober",
            # multimodal serving, the embedding engine and GGUF weights
            "dynamo_tpu_torch.llm.multimodal", "dynamo_tpu_torch.models.vision",
            "dynamo_tpu_torch.engine.embedding", "dynamo_tpu_torch.llm.gguf",
            "dynamo_tpu_torch.examples.multimodal.pipeline",
            "dynamo_tpu_torch.examples.multimodal.components",
            "dynamo_tpu_torch.examples.embeddings.serve_embeddings",
            # the kernel autotuner, the SDK and its GPU allocator, the
            # planner, the KV recorder, the perf gate and the LLM examples
            "dynamo_tpu_torch.ops.autotune", "dynamo_tpu_torch.sdk",
            "dynamo_tpu_torch.sdk.allocator", "dynamo_tpu_torch.sdk.graph",
            "dynamo_tpu_torch.sdk.runner", "dynamo_tpu_torch.sdk.supervisor",
            "dynamo_tpu_torch.planner.planner", "dynamo_tpu_torch.planner.connectors",
            "dynamo_tpu_torch.planner.defrag", "dynamo_tpu_torch.planner.load_predictor",
            "dynamo_tpu_torch.llm.kv_router.recorder", "dynamo_tpu_torch.bench.perfgate",
            "dynamo_tpu_torch.examples.hello_world.hello_world",
            "dynamo_tpu_torch.examples.llm.common", "dynamo_tpu_torch.examples.llm.launch",
            "dynamo_tpu_torch.examples.llm.disagg_router_serve",
            "dynamo_tpu_torch.examples.llm.graphs.agg",
            "dynamo_tpu_torch.examples.llm.graphs.agg_router",
            "dynamo_tpu_torch.examples.llm.graphs.disagg",
            "dynamo_tpu_torch.examples.llm.graphs.disagg_router",
            # the scenario soaks, the operator tools, the deploy plane, the
            # deployment CLI and the standalone router
            "dynamo_tpu_torch.scenarios", "dynamo_tpu_torch.scenarios.spec",
            "dynamo_tpu_torch.scenarios.traffic", "dynamo_tpu_torch.scenarios.fleet",
            "dynamo_tpu_torch.scenarios.runner", "dynamo_tpu_torch.scenarios.soak",
            "dynamo_tpu_torch.scripts", "dynamo_tpu_torch.scripts.dyn_top",
            "dynamo_tpu_torch.scripts.check_metrics", "dynamo_tpu_torch.scripts.chaos_smoke",
            "dynamo_tpu_torch.scripts.migration_bench", "dynamo_tpu_torch.deploy",
            "dynamo_tpu_torch.deploy.api_store", "dynamo_tpu_torch.deploy.crds",
            "dynamo_tpu_torch.deploy.deployment", "dynamo_tpu_torch.deploy.operator",
            "dynamo_tpu_torch.cli.deployctl",
            "dynamo_tpu_torch.examples.router_standalone.router"} <= names
    assert bad == "[]"


def imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(
    [*PACKAGE.rglob("*.py"), ROOT / "chip_smoke.py"], key=str,
), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    for name in imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "dynamo_tpu"), f"{path} imports {name}"


def test_default_device_is_the_card():
    from dynamo_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()


def test_kernel_wrappers_refuse_other_devices_and_count_plain_calls():
    from dynamo_tpu_torch.ops.kernels import paged_attention

    q = torch.zeros((1, 4, 16))
    cache = torch.zeros((2, 4, 2, 16))
    before = paged_attention.plain_calls
    paged_attention.paged_attention_decode(
        q, cache, cache, torch.zeros((1, 2), dtype=torch.int32),
        torch.ones((1,), dtype=torch.int32),
    )
    assert paged_attention.plain_calls == before + 1
    assert paged_attention.launches == 0  # nothing launched on this host
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention.paged_attention_decode(
            q.to("meta"), cache.to("meta"), cache.to("meta"),
            torch.zeros((1, 2), dtype=torch.int32, device="meta"),
            torch.ones((1,), dtype=torch.int32, device="meta"),
        )


def run_smoke(cwd: Path):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=120,
    )


def test_chip_smoke_without_a_card_fails_and_reports_nothing():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails_and_reports_nothing(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
