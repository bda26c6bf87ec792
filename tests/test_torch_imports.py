"""Import hygiene and the no-fallback rules of the port: dynamo_tpu_torch and
chip_smoke.py import neither JAX nor the JAX package; the default device is
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
        "             or k == 'dynamo_tpu' or k.startswith('dynamo_tpu.'))\n"
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
            "dynamo_tpu_torch.ops.kernels.mla_attention",
            "dynamo_tpu_torch.ops.block_copy", "dynamo_tpu_torch.ops.kernels.block_copy",
            "dynamo_tpu_torch.llm.block_manager.storage",
            "dynamo_tpu_torch.llm.block_manager.pool",
            "dynamo_tpu_torch.llm.block_manager.offload",
            "dynamo_tpu_torch.llm.block_manager.manager",
            "dynamo_tpu_torch.llm.block_manager.remote",
            "dynamo_tpu_torch.runtime.codec",
            "dynamo_tpu_torch.engine.offload"} <= names
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
