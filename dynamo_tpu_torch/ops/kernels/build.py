"""Build and load the port's hand-written CUDA kernels.

The sources under ``dynamo_tpu_torch/csrc`` have a plain C interface.  At
first use they are compiled for Hopper (``sm_90a``) with ``nvcc`` — one
process per source, all started together, then one link — into a single
shared library in ``dynamo_tpu_torch/_build/``, named by a hash of the
sources and flags so an edit rebuilds and an unchanged tree reuses the
library.  It is loaded with ``ctypes``; nothing includes PyTorch's headers,
which keeps the build to seconds.

Nothing here runs at import: ``library()`` builds on its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
SOURCES = ("paged_attention.cu", "ragged_attention.cu", "mla_attention.cu", "block_copy.cu")
HEADERS = ("attention_common.cuh", "split_attention.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the build this process ran


class KernelBuildError(RuntimeError):
    """The CUDA library could not be built or loaded (no nvcc, a compile
    error, no CUDA runtime).  Raised, never worked around: the port has no
    silent fallback from a kernel to its plain version."""


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "cannot be built on this host"
    )


def source_hash() -> str:
    h = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out: Path) -> None:
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        errors = []
        for cmd, _, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"$ {' '.join(cmd)}\n{log}")
        if errors:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = Path(tmp) / out.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_so),
               *(str(obj) for _, obj, _ in procs)]
        link = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelBuildError(f"nvcc link failed:\n$ {' '.join(cmd)}\n{link.stdout}")
        os.replace(tmp_so, out)  # atomic: a concurrent build sees all or nothing


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.dyn_paged_window_attention.argtypes = [p] * 8 + [i] * 12 + [p]
    lib.dyn_paged_window_attention.restype = i
    lib.dyn_ragged_paged_attention.argtypes = [p] * 13 + [i] * 13 + [p]
    lib.dyn_ragged_paged_attention.restype = i
    lib.dyn_mla_paged_window_decode.argtypes = [p] * 9 + [i] * 10 + [f, i, i, p]
    lib.dyn_mla_paged_window_decode.restype = i
    lib.dyn_ragged_mla_attention.argtypes = [p] * 14 + [i] * 10 + [f, i, i, p]
    lib.dyn_ragged_mla_attention.restype = i
    lib.dyn_gather_blocks.argtypes = [p] * 4 + [i64] * 6 + [i] * 2 + [p]
    lib.dyn_gather_blocks.restype = i
    lib.dyn_scatter_blocks.argtypes = [p] * 4 + [i64] * 6 + [i] * 2 + [p]
    lib.dyn_scatter_blocks.restype = i


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  Raises
    KernelBuildError when it cannot be built or loaded."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"libdyn_kernels_{source_hash()}.so"
        if not so.exists():
            t0 = time.perf_counter()
            _compile(find_nvcc(), so)
            build_seconds = time.perf_counter() - t0
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as exc:
            raise KernelBuildError(f"cannot load {so}: {exc}") from exc
        _declare(lib)
        _lib = lib
        return lib


def check(code: int, name: str) -> None:
    """Raise on a non-zero return of a kernel entry point (a refused launch
    or an unsupported shape)."""
    if code == 0:
        return
    if code == 10000:  # dyn::ERR_UNSUPPORTED
        raise ValueError(f"{name}: shape or dtype not supported by the kernel")
    raise RuntimeError(f"{name}: CUDA error {code} at launch")
