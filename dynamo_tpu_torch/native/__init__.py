"""Native (C++) host codecs (counterpart of dynamo_tpu/native/__init__.py).

Builds ``dynamo_tpu_torch/csrc/<name>.cpp`` on demand with ``g++`` and binds
it with ctypes (a plain C ABI, no pybind11).  Each library is named by a
hash of its source and flags, built in a temporary directory under
``dynamo_tpu_torch/_build/`` and renamed into place, so a process that
loads it while another builds it sees a whole library or none.
``DYN_DISABLE_NATIVE=1`` forces the pure-Python twins, and so does a
failed build (the reference's host fallback: these are host codecs, not
device kernels).

``counters`` counts, process wide, the frame streams the data plane read
through the native decoder and through the Python codec, and the frames
each decoded; ``stats()`` reports them with the libraries this process
loaded.
"""

from __future__ import annotations

import asyncio
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

from dynamo_tpu_torch.utils import knobs
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("native")

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}

counters = {
    "native_streams": 0,   # frame streams read through NativeFrameDecoder
    "native_frames": 0,
    "python_streams": 0,   # frame streams read through the Python codec
    "python_frames": 0,
}


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cpp`` builds to: named by a hash of the source
    and the flags, so an edit rebuilds and an unchanged tree reuses it."""
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD / f"lib{name}_{h.hexdigest()[:16]}.so"


def _build(source: Path, lib_path: Path) -> None:
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        tmp_so = Path(tmp) / lib_path.name
        subprocess.run(
            ["g++", *GXX_FLAGS, str(source), "-o", str(tmp_so)],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp_so, lib_path)  # atomic: a concurrent loader sees all or nothing


def load_native(name: str) -> ctypes.CDLL | None:
    """Compile (cached) and load ``csrc/<name>.cpp``; None when
    ``DYN_DISABLE_NATIVE`` is set or the build fails."""
    if knobs.get("DYN_DISABLE_NATIVE"):
        return None
    with _lock:
        if name in _libs:
            return _libs[name]
        source = CSRC / f"{name}.cpp"
        try:
            lib_path = library_path(name)
            if not lib_path.exists():
                _build(source, lib_path)
                logger.info("built native %s", lib_path.name)
            _libs[name] = ctypes.CDLL(str(lib_path))
        except (subprocess.CalledProcessError, OSError) as exc:
            detail = getattr(exc, "stderr", "") or repr(exc)
            logger.warning("native %s unavailable (%s); using Python fallback", name, detail)
            _libs[name] = None
        return _libs[name]


async def warm_native(name: str) -> None:
    """Build and load ``name`` off the event loop, once a process: first use
    otherwise runs a synchronous ``g++`` inside a connection handler."""
    if name not in _libs and not knobs.get("DYN_DISABLE_NATIVE"):
        await asyncio.to_thread(load_native, name)


def stats() -> dict:
    """The libraries this process loaded (None: tried and fell back) and the
    data plane's decode counters."""
    return {
        "libraries": {name: lib is not None for name, lib in _libs.items()},
        **counters,
    }
