"""ctypes binding for the native radix index (csrc/radix_index.cpp; a copy of
dynamo_tpu/native/radix.py).

Interface-compatible with the Python ``RadixTree``
(dynamo_tpu_torch/llm/kv_router/indexer.py), which remains the behavioral spec and
fallback.
"""

from __future__ import annotations

import ctypes

from dynamo_tpu_torch.llm.kv_router.protocols import OverlapScores, RouterEvent
from dynamo_tpu_torch.native import load_native

MAX_WORKERS_OUT = 4096


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.radix_new.restype = ctypes.c_void_p
    lib.radix_free.argtypes = [ctypes.c_void_p]
    lib.radix_apply_stored.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32,
    ]
    lib.radix_apply_removed.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32,
    ]
    lib.radix_remove_worker.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.radix_find_matches.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.radix_find_matches.restype = ctypes.c_int32
    lib.radix_size.argtypes = [ctypes.c_void_p]
    lib.radix_size.restype = ctypes.c_int32
    lib.radix_worker_block_count.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.radix_worker_block_count.restype = ctypes.c_int32
    return lib


def native_available() -> bool:
    return load_native("radix_index") is not None


class NativeRadixTree:
    def __init__(self) -> None:
        lib = load_native("radix_index")
        if lib is None:
            raise RuntimeError("native radix index unavailable")
        self._lib = _bind(lib)
        self._handle = ctypes.c_void_p(self._lib.radix_new())

    def __del__(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.radix_free(handle)
            self._handle = None

    @staticmethod
    def _hash_array(hashes: list[int]):
        return (ctypes.c_uint64 * len(hashes))(*hashes)

    def apply(self, event: RouterEvent) -> None:
        kv = event.event
        if kv.kind == "stored":
            arr = self._hash_array(kv.block_hashes)
            parent = kv.parent_hash if kv.parent_hash is not None else 0
            self._lib.radix_apply_stored(
                self._handle, event.worker_id, arr, len(kv.block_hashes),
                ctypes.c_uint64(parent), 1 if kv.parent_hash is not None else 0,
            )
        elif kv.kind == "removed":
            arr = self._hash_array(kv.block_hashes)
            self._lib.radix_apply_removed(self._handle, event.worker_id, arr, len(kv.block_hashes))
        elif kv.kind == "cleared":
            self.remove_worker(event.worker_id)

    def remove_worker(self, worker_id: int) -> None:
        self._lib.radix_remove_worker(self._handle, worker_id)

    def find_matches(self, block_hashes: list[int]) -> OverlapScores:
        if not block_hashes:
            return OverlapScores(scores={}, total_blocks=0)
        arr = self._hash_array(block_hashes)
        out_workers = (ctypes.c_int64 * MAX_WORKERS_OUT)()
        out_scores = (ctypes.c_int32 * MAX_WORKERS_OUT)()
        n = self._lib.radix_find_matches(
            self._handle, arr, len(block_hashes), out_workers, out_scores, MAX_WORKERS_OUT
        )
        return OverlapScores(
            scores={int(out_workers[i]): int(out_scores[i]) for i in range(n)},
            total_blocks=len(block_hashes),
        )

    def size(self) -> int:
        return self._lib.radix_size(self._handle)

    def worker_block_count(self, worker_id: int) -> int:
        return self._lib.radix_worker_block_count(self._handle, worker_id)
