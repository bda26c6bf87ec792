"""Argument checks and device facts shared by the kernel wrappers."""

from __future__ import annotations

import functools

import torch

# the element types the kernels read, by the codes of csrc/attention_common.cuh's
# CacheType: queries and outputs float32 or bf16, caches any of the five
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
           torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}
Q_DTYPES = (torch.float32, torch.bfloat16)
# caches the tensor-core walks read under bf16 queries (an fp8 value is
# exact in bf16); the others take the CUDA-core loops
WALK_CACHE_DTYPES = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)
HEAD_DIMS = (16, 64, 128)


def dtype_code(dtype: torch.dtype) -> int:
    return _DTYPES[dtype]


def walk_cache(q_dtype: torch.dtype, cache_dtype: torch.dtype) -> bool:
    """Whether a tensor-core walk takes these dtypes (shapes aside)."""
    return q_dtype == torch.bfloat16 and cache_dtype in WALK_CACHE_DTYPES


def stream_ptr(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the integer the C entry
    points take."""
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA ``device`` (the split planners
    size their grids by it)."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def check_cache(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                d: int, dk: int) -> None:
    """Device, dtype, shape, contiguity and alignment checks for q and a
    [N, bs, KVH, D] cache pair.  The kernels take float32 or bfloat16
    queries, caches of any dtype in ``_DTYPES`` (both of one dtype, the
    queries' or another), and head dims 16, 64 and 128."""
    if q.dtype not in Q_DTYPES:
        raise ValueError(f"query dtype {q.dtype} is not supported by the kernels "
                         "(float32, bfloat16)")
    if k_cache.dtype not in _DTYPES:
        raise ValueError(
            f"cache dtype {k_cache.dtype} is not supported by the kernels "
            f"({', '.join(str(t).removeprefix('torch.') for t in _DTYPES)})"
        )
    if v_cache.dtype != k_cache.dtype:
        raise ValueError(f"k ({k_cache.dtype}) and v ({v_cache.dtype}) caches differ in dtype")
    if d != dk or d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} (cache {dk}) not in {HEAD_DIMS}")
    if v_cache.shape != k_cache.shape:
        raise ValueError("k and v caches differ in shape")
    check_layout(q.device, q=q, k_cache=k_cache, v_cache=v_cache)


def check_layout(device: torch.device, **tensors: torch.Tensor) -> None:
    """Data arguments: on ``device``, contiguous, 16-byte aligned (the
    kernels load 16 bytes at a time)."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")


def check_index(device: torch.device, **tensors: torch.Tensor) -> None:
    """Index and metadata arguments: contiguous int32 tensors on ``device``."""
    for name, t in tensors.items():
        if t.dtype != torch.int32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {device}")
