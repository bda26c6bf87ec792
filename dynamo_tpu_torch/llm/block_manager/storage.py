"""Storage backends for KV block pools.

A block's payload is one tensor ``[layers, 2(kv), block_size, kv_heads,
head_dim]`` (or a raw byte payload, see ``KvbmConfig.payload_shape``).
Backends expose uniform read/write by block id; batched variants amortize
dispatch (the transfer engine always moves batches).  Data crosses tiers as
CPU tensors: ``read_batch`` returns one, ``write_batch`` takes a tensor on
any device.

(Counterpart of dynamo_tpu/llm/block_manager/storage.py.  Device is a torch
tensor on the card, moved by the hand-written block gather/scatter kernels;
Host is a CPU tensor, pinned when a card is present; Disk is a numpy uint8
memmap viewed as the pool's dtype, so bf16 blocks need no numpy dtype.)
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.ops.kernels import block_copy


def block_shape(num_layers: int, block_size: int, kv_heads: int, head_dim: int) -> tuple:
    return (num_layers, 2, block_size, kv_heads, head_dim)


def _index(block_ids: list[int]) -> torch.Tensor:
    return torch.as_tensor(block_ids, dtype=torch.int64)


class Storage:
    """Uniform block storage interface."""

    num_blocks: int

    def read_batch(self, block_ids: list[int]) -> torch.Tensor:
        raise NotImplementedError

    def write_batch(self, block_ids: list[int], data: torch.Tensor) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullStorage(Storage):
    """Metadata-only: accepts writes, reads zeros.  For pool/offload logic
    tests with no memory cost."""

    def __init__(self, num_blocks: int, shape: tuple, dtype: torch.dtype = torch.float32):
        self.num_blocks = num_blocks
        self.shape = shape
        self.dtype = dtype

    def read_batch(self, block_ids: list[int]) -> torch.Tensor:
        return torch.zeros((len(block_ids), *self.shape), dtype=self.dtype)

    def write_batch(self, block_ids: list[int], data: torch.Tensor) -> None:
        pass


class HostStorage(Storage):
    """Host DRAM pool (G2): one CPU tensor, page-locked when a card is
    present so copies to and from it run at the host link's rate."""

    def __init__(self, num_blocks: int, shape: tuple, dtype: torch.dtype = torch.float32):
        self.num_blocks = num_blocks
        self.shape = shape
        self._data = torch.zeros(
            (num_blocks, *shape), dtype=dtype, pin_memory=torch.cuda.is_available()
        )

    def read_batch(self, block_ids: list[int]) -> torch.Tensor:
        return self._data[_index(block_ids)]

    def write_batch(self, block_ids: list[int], data: torch.Tensor) -> None:
        self._data[_index(block_ids)] = data.to("cpu", self._data.dtype)


class DiskStorage(Storage):
    """Local SSD pool (G3): a numpy uint8 memmap viewed as the pool's dtype
    (host-mediated, the counterpart of the reference's GDS-backed disk
    tier)."""

    def __init__(self, num_blocks: int, shape: tuple, dtype: torch.dtype = torch.float32, *,
                 path: str | Path):
        self.num_blocks = num_blocks
        self.shape = shape
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._map = np.memmap(
            self.path, dtype=np.uint8, mode="w+",
            shape=(num_blocks, math.prod(shape) * dtype.itemsize),
        )
        self._data = torch.from_numpy(self._map).view(dtype).view(num_blocks, *shape)

    def read_batch(self, block_ids: list[int]) -> torch.Tensor:
        return self._data[_index(block_ids)]

    def write_batch(self, block_ids: list[int], data: torch.Tensor) -> None:
        self._data[_index(block_ids)] = data.to("cpu", self._data.dtype)

    def flush(self) -> None:
        self._map.flush()

    def close(self) -> None:
        self.flush()
        del self._data, self._map


class DeviceStorage(Storage):
    """Device pool (G1): one tensor ``[N, *block]`` on the card (or on the
    CPU when the caller asks for it), moved by block id through the block
    gather/scatter kernels (``ops/kernels/block_copy.py``; their plain
    versions on the CPU).

    The offload manager calls these from worker threads: each call makes
    the pool's device current in its thread, and synchronizes before it
    returns, so the next tier never sees a copy in flight."""

    def __init__(self, num_blocks: int, shape: tuple, dtype: torch.dtype = torch.float32, *,
                 device=None):
        self.num_blocks = num_blocks
        self.shape = shape
        self.device = resolve_device(device)
        self._data = torch.zeros((num_blocks, *shape), dtype=dtype, device=self.device)

    @property
    def array(self) -> torch.Tensor:
        return self._data

    def _current(self):
        return torch.cuda.device(self.device) if self.device.type == "cuda" else nullcontext()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def read_batch(self, block_ids: list[int]) -> torch.Tensor:
        with self._current():
            out = block_copy.gather_blocks(self._data, block_ids).to("cpu")
            self._sync()
        return out

    def write_batch(self, block_ids: list[int], data: torch.Tensor) -> None:
        with self._current():
            block_copy.scatter_blocks(self._data, data.to(self.device), block_ids)
            self._sync()
