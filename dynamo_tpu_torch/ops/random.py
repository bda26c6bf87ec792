"""JAX's threefry2x32 random stream in plain PyTorch.

The reference samples with ``jax.random``: each lane's raw key ``[hi, lo]``
(uint32) is folded with the step's context length
(``jax.random.fold_in``) and ``jax.random.categorical`` draws
``argmax(logits + gumbel(key, (vocab,)))``.  These functions reproduce
those bits — threefry2x32 (Salmon et al., "Parallel random numbers: as easy
as 1, 2, 3"), ``fold_in``, 32-bit random bits with the partitionable
counter layout, and the uniform → Gumbel map — so that the port's seeded
streams match the reference's.  The final ``log``s may differ from XLA's
in the last bit.

uint32 words live in int64 tensors, masked to 32 bits after every add and
shift.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of counter words (x0, x1) under key (k1, k2);
    all arguments broadcast, int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` for raw keys: keys [n, 2] and data [n] (int64
    holding uint32 values) → new keys [n, 2]."""
    y0, y1 = threefry2x32(
        keys[:, 0], keys[:, 1], torch.zeros_like(data), data & _M32
    )
    return torch.stack([y0, y1], dim=1)


def gumbel(keys: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (size,))`` (float32, the default "low"
    mode) for every row of keys [n, 2]: [n, size]."""
    counts = torch.arange(size, dtype=torch.int64, device=keys.device)[None, :]
    b0, b1 = threefry2x32(
        keys[:, 0:1], keys[:, 1:2], torch.zeros_like(counts), counts
    )
    bits = b0 ^ b1
    # 23 random mantissa bits under exponent 0: a float in [1, 2), minus 1
    float_bits = (bits >> 9) | 0x3F800000
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    # a Python scalar, not a tensor made from one: that would be a host copy
    # on a card, which a captured decode step cannot hold (float32 1 - tiny
    # rounds to 1, as the reference's does)
    tiny = torch.finfo(torch.float32).tiny
    u = (floats + tiny).clamp_min(tiny)
    return -torch.log(-torch.log(u))
