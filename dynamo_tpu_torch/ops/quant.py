"""Weight-only int8 quantization for serving (counterpart of
dynamo_tpu/ops/quant.py).

- ``QuantizedMatrix`` pairs int8 values with a symmetric per-output-channel
  float32 scale.  The scale keeps the matrix's rank (size 1 on the
  contraction axis, the second-to-last), so a layer-stacked ``[L, in, out]``
  or expert-bank ``[L, E, in, out]`` weight quantizes per (layer[, expert],
  out-channel) and a leading index (``w[i]``, the layer loop) slices both
  leaves.
- ``mm(x, w)`` / ``qeinsum(spec, x, w)``: products that take a plain tensor
  or a ``QuantizedMatrix``; the model forwards call them instead of ``@``.
- ``quantize_specs``: a parameter spec tree's twin for quantized leaves (the
  values shard as their leaf, the scale keeps its contraction axis whole),
  so a tensor-parallel rank quantizes nothing itself: it slices the full
  matrix's int8 values and scales (``parallel/mesh.py``).

The arithmetic order is the reference's, so the port and the JAX engine
serve byte-identical streams from the same int8 weights: ``amax / 127``,
round half to even, clip at +-127; the product of ``x`` with the int8
values converted to ``x``'s dtype, then the scale (converted to ``x``'s
dtype) multiplying the result.  The conversion is a dequantized operand
the size of the matrix, made at use and freed after it (the reference
leaves these products to XLA outside any Pallas kernel; a product that
reads the int8 weight once and dequantizes in registers is a kernel of a
later slice).
"""

from __future__ import annotations

import torch


class QuantizedMatrix:
    """Symmetric weight-only int8 matrix: ``w ~= q.to(f) * s``.

    ``q``: int8, the original weight's shape.  ``s``: float32, the same
    rank, size 1 on the contraction (second-to-last) axis."""

    __slots__ = ("q", "s")

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        self.q = q
        self.s = s

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def dtype(self) -> torch.dtype:  # the reported dtype is the scale's
        return self.s.dtype

    def __getitem__(self, index) -> "QuantizedMatrix":
        """A leading index or slice (a layer, or a layer and an expert) of
        both leaves."""
        return QuantizedMatrix(self.q[index], self.s[index])

    def to(self, device) -> "QuantizedMatrix":
        return QuantizedMatrix(self.q.to(device), self.s.to(device))


def quantize_matrix(w: torch.Tensor) -> QuantizedMatrix:
    """Per-output-channel symmetric int8: the scale over the contraction
    axis (second-to-last), kept as a size-1 axis so it broadcasts in ``mm``.
    A stacked weight is quantized one leading index at a time (each
    channel's scale is its own), which bounds the float32 temporaries to
    one matrix."""
    if w.dim() > 2:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty((*w.shape[:-2], 1, w.shape[-1]), dtype=torch.float32, device=w.device)
        for i in range(w.shape[0]):
            part = quantize_matrix(w[i])
            q[i], s[i] = part.q, part.s
        return QuantizedMatrix(q, s)
    axis = w.dim() - 2
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return QuantizedMatrix(q, s)


def dequantize_matrix(w: QuantizedMatrix, dtype=torch.bfloat16) -> torch.Tensor:
    return (w.q.float() * w.s.float()).to(dtype)


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain or quantized ``w``: the int8 values converted
    to ``x``'s dtype on the product's operand, the per-channel scale on the
    ``[..., out]`` result."""
    if isinstance(w, QuantizedMatrix):
        out = x @ w.q.to(x.dtype)
        return out * w.s.squeeze(w.s.dim() - 2).to(x.dtype)
    return x @ w


def qeinsum(subscripts: str, x: torch.Tensor, w) -> torch.Tensor:
    """Two-operand einsum whose second operand may be quantized (the MoE
    expert banks ``ech,ehi->eci``).  The weight's contraction axis is its
    second-to-last, so the size-1 scale broadcasts against the result."""
    if isinstance(w, QuantizedMatrix):
        return torch.einsum(subscripts, x, w.q.to(x.dtype)) * w.s.to(x.dtype)
    return torch.einsum(subscripts, x, w)


def quantize_params(params: dict, leaf_names: tuple[str, ...]) -> dict:
    """The parameter tree with every leaf named in ``leaf_names`` (a dict
    key anywhere in the tree) replaced by its ``QuantizedMatrix``."""

    def walk(node):
        if isinstance(node, dict):
            return {
                k: quantize_matrix(v) if k in leaf_names and not isinstance(v, dict) else walk(v)
                for k, v in node.items()
            }
        return node

    return walk(params)


def scale_spec(spec: tuple) -> tuple:
    """The scale's sharding of a matrix sharded by ``spec``: the matrix's,
    but for the contraction axis (second-to-last), where the scale's extent
    is 1 and cannot be split (a row-parallel ``wo`` shards that axis over
    tp: each rank keeps the whole per-channel scale)."""
    entries = list(spec)
    if len(entries) >= 2:
        entries[-2] = None
    return tuple(entries)


def quantize_specs(specs: dict, leaf_names: tuple[str, ...]) -> dict:
    """The spec-tree twin of ``quantize_params`` (the reference's
    ``quantize_specs``): a named leaf's spec becomes a ``QuantizedMatrix``
    of specs, the int8 values sharded as the full-precision leaf, the scale
    by ``scale_spec``."""

    def walk(node):
        if isinstance(node, dict):
            return {
                k: QuantizedMatrix(v, scale_spec(v)) if k in leaf_names
                and not isinstance(v, dict) else walk(v)
                for k, v in node.items()
            }
        return node

    return walk(specs)


def is_quantized(params) -> bool:
    """True if the tree holds any ``QuantizedMatrix``."""
    if isinstance(params, QuantizedMatrix):
        return True
    if isinstance(params, dict):
        return any(is_quantized(v) for v in params.values())
    return False
