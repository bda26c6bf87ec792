"""Normalization ops (counterpart of dynamo_tpu/ops/norms.py)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with float32 accumulation, cast back to the input dtype
    (llama-family numerics: normalize in fp32 even for bf16 activations)."""
    x32 = x.float()
    variance = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = x32 / torch.sqrt(variance + eps)
    return (normed * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with float32 accumulation, cast back to the input dtype
    (ViT-family numerics).  The variance is the biased one, as ``jnp.var``
    computes it."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    normed = (x32 - mean) / torch.sqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)
