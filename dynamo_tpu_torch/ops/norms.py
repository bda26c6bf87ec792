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
