"""Rotary position embeddings (counterpart of dynamo_tpu/ops/rope.py).

Split-half convention (llama-family): rotate pairs (x[..., :d/2], x[..., d/2:]).
Tables are precomputed once per model in float32 and indexed by absolute
position.
"""

from __future__ import annotations

import math

import torch


def _llama3_scale_freqs(freqs: torch.Tensor, scaling: dict) -> torch.Tensor:
    """Llama-3.1 frequency-dependent scaling: long wavelengths divide by
    ``factor``, short ones stay, a smooth ramp interpolates between."""
    factor = float(scaling.get("factor", 8.0))
    low = float(scaling.get("low_freq_factor", 1.0))
    high = float(scaling.get("high_freq_factor", 4.0))
    orig = float(scaling.get("original_max_position_embeddings", 8192))

    wavelen = 2.0 * math.pi / freqs
    low_wavelen = orig / low
    high_wavelen = orig / high
    smooth = (orig / wavelen - low) / (high - low)
    interp = (1.0 - smooth) * (freqs / factor) + smooth * freqs
    out = torch.where(wavelen > low_wavelen, freqs / factor, freqs)
    mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return torch.where(mid, interp, out)


def _yarn_scale_freqs(freqs: torch.Tensor, half: int, theta: float, scaling: dict) -> torch.Tensor:
    """YaRN NTK-by-parts interpolation: high-frequency dims keep, low-frequency
    dims divide by ``factor``, with a linear ramp between ``beta_fast`` and
    ``beta_slow`` rotations."""
    factor = float(scaling.get("factor", 1.0))
    orig = float(scaling.get("original_max_position_embeddings", 4096))
    beta_fast = float(scaling.get("beta_fast", 32.0))
    beta_slow = float(scaling.get("beta_slow", 1.0))

    def dim_for_rotations(rot: float) -> float:
        return (2 * half) * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(dim_for_rotations(beta_fast)), 0)
    high = min(math.ceil(dim_for_rotations(beta_slow)), half - 1)
    ramp = torch.clamp(
        (torch.arange(half, dtype=torch.float32) - low) / max(high - low, 1e-3), 0.0, 1.0
    )
    return (freqs / factor) * ramp + freqs * (1.0 - ramp)


def yarn_mscale(scaling: dict | None) -> float:
    """YaRN attention-temperature correction: DeepSeek multiplies its
    softmax scale by ``mscale**2``, with ``mscale = 0.1 * mscale_all_dim *
    ln(factor) + 1`` (1 without yarn, a factor <= 1 or no
    ``mscale_all_dim``)."""
    if not scaling or scaling.get("rope_type", scaling.get("type")) != "yarn":
        return 1.0
    factor = float(scaling.get("factor", 1.0))
    m_all = float(scaling.get("mscale_all_dim", 0.0) or 0.0)
    if factor <= 1.0 or not m_all:
        return 1.0
    return 0.1 * m_all * math.log(factor) + 1.0


def rope_table(
    max_len: int, head_dim: int, theta: float = 10000.0,
    scaling: dict | None = None,
    *,
    yarn_apply_attention_factor: bool = True,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables, shape [max_len, head_dim//2], float32.

    ``scaling`` is an HF ``rope_scaling`` dict: type "linear", "llama3" or
    "yarn".  For yarn the llama-family convention bakes HF's attention
    factor into both tables; DeepSeek puts the temperature on its softmax
    scale instead (``yarn_mscale``) and passes
    ``yarn_apply_attention_factor=False``.  The tables are computed on the
    CPU and moved to ``device``."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32) / half))
    attn_factor = 1.0
    if scaling:
        kind = scaling.get("rope_type", scaling.get("type", ""))
        if kind == "linear":
            freqs = freqs / float(scaling.get("factor", 1.0))
        elif kind == "llama3":
            freqs = _llama3_scale_freqs(freqs, scaling)
        elif kind == "yarn":
            freqs = _yarn_scale_freqs(freqs, half, theta, scaling)
            if yarn_apply_attention_factor:
                factor = float(scaling.get("factor", 1.0))
                attn_factor = float(
                    scaling.get("attention_factor")
                    or (0.1 * math.log(factor) + 1.0 if factor > 1.0 else 1.0)
                )
        elif kind:
            raise NotImplementedError(f"rope_scaling type {kind!r}")
    angles = torch.arange(max_len, dtype=torch.float32)[:, None] * freqs[None, :]
    cos, sin = torch.cos(angles) * attn_factor, torch.sin(angles) * attn_factor
    return cos.to(device), sin.to(device)


def apply_rope(
    x: torch.Tensor,          # [..., seq, heads, head_dim]
    positions: torch.Tensor,  # [..., seq] int
    cos_table: torch.Tensor,  # [max_len, head_dim//2]
    sin_table: torch.Tensor,
) -> torch.Tensor:
    cos = cos_table[positions].unsqueeze(-2)  # [..., seq, 1, half]
    sin = sin_table[positions].unsqueeze(-2)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def table_positions(positions: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Positions as rows of a rope table: the reference's gather clamps an
    index past the table to its last row (pad tokens of a prefill bucket,
    verify positions past the engine's last), where a torch index raises."""
    return positions.clamp(0, table.shape[0] - 1)
