"""Vision encoder (ViT) and LLaVA-style projector in PyTorch (counterpart of
dynamo_tpu/models/vision.py).

The encode side of multimodal serving (``examples/multimodal`` of this
package): images, or video frames on the batch axis, become patch
embeddings in the language model's hidden space, which the engine splices
ahead of the text (``generate_multimodal``).

- patchify is a reshape, and the patch embedding one matmul (the
  convolution as a product);
- layer weights are stacked on a leading axis, as the reference's are for
  its ``lax.scan``; a Python loop over the layers takes the scan's place;
- pre-LN blocks, LayerNorm and the softmax in float32, the attention the
  reference's float32 einsum form (it runs outside any Pallas kernel, so
  it stays plain PyTorch here), GELU in its tanh form (``jax.nn.gelu``'s
  default);
- a 2-layer GELU projector into the language model's hidden size.

The reference's parameter tree converts with ``params_from_jax``
(re-exported here): same names, same layouts.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models.llama import param_init
from dynamo_tpu_torch.models.llama import params_from_jax  # noqa: F401 — re-exported
from dynamo_tpu_torch.ops.norms import layer_norm


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    projector_dim: int = 4096       # the language model's hidden size
    layer_norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def from_hf_config(
        cls, config: dict | str | Path, *, llm_hidden_size: int | None = None
    ) -> "VisionConfig":
        """A LLaVA-style multimodal config (``vision_config`` and
        ``text_config``) or a bare CLIP/SigLIP vision config.
        ``projector_dim`` is the language model's hidden size (from
        ``text_config.hidden_size``, not CLIP's contrastive
        ``projection_dim``); pass ``llm_hidden_size`` with a bare vision
        config."""
        if not isinstance(config, dict):
            config = json.loads(Path(config).read_text())
        vision = config.get("vision_config", config)
        if llm_hidden_size is None:
            text = config.get("text_config")
            if isinstance(text, dict) and "hidden_size" in text:
                llm_hidden_size = text["hidden_size"]
            elif "vision_config" in config and "hidden_size" in config:
                # the older LLaVA layout: the top level is the text config
                llm_hidden_size = config["hidden_size"]
            else:
                llm_hidden_size = 4096
        return cls(
            image_size=vision.get("image_size", 336),
            patch_size=vision.get("patch_size", 14),
            hidden_size=vision.get("hidden_size", 1024),
            num_layers=vision.get("num_hidden_layers", 24),
            num_heads=vision.get("num_attention_heads", 16),
            mlp_dim=vision.get("intermediate_size", 4096),
            projector_dim=llm_hidden_size,
        )

    @classmethod
    def tiny(cls) -> "VisionConfig":
        """Test geometry (the reference's ``tiny``)."""
        return cls(
            image_size=16, patch_size=8, hidden_size=32, num_layers=2,
            num_heads=2, mlp_dim=64, projector_dim=64, dtype=torch.float32,
        )


def init_vit_params(cfg: VisionConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random-init ViT and projector parameters on ``device`` from
    ``generator`` (on the same device), the reference's layout:
    N(0, 1) / sqrt(fan_in) weights, unit LayerNorm scales, zero biases."""
    h, m, n = cfg.hidden_size, cfg.mlp_dim, cfg.num_layers
    p = cfg.projector_dim
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    normal, ones = param_init(cfg.dtype, generator, device)

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    return {
        "patch_proj": normal((patch_dim, h), patch_dim),
        "pos_embed": normal((cfg.num_patches, h), h),
        "layers": {
            "ln1_w": ones((n, h)),
            "ln1_b": zeros((n, h)),
            "wq": normal((n, h, h), h),
            "wk": normal((n, h, h), h),
            "wv": normal((n, h, h), h),
            "wo": normal((n, h, h), h),
            "ln2_w": ones((n, h)),
            "ln2_b": zeros((n, h)),
            "w1": normal((n, h, m), h),
            "b1": zeros((n, m)),
            "w2": normal((n, m, h), m),
            "b2": zeros((n, h)),
        },
        "final_ln_w": ones((h,)),
        "final_ln_b": zeros((h,)),
        "proj_w1": normal((h, p), h),
        "proj_b1": zeros((p,)),
        "proj_w2": normal((p, p), p),
        "proj_b2": zeros((p,)),
    }


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, num_patches, patch * patch * 3] (a reshape)."""
    b, hgt, wid, c = images.shape
    gh, gw = hgt // patch, wid // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation, not torch's exact erf
    return F.gelu(x, approximate="tanh")


def vit_encode(params: dict, cfg: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] images -> [B, num_patches, projector_dim] float32
    embeddings."""
    b = images.shape[0]
    x = patchify(images.to(cfg.dtype), cfg.patch_size) @ params["patch_proj"]
    x = x + params["pos_embed"]
    # the reference's 1 / sqrt(float32(head_dim)), rounded to float32
    scale = float(torch.tensor(1.0 / math.sqrt(cfg.head_dim), dtype=torch.float32))
    layers = params["layers"]
    for i in range(layers["wq"].shape[0]):
        w = {name: leaf[i] for name, leaf in layers.items()}
        attn_in = layer_norm(x, w["ln1_w"], w["ln1_b"], cfg.layer_norm_eps)
        q = (attn_in @ w["wq"]).reshape(b, -1, cfg.num_heads, cfg.head_dim)
        k = (attn_in @ w["wk"]).reshape(b, -1, cfg.num_heads, cfg.head_dim)
        v = (attn_in @ w["wv"]).reshape(b, -1, cfg.num_heads, cfg.head_dim)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        weights = torch.softmax(logits * scale, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
        x = x + attn.reshape(b, -1, cfg.hidden_size).to(cfg.dtype) @ w["wo"]
        mlp_in = layer_norm(x, w["ln2_w"], w["ln2_b"], cfg.layer_norm_eps)
        x = x + _gelu(mlp_in @ w["w1"] + w["b1"]) @ w["w2"] + w["b2"]
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], cfg.layer_norm_eps)
    # the LLaVA-style 2-layer GELU projector into the language model's space
    x = _gelu(x @ params["proj_w1"] + params["proj_b1"])
    x = x @ params["proj_w2"] + params["proj_b2"]
    return x.float()


def vit_encode_video(params: dict, cfg: VisionConfig, frames: torch.Tensor, *,
                     temporal_pool: int = 2) -> torch.Tensor:
    """[T, H, W, 3] frames -> [ceil(T / pool) * num_patches, projector_dim]
    float32: every frame through the same ViT and projector on the batch
    axis, then each group of ``temporal_pool`` consecutive frames
    mean-pooled per patch position (a short last group padded by repeating
    the last frame)."""
    if temporal_pool < 1:
        raise ValueError(f"temporal_pool must be >= 1, got {temporal_pool}")
    t = frames.shape[0]
    per_frame = vit_encode(params, cfg, frames)  # [T, P, D]
    if temporal_pool > 1:
        pad = (-t) % temporal_pool
        if pad:
            per_frame = torch.cat([per_frame, per_frame[-1:].expand(pad, -1, -1)], dim=0)
        groups = per_frame.reshape(-1, temporal_pool, cfg.num_patches, cfg.projector_dim)
        per_frame = groups.mean(dim=1)
    return per_frame.reshape(-1, cfg.projector_dim)
