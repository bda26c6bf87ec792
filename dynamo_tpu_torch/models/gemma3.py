"""Gemma-3 text in PyTorch (counterpart of dynamo_tpu/models/gemma3.py).

The Gemma-2 machinery (``models/gemma2.py``: sandwich norms, GeGLU,
sqrt(hidden) embedding scale, (1 + w) RMSNorm, a window per layer, the
query scale, plain attention on every device, no unified forward) with
Gemma-3's changes:
- a 5:1 local/global pattern: five sliding-window layers, then one of full
  attention (HF ``layer_types``);
- two rope bases: local layers rotate with ``rope_local_base_freq`` (10k),
  global layers with ``rope_theta`` (1M, stretched by ``rope_scaling``
  where a checkpoint has it).  The engine holds one (cos, sin) pair, so
  the two tables are packed on the feature axis, [max_len, head_dim] =
  local half ++ global half, and each layer takes its half
  (``_rope_halves``);
- per-head (1 + w) q/k RMSNorm in place of Gemma-2's soft-capping (no
  attention or final capping).

A multimodal Gemma-3 config (``model_type: gemma3`` with a ``text_config``)
parses its text config; image input goes through the embeddings prefill
(``gemma3_forward_prefill_embeds``), the vision encoder's patch
embeddings spliced before the text's.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch

from dynamo_tpu_torch.models import gemma2
from dynamo_tpu_torch.models.llama import params_from_jax  # noqa: F401 — re-exported
from dynamo_tpu_torch.ops.norms import rms_norm
from dynamo_tpu_torch.ops.rope import apply_rope, rope_table
from dynamo_tpu_torch.parallel.mesh import shard_config


@dataclass(frozen=True)
class Gemma3Config:
    vocab_size: int = 262208
    hidden_size: int = 2560
    intermediate_size: int = 10240
    num_layers: int = 34
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 256
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6             # global layers
    rope_local_theta: float = 10000.0   # sliding layers
    rope_scaling: Any = None            # the GLOBAL table's only
    # the class default; gemma-3-4b's published config has 1024 (and a
    # linear x8 global rope scaling), which from_hf_config reads
    sliding_window: int = 4096
    query_pre_attn_scalar: float = 256.0
    # per layer, True = full attention (HF layer_types); empty = every
    # sixth layer global (__post_init__), whatever the config's
    # sliding_window_pattern says (the reference's fallback, copied as it is)
    global_layers: tuple = field(default=())
    tie_word_embeddings: bool = True
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if not self.global_layers:
            object.__setattr__(self, "global_layers",
                               tuple((i + 1) % 6 == 0 for i in range(self.num_layers)))
        if len(self.global_layers) != self.num_layers:
            raise ValueError(f"global_layers has {len(self.global_layers)} entries for "
                             f"{self.num_layers} layers")

    @property
    def embed_scale(self) -> float:
        return float(self.hidden_size) ** 0.5

    def layer_windows(self) -> tuple[int, ...]:
        """Each layer's attention window: 0 (full) on global layers, the
        sliding window elsewhere."""
        return tuple(0 if g else self.sliding_window for g in self.global_layers)

    @classmethod
    def from_hf_config(cls, config: dict | str | Path) -> "Gemma3Config":
        if not isinstance(config, dict):
            config = json.loads(Path(config).read_text())
        if "text_config" in config:  # the multimodal wrapper (model_type gemma3)
            config = config["text_config"]
        heads = config.get("num_attention_heads", 8)
        layer_types = config.get("layer_types")
        global_layers = (tuple(t == "full_attention" for t in layer_types)
                         if layer_types else ())
        return cls(
            vocab_size=config["vocab_size"],
            hidden_size=config["hidden_size"],
            intermediate_size=config["intermediate_size"],
            num_layers=config["num_hidden_layers"],
            num_heads=heads,
            num_kv_heads=config.get("num_key_value_heads", heads),
            head_dim=config.get("head_dim") or config["hidden_size"] // heads,
            max_position_embeddings=config.get("max_position_embeddings", 131072),
            rms_norm_eps=config.get("rms_norm_eps", 1e-6),
            rope_theta=config.get("rope_theta", 1e6),
            rope_local_theta=config.get("rope_local_base_freq", 10000.0),
            rope_scaling=config.get("rope_scaling"),
            sliding_window=config.get("sliding_window", 4096),
            query_pre_attn_scalar=float(
                config.get("query_pre_attn_scalar") or config["hidden_size"] // heads
            ),
            global_layers=global_layers,
        )

    @classmethod
    def tiny(cls) -> "Gemma3Config":
        """Test geometry: 7 layers, so the 5:1 pattern holds one global layer
        (index 5) and local layers on both sides of it."""
        return cls(
            vocab_size=480, hidden_size=64, intermediate_size=128,
            num_layers=7, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position_embeddings=128, sliding_window=8,
            query_pre_attn_scalar=16.0,
        )


def init_params(cfg: Gemma3Config, generator: torch.Generator, device="cuda",
                shard=None) -> dict:
    """Gemma-2's parameters (``gemma2.init_params``) and the per-head q/k
    norms [L, head_dim]; ``shard`` as there."""
    params = gemma2.init_params(cfg, generator, device, shard=shard)
    for name in ("q_norm", "k_norm"):
        leaf = torch.ones((cfg.num_layers, cfg.head_dim), dtype=cfg.dtype, device=device)
        params["layers"][name] = leaf if shard is None else shard(("layers", name), leaf)
    return params


# the reference's (dynamo_tpu/models/gemma3.py:180): Gemma-2's, with the
# per-head q/k norms on the layer axis
param_specs = gemma2.param_specs
shard_params = gemma2.shard_params


def make_rope_tables(cfg: Gemma3Config, device="cuda", max_len: int | None = None):
    """Both bases packed on the feature axis: [max_len, head_dim] = the local
    table's half ++ the global table's half (each [max_len, head_dim // 2]);
    the layers take theirs (``_rope_halves``)."""
    n = max_len or cfg.max_position_embeddings
    cos_l, sin_l = rope_table(n, cfg.head_dim, cfg.rope_local_theta, device=device)
    cos_g, sin_g = rope_table(n, cfg.head_dim, cfg.rope_theta, scaling=cfg.rope_scaling,
                              device=device)
    return torch.cat([cos_l, cos_g], dim=-1), torch.cat([sin_l, sin_g], dim=-1)


def _rope_halves(cos, sin, is_global: bool):
    """A layer's (cos, sin) from the packed tables."""
    half = cos.shape[-1] // 2
    part = slice(half, None) if is_global else slice(0, half)
    return cos[..., part], sin[..., part]


def _roped(cfg: Gemma3Config, cos, sin, mesh=None):
    """Layer g's (by its index in the model) roped q, k and v: the per-head
    (1 + w) q/k norms, then the rope table of the layer's kind."""
    cfg = shard_config(cfg, mesh)

    def qkv(x, w, g, positions):
        attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
        q, k, v = gemma2._qkv(attn_in, w, cfg)
        q = rms_norm(q, w["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, w["k_norm"], cfg.rms_norm_eps)
        c, s = _rope_halves(cos, sin, cfg.global_layers[g])
        return apply_rope(q, positions, c, s), apply_rope(k, positions, c, s), v

    return qkv


def gemma3_forward_prefill(params, cfg: Gemma3Config, token_ids, kv_cache, block_ids,
                           seq_len, start_pos, cos, sin, *, mesh=None):
    """Single-sequence prefill (the split prefill step): (the last valid
    token's logits [vocab] f32, cache), the cache written in place;
    ``mesh`` as Gemma-2's."""
    return gemma2.prefill(params, cfg, _roped(cfg, cos, sin, mesh), token_ids, kv_cache,
                          block_ids, seq_len, start_pos, cos, mesh)


def gemma3_forward_prefill_embeds(params, cfg: Gemma3Config, input_embeds, kv_cache,
                                  block_ids, seq_len, start_pos, cos, sin, *, mesh=None):
    """Prefill from precomputed input embeddings [seq_pad, hidden] (the
    contract of ``llama_forward_prefill_embeds``, ``mesh`` included; the
    text rows come through the family's ``embed`` hook, which applies the
    sqrt(hidden) scale)."""
    return gemma2.prefill_embeds(params, cfg, _roped(cfg, cos, sin, mesh), input_embeds,
                                 kv_cache, block_ids, seq_len, start_pos, cos, mesh)


def gemma3_forward_prefill_with_prefix(params, cfg: Gemma3Config, token_ids, kv_cache,
                                       full_block_ids, tail_block_ids, tail_len, start_pos,
                                       cos, sin, *, mesh=None):
    return gemma2.prefill_with_prefix(params, cfg, _roped(cfg, cos, sin, mesh), token_ids,
                                      kv_cache, full_block_ids, tail_block_ids, tail_len,
                                      start_pos, cos, mesh)


def gemma3_forward_decode(params, cfg: Gemma3Config, token_ids, kv_cache, block_tables,
                          context_lens, slot_ids, cos, sin, *, mesh=None):
    """Batched decode: (logits [batch, vocab] f32, cache)."""
    return gemma2.decode(params, cfg, _roped(cfg, cos, sin, mesh), token_ids, kv_cache,
                         block_tables, context_lens, slot_ids, mesh)


def gemma3_forward_verify(params, cfg: Gemma3Config, token_ids, kv_cache, block_tables,
                          context_lens, slot_ids, cos, sin, *, mesh=None):
    """Speculative verification: (logits [batch, w, vocab] f32, cache)."""
    return gemma2.verify(params, cfg, _roped(cfg, cos, sin, mesh), token_ids, kv_cache,
                         block_tables, context_lens, slot_ids, cos, mesh)


# ---------------------------------------------------------------------------
# HF weight loading
# ---------------------------------------------------------------------------

_HF_LAYER_MAP = {
    **gemma2._HF_LAYER_MAP,
    "q_norm": "model.layers.{i}.self_attn.q_norm.weight",
    "k_norm": "model.layers.{i}.self_attn.k_norm.weight",
}
_NORM_LEAVES = (*gemma2.NORM_LEAVES, "q_norm", "k_norm")


def load_hf_weights(cfg: Gemma3Config, model_dir: str | Path, device="cuda") -> dict:
    """Gemma-3 text safetensors on ``device``, the (1 + w) of every RMSNorm
    (the per-head q/k norms included) baked in.  A multimodal checkpoint's
    text half is read from under its ``language_model`` prefix and its
    vision tower left out; an untied ``lm_head`` is refused under any of
    its names, before anything is read."""
    from dynamo_tpu_torch.models.hf_io import read_safetensors

    tensors = read_safetensors(model_dir)
    for head in ("lm_head.weight", "language_model.lm_head.weight",
                 "model.language_model.lm_head.weight"):
        if head in tensors:
            raise ValueError(
                f"gemma3 checkpoint ships {head} (untied unembedding); "
                "this family implements the tied projection only"
            )
    if "model.embed_tokens.weight" not in tensors:
        # Gemma3ForConditionalGeneration: language_model.model.* (the
        # save_pretrained legacy names) or model.language_model.*
        for prefix in ("language_model.model.", "model.language_model."):
            if prefix + "embed_tokens.weight" in tensors:
                tensors = {"model." + name[len(prefix):]: t for name, t in tensors.items()
                           if name.startswith(prefix)}
                break
    return gemma2.load_layers(cfg, tensors, _HF_LAYER_MAP, _NORM_LEAVES, device)
