"""Gemma-2 in PyTorch (counterpart of dynamo_tpu/models/gemma2.py; HF
``Gemma2ForCausalLM``).

What sets it apart from the llama geometry:
- alternating local and global attention: even layers attend through a
  sliding window, odd layers fully (``layer_windows``: one Python int a
  layer, 0 = full, so every forward stays a fixed sequence of launches that
  the engine captures as a CUDA graph);
- logit soft-capping, ``cap * tanh(x / cap)``, of the attention scores
  (``attn_logit_softcapping``, 50) and of the final logits
  (``final_logit_softcapping``, 30);
- sandwich norms: a norm before and after attention and before and after
  the MLP, the post-norm on the block's output before the residual add;
- the scores scaled by ``query_pre_attn_scalar ** -0.5``;
- Gemma-1's GeGLU MLP, sqrt(hidden) input-embedding scale and (1 + w)
  RMSNorm weights (baked in at load).

Attention is the plain PyTorch form of ``ops.attention`` on every device:
the reference's Pallas kernels have no per-layer window, soft-cap or query
scale, so its Gemma-2 attention runs in XLA, and no kernel stands behind
this one.  The family has no unified forward: the engine serves it on the
split prefill and decode steps.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch

from dynamo_tpu_torch.models.llama import (
    _embed,
    _layers,
    _mlp,
    param_init,
    params_from_jax,  # noqa: F401 — the reference's pytree as port parameters
    plus_one,
)
from dynamo_tpu_torch.ops.attention import (
    _apply_softcap,
    cache_rows,
    dense_causal_attention,
    gather_prefix_kv,
    last_valid_row,
    last_writer_rows,
    paged_decode_attention,
    paged_window_attention,
    prefill_attention_with_prefix,
    slot_rows,
    write_prefill_kv,
    write_rows,
)
from dynamo_tpu_torch.ops.norms import rms_norm
from dynamo_tpu_torch.ops.quant import mm
from dynamo_tpu_torch.ops.rope import apply_rope, rope_table, table_positions
from dynamo_tpu_torch.utils import profiling


@dataclass(frozen=True)
class Gemma2Config:
    vocab_size: int = 256000
    hidden_size: int = 2304
    intermediate_size: int = 9216
    num_layers: int = 26
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 256
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Any = None          # gemma-2 ships none; kept for rope_table
    sliding_window: int = 4096        # even-indexed layers only
    query_pre_attn_scalar: float = 256.0
    attn_logit_softcap: float = 50.0
    final_logit_softcap: float = 30.0
    tie_word_embeddings: bool = True  # in every released checkpoint
    dtype: Any = torch.bfloat16

    @property
    def embed_scale(self) -> float:
        return float(self.hidden_size) ** 0.5

    def layer_windows(self) -> tuple[int, ...]:
        """Each layer's attention window: the sliding window on even
        layers, 0 (full attention) on odd ones, whatever the config's
        ``layer_types`` say (the reference's pattern, copied as it is)."""
        return tuple(self.sliding_window if i % 2 == 0 else 0
                     for i in range(self.num_layers))

    @classmethod
    def from_hf_config(cls, config: dict | str | Path) -> "Gemma2Config":
        if not isinstance(config, dict):
            config = json.loads(Path(config).read_text())
        heads = config["num_attention_heads"]
        return cls(
            vocab_size=config["vocab_size"],
            hidden_size=config["hidden_size"],
            intermediate_size=config["intermediate_size"],
            num_layers=config["num_hidden_layers"],
            num_heads=heads,
            num_kv_heads=config.get("num_key_value_heads", heads),
            head_dim=config.get("head_dim") or config["hidden_size"] // heads,
            max_position_embeddings=config.get("max_position_embeddings", 8192),
            rms_norm_eps=config.get("rms_norm_eps", 1e-6),
            rope_theta=config.get("rope_theta", 10000.0),
            rope_scaling=config.get("rope_scaling"),
            sliding_window=config.get("sliding_window", 4096),
            query_pre_attn_scalar=float(
                config.get("query_pre_attn_scalar") or config["hidden_size"] // heads
            ),
            attn_logit_softcap=config.get("attn_logit_softcapping", 50.0),
            final_logit_softcap=config.get("final_logit_softcapping", 30.0),
        )

    @classmethod
    def tiny(cls) -> "Gemma2Config":
        """Test geometry: 4 layers, so both attention patterns appear twice."""
        return cls(
            vocab_size=480, hidden_size=64, intermediate_size=128,
            num_layers=4, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position_embeddings=128, sliding_window=8,
            query_pre_attn_scalar=16.0,
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

# the norms of a layer: before and after attention, before and after the MLP
NORM_LEAVES = ("attn_norm", "post_attn_norm", "mlp_norm", "post_mlp_norm")


def init_params(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Random-init parameters on ``device`` from ``generator`` (on the same
    device), the reference's names and layouts."""
    h, i, n_layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    normal, ones = param_init(cfg.dtype, generator, device)
    layers = {name: ones((n_layers, h)) for name in NORM_LEAVES}
    layers.update(
        wq=normal((n_layers, h, qd), h),
        wk=normal((n_layers, h, kvd), h),
        wv=normal((n_layers, h, kvd), h),
        wo=normal((n_layers, qd, h), qd),
        w_gate=normal((n_layers, h, i), h),
        w_up=normal((n_layers, h, i), h),
        w_down=normal((n_layers, i, h), i),
    )
    return {"embed": normal((cfg.vocab_size, h), 1.0), "final_norm": ones((h,)),
            "layers": layers}


def make_rope_tables(cfg: Gemma2Config, device="cuda", max_len: int | None = None):
    return rope_table(
        max_len or cfg.max_position_embeddings, cfg.head_dim, cfg.rope_theta,
        scaling=cfg.rope_scaling, device=device,
    )


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _qkv(attn_in, w, cfg: Gemma2Config):
    s = attn_in.shape[0]
    q = mm(attn_in, w["wq"]).view(s, cfg.num_heads, cfg.head_dim)
    k = mm(attn_in, w["wk"]).view(s, cfg.num_kv_heads, cfg.head_dim)
    v = mm(attn_in, w["wv"]).view(s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _final_logits(params, cfg, x) -> torch.Tensor:
    """Logits [.., vocab] f32 through the tied embedding, soft-capped where
    the config caps them (Gemma-2; HF semantics: a null or 0 cap, and
    Gemma-3's none, is no capping)."""
    logits = (x @ params["embed"].to(x.dtype).T).float()
    cap = getattr(cfg, "final_logit_softcap", None)
    return _apply_softcap(logits, cap) if cap else logits


def attn_kwargs(cfg, window: int) -> dict:
    """The plain attention's arguments of a layer whose window is
    ``window`` (0 = full attention): the window, Gemma-2's attention
    soft-cap (none where the config has none, as Gemma-3's) and the query
    scale."""
    return {
        "sliding_window": window or None,
        # HF semantics: a null or 0 cap is no capping
        "logit_softcap": getattr(cfg, "attn_logit_softcap", None) or None,
        "query_scale": float(cfg.query_pre_attn_scalar) ** -0.5,
    }


def sandwich(x, w, cfg, attn):
    """The layer's tail: the attention output ``attn`` [t, H*D] through
    ``wo`` and its post-norm into the residual, then the GeGLU MLP between
    its two norms."""
    eps = cfg.rms_norm_eps
    x = x + rms_norm(mm(attn, w["wo"]), w["post_attn_norm"], eps)
    mlp = _mlp(rms_norm(x, w["mlp_norm"], eps), w["w_gate"], w["w_up"], w["w_down"],
               "gelu_tanh")
    return x + rms_norm(mlp, w["post_mlp_norm"], eps)


def _layer_inputs(cfg, params):
    """(layer index, weights, window) of every layer."""
    for (i, w), window in zip(_layers(params), cfg.layer_windows()):
        yield i, w, window


def prefill(params, cfg, qkv, token_ids, kv_cache, block_ids, seq_len, start_pos, cos):
    """The split prefill step of the Gemma families: the llama contract
    (``llama_forward_prefill``), each layer masked by its own window.
    ``qkv(x, w, i, positions)`` gives layer i's roped q, k and v; ``cos``,
    the rope table, bounds the positions."""
    return prefill_embeds(params, cfg, qkv, _embed(params, cfg, token_ids), kv_cache,
                          block_ids, seq_len, start_pos, cos)


def prefill_embeds(params, cfg, qkv, input_embeds, kv_cache, block_ids, seq_len, start_pos,
                   cos):
    """``prefill`` from precomputed input embeddings [seq_pad, hidden] (a
    multimodal prompt: the family's ``embed`` hook applies the sqrt(hidden)
    scale to the text rows before the splice)."""
    s = input_embeds.shape[0]
    x = input_embeds.to(cfg.dtype)
    positions = table_positions(start_pos + torch.arange(s, device=x.device), cos)
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    lens = torch.as_tensor(seq_len, device=x.device).reshape(1)
    for i, w, window in _layer_inputs(cfg, params):
        q, k, v = qkv(x, w, i, positions)
        write_prefill_kv(k_all[i], v_all[i], k, v, block_ids, seq_len)
        with profiling.annotate("split_prefill_attention"):
            attn = dense_causal_attention(q[None], k[None], v[None], lens,
                                          **attn_kwargs(cfg, window))[0]
        x = sandwich(x, w, cfg, attn.reshape(s, -1))
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _final_logits(params, cfg, last_valid_row(x, seq_len))[0], kv_cache


def prefill_with_prefix(params, cfg, qkv, token_ids, kv_cache, full_block_ids,
                        tail_block_ids, tail_len, start_pos, cos):
    """Continued prefill over a resident prefix (the llama contract), each
    layer masked by its own window."""
    s = token_ids.shape[0]
    x = _embed(params, cfg, token_ids)
    positions = table_positions(start_pos + torch.arange(s, device=x.device), cos)
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    for i, w, window in _layer_inputs(cfg, params):
        q, k, v = qkv(x, w, i, positions)
        # read the resident prefix BEFORE the tail is written
        k_prefix, v_prefix = gather_prefix_kv(k_all[i], v_all[i], full_block_ids)
        write_prefill_kv(k_all[i], v_all[i], k, v, tail_block_ids, tail_len)
        with profiling.annotate("split_prefill_attention"):
            attn = prefill_attention_with_prefix(q, k, v, k_prefix, v_prefix, start_pos,
                                                 tail_len, **attn_kwargs(cfg, window))
        x = sandwich(x, w, cfg, attn.reshape(s, -1))
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _final_logits(params, cfg, last_valid_row(x, tail_len))[0], kv_cache


def decode(params, cfg, qkv, token_ids, kv_cache, block_tables, context_lens, slot_ids):
    """Batched single-token decode (the llama contract), plain attention
    with each layer's window, soft-cap and query scale."""
    b = token_ids.shape[0]
    x = _embed(params, cfg, token_ids)
    positions = (context_lens - 1).clamp(min=0)
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    k_rows, v_rows = cache_rows(k_all), cache_rows(v_all)
    rows = slot_rows(slot_ids, k_all)  # idle lanes write the dump row
    for i, w, window in _layer_inputs(cfg, params):
        q, k, v = qkv(x, w, i, positions)
        write_rows(k_rows, v_rows, rows[i], k, v)
        attn = paged_decode_attention(q, k_all[i], v_all[i], block_tables, context_lens,
                                      **attn_kwargs(cfg, window))
        x = sandwich(x, w, cfg, attn.reshape(b, -1))
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _final_logits(params, cfg, x), kv_cache


def verify(params, cfg, qkv, token_ids, kv_cache, block_tables, context_lens, slot_ids,
           cos):
    """Speculative verification (the llama contract): all w window
    positions in one pass, batch-major, each layer's window masking its
    queries.  Logits [batch, w, vocab] f32."""
    b, w_len = token_ids.shape
    x = _embed(params, cfg, token_ids.reshape(-1))  # [b*w, hidden], batch-major
    positions = table_positions(
        context_lens[:, None] - w_len + torch.arange(w_len, device=x.device)[None, :], cos
    ).reshape(-1)
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    k_rows, v_rows = cache_rows(k_all), cache_rows(v_all)
    rows = last_writer_rows(slot_ids.reshape(-1), k_all)
    for i, w, window in _layer_inputs(cfg, params):
        q, k, v = qkv(x, w, i, positions)
        write_rows(k_rows, v_rows, rows[i], k, v)
        attn = paged_window_attention(
            q.view(b, w_len, cfg.num_heads, cfg.head_dim), k_all[i], v_all[i], block_tables,
            context_lens, **attn_kwargs(cfg, window))
        x = sandwich(x, w, cfg, attn.reshape(b * w_len, -1))
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _final_logits(params, cfg, x).view(b, w_len, -1), kv_cache


def _roped(cfg: Gemma2Config, cos, sin):
    def qkv(x, w, i, positions):
        q, k, v = _qkv(rms_norm(x, w["attn_norm"], cfg.rms_norm_eps), w, cfg)
        return apply_rope(q, positions, cos, sin), apply_rope(k, positions, cos, sin), v

    return qkv


def gemma2_forward_prefill(params, cfg: Gemma2Config, token_ids, kv_cache, block_ids,
                           seq_len, start_pos, cos, sin):
    """Single-sequence prefill: (the last valid token's logits [vocab] f32,
    cache), the cache written in place."""
    return prefill(params, cfg, _roped(cfg, cos, sin), token_ids, kv_cache, block_ids,
                   seq_len, start_pos, cos)


def gemma2_forward_prefill_with_prefix(params, cfg: Gemma2Config, token_ids, kv_cache,
                                       full_block_ids, tail_block_ids, tail_len, start_pos,
                                       cos, sin):
    return prefill_with_prefix(params, cfg, _roped(cfg, cos, sin), token_ids, kv_cache,
                               full_block_ids, tail_block_ids, tail_len, start_pos, cos)


def gemma2_forward_decode(params, cfg: Gemma2Config, token_ids, kv_cache, block_tables,
                          context_lens, slot_ids, cos, sin):
    """Batched decode: (logits [batch, vocab] f32, cache)."""
    return decode(params, cfg, _roped(cfg, cos, sin), token_ids, kv_cache, block_tables,
                  context_lens, slot_ids)


def gemma2_forward_verify(params, cfg: Gemma2Config, token_ids, kv_cache, block_tables,
                          context_lens, slot_ids, cos, sin):
    """Speculative verification: (logits [batch, w, vocab] f32, cache)."""
    return verify(params, cfg, _roped(cfg, cos, sin), token_ids, kv_cache, block_tables,
                  context_lens, slot_ids, cos)


# ---------------------------------------------------------------------------
# HF weight loading
# ---------------------------------------------------------------------------

_HF_LAYER_MAP = {
    "attn_norm": "model.layers.{i}.input_layernorm.weight",
    "post_attn_norm": "model.layers.{i}.post_attention_layernorm.weight",
    "mlp_norm": "model.layers.{i}.pre_feedforward_layernorm.weight",
    "post_mlp_norm": "model.layers.{i}.post_feedforward_layernorm.weight",
    "wq": "model.layers.{i}.self_attn.q_proj.weight",
    "wk": "model.layers.{i}.self_attn.k_proj.weight",
    "wv": "model.layers.{i}.self_attn.v_proj.weight",
    "wo": "model.layers.{i}.self_attn.o_proj.weight",
    "w_gate": "model.layers.{i}.mlp.gate_proj.weight",
    "w_up": "model.layers.{i}.mlp.up_proj.weight",
    "w_down": "model.layers.{i}.mlp.down_proj.weight",
}


def load_layers(cfg, tensors: dict, layer_map: dict, norms: tuple, device) -> dict:
    """The Gemma families' parameters from HF ``tensors``: projections
    transposed to [in, out], every norm in ``norms`` (and the final norm)
    as the (1 + w) it applies, each stacked leaf filled layer by layer."""

    def get(name: str, transpose: bool = False) -> torch.Tensor:
        t = tensors[name].to(cfg.dtype)
        return t.T if transpose else t

    layers: dict[str, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        for ours, theirs in layer_map.items():
            t = get(theirs.format(i=i), transpose=ours.startswith("w"))
            if ours in norms:
                t = plus_one(t)
            if ours not in layers:
                layers[ours] = torch.empty((cfg.num_layers, *t.shape), dtype=cfg.dtype,
                                           device=device)
            layers[ours][i].copy_(t)
    return {
        "embed": get("model.embed_tokens.weight").to(device).contiguous(),
        "final_norm": plus_one(get("model.norm.weight")).to(device),
        "layers": layers,
    }


def load_hf_weights(cfg: Gemma2Config, model_dir: str | Path, device="cuda") -> dict:
    """Gemma-2 safetensors on ``device``, the (1 + w) of every RMSNorm
    baked in.  A checkpoint with an untied ``lm_head`` is refused: this
    family projects through the tied embedding only."""
    from dynamo_tpu_torch.models.hf_io import read_safetensors

    tensors = read_safetensors(model_dir)
    if "lm_head.weight" in tensors:
        raise ValueError(
            "gemma2 checkpoint ships lm_head.weight (untied unembedding); "
            "this family implements the tied projection only"
        )
    return load_layers(cfg, tensors, _HF_LAYER_MAP, NORM_LEAVES, device)
