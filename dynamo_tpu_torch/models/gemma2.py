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

On a mesh (``mesh=`` on the prefill and decode forwards, ``param_specs``
the reference's): heads and the MLP width over tp, each row-parallel
product summed over tp before its post-norm, the embedding (and so the
tied head) whole on every rank as the reference's spec keeps it; the
layer axis over pp, the stages run in turn (``stage_layer_stack``; the
reference has no pipelined Gemma decode), each layer keeping its own
window by its index in the whole model.
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
    _stage_input,
    leaf_sink,
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
from dynamo_tpu_torch.parallel.mesh import all_reduce, mesh_size, shard_config, shard_tree
from dynamo_tpu_torch.parallel.pipeline import first_stage, stage_layer_stack
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


def init_params(cfg, generator: torch.Generator, device="cuda", shard=None) -> dict:
    """Random-init parameters on ``device`` from ``generator`` (on the same
    device), the reference's names and layouts.  ``shard(path, leaf)`` as
    in ``llama.init_params``: each leaf replaced by a rank's slice as soon
    as it is drawn, the draws unchanged."""
    h, i, n_layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    normal, ones = param_init(cfg.dtype, generator, device)
    params, put = leaf_sink(shard)
    for name in NORM_LEAVES:
        put(("layers", name), ones((n_layers, h)))
    for name, make in (
        ("wq", lambda: normal((n_layers, h, qd), h)),
        ("wk", lambda: normal((n_layers, h, kvd), h)),
        ("wv", lambda: normal((n_layers, h, kvd), h)),
        ("wo", lambda: normal((n_layers, qd, h), qd)),
        ("w_gate", lambda: normal((n_layers, h, i), h)),
        ("w_up", lambda: normal((n_layers, h, i), h)),
        ("w_down", lambda: normal((n_layers, i, h), i)),
    ):
        put(("layers", name), make())
    put(("embed",), normal((cfg.vocab_size, h), 1.0))
    put(("final_norm",), ones((h,)))
    return params


def param_specs(cfg) -> dict:
    """The reference's (dynamo_tpu/models/gemma2.py:162) as tuples of axis
    names: the llama family's tp and pp story (heads and the MLP width over
    tp, ``wo`` and ``w_down`` by row; the layer axis over pp), the
    embedding replicated; Gemma-3's per-head q/k norms with the layers."""
    norm = ("pp", None)
    layers = {name: norm for name in NORM_LEAVES}
    if hasattr(cfg, "global_layers"):  # Gemma-3 (dynamo_tpu/models/gemma3.py:180)
        layers.update(q_norm=norm, k_norm=norm)
    layers.update(wq=("pp", None, "tp"), wk=("pp", None, "tp"), wv=("pp", None, "tp"),
                  wo=("pp", "tp", None), w_gate=("pp", None, "tp"), w_up=("pp", None, "tp"),
                  w_down=("pp", "tp", None))
    return {"embed": (None, None), "final_norm": (None,), "layers": layers}


def shard_params(params: dict, cfg, mesh) -> dict:
    """This rank's slice of every leaf under ``param_specs`` (int8 leaves
    under ``quantize_specs``), each the reference's ``NamedSharding`` shard
    of the same leaf."""
    from dynamo_tpu_torch.models.llama import QUANT_LEAVES
    from dynamo_tpu_torch.ops.quant import is_quantized, quantize_specs

    specs = param_specs(cfg)
    if is_quantized(params):
        specs = quantize_specs(specs, QUANT_LEAVES)
    return shard_tree(params, specs, mesh)


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


def sandwich(x, w, cfg, attn, mesh=None):
    """The layer's tail: the attention output ``attn`` [t, H*D] through
    ``wo`` and its post-norm into the residual, then the GeGLU MLP between
    its two norms.  On a tp mesh both products are row-parallel, summed
    over tp before their post-norms."""
    eps = cfg.rms_norm_eps
    x = x + rms_norm(all_reduce(mm(attn, w["wo"]), mesh), w["post_attn_norm"], eps)
    mlp = _mlp(rms_norm(x, w["mlp_norm"], eps), w["w_gate"], w["w_up"], w["w_down"],
               "gelu_tanh")
    return x + rms_norm(all_reduce(mlp, mesh), w["post_mlp_norm"], eps)


def _layer_inputs(cfg, params, mesh=None):
    """(layer index in this rank's stack, weights, window, index in the
    whole model) of every layer this rank holds: a pp stage's layers keep
    the windows (and Gemma-3's rope tables) of their place in the model."""
    n_local = next(iter(params["layers"].values())).shape[0]
    first = mesh.index("pp") * n_local if mesh_size(mesh, "pp") > 1 else 0
    windows = cfg.layer_windows()
    for i, w in _layers(params):
        yield i, w, windows[first + i], first + i


def prefill(params, cfg, qkv, token_ids, kv_cache, block_ids, seq_len, start_pos, cos,
            mesh=None):
    """The split prefill step of the Gemma families: the llama contract
    (``llama_forward_prefill``, ``mesh`` included), each layer masked by
    its own window.  ``qkv(x, w, g, positions)`` gives layer g's (by its
    index in the model) roped q, k and v; ``cos``, the rope table, bounds
    the positions."""
    s = token_ids.shape[0]
    x = _stage_input(lambda: _embed(params, cfg, token_ids), s, cfg, token_ids.device, mesh)
    return prefill_embeds(params, cfg, qkv, x, kv_cache, block_ids, seq_len, start_pos, cos,
                          mesh)


def prefill_embeds(params, cfg, qkv, input_embeds, kv_cache, block_ids, seq_len, start_pos,
                   cos, mesh=None):
    """``prefill`` from precomputed input embeddings [seq_pad, hidden] (a
    multimodal prompt: the family's ``embed`` hook applies the sqrt(hidden)
    scale to the text rows before the splice)."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    s = input_embeds.shape[0]
    x = input_embeds.to(cfg.dtype)
    positions = table_positions(start_pos + torch.arange(s, device=x.device), cos)
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    lens = torch.as_tensor(seq_len, device=x.device).reshape(1)

    def run_layers(x):
        for i, w, window, g in _layer_inputs(cfg, params, mesh):
            q, k, v = qkv(x, w, g, positions)
            write_prefill_kv(k_all[i], v_all[i], k, v, block_ids, seq_len)
            with profiling.annotate("split_prefill_attention"):
                attn = dense_causal_attention(q[None], k[None], v[None], lens,
                                              **attn_kwargs(cfg, window))[0]
            x = sandwich(x, w, cfg, attn.reshape(s, -1), mesh)
        return x

    x = stage_layer_stack(run_layers, x, mesh)
    if not first_stage(mesh):
        return None, kv_cache
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _final_logits(params, full_cfg, last_valid_row(x, seq_len))[0], kv_cache


def prefill_with_prefix(params, cfg, qkv, token_ids, kv_cache, full_block_ids,
                        tail_block_ids, tail_len, start_pos, cos, mesh=None):
    """Continued prefill over a resident prefix (the llama contract), each
    layer masked by its own window."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    s = token_ids.shape[0]
    x = _stage_input(lambda: _embed(params, cfg, token_ids), s, cfg, token_ids.device, mesh)
    positions = table_positions(start_pos + torch.arange(s, device=x.device), cos)
    k_all, v_all = kv_cache["k"], kv_cache["v"]

    def run_layers(x):
        for i, w, window, g in _layer_inputs(cfg, params, mesh):
            q, k, v = qkv(x, w, g, positions)
            # read the resident prefix BEFORE the tail is written
            k_prefix, v_prefix = gather_prefix_kv(k_all[i], v_all[i], full_block_ids)
            write_prefill_kv(k_all[i], v_all[i], k, v, tail_block_ids, tail_len)
            with profiling.annotate("split_prefill_attention"):
                attn = prefill_attention_with_prefix(q, k, v, k_prefix, v_prefix, start_pos,
                                                     tail_len, **attn_kwargs(cfg, window))
            x = sandwich(x, w, cfg, attn.reshape(s, -1), mesh)
        return x

    x = stage_layer_stack(run_layers, x, mesh)
    if not first_stage(mesh):
        return None, kv_cache
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _final_logits(params, full_cfg, last_valid_row(x, tail_len))[0], kv_cache


def decode(params, cfg, qkv, token_ids, kv_cache, block_tables, context_lens, slot_ids,
           mesh=None):
    """Batched single-token decode (the llama contract), plain attention
    with each layer's window, soft-cap and query scale; on a pp mesh the
    stages in turn."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    b = token_ids.shape[0]
    x = _stage_input(lambda: _embed(params, cfg, token_ids), b, cfg, token_ids.device, mesh)
    positions = (context_lens - 1).clamp(min=0)
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    k_rows, v_rows = cache_rows(k_all), cache_rows(v_all)
    rows = slot_rows(slot_ids, k_all)  # idle lanes write the dump row

    def run_layers(x):
        for i, w, window, g in _layer_inputs(cfg, params, mesh):
            q, k, v = qkv(x, w, g, positions)
            write_rows(k_rows, v_rows, rows[i], k, v)
            attn = paged_decode_attention(q, k_all[i], v_all[i], block_tables, context_lens,
                                          **attn_kwargs(cfg, window))
            x = sandwich(x, w, cfg, attn.reshape(b, -1), mesh)
        return x

    x = stage_layer_stack(run_layers, x, mesh)
    if not first_stage(mesh):
        return None, kv_cache
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _final_logits(params, full_cfg, x), kv_cache


def verify(params, cfg, qkv, token_ids, kv_cache, block_tables, context_lens, slot_ids,
           cos, mesh=None):
    """Speculative verification (the llama contract): all w window
    positions in one pass, batch-major, each layer's window masking its
    queries.  Logits [batch, w, vocab] f32.  On a tp ``mesh`` the plain
    attention runs on this rank's heads, the products summed as in
    decode."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    b, w_len = token_ids.shape
    x = _embed(params, cfg, token_ids.reshape(-1))  # [b*w, hidden], batch-major
    positions = table_positions(
        context_lens[:, None] - w_len + torch.arange(w_len, device=x.device)[None, :], cos
    ).reshape(-1)
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    k_rows, v_rows = cache_rows(k_all), cache_rows(v_all)
    rows = last_writer_rows(slot_ids.reshape(-1), k_all)
    for i, w, window, g in _layer_inputs(cfg, params, mesh):
        q, k, v = qkv(x, w, g, positions)
        write_rows(k_rows, v_rows, rows[i], k, v)
        attn = paged_window_attention(
            q.view(b, w_len, cfg.num_heads, cfg.head_dim), k_all[i], v_all[i], block_tables,
            context_lens, **attn_kwargs(cfg, window))
        x = sandwich(x, w, cfg, attn.reshape(b * w_len, -1), mesh)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _final_logits(params, full_cfg, x).view(b, w_len, -1), kv_cache


def _roped(cfg: Gemma2Config, cos, sin, mesh=None):
    cfg = shard_config(cfg, mesh)

    def qkv(x, w, g, positions):
        q, k, v = _qkv(rms_norm(x, w["attn_norm"], cfg.rms_norm_eps), w, cfg)
        return apply_rope(q, positions, cos, sin), apply_rope(k, positions, cos, sin), v

    return qkv


def gemma2_forward_prefill(params, cfg: Gemma2Config, token_ids, kv_cache, block_ids,
                           seq_len, start_pos, cos, sin, *, mesh=None):
    """Single-sequence prefill: (the last valid token's logits [vocab] f32,
    cache), the cache written in place; ``mesh`` as the llama family's."""
    return prefill(params, cfg, _roped(cfg, cos, sin, mesh), token_ids, kv_cache, block_ids,
                   seq_len, start_pos, cos, mesh)


def gemma2_forward_prefill_with_prefix(params, cfg: Gemma2Config, token_ids, kv_cache,
                                       full_block_ids, tail_block_ids, tail_len, start_pos,
                                       cos, sin, *, mesh=None):
    return prefill_with_prefix(params, cfg, _roped(cfg, cos, sin, mesh), token_ids, kv_cache,
                               full_block_ids, tail_block_ids, tail_len, start_pos, cos, mesh)


def gemma2_forward_decode(params, cfg: Gemma2Config, token_ids, kv_cache, block_tables,
                          context_lens, slot_ids, cos, sin, *, mesh=None):
    """Batched decode: (logits [batch, vocab] f32, cache)."""
    return decode(params, cfg, _roped(cfg, cos, sin, mesh), token_ids, kv_cache, block_tables,
                  context_lens, slot_ids, mesh)


def gemma2_forward_verify(params, cfg: Gemma2Config, token_ids, kv_cache, block_tables,
                          context_lens, slot_ids, cos, sin, *, mesh=None):
    """Speculative verification: (logits [batch, w, vocab] f32, cache)."""
    return verify(params, cfg, _roped(cfg, cos, sin, mesh), token_ids, kv_cache, block_tables,
                  context_lens, slot_ids, cos, mesh)


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
