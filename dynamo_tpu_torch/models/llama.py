"""Llama-family model in PyTorch (counterpart of dynamo_tpu/models/llama.py).

Parameters are a plain dict with the reference's names and layouts: layer
weights stacked on a leading layer axis, projections stored [in, out].  A
Python loop over layers takes the place of ``lax.scan``.  The paged KV cache
``{"k", "v"}: [layers, num_blocks, block_size, kv_heads, head_dim]`` is
updated in place where the reference donated its buffer.

Every projection goes through ``ops.quant.mm``, so the named leaves of
``QUANT_LEAVES`` may be int8 ``QuantizedMatrix`` weights (the engine's
``quantize="int8"``) as well as plain tensors.  The cache may hold a
narrower float dtype than the model's (``init_kv_cache``'s ``dtype``):
every write casts to it, every read upcasts.

Attention of the unified, decode and verify forwards goes through the kernel
wrappers in ``ops.kernels``: on a CUDA tensor they launch the hand-written
kernels, on a CPU tensor they take the plain PyTorch versions in
``ops.attention``.  The split prefill forwards attend with the plain dense
causal form everywhere, as the reference does outside any Pallas kernel.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops.attention import (
    alloc_cache_leaf,
    cache_rows,
    dense_causal_attention,
    gather_prefix_kv,
    last_writer_slots,
    prefill_attention_with_prefix,
    slot_rows,
    write_decode_kv,
    write_prefill_kv,
    write_rows,
)
from dynamo_tpu_torch.ops.kernels import (
    paged_attention_decode,
    paged_window_attention_decode,
    ragged_attention,
    ragged_paged_attention,
)
from dynamo_tpu_torch.ops.kernels.common import sm_count
from dynamo_tpu_torch.ops.kernels.paged_attention import check_window
from dynamo_tpu_torch.ops.norms import rms_norm
from dynamo_tpu_torch.ops.quant import QuantizedMatrix, mm
from dynamo_tpu_torch.ops.rope import apply_rope, rope_table, table_positions

# the projections the engine's quantize="int8" stores as int8 (the
# reference's _PROJ_QUANT_LEAVES, dynamo_tpu/models/registry.py:92-94):
# attention, FFN and the output head; embeddings, norms and biases stay
QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    # qkv projection biases (Qwen2-family geometry; llama proper has none)
    attention_bias: bool = False
    # per-head RMSNorm on q/k after projection, before rope (Qwen3 geometry)
    qk_norm: bool = False
    # HF rope_scaling dict: "linear" | "llama3" | "yarn" (ops/rope.py)
    rope_scaling: Any = None
    # Mistral-style sliding-window attention (None = full attention)
    sliding_window: int | None = None
    dtype: Any = torch.bfloat16

    @classmethod
    def from_hf_config(cls, config: dict | str | Path) -> "LlamaConfig":
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
            max_position_embeddings=config.get("max_position_embeddings", 4096),
            rms_norm_eps=config.get("rms_norm_eps", 1e-5),
            rope_theta=config.get("rope_theta", 10000.0),
            tie_word_embeddings=config.get("tie_word_embeddings", False),
            attention_bias=config.get("attention_bias", False),
            qk_norm=config.get("qk_norm", config.get("model_type") == "qwen3"),
            rope_scaling=config.get("rope_scaling"),
            sliding_window=cls._resolve_sliding_window(config),
        )

    @staticmethod
    def _resolve_sliding_window(config: dict) -> int | None:
        """HF transformers' window semantics, applied to every layer: qwen2
        configs pair ``sliding_window`` with ``use_sliding_window`` and
        ``max_window_layers``; a genuine per-layer split is refused."""
        window = config.get("sliding_window") or None
        if window is None or not config.get("use_sliding_window", True):
            return None
        mwl = config.get("max_window_layers")
        if mwl is None or mwl <= 0:
            return window
        if mwl >= config["num_hidden_layers"]:
            return None
        raise NotImplementedError(
            f"per-layer sliding-window split (max_window_layers={mwl} < "
            f"num_hidden_layers={config['num_hidden_layers']}) is not "
            "supported: every layer shares one attention pattern"
        )

    # --- presets (geometries for serving; weights loaded or random) -------
    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def llama3_70b(cls) -> "LlamaConfig":
        return cls(hidden_size=8192, intermediate_size=28672, num_layers=80, num_heads=64)

    @classmethod
    def llama32_3b(cls) -> "LlamaConfig":
        return cls(
            hidden_size=3072, intermediate_size=8192, num_layers=28, num_heads=24,
            num_kv_heads=8, head_dim=128, rope_theta=500000.0, tie_word_embeddings=True,
        )

    @classmethod
    def llama32_1b(cls) -> "LlamaConfig":
        return cls(
            hidden_size=2048, intermediate_size=8192, num_layers=16, num_heads=32,
            num_kv_heads=8, head_dim=64, rope_theta=500000.0, tie_word_embeddings=True,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "LlamaConfig":
        """Test geometry: 2 layers, 4 heads, float32."""
        return cls(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_position_embeddings=2048,
            rope_theta=10000.0, tie_word_embeddings=True, dtype=torch.float32,
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: LlamaConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random-init parameters on ``device`` from ``generator`` (which must
    live on the same device): N(0, 1) / sqrt(fan_in) drawn in float32, one
    layer at a time, then cast to the model dtype."""
    h, i, n_layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def normal(shape, fan_in):
        out = torch.empty(shape, dtype=cfg.dtype, device=device)
        rows = out if len(shape) == 3 else out[None]
        for r in rows:  # one float32 layer slice at a time bounds the peak
            tmp = torch.empty(r.shape, dtype=torch.float32, device=device)
            tmp.normal_(generator=generator)
            r.copy_(tmp / math.sqrt(fan_in))
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    params = {
        "embed": normal((cfg.vocab_size, h), 1.0),
        "final_norm": ones((h,)),
        "layers": {
            "attn_norm": ones((n_layers, h)),
            "wq": normal((n_layers, h, qd), h),
            "wk": normal((n_layers, h, kvd), h),
            "wv": normal((n_layers, h, kvd), h),
            "wo": normal((n_layers, qd, h), qd),
            "mlp_norm": ones((n_layers, h)),
            "w_gate": normal((n_layers, h, i), h),
            "w_up": normal((n_layers, h, i), h),
            "w_down": normal((n_layers, i, h), i),
        },
    }
    if cfg.attention_bias:
        for name, width in (("bq", qd), ("bk", kvd), ("bv", kvd)):
            params["layers"][name] = torch.zeros(
                (n_layers, width), dtype=cfg.dtype, device=device
            )
    if cfg.qk_norm:
        params["layers"]["q_norm"] = ones((n_layers, cfg.head_dim))
        params["layers"]["k_norm"] = ones((n_layers, cfg.head_dim))
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((h, cfg.vocab_size), h)
    return params


def _tensor_from_numpy(a) -> torch.Tensor:
    """A numpy array as a tensor with the same bits, ml_dtypes' bfloat16 and
    fp8 arrays included (through an integer view of the same width)."""
    a = np.array(a)  # a writable copy: torch shares numpy's memory
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    if a.dtype.name in ("float8_e4m3fn", "float8_e5m2"):  # ml_dtypes' fp8: torch's bits
        return torch.from_numpy(a.view(np.uint8)).view(getattr(torch, a.dtype.name))
    return torch.from_numpy(a)


def params_from_jax(tree, device="cuda"):
    """The reference's parameter pytree (its leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as port parameters: same names,
    same layouts, on ``device``.  A quantized leaf (the reference's
    ``QuantizedMatrix``, a node with int8 ``q`` and scale ``s``) becomes
    the port's ``QuantizedMatrix``, so both engines serve the same int8
    weights."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "s"):
        return QuantizedMatrix(_tensor_from_numpy(tree.q).to(device),
                               _tensor_from_numpy(tree.s).to(device))
    return _tensor_from_numpy(tree).to(device)


def init_kv_cache(cfg: LlamaConfig, num_blocks: int, block_size: int, dtype=None,
                  device="cuda") -> dict:
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return {
        "k": alloc_cache_leaf(shape, dtype, device),
        "v": alloc_cache_leaf(shape, dtype, device),
    }


def make_rope_tables(cfg: LlamaConfig, device="cuda", max_len: int | None = None):
    """(cos, sin) float32 tables; ``max_len`` cuts them to the positions an
    engine can reach."""
    return rope_table(
        max_len or cfg.max_position_embeddings, cfg.head_dim, cfg.rope_theta,
        scaling=cfg.rope_scaling, device=device,
    )


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed(params, cfg: LlamaConfig, token_ids) -> torch.Tensor:
    return params["embed"][token_ids].to(cfg.dtype)


def _mlp(x, gate, up, down):
    return mm(F.silu(mm(x, gate)) * mm(x, up), down)


def _qkv(attn_in, w, cfg: LlamaConfig):
    s = attn_in.shape[0]
    q = mm(attn_in, w["wq"])
    k = mm(attn_in, w["wk"])
    v = mm(attn_in, w["wv"])
    if cfg.attention_bias:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = q.view(s, cfg.num_heads, cfg.head_dim)
    k = k.view(s, cfg.num_kv_heads, cfg.head_dim)
    v = v.view(s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, w["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, w["k_norm"], cfg.rms_norm_eps)
    return q, k, v


def _layers(params):
    layers = params["layers"]
    n = next(iter(layers.values())).shape[0]
    for i in range(n):
        yield i, {name: leaf[i] for name, leaf in layers.items()}


def _logits(params, cfg, x):
    if cfg.tie_word_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return mm(x, params["lm_head"])


def _residual_block(x, attn, w, cfg):
    x = x + mm(attn.reshape(x.shape[0], -1), w["wo"])
    mlp_in = rms_norm(x, w["mlp_norm"], cfg.rms_norm_eps)
    return x + _mlp(mlp_in, w["w_gate"], w["w_up"], w["w_down"])


def llama_forward_prefill(
    params: dict,
    cfg: LlamaConfig,
    token_ids: torch.Tensor,  # [seq_pad] int
    kv_cache: dict,           # {"k","v"}: [L, N, bs, kvh, d]
    block_ids: torch.Tensor,  # [max_blocks] int
    seq_len: int,             # valid tokens
    start_pos: int,           # absolute position of token 0
    cos: torch.Tensor,
    sin: torch.Tensor,
) -> tuple[torch.Tensor, dict]:
    """Single-sequence prefill (the split prefill step).  Returns (the last
    valid token's logits [vocab] f32, cache); the cache is written in
    place.  Attention is the plain dense causal form in float32, as the
    reference computes it outside any Pallas kernel."""
    s = token_ids.shape[0]
    x = _embed(params, cfg, token_ids)
    positions = table_positions(start_pos + torch.arange(s, device=x.device), cos)
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    lens = torch.tensor([seq_len], device=x.device)
    for i, w in _layers(params):
        attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(attn_in, w, cfg)
        q = apply_rope(q, positions, cos, sin)
        k = apply_rope(k, positions, cos, sin)
        write_prefill_kv(k_all[i], v_all[i], k, v, block_ids, seq_len)
        attn = dense_causal_attention(
            q[None], k[None], v[None], lens, sliding_window=cfg.sliding_window,
        )[0]
        x = _residual_block(x, attn.reshape(s, -1), w, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = x[max(int(seq_len) - 1, 0)]
    return _logits(params, cfg, last[None])[0].float(), kv_cache


def llama_forward_prefill_with_prefix(
    params: dict,
    cfg: LlamaConfig,
    token_ids: torch.Tensor,       # [tail_pad] int — the uncached tail
    kv_cache: dict,
    full_block_ids: torch.Tensor,  # [table_len] int — whole table (prefix + tail)
    tail_block_ids: torch.Tensor,  # [table_len] int — table from the first tail block
    tail_len: int,                 # valid tail tokens
    start_pos: int,                # resident prefix length (block-aligned)
    cos: torch.Tensor,
    sin: torch.Tensor,
) -> tuple[torch.Tensor, dict]:
    """Continued prefill over a resident prefix (a prefix-cache hit or a
    later chunk of a chunked prefill): the tail's queries attend to the
    prefix K/V read from the paged cache plus themselves, and only the
    tail's K/V are written.  Returns (last tail token's logits [vocab] f32,
    cache)."""
    s = token_ids.shape[0]
    x = _embed(params, cfg, token_ids)
    positions = table_positions(start_pos + torch.arange(s, device=x.device), cos)
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    for i, w in _layers(params):
        attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(attn_in, w, cfg)
        q = apply_rope(q, positions, cos, sin)
        k = apply_rope(k, positions, cos, sin)
        # read the resident prefix BEFORE the tail is written
        k_prefix, v_prefix = gather_prefix_kv(k_all[i], v_all[i], full_block_ids)
        write_prefill_kv(k_all[i], v_all[i], k, v, tail_block_ids, tail_len)
        attn = prefill_attention_with_prefix(
            q, k, v, k_prefix, v_prefix, start_pos, tail_len,
            sliding_window=cfg.sliding_window,
        )
        x = _residual_block(x, attn.reshape(s, -1), w, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = x[max(int(tail_len) - 1, 0)]
    return _logits(params, cfg, last[None])[0].float(), kv_cache


def check_verify_width(cfg: LlamaConfig, w: int) -> None:
    """Refuse, before any launch, a verify window wider than the paged
    window kernel holds at this geometry."""
    check_window(w, cfg.num_heads, cfg.num_kv_heads)


def llama_forward_verify(
    params: dict,
    cfg: LlamaConfig,
    token_ids: torch.Tensor,     # [batch, w] int — the last accepted token, then drafts
    kv_cache: dict,
    block_tables: torch.Tensor,  # [batch, max_blocks] int32
    context_lens: torch.Tensor,  # [batch] int32 INCLUDING the window's last token
    slot_ids: torch.Tensor,      # [batch, w] int32 flat cache slot per position
    cos: torch.Tensor,
    sin: torch.Tensor,
) -> tuple[torch.Tensor, dict]:
    """Speculative verification: score all w window positions in one pass
    (logits [batch, w, vocab] f32).  The whole window's K/V is written like
    decode (a slot named twice keeps its last position, as the reference's
    scatter does); attention is the paged window kernel at W = w — on a
    CPU tensor its plain version."""
    b, w_len = token_ids.shape
    x = _embed(params, cfg, token_ids.reshape(-1))  # [b*w, hidden], batch-major
    positions = table_positions(
        context_lens[:, None] - w_len + torch.arange(w_len, device=x.device)[None, :], cos
    )  # [b, w]
    flat_slots = slot_ids.reshape(-1)
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    live = last_writer_slots(flat_slots, k_all.shape[1] * k_all.shape[2])
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for i, w in _layers(params):
        attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(attn_in, w, cfg)
        q = apply_rope(q.view(b, w_len, h, d), positions, cos, sin)
        k = apply_rope(k.view(b, w_len, kvh, d), positions, cos, sin)
        write_decode_kv(k_all[i], v_all[i], k.reshape(b * w_len, kvh, d), v, flat_slots, live)
        attn = paged_window_attention_decode(
            q, k_all[i], v_all[i], block_tables, context_lens,
            sliding_window=cfg.sliding_window,
        )
        x = _residual_block(x, attn.reshape(b * w_len, -1), w, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(params, cfg, x).view(b, w_len, -1).float(), kv_cache


def llama_forward_decode(
    params: dict,
    cfg: LlamaConfig,
    token_ids: torch.Tensor,     # [batch] int — last sampled token per seq
    kv_cache: dict,
    block_tables: torch.Tensor,  # [batch, max_blocks] int32
    context_lens: torch.Tensor,  # [batch] int32 length INCLUDING this token
    slot_ids: torch.Tensor,      # [batch] int32 flat cache slot for this token
    cos: torch.Tensor,
    sin: torch.Tensor,
) -> tuple[torch.Tensor, dict]:
    """Batched single-token decode.  Returns (logits [batch, vocab] f32,
    cache); the cache is written in place."""
    b = token_ids.shape[0]
    x = _embed(params, cfg, token_ids)
    positions = (context_lens - 1).clamp(min=0)[:, None]  # this token's position
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    k_rows, v_rows = cache_rows(k_all), cache_rows(v_all)
    rows = slot_rows(slot_ids, k_all)  # idle lanes write the dump row
    for i, w in _layers(params):
        attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(attn_in, w, cfg)
        q = apply_rope(q[:, None], positions, cos, sin)[:, 0]
        k = apply_rope(k[:, None], positions, cos, sin)[:, 0]
        write_rows(k_rows, v_rows, rows[i], k, v)
        attn = paged_attention_decode(
            q, k_all[i], v_all[i], block_tables, context_lens,
            sliding_window=cfg.sliding_window,
        )
        x = _residual_block(x, attn.reshape(b, -1), w, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(params, cfg, x).float(), kv_cache


def unified_planner(cfg: LlamaConfig, *, block_size: int, tb_tokens: int,
                    device: torch.device, cache_dtype: torch.dtype | None = None):
    """The ragged GQA walk's planner (``ragged_planner``: a unified step's
    work plan from its host ``page_count``, and the fixed capacity of a
    token bucket's plans), or None where the kernel reads no plan: off the
    card, and on the CUDA-core loop's shapes and dtypes (``cache_dtype``:
    the cache's, default the model's)."""
    rows = tb_tokens * (cfg.num_heads // cfg.num_kv_heads)
    if device.type != "cuda" or not ragged_attention.split_route(
            cfg.dtype, cfg.head_dim, block_size, rows, cache_dtype):
        return None
    return ragged_attention.ragged_planner(cfg.num_kv_heads, sm_count(device), rows,
                                           cfg.head_dim)


def llama_forward_unified(
    params: dict,
    cfg: LlamaConfig,
    token_ids: torch.Tensor,     # [T] int — flat ragged token batch
    kv_cache: dict,
    block_tables: torch.Tensor,  # [lanes, max_blocks] int32
    context_lens: torch.Tensor,  # [lanes] int32 incl. each lane's span end
    token_pos: torch.Tensor,     # [T] int32 absolute position (-1 = pad)
    token_slot: torch.Tensor,    # [T] int32 flat cache slot (out of range = pad)
    token_lane: torch.Tensor,    # [T] int32 owning lane (out of range = pad)
    page_phys: torch.Tensor,     # [T // tb_tokens, PS] int32 (pack_page_meta)
    page_lane: torch.Tensor,     # [T // tb_tokens, PS] int32 owning lane (-1 pad)
    page_ord: torch.Tensor,      # [T // tb_tokens, PS] int32 page ordinal
    page_count: torch.Tensor,    # [T // tb_tokens] int32 live worklist entries
    sample_rows: torch.Tensor,   # [lanes] int flat index of each span's LAST token
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    tb_tokens: int = 8,
    pages_per_step: int = 1,
    plan=None,
) -> tuple[torch.Tensor, dict]:
    """Ragged unified-batch forward: chunked-prefill spans and decode tokens
    of different sequences in one pass, each token at its own absolute
    position.  Every token's K/V is written to its cache slot before any
    token attends, so span tokens see their predecessors through the cache.
    ``plan`` (``plan_ragged_work`` over ``page_count``, made once a step,
    or the ``DeviceWork`` it was written into) balances every layer's
    ragged kernel on the card.  Logits are gathered
    at each lane's last span row: [lanes, vocab] f32 (junk for lanes
    without tokens; the caller gates them)."""
    t = token_ids.shape[0]
    x = _embed(params, cfg, token_ids)
    positions = token_pos.clamp(min=0)  # pads rope at position 0
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    k_rows, v_rows = cache_rows(k_all), cache_rows(v_all)
    rows = slot_rows(token_slot, k_all)  # pad tokens write the dump row
    for i, w in _layers(params):
        attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(attn_in, w, cfg)
        q = apply_rope(q, positions, cos, sin)
        k = apply_rope(k, positions, cos, sin)
        write_rows(k_rows, v_rows, rows[i], k, v)
        attn = ragged_paged_attention(
            q, k_all[i], v_all[i], block_tables, token_lane, token_pos,
            page_phys, page_lane, page_ord, page_count,
            tb_tokens=tb_tokens, pages_per_step=pages_per_step,
            sliding_window=cfg.sliding_window, plan=plan,
        )
        x = _residual_block(x, attn.reshape(t, -1), w, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    rows = x[sample_rows]
    return _logits(params, cfg, rows).float(), kv_cache


# ---------------------------------------------------------------------------
# HF weight loading (safetensors)
# ---------------------------------------------------------------------------

_HF_LAYER_MAP = {
    "attn_norm": "model.layers.{i}.input_layernorm.weight",
    "wq": "model.layers.{i}.self_attn.q_proj.weight",
    "wk": "model.layers.{i}.self_attn.k_proj.weight",
    "wv": "model.layers.{i}.self_attn.v_proj.weight",
    "wo": "model.layers.{i}.self_attn.o_proj.weight",
    "mlp_norm": "model.layers.{i}.post_attention_layernorm.weight",
    "w_gate": "model.layers.{i}.mlp.gate_proj.weight",
    "w_up": "model.layers.{i}.mlp.up_proj.weight",
    "w_down": "model.layers.{i}.mlp.down_proj.weight",
}


def load_hf_weights(cfg: LlamaConfig, model_dir: str | Path, device="cuda") -> dict:
    """Load and stack HF llama safetensors into the layer-stacked dict on
    ``device`` (HF stores projections [out, in]; ours are [in, out])."""
    from dynamo_tpu_torch.models.hf_io import read_safetensors

    tensors = read_safetensors(model_dir)

    def get(name: str, transpose: bool = False) -> torch.Tensor:
        t = tensors[name]
        if transpose:
            t = t.T
        return t.to(device=device, dtype=cfg.dtype).contiguous()

    layer_map = dict(_HF_LAYER_MAP)
    if cfg.attention_bias:
        layer_map.update(
            bq="model.layers.{i}.self_attn.q_proj.bias",
            bk="model.layers.{i}.self_attn.k_proj.bias",
            bv="model.layers.{i}.self_attn.v_proj.bias",
        )
    if cfg.qk_norm:
        layer_map.update(
            q_norm="model.layers.{i}.self_attn.q_norm.weight",
            k_norm="model.layers.{i}.self_attn.k_norm.weight",
        )
    layers = {
        ours: torch.stack([
            get(theirs.format(i=i), ours.startswith("w")) for i in range(cfg.num_layers)
        ])
        for ours, theirs in layer_map.items()
    }
    params = {
        "embed": get("model.embed_tokens.weight"),
        "final_norm": get("model.norm.weight"),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in tensors:
        params["lm_head"] = get("lm_head.weight", transpose=True)
    return params
