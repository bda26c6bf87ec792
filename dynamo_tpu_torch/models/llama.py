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
No forward reads a length on the host, so the engine captures each as a
CUDA graph (``engine/graphs.py``).
"""

from __future__ import annotations

import dataclasses
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
    last_valid_row,
    last_writer_rows,
    prefill_attention_with_prefix,
    slot_rows,
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
from dynamo_tpu_torch.ops.ring_attention import (
    ring_attention,
    ring_attention_with_prefix,
    sequence_chunk,
)
from dynamo_tpu_torch.parallel.mesh import (
    all_gather,
    all_reduce,
    embed_rows,
    mesh_size,
    shard_config,
    vocab_parallel_embed,
)
from dynamo_tpu_torch.parallel.pipeline import (
    first_stage,
    pipeline_layer_stack,
    stage_layer_stack,
)
from dynamo_tpu_torch.utils import profiling

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
    # MLP gate activation: "silu" (llama/qwen/mistral/phi3) or "gelu_tanh"
    # (gemma's GeGLU)
    mlp_activation: str = "silu"
    # input-embedding scale (gemma: sqrt(hidden_size), at the input only;
    # the tied unembedding stays unscaled, so it cannot be baked in)
    embed_scale: float = 1.0
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


def param_init(dtype, generator: torch.Generator, device):
    """``(normal, ones)`` leaf makers of the families' random init:
    ``normal(shape, fan_in)`` draws N(0, 1) / sqrt(fan_in) in float32 one
    layer slice (the leading axis of a stacked leaf) at a time, which bounds
    the float32 peak, and casts to ``dtype``; ``ones(shape)``."""

    def normal(shape, fan_in):
        out = torch.empty(shape, dtype=dtype, device=device)
        rows = out if len(shape) >= 3 else out[None]
        for r in rows:
            tmp = torch.empty(r.shape, dtype=torch.float32, device=device)
            tmp.normal_(generator=generator)
            r.copy_(tmp / math.sqrt(fan_in))
        return out

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return normal, ones


def leaf_sink(shard=None):
    """``(tree, put)``: ``put(path, leaf)`` stores ``leaf`` at ``path`` of
    ``tree``, or ``shard(path, leaf)`` where a sharding callback is given
    (``parallel.mesh.leaf_sharder``: a tensor-parallel rank keeps its slice
    and drops the full leaf before the next is made)."""
    tree: dict = {}

    def put(path: tuple[str, ...], leaf):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf if shard is None else shard(path, leaf)

    return tree, put


def init_params(cfg: LlamaConfig, generator: torch.Generator, device="cuda",
                shard=None) -> dict:
    """Random-init parameters on ``device`` from ``generator`` (which must
    live on the same device): N(0, 1) / sqrt(fan_in) drawn in float32, one
    layer at a time, then cast to the model dtype.  ``shard(path, leaf)``
    (optional) replaces each leaf as soon as it is drawn; the draws are the
    same with and without it."""
    h, i, n_layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    normal, ones = param_init(cfg.dtype, generator, device)
    params, put = leaf_sink(shard)
    put(("embed",), normal((cfg.vocab_size, h), 1.0))
    put(("final_norm",), ones((h,)))
    for name, make in (
        ("attn_norm", lambda: ones((n_layers, h))),
        ("wq", lambda: normal((n_layers, h, qd), h)),
        ("wk", lambda: normal((n_layers, h, kvd), h)),
        ("wv", lambda: normal((n_layers, h, kvd), h)),
        ("wo", lambda: normal((n_layers, qd, h), qd)),
        ("mlp_norm", lambda: ones((n_layers, h))),
        ("w_gate", lambda: normal((n_layers, h, i), h)),
        ("w_up", lambda: normal((n_layers, h, i), h)),
        ("w_down", lambda: normal((n_layers, i, h), i)),
    ):
        put(("layers", name), make())
    if cfg.attention_bias:
        for name, width in (("bq", qd), ("bk", kvd), ("bv", kvd)):
            put(("layers", name), torch.zeros((n_layers, width), dtype=cfg.dtype, device=device))
    if cfg.qk_norm:
        put(("layers", "q_norm"), ones((n_layers, cfg.head_dim)))
        put(("layers", "k_norm"), ones((n_layers, cfg.head_dim)))
    if not cfg.tie_word_embeddings:
        put(("lm_head",), normal((h, cfg.vocab_size), h))
    return params


def param_specs(cfg: LlamaConfig) -> dict:
    """The reference's PartitionSpecs (dynamo_tpu/models/llama.py:209) as
    tuples of axis names: tp shards the heads of ``wq``/``wk``/``wv`` (and
    Qwen2's biases) and the FFN's ``w_gate``/``w_up`` by column, ``wo`` and
    ``w_down`` by row (their products are summed over tp), the vocabulary
    of the embedding and the LM head; ``pp`` the layer axis (a stage holds
    its layers and their cache)."""
    specs = {
        "embed": ("tp", None),
        "final_norm": (None,),
        "layers": {
            "attn_norm": ("pp", None),
            "wq": ("pp", None, "tp"),
            "wk": ("pp", None, "tp"),
            "wv": ("pp", None, "tp"),
            "wo": ("pp", "tp", None),
            "mlp_norm": ("pp", None),
            "w_gate": ("pp", None, "tp"),
            "w_up": ("pp", None, "tp"),
            "w_down": ("pp", "tp", None),
        },
    }
    if cfg.attention_bias:
        for name in ("bq", "bk", "bv"):
            specs["layers"][name] = ("pp", "tp")
    if cfg.qk_norm:
        specs["layers"]["q_norm"] = ("pp", None)
        specs["layers"]["k_norm"] = ("pp", None)
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, "tp")
    return specs


def kv_cache_spec() -> tuple:
    """The paged cache's: the layer axis over pp, kv heads over tp,
    replicated over sp (the reference's :242)."""
    return ("pp", None, None, "tp", None)


def cache_specs(cfg: LlamaConfig) -> dict:
    return {"k": kv_cache_spec(), "v": kv_cache_spec()}


def shard_params(params: dict, cfg: LlamaConfig, mesh, specs: dict | None = None) -> dict:
    """This rank's slice of every leaf under ``param_specs`` (int8 leaves
    under ``quantize_specs``), each bitwise the reference's
    ``NamedSharding`` shard of the same leaf."""
    from dynamo_tpu_torch.ops.quant import is_quantized, quantize_specs
    from dynamo_tpu_torch.parallel.mesh import shard_tree

    specs = specs or param_specs(cfg)
    if is_quantized(params):
        specs = quantize_specs(specs, QUANT_LEAVES)
    return shard_tree(params, specs, mesh)


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
                  device="cuda", num_layers: int | None = None) -> dict:
    """The paged cache ``{"k", "v"}: [L, N, bs, kvh, d]``; ``num_layers``
    (default the model's) a pp stage's share of the layers."""
    shape = (num_layers or cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
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


def _embed(params, cfg: LlamaConfig, token_ids, mesh=None) -> torch.Tensor:
    table = params["embed"]
    if table.shape[0] != cfg.vocab_size:  # vocab-sharded over tp
        x = vocab_parallel_embed(table, token_ids, mesh).to(cfg.dtype)
    else:
        x = embed_rows(table, token_ids).to(cfg.dtype)
    if cfg.embed_scale != 1.0:
        # the reference multiplies by the scale cast to the model dtype
        x = x * torch.tensor(cfg.embed_scale, dtype=cfg.dtype).item()
    return x


def _mlp(x, gate, up, down, activation: str = "silu"):
    if activation == "gelu_tanh":  # gemma's GeGLU (HF gelu_pytorch_tanh)
        act = F.gelu(mm(x, gate), approximate="tanh")
    elif activation == "silu":
        act = F.silu(mm(x, gate))
    else:  # a misspelt activation must not run silu into wrong logits
        raise ValueError(f"unknown mlp_activation {activation!r}")
    return mm(act * mm(x, up), down)


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


def llama_forward_trunk(params: dict, cfg: LlamaConfig, token_ids: torch.Tensor, seq_len,
                        cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The trunk alone (no KV cache, no LM head): the final hidden states
    [seq_pad, hidden] of ``token_ids``, keys past ``seq_len`` (a 0-d int
    tensor or an int) masked.  The embedding engine's forward; attention is
    the plain dense causal form, as the reference's."""
    s = token_ids.shape[0]
    x = _embed(params, cfg, token_ids)
    positions = table_positions(torch.arange(s, device=x.device), cos)
    lens = torch.as_tensor(seq_len, device=x.device).reshape(1)
    for _, w in _layers(params):
        attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(attn_in, w, cfg)
        q = apply_rope(q, positions, cos, sin)
        k = apply_rope(k, positions, cos, sin)
        attn = dense_causal_attention(q[None], k[None], v[None], lens,
                                      sliding_window=cfg.sliding_window)[0]
        x = _residual_block(x, attn.reshape(s, -1), w, cfg)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def _logits(params, cfg, x, mesh=None):
    """The LM head's logits; a vocab-sharded head's (tp ranks) gathered
    from every rank."""
    if cfg.tie_word_embeddings:
        table = params["embed"]
        out, width = x @ table.to(x.dtype).T, table.shape[0]
    else:
        out, width = mm(x, params["lm_head"]), params["lm_head"].shape[-1]
    return out if width == cfg.vocab_size else all_gather(out, mesh, "tp", dim=-1)


def _residual_block(x, attn, w, cfg, mesh=None):
    """The layer's tail: ``wo`` then the MLP, each a residual add; on a tp
    mesh both are row-parallel products, summed over tp."""
    x = x + all_reduce(mm(attn.reshape(x.shape[0], -1), w["wo"]), mesh)
    mlp_in = rms_norm(x, w["mlp_norm"], cfg.rms_norm_eps)
    return x + all_reduce(_mlp(mlp_in, w["w_gate"], w["w_up"], w["w_down"], cfg.mlp_activation),
                          mesh)


def _stage_input(make, rows: int, cfg, device, mesh) -> torch.Tensor:
    """Stage 0's activations (``make()``: the embedding), or on a later
    pipeline stage an empty tensor of their shape: its rows come from the
    previous stage (``parallel.pipeline``)."""
    if first_stage(mesh):
        return make()
    return torch.empty((rows, cfg.hidden_size), dtype=cfg.dtype, device=device)


def _sp_chunk(s: int, mesh) -> tuple[int, int]:
    """(offset, length) of this sp rank's contiguous chunk of a bucket of
    ``s`` positions: the whole bucket off an sp mesh."""
    n = mesh_size(mesh, "sp")
    if n == 1:
        return 0, s
    chunk = sequence_chunk(s, n)
    return mesh.index("sp") * chunk, chunk


def _check_sp_window(cfg, mesh) -> None:
    if mesh_size(mesh, "sp") > 1 and cfg.sliding_window is not None:
        # the ring has no window mask: a shard would compute full attention
        raise NotImplementedError(
            "sequence parallelism does not compose with sliding-window "
            "attention: ring attention computes the full causal mask"
        )


def _sp_last_row(x: torch.Tensor, n, offset: int, mesh) -> torch.Tensor:
    """Row ``max(n - 1, 0)`` of the whole sequence as ``[1, ...]``, on
    every rank: on an sp mesh the rank whose chunk holds it gives it, the
    others zeros, and the sum over sp is that row exactly."""
    if mesh_size(mesh, "sp") == 1:
        return last_valid_row(x, n)
    r = (torch.as_tensor(n, device=x.device) - 1).clamp(min=0).reshape(1).long() - offset
    mine = (r >= 0) & (r < x.shape[0])
    row = x.index_select(0, r.clamp(0, x.shape[0] - 1))
    return all_reduce(torch.where(mine[:, None], row, torch.zeros_like(row)), mesh, "sp")


def _sp_kv(k: torch.Tensor, v: torch.Tensor, mesh):
    """A chunk's K/V, all-gathered over sp into the whole sequence's: the
    cache is replicated over sp, so every rank writes every row."""
    return all_gather(k, mesh, "sp", dim=0), all_gather(v, mesh, "sp", dim=0)


def llama_forward_prefill(
    params: dict,
    cfg: LlamaConfig,
    token_ids: torch.Tensor,  # [seq_pad] int
    kv_cache: dict,           # {"k","v"}: [L, N, bs, kvh, d]
    block_ids: torch.Tensor,  # [max_blocks] int
    seq_len,                  # valid tokens
    start_pos,                # absolute position of token 0
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    mesh=None,
) -> tuple[torch.Tensor, dict]:
    """Single-sequence prefill (the split prefill step).  Returns (the last
    valid token's logits [vocab] f32, cache); the cache is written in
    place.  Attention is the plain dense causal form in float32, as the
    reference computes it outside any Pallas kernel.  ``seq_len`` and
    ``start_pos`` are 0-d int tensors on the device (or ints): no length is
    read on the host (a captured step), and the pad rows write the dump row
    past the cache leaf.  ``mesh``: this rank's shard of the parameters
    (``shard_params``) and of the cache: its tp heads, its pp stage's
    layers (the stages run in turn, ``stage_layer_stack``; a later stage
    returns None for the logits, which reach stage 0), its sp chunk of the
    bucket (attention over the sp ring, ``ops.ring_attention``); every
    forward takes it alike."""
    off, chunk = _sp_chunk(token_ids.shape[0], mesh)
    x = _stage_input(lambda: _embed(params, shard_config(cfg, mesh),
                                    token_ids[off:off + chunk], mesh),
                     chunk, cfg, token_ids.device, mesh)
    return _prefill(params, cfg, x, kv_cache, block_ids, seq_len, start_pos, cos, sin, mesh)


def llama_forward_prefill_embeds(
    params: dict,
    cfg: LlamaConfig,
    input_embeds: torch.Tensor,  # [seq_pad, hidden] — e.g. image patches + text
    kv_cache: dict,
    block_ids: torch.Tensor,
    seq_len,
    start_pos,
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    mesh=None,
) -> tuple[torch.Tensor, dict]:
    """Prefill from precomputed input embeddings (a multimodal prompt:
    vision patch embeddings spliced before the text's token embeddings,
    LLaVA-style); the contract of ``llama_forward_prefill``."""
    off, chunk = _sp_chunk(input_embeds.shape[0], mesh)
    x = _stage_input(lambda: input_embeds[off:off + chunk].to(cfg.dtype), chunk, cfg,
                     input_embeds.device, mesh)
    return _prefill(params, cfg, x, kv_cache, block_ids, seq_len, start_pos, cos, sin, mesh)


def _prefill(params, cfg, x, kv_cache, block_ids, seq_len, start_pos, cos, sin, mesh):
    """The prefill's layers on this rank's rows ``x`` (its sp chunk, or the
    bucket), then the head on stage 0."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    _check_sp_window(cfg, mesh)
    sp = mesh_size(mesh, "sp") > 1
    s = x.shape[0]
    off = mesh.index("sp") * s if sp else 0
    positions = table_positions(start_pos + off + torch.arange(s, device=x.device), cos)
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    lens = torch.as_tensor(seq_len, device=x.device).reshape(1)

    def run_layers(x):
        for i, w in _layers(params):
            attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
            q, k, v = _qkv(attn_in, w, cfg)
            q = apply_rope(q, positions, cos, sin)
            k = apply_rope(k, positions, cos, sin)
            write_prefill_kv(k_all[i], v_all[i], *(_sp_kv(k, v, mesh) if sp else (k, v)),
                             block_ids, seq_len)
            with profiling.annotate("split_prefill_attention"):
                if sp:
                    attn = ring_attention(q[None], k[None], v[None], seq_len, mesh)[0]
                else:
                    attn = dense_causal_attention(
                        q[None], k[None], v[None], lens, sliding_window=cfg.sliding_window,
                    )[0]
            x = _residual_block(x, attn.reshape(s, -1), w, cfg, mesh)
        return x

    x = stage_layer_stack(run_layers, x, mesh)
    if not first_stage(mesh):
        return None, kv_cache
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(params, full_cfg, _sp_last_row(x, seq_len, off, mesh), mesh)[0].float(), \
        kv_cache


def llama_forward_prefill_with_prefix(
    params: dict,
    cfg: LlamaConfig,
    token_ids: torch.Tensor,       # [tail_pad] int — the uncached tail
    kv_cache: dict,
    full_block_ids: torch.Tensor,  # [table_len] int — whole table (prefix + tail)
    tail_block_ids: torch.Tensor,  # [table_len] int — table from the first tail block
    tail_len,                      # valid tail tokens
    start_pos,                     # resident prefix length (block-aligned)
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    mesh=None,
) -> tuple[torch.Tensor, dict]:
    """Continued prefill over a resident prefix (a prefix-cache hit or a
    later chunk of a chunked prefill): the tail's queries attend to the
    prefix K/V read from the paged cache plus themselves, and only the
    tail's K/V are written.  Returns (last tail token's logits [vocab] f32,
    cache).  Lengths and ``mesh`` as in ``llama_forward_prefill``; on an sp
    mesh the tail rings and each rank folds in the whole resident prefix
    (``ring_attention_with_prefix``)."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    _check_sp_window(cfg, mesh)
    off, s = _sp_chunk(token_ids.shape[0], mesh)
    sp = mesh_size(mesh, "sp") > 1
    x = _stage_input(lambda: _embed(params, cfg, token_ids[off:off + s], mesh), s, cfg,
                     token_ids.device, mesh)
    positions = table_positions(start_pos + off + torch.arange(s, device=x.device), cos)
    k_all, v_all = kv_cache["k"], kv_cache["v"]

    def run_layers(x):
        for i, w in _layers(params):
            attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
            q, k, v = _qkv(attn_in, w, cfg)
            q = apply_rope(q, positions, cos, sin)
            k = apply_rope(k, positions, cos, sin)
            # read the resident prefix BEFORE the tail is written
            k_prefix, v_prefix = gather_prefix_kv(k_all[i], v_all[i], full_block_ids)
            write_prefill_kv(k_all[i], v_all[i], *(_sp_kv(k, v, mesh) if sp else (k, v)),
                             tail_block_ids, tail_len)
            with profiling.annotate("split_prefill_attention"):
                if sp:
                    attn = ring_attention_with_prefix(
                        q[None], k[None], v[None], k_prefix[None], v_prefix[None], start_pos,
                        tail_len, mesh)[0]
                else:
                    attn = prefill_attention_with_prefix(
                        q, k, v, k_prefix, v_prefix, start_pos, tail_len,
                        sliding_window=cfg.sliding_window,
                    )
            x = _residual_block(x, attn.reshape(s, -1), w, cfg, mesh)
        return x

    x = stage_layer_stack(run_layers, x, mesh)
    if not first_stage(mesh):
        return None, kv_cache
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(params, full_cfg, _sp_last_row(x, tail_len, off, mesh), mesh)[0].float(), \
        kv_cache


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
    *,
    mesh=None,
) -> tuple[torch.Tensor, dict]:
    """Speculative verification: score all w window positions in one pass
    (logits [batch, w, vocab] f32).  The whole window's K/V is written like
    decode, sync-free (a slot named twice keeps its last position, as the
    reference's scatter does; pads and idle lanes write the dump row);
    attention is the paged window kernel at W = w — on a CPU tensor its
    plain version.  On a tp ``mesh`` the kernel runs on this rank's
    ``H / tp`` heads over its ``KVH / tp`` cache (the rows per kv head,
    W * H / KVH, are the model's), the residual tail as in decode; an sp
    rank verifies the whole window over its whole cache."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    b, w_len = token_ids.shape
    x = _embed(params, cfg, token_ids.reshape(-1), mesh)  # [b*w, hidden], batch-major
    positions = table_positions(
        context_lens[:, None] - w_len + torch.arange(w_len, device=x.device)[None, :], cos
    )  # [b, w]
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    k_rows, v_rows = cache_rows(k_all), cache_rows(v_all)
    rows = last_writer_rows(slot_ids.reshape(-1), k_all)
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for i, w in _layers(params):
        attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(attn_in, w, cfg)
        q = apply_rope(q.view(b, w_len, h, d), positions, cos, sin)
        k = apply_rope(k.view(b, w_len, kvh, d), positions, cos, sin)
        write_rows(k_rows, v_rows, rows[i], k.reshape(b * w_len, kvh, d), v)
        attn = paged_window_attention_decode(
            q, k_all[i], v_all[i], block_tables, context_lens,
            sliding_window=cfg.sliding_window,
        )
        x = _residual_block(x, attn.reshape(b * w_len, -1), w, cfg, mesh)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(params, full_cfg, x, mesh).view(b, w_len, -1).float(), kv_cache


def decode_layer(cfg: LlamaConfig, kv_cache: dict, cos, sin, mesh=None):
    """The decode's layer body, ``body(x, aux, i, w) -> x``: layer ``i`` on
    a batch of lanes ``x`` [b, hidden], ``aux`` = (positions [b, 1], cache
    rows [b, L] (``slot_rows`` transposed), block tables, context lengths)
    of those lanes; the K/V rows written in place, then row 2 at W = 1 over
    the layer's cache (on a tp mesh this rank's heads), then the residual
    tail.  ``cfg`` is the rank's (``shard_config``)."""
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    k_rows, v_rows = cache_rows(k_all), cache_rows(v_all)

    def body(x, aux, i, w):
        positions, rows, tables, lens = aux
        attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(attn_in, w, cfg)
        q = apply_rope(q[:, None], positions, cos, sin)[:, 0]
        k = apply_rope(k[:, None], positions, cos, sin)[:, 0]
        write_rows(k_rows, v_rows, rows[:, i], k, v)
        attn = paged_attention_decode(q, k_all[i], v_all[i], tables, lens,
                                      sliding_window=cfg.sliding_window)
        return _residual_block(x, attn.reshape(x.shape[0], -1), w, cfg, mesh)

    return body


def decode_aux(kv_cache: dict, block_tables, context_lens, slot_ids) -> tuple:
    """``decode_layer``'s per-lane side inputs: each lane's position, its
    cache row in every layer (idle lanes the dump row), table and length."""
    rows = slot_rows(slot_ids, kv_cache["k"]).T  # [b, L]
    return (context_lens - 1).clamp(min=0)[:, None], rows, block_tables, context_lens


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
    *,
    mesh=None,
    microbatches: int = 1,
) -> tuple[torch.Tensor, dict]:
    """Batched single-token decode.  Returns (logits [batch, vocab] f32,
    cache); the cache is written in place.  On a tp ``mesh`` row 2 runs on
    this rank's ``H / tp`` query heads over its ``KVH / tp`` kv-head cache:
    heads are kv-major, so a rank's contiguous chunk of query heads is the
    group of its kv heads (the reference's shard_map, llama.py:506-536).
    On a pp mesh the batch goes through the stages in ``microbatches``
    (``parallel.pipeline``; 1: the stages in turn), the head on stage 0 (a
    later stage returns None for the logits)."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    b = token_ids.shape[0]
    x = _stage_input(lambda: _embed(params, cfg, token_ids, mesh), b, cfg, token_ids.device,
                     mesh)
    x = pipeline_layer_stack(decode_layer(cfg, kv_cache, cos, sin, mesh), x,
                             decode_aux(kv_cache, block_tables, context_lens, slot_ids),
                             params["layers"], mesh, microbatches=microbatches)
    if not first_stage(mesh):
        return None, kv_cache
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(params, full_cfg, x, mesh).float(), kv_cache


def llama_forward_decode_pp(params: dict, cfg: LlamaConfig, token_ids, kv_cache, block_tables,
                            context_lens, slot_ids, cos, sin, *, mesh=None,
                            microbatches: int | None = None) -> tuple[torch.Tensor, dict]:
    """Batched decode with the layer stack pipelined over the pp axis
    (the reference's ``llama_forward_decode_pp``): the lanes split into
    ``microbatches`` (default pp) that stream through the stages, each
    stage running the decode layer (row 2 on the microbatch's lanes) over
    its layers' cache.  Equal to ``llama_forward_decode``: the same layer
    body on the same rows."""
    return llama_forward_decode(params, cfg, token_ids, kv_cache, block_tables, context_lens,
                                slot_ids, cos, sin, mesh=mesh,
                                microbatches=microbatches or mesh_size(mesh, "pp"))


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


def unified_max_tb(cfg: LlamaConfig) -> int:
    """The largest token block the ragged GQA kernel takes: ``tb x H/KVH``
    query rows a kv head, at most ``MAX_ROWS``."""
    return ragged_attention.MAX_ROWS // max(1, cfg.num_heads // cfg.num_kv_heads)


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


def load_hf_weights(cfg: LlamaConfig, model_dir: str | Path, device="cuda", *,
                    tensors: dict | None = None) -> dict:
    """Load and stack HF llama safetensors into the layer-stacked dict on
    ``device`` (HF stores projections [out, in]; ours are [in, out]).
    ``tensors`` stands in for the read of ``model_dir`` where a loader
    rewrites the checkpoint first (phi3 splits its fused tensors)."""
    if tensors is None:
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


# ---------------------------------------------------------------------------
# Checkpoint quirks of the llama-geometry variants (phi3, gemma)
# ---------------------------------------------------------------------------


def phi3_config_from_hf(config: dict | str | Path) -> LlamaConfig:
    """Phi-3: llama math with fused checkpoint tensors (split by
    ``phi3_load_hf_weights``) and an always-on sliding window.  The 128k
    "longrope" variants are refused by name: ``ops/rope.py`` has no
    longrope schedule."""
    if not isinstance(config, dict):
        config = json.loads(Path(config).read_text())
    scaling = config.get("rope_scaling") or {}
    kind = scaling.get("rope_type") or scaling.get("type")
    if kind in ("longrope", "su"):
        raise NotImplementedError(
            "phi3 longrope scaling is not implemented; the 4k-context "
            "variants (rope_scaling: null) are supported"
        )
    return LlamaConfig.from_hf_config(config)


def phi3_load_hf_weights(cfg: LlamaConfig, model_dir: str | Path, device="cuda") -> dict:
    """Split Phi-3's fused ``qkv_proj`` [q+k+v, h] and ``gate_up_proj``
    [2i, h] into the per-projection names, then load as llama."""
    from dynamo_tpu_torch.models.hf_io import read_safetensors

    tensors = dict(read_safetensors(model_dir))
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    inter = cfg.intermediate_size
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        qkv = tensors.pop(f"{p}.self_attn.qkv_proj.weight")
        tensors[f"{p}.self_attn.q_proj.weight"] = qkv[:qd]
        tensors[f"{p}.self_attn.k_proj.weight"] = qkv[qd: qd + kvd]
        tensors[f"{p}.self_attn.v_proj.weight"] = qkv[qd + kvd:]
        gate_up = tensors.pop(f"{p}.mlp.gate_up_proj.weight")
        tensors[f"{p}.mlp.gate_proj.weight"] = gate_up[:inter]
        tensors[f"{p}.mlp.up_proj.weight"] = gate_up[inter:]
    return load_hf_weights(cfg, model_dir, device, tensors=tensors)


def gemma_config_from_hf(config: dict | str | Path) -> LlamaConfig:
    """Gemma-1: the llama skeleton with a GeGLU MLP, a sqrt(hidden) input
    embedding scale and (1 + w) RMSNorm weights (baked in by
    ``gemma_load_hf_weights``); the embedding is always tied."""
    if not isinstance(config, dict):
        config = json.loads(Path(config).read_text())
    act = config.get("hidden_activation") or config.get("hidden_act") or "gelu_pytorch_tanh"
    if act not in ("gelu", "gelu_pytorch_tanh"):
        raise ValueError(f"unexpected gemma activation {act!r}")
    return dataclasses.replace(
        LlamaConfig.from_hf_config(config),
        tie_word_embeddings=True,
        mlp_activation="gelu_tanh",
        embed_scale=float(config["hidden_size"]) ** 0.5,
    )


def plus_one(t: torch.Tensor) -> torch.Tensor:
    """A gemma RMSNorm weight ``w`` as the ``1 + w`` it multiplies by,
    added in float32 and cast back."""
    return (t.float() + 1.0).to(t.dtype)


def gemma_load_hf_weights(cfg: LlamaConfig, model_dir: str | Path, device="cuda") -> dict:
    """Gemma checkpoints store RMSNorm weights as w, applied as (1 + w):
    the +1 is baked in once so every forward runs unchanged."""
    params = load_hf_weights(cfg, model_dir, device)
    layers = dict(params["layers"])
    layers["attn_norm"] = plus_one(layers["attn_norm"])
    layers["mlp_norm"] = plus_one(layers["mlp_norm"])
    return {**params, "layers": layers, "final_norm": plus_one(params["final_norm"])}
