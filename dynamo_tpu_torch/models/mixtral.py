"""Mixtral-class sparse-MoE model in PyTorch (counterpart of
dynamo_tpu/models/mixtral.py): Mixtral-8x7B and Qwen3-MoE geometries.

The attention trunk is the llama family's (``models/llama.py``: the same
parameter names, paged cache and kernels, and Qwen3-MoE's per-head q/k
RMSNorm); the dense MLP is the top-k routed-expert FFN of ``ops/moe.py``
(``w_router [L, h, E]``, expert banks ``w_gate``/``w_up`` ``[L, E, h, i]``
and ``w_down [L, E, i, h]``).  The unified, decode and verify forwards
attend through the kernel wrappers of ``ops.kernels`` (rows 1 and 2: on a
CUDA tensor the hand-written kernels, on a CPU tensor their plain
versions); the split prefill forwards attend densely in float32, as the
reference does outside any Pallas kernel.

Expert capacity is ``max(1, int(t * k / E * capacity_factor))`` over the
padded token count ``t``: pad rows route too and may take slots, as in the
reference, so every forward routes exactly the rows the reference routes,
in the same order.  The verify window runs position-major (index =
position * lanes + lane), the reference's dispatch order, so the
always-emitted position-0 tokens never lose a slot to a draft position.
The family has no sliding-window mask: a windowed checkpoint is refused.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import torch

from dynamo_tpu_torch.models.llama import (
    LlamaConfig,
    _layers,
    _logits,
    _qkv,
    _stage_input,
    decode_aux,
    leaf_sink,
    param_init,
    params_from_jax,  # noqa: F401 — the reference's pytree as port parameters
)
from dynamo_tpu_torch.models.llama import shard_params as llama_shard_params
from dynamo_tpu_torch.ops.attention import (
    cache_rows,
    dense_causal_attention,
    gather_prefix_kv,
    last_valid_row,
    last_writer_rows,
    position_major_to_batch,
    prefill_attention_with_prefix,
    slot_rows,
    write_prefill_kv,
    write_rows,
)
from dynamo_tpu_torch.ops.kernels import (
    paged_attention_decode,
    paged_window_attention_decode,
    ragged_paged_attention,
)
from dynamo_tpu_torch.ops.moe import moe_ffn
from dynamo_tpu_torch.ops.norms import rms_norm
from dynamo_tpu_torch.ops.quant import mm
from dynamo_tpu_torch.ops.rope import apply_rope, table_positions
from dynamo_tpu_torch.parallel.mesh import all_reduce, mesh_size, shard_config
from dynamo_tpu_torch.parallel.pipeline import (
    first_stage,
    pipeline_layer_stack,
    stage_layer_stack,
    stage_specs,
)
from dynamo_tpu_torch.utils import profiling


@dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 2.0
    # expert FFN width; 0 = intermediate_size (Mixtral).  Qwen3-MoE
    # configs carry their own moe_intermediate_size
    moe_intermediate_size: int = 0
    # renormalize the top-k router weights (Mixtral yes; some Qwen3-MoE
    # variants no)
    norm_topk_prob: bool = True

    def __post_init__(self):
        # no mixtral-family forward masks a window: refuse one rather than
        # run full attention in its place
        if self.sliding_window is not None:
            raise NotImplementedError("mixtral-family attention has no sliding-window mask")

    @property
    def expert_intermediate_size(self) -> int:
        return self.moe_intermediate_size or self.intermediate_size

    @classmethod
    def mixtral_8x7b(cls) -> "MixtralConfig":
        return cls(
            vocab_size=32_000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            max_position_embeddings=32768, rope_theta=1e6,
            num_experts=8, experts_per_token=2,
        )

    @classmethod
    def tiny_moe(cls, vocab_size: int = 512) -> "MixtralConfig":
        """Test geometry: 2 layers, 4 experts top-2, float32."""
        return cls(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=96,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position_embeddings=2048, rope_theta=10000.0,
            tie_word_embeddings=True, dtype=torch.float32,
            num_experts=4, experts_per_token=2, capacity_factor=4.0,
        )

    @classmethod
    def from_hf_config(cls, config: dict | str | Path) -> "MixtralConfig":
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
            rope_theta=config.get("rope_theta", 1e6),
            num_experts=config.get("num_local_experts", 0) or config.get("num_experts", 8),
            experts_per_token=config.get("num_experts_per_tok", 2),
            moe_intermediate_size=config.get("moe_intermediate_size", 0) or 0,
            norm_topk_prob=config.get("norm_topk_prob", True),
            tie_word_embeddings=config.get("tie_word_embeddings", False),
            rope_scaling=config.get("rope_scaling"),
            qk_norm=config.get("qk_norm", config.get("model_type") == "qwen3_moe"),
            # HF's use_sliding_window / max_window_layers semantics: a
            # really windowed MoE checkpoint meets the __post_init__ refusal
            sliding_window=cls._resolve_sliding_window(config),
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: MixtralConfig, generator: torch.Generator, device="cuda",
                shard=None) -> dict:
    """Random-init parameters on ``device`` from ``generator`` (on the same
    device): N(0, 1) / sqrt(fan_in) in float32 a layer at a time, cast to
    the model dtype; the reference's names and layouts.  ``shard`` as in
    ``llama.init_params``."""
    h, i, n_layers, e = (cfg.hidden_size, cfg.expert_intermediate_size, cfg.num_layers,
                         cfg.num_experts)
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
        ("w_router", lambda: normal((n_layers, h, e), h)),
        ("w_gate", lambda: normal((n_layers, e, h, i), h)),
        ("w_up", lambda: normal((n_layers, e, h, i), h)),
        ("w_down", lambda: normal((n_layers, e, i, h), i)),
    ):
        put(("layers", name), make())
    if cfg.qk_norm:
        put(("layers", "q_norm"), ones((n_layers, cfg.head_dim)))
        put(("layers", "k_norm"), ones((n_layers, cfg.head_dim)))
    if not cfg.tie_word_embeddings:
        put(("lm_head",), normal((h, cfg.vocab_size), h))
    return params


def param_specs(cfg: MixtralConfig) -> dict:
    """The reference's (dynamo_tpu/models/mixtral.py:154): experts over
    ep, each expert's FFN width over tp, attention head-sharded over tp as
    in the llama family; the embedding and the router replicated."""
    specs = {
        "embed": (None, None),
        "final_norm": (None,),
        "layers": {
            "attn_norm": (None, None),
            "wq": (None, None, "tp"),
            "wk": (None, None, "tp"),
            "wv": (None, None, "tp"),
            "wo": (None, "tp", None),
            "mlp_norm": (None, None),
            "w_router": (None, None, None),
            "w_gate": (None, "ep", None, "tp"),
            "w_up": (None, "ep", None, "tp"),
            "w_down": (None, "ep", "tp", None),
        },
    }
    if cfg.qk_norm:
        specs["layers"]["q_norm"] = (None, None)
        specs["layers"]["k_norm"] = (None, None)
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, "tp")
    return specs


def shard_params(params: dict, cfg: MixtralConfig, mesh) -> dict:
    """This rank's slice of every leaf under ``param_specs``, a pp stage
    keeping its own layers (``stage_specs``)."""
    return llama_shard_params(params, cfg, mesh, stage_specs(param_specs(cfg), mesh))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed(params, cfg: MixtralConfig, token_ids) -> torch.Tensor:
    return params["embed"][token_ids].to(cfg.dtype)


def _block(cfg: MixtralConfig, w, x, attn, mesh=None, *, capacity_scale: float = 1.0):
    """The layer's residual tail: the attention output ``attn`` [t, H*D]
    through ``wo`` (row-parallel on a tp mesh: summed over tp), then the
    routed-expert FFN on the normed residual (on a mesh each rank's experts
    and FFN slice, summed over ep and tp in ``moe_ffn``).
    ``capacity_scale``: a caller that routes a slice of the batch (the
    pipelined decode routes each microbatch) scales the capacity factor by
    the slices, as the reference's (mixtral.py:181)."""
    x = x + all_reduce(mm(attn, w["wo"]), mesh)
    mlp_in = rms_norm(x, w["mlp_norm"], cfg.rms_norm_eps)
    return x + moe_ffn(
        mlp_in, w["w_router"], w["w_gate"], w["w_up"], w["w_down"],
        top_k=cfg.experts_per_token, capacity_factor=cfg.capacity_factor * capacity_scale,
        norm_topk_prob=cfg.norm_topk_prob, num_experts=cfg.num_experts, mesh=mesh,
    )


def _roped_qkv(x, w, cfg: MixtralConfig, positions, cos, sin):
    attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
    q, k, v = _qkv(attn_in, w, cfg)
    return apply_rope(q, positions, cos, sin), apply_rope(k, positions, cos, sin), v


def mixtral_forward_prefill(
    params: dict,
    cfg: MixtralConfig,
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
    """Single-sequence prefill (the split prefill step): the llama contract
    (``llama_forward_prefill``, ``mesh`` included), the experts routing
    every row of the padded chunk.  Returns (the last valid token's logits
    [vocab] f32, cache); the cache is written in place."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    s = token_ids.shape[0]
    x = _stage_input(lambda: _embed(params, cfg, token_ids), s, cfg, token_ids.device, mesh)
    positions = table_positions(start_pos + torch.arange(s, device=x.device), cos)
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    lens = torch.as_tensor(seq_len, device=x.device).reshape(1)

    def run_layers(x):
        for i, w in _layers(params):
            q, k, v = _roped_qkv(x, w, cfg, positions, cos, sin)
            write_prefill_kv(k_all[i], v_all[i], k, v, block_ids, seq_len)
            with profiling.annotate("split_prefill_attention"):
                attn = dense_causal_attention(q[None], k[None], v[None], lens)[0]
            x = _block(cfg, w, x, attn.reshape(s, -1), mesh)
        return x

    x = stage_layer_stack(run_layers, x, mesh)
    if not first_stage(mesh):
        return None, kv_cache
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(params, full_cfg, last_valid_row(x, seq_len), mesh)[0].float(), kv_cache


def mixtral_forward_prefill_with_prefix(
    params: dict,
    cfg: MixtralConfig,
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
    """Continued prefill over a resident prefix (the llama contract): the
    tail's queries attend to the prefix read from the cache plus
    themselves; the experts see the tail's rows only."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    s = token_ids.shape[0]
    x = _stage_input(lambda: _embed(params, cfg, token_ids), s, cfg, token_ids.device, mesh)
    positions = table_positions(start_pos + torch.arange(s, device=x.device), cos)
    k_all, v_all = kv_cache["k"], kv_cache["v"]

    def run_layers(x):
        for i, w in _layers(params):
            q, k, v = _roped_qkv(x, w, cfg, positions, cos, sin)
            # read the resident prefix BEFORE the tail is written
            k_prefix, v_prefix = gather_prefix_kv(k_all[i], v_all[i], full_block_ids)
            write_prefill_kv(k_all[i], v_all[i], k, v, tail_block_ids, tail_len)
            with profiling.annotate("split_prefill_attention"):
                attn = prefill_attention_with_prefix(q, k, v, k_prefix, v_prefix, start_pos,
                                                     tail_len)
            x = _block(cfg, w, x, attn.reshape(s, -1), mesh)
        return x

    x = stage_layer_stack(run_layers, x, mesh)
    if not first_stage(mesh):
        return None, kv_cache
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(params, full_cfg, last_valid_row(x, tail_len), mesh)[0].float(), kv_cache


def mixtral_forward_decode(
    params: dict,
    cfg: MixtralConfig,
    token_ids: torch.Tensor,     # [batch] int — last sampled token per seq
    kv_cache: dict,
    block_tables: torch.Tensor,  # [batch, max_blocks] int32
    context_lens: torch.Tensor,  # [batch] int32 length INCLUDING this token
    slot_ids: torch.Tensor,      # [batch] int32 flat cache slot for this token
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    mesh=None,
) -> tuple[torch.Tensor, dict]:
    """Batched single-token decode: row 2 at W = 1 (on a tp mesh on this
    rank's heads).  Returns (logits [batch, vocab] f32, cache); idle lanes
    route through the experts too, as the reference's do.  On a pp mesh
    the stages run in turn (``mixtral_forward_decode_pp`` pipelines them),
    the head on stage 0 (a later stage returns None for the logits)."""
    return _decode(params, cfg, token_ids, kv_cache, block_tables, context_lens, slot_ids,
                   cos, sin, mesh, 1)


def mixtral_forward_decode_pp(params: dict, cfg: MixtralConfig, token_ids, kv_cache,
                              block_tables, context_lens, slot_ids, cos, sin, *, mesh=None,
                              microbatches: int | None = None) -> tuple[torch.Tensor, dict]:
    """Batched MoE decode with the layer stack pipelined over the pp axis
    (the reference's ``mixtral_forward_decode_pp``), the experts of each
    stage over ep.  Routing runs per microbatch with the capacity factor
    scaled by the microbatch count, so each microbatch drops what the
    reference's microbatch drops (equal to the plain decode wherever
    nothing is dropped)."""
    return _decode(params, cfg, token_ids, kv_cache, block_tables, context_lens, slot_ids,
                   cos, sin, mesh, microbatches or mesh_size(mesh, "pp"))


def _decode(params, cfg, token_ids, kv_cache, block_tables, context_lens, slot_ids, cos, sin,
            mesh, microbatches: int):
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    b = token_ids.shape[0]
    x = _stage_input(lambda: _embed(params, cfg, token_ids), b, cfg, token_ids.device, mesh)
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    k_rows, v_rows = cache_rows(k_all), cache_rows(v_all)

    def body(x, aux, i, w):
        positions, rows, tables, lens = aux
        attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(attn_in, w, cfg)
        q = apply_rope(q[:, None], positions, cos, sin)[:, 0]
        k = apply_rope(k[:, None], positions, cos, sin)[:, 0]
        write_rows(k_rows, v_rows, rows[:, i], k, v)
        attn = paged_attention_decode(q, k_all[i], v_all[i], tables, lens)
        return _block(cfg, w, x, attn.reshape(x.shape[0], -1), mesh,
                      capacity_scale=float(microbatches))

    x = pipeline_layer_stack(body, x, decode_aux(kv_cache, block_tables, context_lens, slot_ids),
                             params["layers"], mesh, microbatches=microbatches)
    if not first_stage(mesh):
        return None, kv_cache
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(params, full_cfg, x, mesh).float(), kv_cache


def mixtral_forward_unified(
    params: dict,
    cfg: MixtralConfig,
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
    """Ragged unified-batch forward (the llama unified contract, row 1 with
    its work ``plan``) with the dense MLP swapped for the routed experts.
    Routing is per token, so it composes with the ragged layout; the pad
    rows of the token bucket route too and are dropped at the sample
    gather.  Logits [lanes, vocab] f32 (junk for lanes without tokens)."""
    t = token_ids.shape[0]
    x = _embed(params, cfg, token_ids)
    positions = token_pos.clamp(min=0)  # pads rope at position 0
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    k_rows, v_rows = cache_rows(k_all), cache_rows(v_all)
    rows = slot_rows(token_slot, k_all)  # pad tokens write the dump row
    for i, w in _layers(params):
        q, k, v = _roped_qkv(x, w, cfg, positions, cos, sin)
        # every token writes before any reads: a span's tokens see their
        # predecessors through the cache
        write_rows(k_rows, v_rows, rows[i], k, v)
        attn = ragged_paged_attention(
            q, k_all[i], v_all[i], block_tables, token_lane, token_pos,
            page_phys, page_lane, page_ord, page_count,
            tb_tokens=tb_tokens, pages_per_step=pages_per_step, plan=plan,
        )
        x = _block(cfg, w, x, attn.reshape(t, -1))
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(params, cfg, x[sample_rows]).float(), kv_cache


def mixtral_forward_verify(
    params: dict,
    cfg: MixtralConfig,
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
    """Speculative verification (the llama contract): logits [batch, w,
    vocab] f32, attention through row 2 at W = w.  The window's b * w
    tokens run position-major through the trunk, so the experts give the
    position-0 tokens capacity first, as the reference does.  On a tp
    ``mesh`` row 2 runs on this rank's heads; on ep each rank's experts,
    the capacity from the global token and expert counts (``moe_ffn``)."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    b, w_len = token_ids.shape
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = _embed(params, cfg, token_ids.t().reshape(-1))  # [w*b, hidden] position-major
    positions = table_positions(
        context_lens[:, None] - w_len + torch.arange(w_len, device=x.device)[None, :], cos
    )  # [b, w]
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    k_rows, v_rows = cache_rows(k_all), cache_rows(v_all)
    rows = last_writer_rows(slot_ids.t().reshape(-1), k_all)
    for i, w in _layers(params):
        attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(attn_in, w, cfg)
        q = apply_rope(position_major_to_batch(q, w_len, b, h, d), positions, cos, sin)
        k = apply_rope(position_major_to_batch(k, w_len, b, kvh, d), positions, cos, sin)
        write_rows(k_rows, v_rows, rows[i], k.transpose(0, 1).reshape(w_len * b, kvh, d), v)
        attn = paged_window_attention_decode(q, k_all[i], v_all[i], block_tables,
                                             context_lens)  # [b, w, H, D]
        x = _block(cfg, w, x, attn.transpose(0, 1).reshape(w_len * b, -1), mesh)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = _logits(params, full_cfg, x, mesh).view(w_len, b, -1).transpose(0, 1)
    return logits.float(), kv_cache


# ---------------------------------------------------------------------------
# HF weight loading (safetensors)
# ---------------------------------------------------------------------------


def load_hf_weights(cfg: MixtralConfig, model_dir: str | Path, device="cuda") -> dict:
    """Load HF Mixtral or Qwen3-MoE safetensors into the layer-stacked dict
    on ``device``: projections transpose to [in, out], experts stack on an
    E axis.  Mixtral names its experts ``block_sparse_moe.experts.{e}.w1``
    (gate), ``w3`` (up), ``w2`` (down); Qwen3-MoE ``mlp.experts.{e}.
    gate_proj`` / ``up_proj`` / ``down_proj``.  Each stacked leaf is
    allocated once and filled layer by layer."""
    from dynamo_tpu_torch.models.hf_io import read_safetensors

    tensors = read_safetensors(model_dir)

    def get(name: str, transpose: bool = False) -> torch.Tensor:
        t = tensors[name]
        return t.T if transpose else t

    def leaves(i: int) -> dict:
        p = f"model.layers.{i}"
        out = {
            "attn_norm": get(f"{p}.input_layernorm.weight"),
            "wq": get(f"{p}.self_attn.q_proj.weight", True),
            "wk": get(f"{p}.self_attn.k_proj.weight", True),
            "wv": get(f"{p}.self_attn.v_proj.weight", True),
            "wo": get(f"{p}.self_attn.o_proj.weight", True),
            "mlp_norm": get(f"{p}.post_attention_layernorm.weight"),
        }
        if cfg.qk_norm:
            out["q_norm"] = get(f"{p}.self_attn.q_norm.weight")
            out["k_norm"] = get(f"{p}.self_attn.k_norm.weight")
        if f"{p}.block_sparse_moe.gate.weight" in tensors:
            moe, names = f"{p}.block_sparse_moe", ("w1", "w3", "w2")
        else:
            moe, names = f"{p}.mlp", ("gate_proj", "up_proj", "down_proj")
        out["w_router"] = get(f"{moe}.gate.weight", True)
        for ours, theirs in zip(("w_gate", "w_up", "w_down"), names):
            out[ours] = torch.stack([get(f"{moe}.experts.{e}.{theirs}.weight", True)
                                     for e in range(cfg.num_experts)])
        return out

    layers: dict[str, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        for name, leaf in leaves(i).items():
            if name not in layers:
                layers[name] = torch.empty((cfg.num_layers, *leaf.shape), dtype=cfg.dtype,
                                           device=device)
            layers[name][i].copy_(leaf)

    def whole(name: str, transpose: bool = False) -> torch.Tensor:
        return get(name, transpose).to(device=device, dtype=cfg.dtype).contiguous()

    params = {"embed": whole("model.embed_tokens.weight"),
              "final_norm": whole("model.norm.weight"), "layers": layers}
    if not cfg.tie_word_embeddings and "lm_head.weight" in tensors:
        params["lm_head"] = whole("lm_head.weight", True)
    return params
