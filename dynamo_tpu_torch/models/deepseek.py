"""DeepSeek-V2/V3 in PyTorch: Multi-head Latent Attention (MLA) and
fine-grained MoE (counterpart of dynamo_tpu/models/deepseek.py).

The KV cache stores only the compressed latent per token, in the engine's
``{"k", "v"}`` layout with two widths:

    k: [layers, num_blocks, block_size, 1, kv_lora_rank]     (latent c_kv)
    v: [layers, num_blocks, block_size, 1, qk_rope_head_dim] (roped key)

Attention runs in latent space ("absorbed" form): q_nope folds through the
K up-projection once per step, scores are taken against the latent cache
directly, and the float32 context is decompressed through the V
up-projection afterwards.  The unified ragged step, the decode step and the
speculative verify window go through the MLA kernel wrappers in
``ops.kernels``: on a CUDA tensor they launch the hand-written kernels, on a
CPU tensor they take the plain versions in ``ops.attention``.  The split
prefill forwards decompress the chunk's own keys and values and attend
densely in float32 (prefill is compute-bound), reading a resident prefix in
latent space, as the reference does outside any Pallas kernel.  The verify
window runs position-major (index = position * lanes + lane), the
reference's order, which gives position-0 tokens expert-capacity priority
in the MoE layers.  The trunk is ``first_k_dense`` dense layers
then MoE layers (routed experts times ``routed_scaling_factor``, plus shared
experts).  Parameters are a plain dict with the reference's names and
layouts (``dense_layers`` and ``moe_layers`` stacks, projections [in, out]);
the leaves of ``QUANT_LEAVES`` may be int8 ``QuantizedMatrix`` weights
(``ops.quant``); the cache, which may hold a narrower float dtype than the
model's, is updated in place.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops.attention import (
    NEG_INF,
    alloc_cache_leaf,
    cache_rows,
    cache_take,
    last_valid_row,
    last_writer_rows,
    position_major_to_batch,
    slot_rows,
    write_prefill_kv,
    write_rows,
)
from dynamo_tpu_torch.ops.kernels import (
    mla_attention,
    mla_paged_attention_decode,
    mla_paged_window_attention_decode,
    ragged_mla_attention,
)
from dynamo_tpu_torch.models.llama import leaf_sink
from dynamo_tpu_torch.ops.kernels.common import sm_count
from dynamo_tpu_torch.ops.moe import moe_ffn
from dynamo_tpu_torch.ops.norms import rms_norm
from dynamo_tpu_torch.ops.quant import mm

# the projections and expert banks the engine's quantize="int8" stores as
# int8 (dynamo_tpu/models/registry.py:285-288); the absorbed up-projections
# w_uk and w_uv stay full precision (they are reshaped into float32 einsums),
# and so do the router, the norms and the embedding
QUANT_LEAVES = (
    "w_dq", "w_uq", "wq", "w_dkv", "wo", "w_gate", "w_up", "w_down",
    "ws_gate", "ws_up", "ws_down", "lm_head",
)
from dynamo_tpu_torch.ops.rope import apply_rope, rope_table, table_positions, yarn_mscale
from dynamo_tpu_torch.parallel.mesh import all_gather, all_reduce, shard_config


@dataclass(frozen=True)
class DeepseekConfig:
    vocab_size: int = 102400
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    # MLA geometry
    q_lora_rank: int = 0              # 0 = direct q projection (V2-Lite)
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # FFN geometry
    intermediate_size: int = 10944    # dense layers
    first_k_dense: int = 1            # leading dense (non-MoE) layers
    moe_intermediate_size: int = 1408  # per routed expert
    num_experts: int = 64
    experts_per_token: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 1.0
    capacity_factor: float = 2.0
    # V3/R1 aux-free routing: sigmoid scores + e_score_correction_bias +
    # group-limited top-k; V2 uses softmax
    scoring_func: str = "softmax"     # "softmax" | "sigmoid"
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    max_position_embeddings: int = 163840
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # HF rope_scaling dict; "yarn" also corrects the softmax temperature
    # (attn_scale)
    rope_scaling: Any = None
    tie_word_embeddings: bool = False
    dtype: Any = torch.bfloat16

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def attn_scale(self) -> float:
        m = yarn_mscale(self.rope_scaling)
        return (self.qk_head_dim ** -0.5) * m * m

    @property
    def num_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense

    @classmethod
    def from_hf_config(cls, config: dict | str | Path) -> "DeepseekConfig":
        if not isinstance(config, dict):
            config = json.loads(Path(config).read_text())
        return cls(
            vocab_size=config["vocab_size"],
            hidden_size=config["hidden_size"],
            num_layers=config["num_hidden_layers"],
            num_heads=config["num_attention_heads"],
            q_lora_rank=config.get("q_lora_rank") or 0,
            kv_lora_rank=config["kv_lora_rank"],
            qk_nope_head_dim=config["qk_nope_head_dim"],
            qk_rope_head_dim=config["qk_rope_head_dim"],
            v_head_dim=config["v_head_dim"],
            intermediate_size=config["intermediate_size"],
            first_k_dense=config.get("first_k_dense_replace", 0),
            moe_intermediate_size=config.get("moe_intermediate_size", 0)
            or config["intermediate_size"],
            num_experts=config.get("n_routed_experts", 0) or 1,
            experts_per_token=config.get("num_experts_per_tok", 1) or 1,
            n_shared_experts=config.get("n_shared_experts", 0) or 0,
            routed_scaling_factor=config.get("routed_scaling_factor", 1.0),
            scoring_func=config.get("scoring_func", "softmax"),
            n_group=config.get("n_group", 1) or 1,
            topk_group=config.get("topk_group", 1) or 1,
            norm_topk_prob=config.get("norm_topk_prob", True),
            max_position_embeddings=config.get("max_position_embeddings", 4096),
            rms_norm_eps=config.get("rms_norm_eps", 1e-6),
            rope_theta=config.get("rope_theta", 10000.0),
            rope_scaling=config.get("rope_scaling"),
            tie_word_embeddings=config.get("tie_word_embeddings", False),
        )

    # --- presets (copied from the reference as they are) -----------------
    @classmethod
    def deepseek_v2_lite(cls) -> "DeepseekConfig":
        return cls()  # the defaults above are the 16B V2-Lite geometry

    @classmethod
    def deepseek_v3(cls) -> "DeepseekConfig":
        """671B/R1 geometry (config shape only; serving it needs many cards)."""
        return cls(
            vocab_size=129280, hidden_size=7168, num_layers=61, num_heads=128,
            q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
            qk_rope_head_dim=64, v_head_dim=128, intermediate_size=18432,
            first_k_dense=3, moe_intermediate_size=2048, num_experts=256,
            experts_per_token=8, n_shared_experts=1, routed_scaling_factor=2.5,
            scoring_func="sigmoid", n_group=8, topk_group=4,
        )

    @classmethod
    def tiny_mla(cls, vocab_size: int = 512) -> "DeepseekConfig":
        """Test geometry: q-lora, a dense and two MoE layers, float32."""
        return cls(
            vocab_size=vocab_size, hidden_size=64, num_layers=3, num_heads=4,
            q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
            first_k_dense=1, moe_intermediate_size=48, num_experts=4,
            experts_per_token=2, n_shared_experts=1, capacity_factor=4.0,
            max_position_embeddings=2048, tie_word_embeddings=True,
            dtype=torch.float32,
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: DeepseekConfig, generator: torch.Generator, device="cuda",
                shard=None) -> dict:
    """Random-init parameters on ``device`` from ``generator`` (which must
    live on the same device): N(0, 1) / sqrt(fan_in) drawn in float32 one
    [in, out] slice at a time, then cast to the model dtype, so the
    [layers, experts, in, out] expert banks never exist in float32 whole.
    ``shard(path, leaf)`` (optional) replaces each leaf as soon as it is
    drawn (``llama.init_params``)."""
    h = cfg.hidden_size
    kd, km = cfg.first_k_dense, cfg.num_moe_layers

    def normal(shape, fan_in):
        out = torch.empty(shape, dtype=cfg.dtype, device=device)
        for m in out.view(-1, *shape[-2:]):
            tmp = torch.empty(m.shape, dtype=torch.float32, device=device)
            tmp.normal_(generator=generator)
            m.copy_(tmp / math.sqrt(fan_in))
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    def attn(n):
        hd_q = cfg.num_heads * cfg.qk_head_dim
        r = cfg.kv_lora_rank
        yield "attn_norm", lambda: ones((n, h))
        yield "w_dkv", lambda: normal((n, h, r + cfg.qk_rope_head_dim), h)
        yield "kv_norm", lambda: ones((n, r))
        yield "w_uk", lambda: normal((n, r, cfg.num_heads * cfg.qk_nope_head_dim), r)
        yield "w_uv", lambda: normal((n, r, cfg.num_heads * cfg.v_head_dim), r)
        yield "wo", lambda: normal((n, cfg.num_heads * cfg.v_head_dim, h),
                                   cfg.num_heads * cfg.v_head_dim)
        yield "mlp_norm", lambda: ones((n, h))
        if cfg.q_lora_rank:
            yield "w_dq", lambda: normal((n, h, cfg.q_lora_rank), h)
            yield "q_norm", lambda: ones((n, cfg.q_lora_rank))
            yield "w_uq", lambda: normal((n, cfg.q_lora_rank, hd_q), cfg.q_lora_rank)
        else:
            yield "wq", lambda: normal((n, h, hd_q), h)

    def dense(n):
        i = cfg.intermediate_size
        yield from attn(n)
        yield "w_gate", lambda: normal((n, h, i), h)
        yield "w_up", lambda: normal((n, h, i), h)
        yield "w_down", lambda: normal((n, i, h), i)

    def moe(n):
        mi, e = cfg.moe_intermediate_size, cfg.num_experts
        si = cfg.n_shared_experts * mi
        yield from attn(n)
        yield "w_router", lambda: normal((n, h, e), h)
        yield "w_gate", lambda: normal((n, e, h, mi), h)
        yield "w_up", lambda: normal((n, e, h, mi), h)
        yield "w_down", lambda: normal((n, e, mi, h), mi)
        if cfg.scoring_func == "sigmoid":
            yield "router_bias", lambda: torch.zeros((n, e), dtype=torch.float32, device=device)
        if si:
            yield "ws_gate", lambda: normal((n, h, si), h)
            yield "ws_up", lambda: normal((n, h, si), h)
            yield "ws_down", lambda: normal((n, si, h), si)

    params, put = leaf_sink(shard)
    put(("embed",), normal((cfg.vocab_size, h), 1.0))
    put(("final_norm",), ones((h,)))
    for stack, n, leaves in (("dense_layers", kd, dense), ("moe_layers", km, moe)):
        if n:
            for name, make in leaves(n):
                put((stack, name), make())
    if not cfg.tie_word_embeddings:
        put(("lm_head",), normal((h, cfg.vocab_size), h))
    return params


def _attn_specs(cfg: DeepseekConfig) -> dict:
    """The attention leaves' specs (the reference's deepseek.py:259): the
    latent path (``w_dkv``, the latent cache) replicated, the query and the
    K and V up-projections head-sharded over tp, ``wo`` row-parallel."""
    specs = {
        "attn_norm": (None, None),
        "w_dkv": (None, None, None),
        "kv_norm": (None, None),
        "w_uk": (None, None, "tp"),
        "w_uv": (None, None, "tp"),
        "wo": (None, "tp", None),
    }
    if cfg.q_lora_rank:
        specs["w_dq"] = (None, None, None)
        specs["q_norm"] = (None, None)
        specs["w_uq"] = (None, None, "tp")
    else:
        specs["wq"] = (None, None, "tp")
    return specs


def param_specs(cfg: DeepseekConfig) -> dict:
    """The reference's (deepseek.py:276-316): dense FFNs over tp, routed
    experts over ep with each expert's FFN width over tp, shared experts
    over tp; the embedding, router and norms replicated."""
    specs: dict = {"embed": (None, None), "final_norm": (None,)}
    if cfg.first_k_dense:
        specs["dense_layers"] = {
            **_attn_specs(cfg), "mlp_norm": (None, None), "w_gate": (None, None, "tp"),
            "w_up": (None, None, "tp"), "w_down": (None, "tp", None),
        }
    if cfg.num_moe_layers:
        moe = {**_attn_specs(cfg), "mlp_norm": (None, None), "w_router": (None, None, None),
               "w_gate": (None, "ep", None, "tp"), "w_up": (None, "ep", None, "tp"),
               "w_down": (None, "ep", "tp", None)}
        if cfg.scoring_func == "sigmoid":
            moe["router_bias"] = (None, None)
        if cfg.n_shared_experts:
            moe.update(ws_gate=(None, None, "tp"), ws_up=(None, None, "tp"),
                       ws_down=(None, "tp", None))
        specs["moe_layers"] = moe
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, "tp")
    return specs


def kv_cache_specs(cfg: DeepseekConfig) -> dict:
    """The latent cache is shared by every head: replicated over tp (the
    reference's :321-325)."""
    return {"k": (None,) * 5, "v": (None,) * 5}


def shard_params(params: dict, cfg: DeepseekConfig, mesh) -> dict:
    """This rank's slice of every leaf under ``param_specs`` (int8 leaves
    under ``quantize_specs``)."""
    from dynamo_tpu_torch.ops.quant import is_quantized, quantize_specs
    from dynamo_tpu_torch.parallel.mesh import shard_tree

    specs = param_specs(cfg)
    if is_quantized(params):
        specs = quantize_specs(specs, QUANT_LEAVES)
    return shard_tree(params, specs, mesh)


def init_kv_cache(cfg: DeepseekConfig, num_blocks: int, block_size: int, dtype=None,
                  device="cuda") -> dict:
    """Latent cache: ``k`` holds c_kv (kv_lora_rank wide), ``v`` the roped
    key (qk_rope_head_dim wide)."""
    dtype = dtype or cfg.dtype
    shape = (cfg.num_layers, num_blocks, block_size, 1)
    return {
        "k": alloc_cache_leaf((*shape, cfg.kv_lora_rank), dtype, device),
        "v": alloc_cache_leaf((*shape, cfg.qk_rope_head_dim), dtype, device),
    }


def make_rope_tables(cfg: DeepseekConfig, device="cuda", max_len: int | None = None):
    """(cos, sin) float32 tables for the rope dims.  DeepSeek puts the YaRN
    temperature on the softmax scale (``attn_scale``), so the tables leave
    the attention factor out."""
    return rope_table(
        max_len or cfg.max_position_embeddings, cfg.qk_rope_head_dim, cfg.rope_theta,
        scaling=cfg.rope_scaling, yarn_apply_attention_factor=False, device=device,
    )


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _project_q(w, x, cfg: DeepseekConfig) -> torch.Tensor:
    """x [t, h] -> q [t, heads, qk_head_dim], through the q-lora bottleneck
    when the config has one."""
    if cfg.q_lora_rank:
        q = mm(rms_norm(mm(x, w["w_dq"]), w["q_norm"], cfg.rms_norm_eps), w["w_uq"])
    else:
        q = mm(x, w["wq"])
    return q.view(x.shape[0], cfg.num_heads, cfg.qk_head_dim)


def _latent_kv(w, x, cfg: DeepseekConfig):
    """x [t, h] -> (c_kv [t, r] normalized, k_rope [t, rope_dim] not roped)."""
    dkv = mm(x, w["w_dkv"])
    c_kv = rms_norm(dkv[:, : cfg.kv_lora_rank], w["kv_norm"], cfg.rms_norm_eps)
    return c_kv, dkv[:, cfg.kv_lora_rank:]


def _absorbed_q(w, x, cfg: DeepseekConfig, positions, cos, sin):
    """(q_lat [t, H, R] float32, q_rope [t, H, P] roped) for tokens at
    ``positions`` [t]: q_nope folded through the K up-projection."""
    q = _project_q(w, x, cfg)
    q_nope, q_rope = q[..., : cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cos, sin)
    w_uk = w["w_uk"].view(cfg.kv_lora_rank, cfg.num_heads, cfg.qk_nope_head_dim)
    q_lat = torch.einsum("thn,rhn->thr", q_nope.float(), w_uk.float())
    return q_lat, q_rope


def _write_latents(w, x, cfg: DeepseekConfig, positions, cache_views, rows, cos, sin) -> None:
    """Every token's latent and roped key into its cache row (``rows`` of
    the leaves' ``cache_views``, ``cache_rows``), in place."""
    c_kv, k_rope = _latent_kv(w, x, cfg)
    k_rope = apply_rope(k_rope[:, None, :], positions, cos, sin)   # [t, 1, P]
    write_rows(*cache_views, rows, c_kv[:, None, :], k_rope)


def _decompress(w, ctx, cfg: DeepseekConfig) -> torch.Tensor:
    """Latent context [t, H, R] f32 -> attention output [t, hidden]."""
    w_uv = w["w_uv"].view(cfg.kv_lora_rank, cfg.num_heads, cfg.v_head_dim)
    out = torch.einsum("thr,rhv->thv", ctx, w_uv.float()).to(cfg.dtype)
    return mm(out.reshape(ctx.shape[0], -1), w["wo"])


def _latent_caches(k_layer, v_layer):
    """[N, bs, 1, R] / [N, bs, 1, P] layer caches as the kernels' [N, bs, R|P]."""
    return k_layer.view(*k_layer.shape[:2], -1), v_layer.view(*v_layer.shape[:2], -1)


def _mla_decode_attn(w, x, cfg: DeepseekConfig, positions, k_layer, v_layer,
                     block_tables, context_lens, cache_views, rows, cos, sin):
    """Absorbed-form batched decode attention against the latent cache."""
    _write_latents(w, x, cfg, positions, cache_views, rows, cos, sin)
    q_lat, q_rope = _absorbed_q(w, x, cfg, positions, cos, sin)
    ck, kr = _latent_caches(k_layer, v_layer)
    ctx = mla_paged_attention_decode(
        q_lat, q_rope, ck, kr, block_tables, context_lens, scale=cfg.attn_scale,
    )
    return _decompress(w, ctx, cfg)


def _mla_unified_attn(w, x, cfg: DeepseekConfig, positions, token_pos, token_lane,
                      cache_views, rows, k_layer, v_layer, block_tables, page_meta,
                      cos, sin, tb_tokens: int, pages_per_step: int, plan=None):
    """Absorbed-form ragged unified-batch attention: every token writes its
    latent before any token reads, so span tokens see their in-window
    predecessors through the cache."""
    _write_latents(w, x, cfg, positions, cache_views, rows, cos, sin)
    q_lat, q_rope = _absorbed_q(w, x, cfg, positions, cos, sin)
    ck, kr = _latent_caches(k_layer, v_layer)
    ctx = ragged_mla_attention(
        q_lat, q_rope, ck, kr, block_tables, token_lane, token_pos, *page_meta,
        scale=cfg.attn_scale, tb_tokens=tb_tokens, pages_per_step=pages_per_step, plan=plan,
    )
    return _decompress(w, ctx, cfg)


def _split_q(w, x, cfg: DeepseekConfig, positions, cos, sin):
    """(q_nope, roped q_rope) of tokens [t] at ``positions``."""
    q = _project_q(w, x, cfg)
    q_nope, q_rope = q[..., : cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cos, sin)


def _chunk_scores(w, cfg: DeepseekConfig, q_nope, q_rope, c_kv, k_rope, valid_len):
    """Dense causal scores [H, s, s] of a prefill chunk against its own
    decompressed keys (float32, masked past ``valid_len``, a 0-d tensor or
    an int), and the chunk's decompressed values [s, H, v]."""
    s = q_nope.shape[0]
    H = cfg.num_heads
    w_uk = w["w_uk"].view(cfg.kv_lora_rank, H, cfg.qk_nope_head_dim)
    w_uv = w["w_uv"].view(cfg.kv_lora_rank, H, cfg.v_head_dim)
    k_nope = torch.einsum("tr,rhn->thn", c_kv, w_uk)     # model dtype, as the reference
    v = torch.einsum("tr,rhv->thv", c_kv, w_uv)
    # the sum and the scale in place: the same values, one [H, s, s] fewer
    logits = torch.einsum("qhn,khn->hqk", q_nope.float(), k_nope.float())
    logits.add_(torch.einsum("qhp,kp->hqk", q_rope.float(), k_rope.float()))
    logits.mul_(cfg.attn_scale)
    pos = torch.arange(s, device=q_nope.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < valid_len)
    return logits.masked_fill_(~mask[None], NEG_INF), v


def _mla_prefill_attn(w, x, cfg: DeepseekConfig, positions, seq_len, k_layer, v_layer,
                      block_ids, cos, sin):
    """Dense causal MLA attention of one prefill chunk: its latents go to
    the paged cache, its keys and values are decompressed for the dense
    in-chunk attention.  Returns the attention output [s, hidden]."""
    s = x.shape[0]
    q_nope, q_rope = _split_q(w, x, cfg, positions, cos, sin)
    c_kv, k_rope = _latent_kv(w, x, cfg)
    k_rope = apply_rope(k_rope[:, None, :], positions, cos, sin)[:, 0]
    write_prefill_kv(k_layer, v_layer, c_kv[:, None, :], k_rope[:, None, :], block_ids, seq_len)
    logits, v = _chunk_scores(w, cfg, q_nope, q_rope, c_kv, k_rope, seq_len)
    out = torch.einsum("hqk,khv->qhv", torch.softmax(logits, dim=-1), v.float())
    return mm(out.to(cfg.dtype).reshape(s, -1), w["wo"])


def _mla_prefill_attn_with_prefix(w, x, cfg: DeepseekConfig, positions, tail_len, start_pos,
                                  k_layer, v_layer, full_block_ids, tail_block_ids, cos, sin):
    """Continued MLA prefill: the tail's queries attend to the resident
    prefix latents (absorbed: scores in latent space, the context
    decompressed once) and to the chunk's own decompressed keys under one
    softmax; only the tail's latents are written."""
    s = x.shape[0]
    H = cfg.num_heads
    q_nope, q_rope = _split_q(w, x, cfg, positions, cos, sin)
    c_kv, k_rope = _latent_kv(w, x, cfg)
    k_rope = apply_rope(k_rope[:, None, :], positions, cos, sin)[:, 0]

    # read the resident prefix BEFORE the tail is written
    ids = full_block_ids.to(x.device).long()
    t_pref = ids.shape[0] * k_layer.shape[1]
    ck_pref = cache_take(k_layer, ids).reshape(t_pref, cfg.kv_lora_rank).float()
    kr_pref = cache_take(v_layer, ids).reshape(t_pref, cfg.qk_rope_head_dim).float()
    write_prefill_kv(k_layer, v_layer, c_kv[:, None, :], k_rope[:, None, :], tail_block_ids,
                     tail_len)

    w_uk = w["w_uk"].view(cfg.kv_lora_rank, H, cfg.qk_nope_head_dim)
    w_uv = w["w_uv"].view(cfg.kv_lora_rank, H, cfg.v_head_dim)
    q_lat = torch.einsum("qhn,rhn->qhr", q_nope.float(), w_uk.float())
    sp = torch.einsum("qhr,tr->hqt", q_lat, ck_pref)
    sp.add_(torch.einsum("qhp,tp->hqt", q_rope.float(), kr_pref))
    sp.mul_(cfg.attn_scale)
    pref_valid = torch.arange(t_pref, device=x.device) < start_pos
    sp.masked_fill_(~pref_valid[None, None], NEG_INF)
    sc, v_chunk = _chunk_scores(w, cfg, q_nope, q_rope, c_kv, k_rope, tail_len)
    scores = torch.cat([sp, sc], dim=-1)                           # [H, s, Tp + s]
    del sp, sc
    weights = torch.softmax(scores, dim=-1)
    del scores
    wp, wc = weights[..., :t_pref], weights[..., t_pref:]
    ctx_lat = torch.einsum("hqt,tr->qhr", wp, ck_pref)
    out_pref = torch.einsum("qhr,rhv->qhv", ctx_lat, w_uv.float())
    out_chunk = torch.einsum("hqk,khv->qhv", wc, v_chunk.float())
    return mm((out_pref + out_chunk).to(cfg.dtype).reshape(s, -1), w["wo"])


def _mla_window_attn(w, x, cfg: DeepseekConfig, positions, k_layer, v_layer, block_tables,
                     context_lens, cache_views, rows, cos, sin, b: int, w_len: int):
    """Multi-query absorbed MLA attention for speculative verification:
    ``x`` is the position-major flat window [w*b, hidden]; every window
    token writes its latent (into ``rows`` of the leaves' ``cache_views``),
    then the window queries attend through the MLA window kernel.  Returns
    the attention output, position-major [w*b, hidden]."""
    H = cfg.num_heads
    q = position_major_to_batch(_project_q(w, x, cfg), w_len, b, H, cfg.qk_head_dim)
    q_nope, q_rope = q[..., : cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cos, sin)                  # [b, w, H, P]
    c_kv, k_rope = _latent_kv(w, x, cfg)                             # [w*b, R], [w*b, P]
    k_rope = apply_rope(
        position_major_to_batch(k_rope, w_len, b, cfg.qk_rope_head_dim)[:, :, None, :],
        positions, cos, sin,
    )                                                                 # [b, w, 1, P]
    write_rows(*cache_views, rows, c_kv[:, None, :],
               k_rope.transpose(0, 1).reshape(w_len * b, 1, -1))
    w_uk = w["w_uk"].view(cfg.kv_lora_rank, H, cfg.qk_nope_head_dim)
    q_lat = torch.einsum("bwhn,rhn->bwhr", q_nope.float(), w_uk.float())
    ck, kr = _latent_caches(k_layer, v_layer)
    ctx = mla_paged_window_attention_decode(
        q_lat, q_rope, ck, kr, block_tables, context_lens, scale=cfg.attn_scale,
    )                                                                 # [b, w, H, R] f32
    w_uv = w["w_uv"].view(cfg.kv_lora_rank, H, cfg.v_head_dim)
    out = torch.einsum("bwhr,rhv->bwhv", ctx, w_uv.float()).to(cfg.dtype)
    return mm(out.transpose(0, 1).reshape(w_len * b, -1), w["wo"])


def _dense_mlp(w, x):
    return mm(F.silu(mm(x, w["w_gate"])) * mm(x, w["w_up"]), w["w_down"])


def _moe_mlp(w, x, cfg: DeepseekConfig, mesh=None):
    """Routed experts (on a mesh summed over ep and tp in ``moe_ffn``) times
    the scaling factor, plus the shared experts (tp-sharded: summed over
    tp)."""
    routed = moe_ffn(
        x, w["w_router"], w["w_gate"], w["w_up"], w["w_down"],
        top_k=cfg.experts_per_token, capacity_factor=cfg.capacity_factor,
        router_bias=w.get("router_bias"),
        scoring="sigmoid_noaux" if cfg.scoring_func == "sigmoid" else "softmax",
        n_group=cfg.n_group, topk_group=cfg.topk_group,
        norm_topk_prob=cfg.norm_topk_prob, num_experts=cfg.num_experts, mesh=mesh,
    )
    out = routed * cfg.routed_scaling_factor
    if cfg.n_shared_experts:
        out = out + all_reduce(
            mm(F.silu(mm(x, w["ws_gate"])) * mm(x, w["ws_up"]), w["ws_down"]), mesh)
    return out


def _forward(params, cfg: DeepseekConfig, x, kv_cache, attn_fn, mesh=None):
    """The trunk: the dense stack, then the MoE stack, each layer reading
    and writing its own slice of the cache (``attn_fn`` gets the layer's
    caches and its index); then the final norm.  On a tp ``mesh`` the
    attention output (``wo`` row-parallel) and the dense FFN are summed
    over tp."""
    k_all, v_all = kv_cache["k"], kv_cache["v"]
    layer = 0
    for stack, mlp in (("dense_layers", lambda w, t: all_reduce(_dense_mlp(w, t), mesh)),
                       ("moe_layers", lambda w, t: _moe_mlp(w, t, cfg, mesh))):
        leaves = params.get(stack)
        if leaves is None:
            continue
        for i in range(next(iter(leaves.values())).shape[0]):
            w = {name: leaf[i] for name, leaf in leaves.items()}
            attn_in = rms_norm(x, w["attn_norm"], cfg.rms_norm_eps)
            x = x + all_reduce(attn_fn(w, attn_in, k_all[layer], v_all[layer], layer), mesh)
            x = x + mlp(w, rms_norm(x, w["mlp_norm"], cfg.rms_norm_eps))
            layer += 1
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def _logits(params, cfg, x, mesh=None):
    """The LM head's logits; a vocab-sharded head's gathered over tp."""
    if cfg.tie_word_embeddings:
        return x @ params["embed"].to(x.dtype).T
    out = mm(x, params["lm_head"])
    return out if out.shape[-1] == cfg.vocab_size else all_gather(out, mesh, "tp", dim=-1)


def deepseek_forward_decode(
    params: dict,
    cfg: DeepseekConfig,
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
    """Batched single-token decode through the absorbed latent path.
    Returns (logits [batch, vocab] f32, cache); the cache is written in
    place.  On a tp ``mesh`` row 4 runs on this rank's ``H / tp`` heads
    over the whole (replicated) latent cache, which every rank writes
    alike; the parameters are this rank's ``shard_params``."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    x = params["embed"][token_ids].to(cfg.dtype)
    positions = (context_lens - 1).clamp(min=0)
    views = (cache_rows(kv_cache["k"]), cache_rows(kv_cache["v"]))
    rows = slot_rows(slot_ids, kv_cache["k"])  # idle lanes write the dump row

    def attn(w, attn_in, k_layer, v_layer, layer):
        return _mla_decode_attn(
            w, attn_in, cfg, positions, k_layer, v_layer, block_tables, context_lens,
            views, rows[layer], cos, sin,
        )

    x = _forward(params, cfg, x, kv_cache, attn, mesh)
    return _logits(params, full_cfg, x, mesh).float(), kv_cache


def deepseek_forward_prefill(
    params: dict,
    cfg: DeepseekConfig,
    token_ids: torch.Tensor,  # [seq_pad] int
    kv_cache: dict,
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
    place.  The MoE layers route every token of the padded chunk, as the
    reference does.  Lengths as in ``llama_forward_prefill``: 0-d int
    tensors on the device (or ints), read nowhere on the host; ``mesh`` as
    in ``deepseek_forward_decode``."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    s = token_ids.shape[0]
    x = params["embed"][token_ids].to(cfg.dtype)
    positions = table_positions(start_pos + torch.arange(s, device=x.device), cos)

    def attn(w, attn_in, k_layer, v_layer, layer):
        return _mla_prefill_attn(w, attn_in, cfg, positions, seq_len, k_layer, v_layer,
                                 block_ids, cos, sin)

    x = _forward(params, cfg, x, kv_cache, attn, mesh)
    return _logits(params, full_cfg, last_valid_row(x, seq_len), mesh)[0].float(), kv_cache


def deepseek_forward_prefill_with_prefix(
    params: dict,
    cfg: DeepseekConfig,
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
    """Continued prefill over a resident prefix for the MLA family (the
    llama contract, ``mesh`` included).  Returns (last tail token's logits
    [vocab] f32, cache)."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    s = token_ids.shape[0]
    x = params["embed"][token_ids].to(cfg.dtype)
    positions = table_positions(start_pos + torch.arange(s, device=x.device), cos)

    def attn(w, attn_in, k_layer, v_layer, layer):
        return _mla_prefill_attn_with_prefix(
            w, attn_in, cfg, positions, tail_len, start_pos, k_layer, v_layer,
            full_block_ids, tail_block_ids, cos, sin,
        )

    x = _forward(params, cfg, x, kv_cache, attn, mesh)
    return _logits(params, full_cfg, last_valid_row(x, tail_len), mesh)[0].float(), kv_cache


def deepseek_forward_verify(
    params: dict,
    cfg: DeepseekConfig,
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
    """Speculative verification for the MLA family (the llama contract):
    logits [batch, w, vocab] f32.  The window runs position-major through
    the trunk, so the MoE layers give position-0 tokens expert-capacity
    priority exactly as the reference does.  On a tp ``mesh`` row 5 runs on
    this rank's ``H / tp`` heads over the whole latent cache, which every
    rank writes alike."""
    full_cfg, cfg = cfg, shard_config(cfg, mesh)
    b, w_len = token_ids.shape
    x = params["embed"][token_ids.t().reshape(-1)].to(cfg.dtype)  # position-major
    positions = table_positions(
        context_lens[:, None] - w_len + torch.arange(w_len, device=x.device)[None, :], cos
    )  # [b, w]
    views = (cache_rows(kv_cache["k"]), cache_rows(kv_cache["v"]))
    rows = last_writer_rows(slot_ids.t().reshape(-1), kv_cache["k"])

    def attn(w, attn_in, k_layer, v_layer, layer):
        return _mla_window_attn(w, attn_in, cfg, positions, k_layer, v_layer, block_tables,
                                context_lens, views, rows[layer], cos, sin, b, w_len)

    x = _forward(params, cfg, x, kv_cache, attn, mesh)
    logits = _logits(params, full_cfg, x, mesh).view(w_len, b, -1).transpose(0, 1)
    return logits.float(), kv_cache


def unified_planner(cfg: DeepseekConfig, *, block_size: int, tb_tokens: int,
                    device: torch.device, cache_dtype: torch.dtype | None = None):
    """The ragged MLA walk's planner (``mla_planner``: a unified step's work
    plan from its host ``page_count``, and the fixed capacity of a token
    bucket's plans), or None where the kernel reads no plan: off the card,
    and on the CUDA-core loop's widths."""
    if device.type != "cuda" or not mla_attention.split_route(
            cfg.dtype, cfg.kv_lora_rank, cfg.qk_rope_head_dim, block_size, cfg.num_heads,
            cache_dtype):
        return None
    return mla_attention.mla_planner(tb_tokens, cfg.num_heads, sm_count(device),
                                     cfg.kv_lora_rank)


def unified_max_tb(cfg: DeepseekConfig) -> int:
    """The largest token block the ragged MLA kernel takes
    (``MAX_TOKEN_BLOCK``)."""
    return mla_attention.MAX_TOKEN_BLOCK


def deepseek_forward_unified(
    params: dict,
    cfg: DeepseekConfig,
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
    """Ragged unified-batch forward for the MLA family: chunked-prefill
    spans and decode tokens in one pass against the latent cache (the llama
    unified contract); the MoE stack routes every token of the padded
    batch.  ``plan`` (``mla_planner(...).plan`` over ``page_count``, made once a
    step, or the ``DeviceWork`` it was written into) balances every
    layer's ragged MLA kernel on the card.  Logits are gathered at each
    lane's last span row: [lanes, vocab] f32 (junk for lanes without
    tokens; the caller gates them)."""
    x = params["embed"][token_ids].to(cfg.dtype)
    positions = token_pos.clamp(min=0)  # pads rope at position 0
    views = (cache_rows(kv_cache["k"]), cache_rows(kv_cache["v"]))
    rows = slot_rows(token_slot, kv_cache["k"])  # pad tokens write the dump row
    page_meta = (page_phys, page_lane, page_ord, page_count)

    def attn(w, attn_in, k_layer, v_layer, layer):
        return _mla_unified_attn(
            w, attn_in, cfg, positions, token_pos, token_lane, views, rows[layer],
            k_layer, v_layer, block_tables, page_meta, cos, sin, tb_tokens,
            pages_per_step, plan,
        )

    x = _forward(params, cfg, x, kv_cache, attn)
    return _logits(params, cfg, x[sample_rows]).float(), kv_cache


# ---------------------------------------------------------------------------
# HF weight loading (safetensors)
# ---------------------------------------------------------------------------


def _deinterleave(cols: torch.Tensor) -> torch.Tensor:
    """HF DeepSeek stores the rope feature dims interleaved; ``apply_rope``
    is split-half, so the permutation is baked into the projection's rope
    output columns once at load time."""
    return torch.cat([cols[..., 0::2], cols[..., 1::2]], dim=-1)


def load_hf_weights(cfg: DeepseekConfig, model_dir: str | Path, device="cuda") -> dict:
    """Load HF DeepSeek-V2/V3 safetensors into the dense/moe layer stacks
    on ``device``.  Projections transpose to [in, out]; ``kv_b_proj [H *
    (nope + v), R]`` splits into ``w_uk [R, H * nope]`` and ``w_uv [R, H *
    v]``; the rope columns of the q and latent projections de-interleave.
    Each stacked leaf is allocated once and filled layer by layer."""
    from dynamo_tpu_torch.models.hf_io import read_safetensors

    tensors = read_safetensors(model_dir)
    H, nope, v_dim, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    rope = cfg.qk_rope_head_dim

    def get(name: str, transpose: bool = False) -> torch.Tensor:
        t = tensors[name].float()
        return t.T if transpose else t

    def fix_q_rope(mat: torch.Tensor) -> torch.Tensor:
        """mat [in, H * qk_head]: de-interleave each head's rope slice."""
        shaped = mat.reshape(mat.shape[0], H, nope + rope).clone()
        shaped[..., nope:] = _deinterleave(shaped[..., nope:])
        return shaped.reshape(mat.shape[0], -1)

    def attn_leaves(i: int) -> dict:
        p = f"model.layers.{i}.self_attn"
        kv_b = get(f"{p}.kv_b_proj.weight").reshape(H, nope + v_dim, r)
        w_dkv = get(f"{p}.kv_a_proj_with_mqa.weight", True).clone()
        w_dkv[:, r:] = _deinterleave(w_dkv[:, r:])
        out = {
            "attn_norm": get(f"model.layers.{i}.input_layernorm.weight"),
            "w_dkv": w_dkv,
            "kv_norm": get(f"{p}.kv_a_layernorm.weight"),
            "w_uk": kv_b[:, :nope, :].permute(2, 0, 1).reshape(r, H * nope),
            "w_uv": kv_b[:, nope:, :].permute(2, 0, 1).reshape(r, H * v_dim),
            "wo": get(f"{p}.o_proj.weight", True),
            "mlp_norm": get(f"model.layers.{i}.post_attention_layernorm.weight"),
        }
        if cfg.q_lora_rank:
            out["w_dq"] = get(f"{p}.q_a_proj.weight", True)
            out["q_norm"] = get(f"{p}.q_a_layernorm.weight")
            out["w_uq"] = fix_q_rope(get(f"{p}.q_b_proj.weight", True))
        else:
            out["wq"] = fix_q_rope(get(f"{p}.q_proj.weight", True))
        return out

    def mlp_leaves(i: int) -> dict:
        mlp = f"model.layers.{i}.mlp"
        if i < cfg.first_k_dense:
            return {name: get(f"{mlp}.{proj}_proj.weight", True)
                    for name, proj in (("w_gate", "gate"), ("w_up", "up"), ("w_down", "down"))}
        out = {"w_router": get(f"{mlp}.gate.weight", True)}
        if cfg.scoring_func == "sigmoid":
            out["router_bias"] = get(f"{mlp}.gate.e_score_correction_bias")
        for name, proj in (("w_gate", "gate"), ("w_up", "up"), ("w_down", "down")):
            out[name] = torch.stack([
                get(f"{mlp}.experts.{e}.{proj}_proj.weight", True)
                for e in range(cfg.num_experts)
            ])
            if cfg.n_shared_experts:
                out["ws" + name[1:]] = get(f"{mlp}.shared_experts.{proj}_proj.weight", True)
        return out

    def stack(layer_ids) -> dict:
        out: dict[str, torch.Tensor] = {}
        for j, i in enumerate(layer_ids):
            for name, leaf in {**attn_leaves(i), **mlp_leaves(i)}.items():
                if name not in out:
                    # the e_score_correction_bias stays float32: bf16 rounding
                    # flips near-tied expert selections
                    dtype = torch.float32 if name == "router_bias" else cfg.dtype
                    out[name] = torch.empty((len(layer_ids), *leaf.shape), dtype=dtype,
                                            device=device)
                out[name][j].copy_(leaf)
        return out

    params: dict = {
        "embed": get("model.embed_tokens.weight").to(device=device, dtype=cfg.dtype),
        "final_norm": get("model.norm.weight").to(device=device, dtype=cfg.dtype),
    }
    if cfg.first_k_dense:
        params["dense_layers"] = stack(range(cfg.first_k_dense))
    if cfg.num_moe_layers:
        params["moe_layers"] = stack(range(cfg.first_k_dense, cfg.num_layers))
    if not cfg.tie_word_embeddings and "lm_head.weight" in tensors:
        params["lm_head"] = get("lm_head.weight", True).to(device=device, dtype=cfg.dtype)
    return params
