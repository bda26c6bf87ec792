"""Mixture-of-Experts layer ops (counterpart of dynamo_tpu/ops/moe.py).

Capacity-based top-k routing with fixed shapes, as the reference:

    dispatch  [T, H] -> [E, C, H]   (scatter by expert slot)
    experts   batched matrix products over the expert axis (torch.bmm)
    combine   [E, C, H] -> [T, H]   weighted by router probabilities, f32

Every expert's bank is multiplied whatever its load, so a decode step reads
all of them.  Semantics kept exactly: capacity over the padded token count,
token-major slot order, dropped (token, k) pairs contributing 0, the
reference's top-k tie order (lower expert id first).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, the lower index
    first among ties (``torch.topk`` promises no order among ties; a stable
    descending sort keeps index order)."""
    vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def moe_router(
    x: torch.Tensor, w_router: torch.Tensor, top_k: int, norm_topk_prob: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(expert_ids [T, k] int32, probs [T, k] f32) — softmax routing
    (DeepSeek-V2 / Mixtral); ``norm_topk_prob=False`` keeps the raw softmax
    weights of the selected experts."""
    logits = x.float() @ w_router.float()                      # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_probs, top_ids = _top_k(probs, top_k)
    if norm_topk_prob:
        top_probs = top_probs / top_probs.sum(dim=-1, keepdim=True)
    return top_ids.to(torch.int32), top_probs


def moe_router_sigmoid_noaux(
    x: torch.Tensor,
    w_router: torch.Tensor,
    bias: torch.Tensor,       # [E] e_score_correction_bias
    top_k: int,
    *,
    n_group: int = 1,
    topk_group: int = 1,
    norm_topk_prob: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3/R1 aux-free routing: sigmoid scores; the bias steers
    selection only; group-limited top-k (the best ``topk_group`` of
    ``n_group`` groups by the sum of each group's top-2 biased scores);
    combine weights from the unbiased scores of the chosen experts."""
    t = x.shape[0]
    e = w_router.shape[-1]
    scores = torch.sigmoid(x.float() @ w_router.float())       # [T, E]
    biased = scores + bias.float()[None, :]
    if n_group > 1:
        grouped = biased.reshape(t, n_group, e // n_group)
        top2 = _top_k(grouped, min(2, e // n_group))[0]
        _, keep = _top_k(top2.sum(dim=-1), topk_group)           # [T, g]
        group_mask = torch.zeros((t, n_group), dtype=torch.bool, device=x.device)
        group_mask.scatter_(1, keep, True)
        expert_mask = group_mask.repeat_interleave(e // n_group, dim=-1)
        biased = biased.masked_fill(~expert_mask, float("-inf"))
    _, top_ids = _top_k(biased, top_k)
    top_scores = scores.gather(-1, top_ids)
    if norm_topk_prob:
        top_scores = top_scores / (top_scores.sum(dim=-1, keepdim=True) + 1e-20)
    return top_ids.to(torch.int32), top_scores


def moe_dispatch_combine(
    x: torch.Tensor,           # [T, H]
    expert_ids: torch.Tensor,  # [T, k]
    probs: torch.Tensor,       # [T, k] f32
    w_gate: torch.Tensor,      # [E, H, I]
    w_up: torch.Tensor,        # [E, H, I]
    w_down: torch.Tensor,      # [E, I, H]
    *,
    capacity: int,
) -> torch.Tensor:
    t, h = x.shape
    e = w_gate.shape[0]
    k = expert_ids.shape[1]
    flat_ids = expert_ids.reshape(-1).long()                   # [T*k]
    onehot = F.one_hot(flat_ids, e)                            # [T*k, E]
    # slot of each (token, k) in its expert's buffer: token-major order
    slots = (torch.cumsum(onehot, dim=0) * onehot).amax(dim=-1) - 1
    within = (slots >= 0) & (slots < capacity)
    # pairs over capacity go to a dump row past the E*C buffer rows: the
    # reference drops them (mode="drop"), a torch index out of range raises
    dump = e * capacity
    row = torch.where(within, flat_ids * capacity + slots, dump)
    token_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    buffers = torch.zeros((dump + 1, h), dtype=x.dtype, device=x.device)
    buffers.index_copy_(0, row, x[token_idx])
    buffers = buffers[:dump].view(e, capacity, h)

    hidden = F.silu(torch.bmm(buffers, w_gate)) * torch.bmm(buffers, w_up)
    out = torch.bmm(hidden, w_down).reshape(dump, h)           # [E*C, H]

    gathered = out[row.clamp(max=dump - 1)]                    # [T*k, H]
    weights = torch.where(within, probs.reshape(-1).float(), 0.0)
    # a token's k pairs are adjacent rows: sum them in one fixed order (an
    # index_add_ on a card adds with atomics, whose order, so whose
    # rounding, changes from run to run)
    weighted = gathered.float() * weights[:, None]
    return weighted.view(t, k, h).sum(dim=1).to(x.dtype)


def moe_ffn(
    x: torch.Tensor,
    w_router: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    top_k: int,
    capacity_factor: float = 2.0,
    router_bias: torch.Tensor | None = None,
    scoring: str = "softmax",     # "softmax" | "sigmoid_noaux"
    n_group: int = 1,
    topk_group: int = 1,
    norm_topk_prob: bool = True,
) -> torch.Tensor:
    t = x.shape[0]
    e = w_gate.shape[0]
    capacity = max(1, int(t * top_k / e * capacity_factor))
    if scoring == "sigmoid_noaux":
        if router_bias is None:
            router_bias = torch.zeros((e,), dtype=torch.float32, device=x.device)
        ids, probs = moe_router_sigmoid_noaux(
            x, w_router, router_bias, top_k, n_group=n_group,
            topk_group=topk_group, norm_topk_prob=norm_topk_prob,
        )
    else:
        ids, probs = moe_router(x, w_router, top_k, norm_topk_prob=norm_topk_prob)
    return moe_dispatch_combine(x, ids, probs, w_gate, w_up, w_down, capacity=capacity)
