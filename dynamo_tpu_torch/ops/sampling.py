"""Token sampling: greedy / temperature / top-k / top-p over a whole batch
with per-lane settings (counterpart of dynamo_tpu/ops/sampling.py).

The reference draws its Gumbel noise from per-lane JAX keys inside the
jitted step.  The port takes the noise as an argument: the engine draws it
from the same keys with the port's threefry stream (``ops/random.py``),
and the tests feed both implementations the same noise, so the sampled ids
agree exactly.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def sample_tokens(
    logits: torch.Tensor,       # [batch, vocab]
    noise: torch.Tensor,        # [batch, vocab] Gumbel noise in SORTED order
    temperature: torch.Tensor,  # [batch] float32; <=0 treated as greedy
    top_k: torch.Tensor,        # [batch] int; <=0 disables
    top_p: torch.Tensor,        # [batch] float32; >=1 disables
    greedy: torch.Tensor,       # [batch] bool
) -> torch.Tensor:
    """Sampled token ids [batch] int32.  Lane i's choice is
    ``argmax(filtered_sorted_logits + noise[i])`` in sorted space, mapped
    back through the sort — the Gumbel-max form of the reference's
    ``jax.random.categorical`` over the same sorted row."""
    b, v = logits.shape
    logits = logits.float()
    greedy_ids = torch.argmax(logits, dim=-1).to(torch.int32)

    force_greedy = greedy | (temperature <= 1e-5)
    safe_temp = torch.where(force_greedy, torch.ones_like(temperature), temperature)
    scaled = logits / safe_temp[:, None]

    # descending order with the reference's tie rule: its ascending stable
    # sort reversed puts the HIGHER index first among equal values, which
    # torch.sort(descending=True) does not
    sorted_asc, idx_asc = torch.sort(scaled, dim=-1, stable=True)
    sorted_logits = sorted_asc.flip(-1)
    sort_idx = idx_asc.flip(-1)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    ranks = torch.arange(v, device=logits.device)[None, :]

    k_eff = torch.where(top_k <= 0, v, top_k)[:, None]
    p_eff = torch.where(top_p >= 1.0, 2.0, top_p)[:, None]
    keep = (ranks < k_eff) & (cum_excl < p_eff)
    keep[:, 0] = True  # always keep the best token

    filtered_sorted = torch.where(keep, sorted_logits, NEG_INF)
    choice = torch.argmax(filtered_sorted + noise, dim=-1)
    sampled_ids = torch.gather(sort_idx, 1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(force_greedy, greedy_ids, sampled_ids)


def apply_penalties(
    logits: torch.Tensor,             # [batch, vocab]
    gen_counts: torch.Tensor,         # [batch, vocab] int: tokens generated so far
    prompt_counts: torch.Tensor,      # [batch, vocab] int: prompt token counts
    presence_penalty: torch.Tensor,   # [batch]
    frequency_penalty: torch.Tensor,  # [batch]
    repetition_penalty: torch.Tensor,  # [batch]; 1.0 disables
) -> torch.Tensor:
    """OpenAI presence/frequency penalties apply to generated tokens; the
    HF-style repetition penalty to everything seen (prompt + generated)."""
    logits = logits.float()
    generated = (gen_counts > 0).float()
    logits = logits - presence_penalty[:, None] * generated
    logits = logits - frequency_penalty[:, None] * gen_counts.float()
    seen = (gen_counts > 0) | (prompt_counts > 0)
    rep = repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    return torch.where(seen, penalized, logits)


def apply_logit_bias(
    logits: torch.Tensor,  # [batch, vocab] f32
    ids: torch.Tensor,     # [batch, K] int; pad entries = vocab (dropped)
    vals: torch.Tensor,    # [batch, K] f32
) -> torch.Tensor:
    """OpenAI ``logit_bias``: add sparse per-token biases.  Pad ids (out of
    the vocabulary) are dropped, as the reference's scatter drops them."""
    if ids.shape[-1] == 0:
        return logits
    vocab = logits.shape[-1]
    valid = (ids >= 0) & (ids < vocab)
    return logits.scatter_add(
        1, torch.where(valid, ids, 0).long(), torch.where(valid, vals, 0.0)
    )


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Log-softmax probability of each chosen token [batch] (float32)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, 1, tokens.long()[:, None])[:, 0]
    return picked - lse


def topk_logprobs(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k log-softmax probabilities and their ids ([batch, k] f32,
    [batch, k] int32)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    vals, ids = torch.topk(logits, k, dim=-1)
    return vals - lse, ids.to(torch.int32)
