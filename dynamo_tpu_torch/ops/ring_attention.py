"""Ring attention: causal prefill attention with the sequence split over the
``sp`` mesh axis (counterpart of dynamo_tpu/ops/ring_attention.py).

Each sp rank holds one contiguous chunk of the bucket's queries, keys and
values.  The K/V chunks go round the ring (``parallel.mesh.ring_shift``,
the reference's ``ppermute``) while each rank folds every chunk into a
float32 online softmax over its own queries: after ``n`` steps every query
has seen every key, and no rank ever holds more than two chunks' scores.

The body takes its rotation as an argument, so one code path runs a rank's
ring on a mesh (lists of one chunk, rotated by ``ring_shift``) and a whole
ring in one process (lists of every chunk, rotated in place: the tests'
form).  Plain PyTorch, as the reference's is XLA einsums: no Pallas kernel
stands behind it.
"""

from __future__ import annotations

from typing import Callable

import torch

from dynamo_tpu_torch.parallel.mesh import Mesh, mesh_size, ring_shift

NEG_INF = -1e30


def sequence_chunk(s: int, n: int, axis_name: str = "sp") -> int:
    """The chunk a rank holds of a sequence of ``s`` over ``n`` ranks,
    refused with the reference's words where ``n`` does not divide ``s``."""
    if s % n:
        raise ValueError(f"sequence {s} not divisible by {axis_name}={n}")
    return s // n


def _chunk_attention(q, k, v, q_offset, kv_offset, q_valid, kv_valid):
    """Partial (unnormalised) attention of the local queries against one
    K/V chunk.  q: [B, Sq, KVH, G, D] f32; k/v: [B, Sk, KVH, D] f32.
    Returns (m [B, Sq, KVH, G, 1], l [B, ..., 1], acc [B, Sq, KVH, G, D])."""
    d = q.shape[-1]
    # the reference's float32 1 / sqrt(d), exact in a float32 multiply
    scale = torch.tensor(d, dtype=torch.float32).sqrt().reciprocal().item()
    s = torch.einsum("bqkgd,bskd->bqkgs", q, k) * scale
    sq, sk = q.shape[1], k.shape[1]
    q_pos = q_offset + torch.arange(sq, device=q.device)
    kv_pos = kv_offset + torch.arange(sk, device=q.device)
    mask = (kv_pos[None, :] <= q_pos[:, None]) & q_valid[:, None] & kv_valid[None, :]
    mask = mask[None, :, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp(min=-1e29)  # fully masked rows stay finite
    p = torch.where(mask, torch.exp(s - m), 0.0)
    return m, p.sum(dim=-1, keepdim=True), torch.einsum("bqkgs,bskd->bqkgd", p, v)


def _merge(m1, l1, acc1, m2, l2, acc2):
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    return m, l1 * a1 + l2 * a2, acc1 * a1 + acc2 * a2


def _ring(qs, ks, vs, indices, chunk: int, n: int, valid_len, rotate: Callable,
          prefix=None) -> list[torch.Tensor]:
    """The ring on the chunks this process holds: ``qs[j]`` ([B, C, H, D])
    is ring position ``indices[j]``'s; ``rotate(list)`` hands every held
    tensor to the next position and returns what the previous one held.
    ``prefix`` (k, v, prefix_len): a resident prefix every valid query sees
    whole, folded in first (the queries' positions start after it).
    Returns each held chunk's output [B, C, H, D] in the queries' dtype."""
    states, qfs, q_valids, q_offs = [], [], [], []
    for q, idx in zip(qs, indices):
        b, sq, h, d = q.shape
        kvh = ks[0].shape[2]
        qf = q.reshape(b, sq, kvh, h // kvh, d).float()
        q_off = idx * chunk
        q_valid = q_off + torch.arange(sq, device=q.device) < valid_len
        if prefix is None:
            state = (torch.full((b, sq, kvh, h // kvh, 1), NEG_INF, device=q.device),
                     torch.zeros((b, sq, kvh, h // kvh, 1), device=q.device),
                     torch.zeros((b, sq, kvh, h // kvh, d), device=q.device))
        else:
            kp, vp, prefix_len = prefix
            p_valid = torch.arange(kp.shape[1], device=q.device) < prefix_len
            state = _chunk_attention(qf, kp.float(), vp.float(), prefix_len + q_off, 0,
                                     q_valid, p_valid)
        states.append(state)
        qfs.append(qf)
        q_valids.append(q_valid)
        q_offs.append(q_off)
    k_cur, v_cur = list(ks), list(vs)
    for step in range(n):
        for j, idx in enumerate(indices):
            # the chunk held after ``step`` rotations started at idx - step
            kv_off = ((idx - step) % n) * chunk
            kv_valid = kv_off + torch.arange(k_cur[j].shape[1], device=qfs[j].device) < valid_len
            part = _chunk_attention(qfs[j], k_cur[j].float(), v_cur[j].float(), q_offs[j],
                                    kv_off, q_valids[j], kv_valid)
            states[j] = _merge(*states[j], *part)
        if step < n - 1:  # the reference's last rotation only returns the chunks home
            rotated = rotate(k_cur + v_cur)
            k_cur, v_cur = rotated[:len(k_cur)], rotated[len(k_cur):]
    outs = []
    for q, (_, l, acc) in zip(qs, states):
        out = acc / l.clamp(min=1e-20)
        outs.append(out.reshape(q.shape).to(q.dtype))
    return outs


def _rotate_in_process(tensors: list) -> list:
    """Every chunk of an in-process ring to the next position: the held
    lists are [k chunks..., v chunks...], position i's chunk at index i."""
    half = len(tensors) // 2
    ks, vs = tensors[:half], tensors[half:]
    return ks[-1:] + ks[:-1] + vs[-1:] + vs[:-1]


def ring_attention(q, k, v, seq_len, mesh: Mesh | None, *, axis_name: str = "sp"):
    """Causal self-attention of this rank's chunk of the sequence.  q:
    [B, C, H, D] (this rank's C = S / n positions, from ``index * C``), k/v
    [B, C, KVH, D]; ``seq_len`` the valid length (pad positions masked).
    Returns this rank's chunk of the output."""
    n = mesh_size(mesh, axis_name)
    idx = 0 if n == 1 else mesh.index(axis_name)
    return _ring([q], [k], [v], [idx], q.shape[1], n, seq_len,
                 lambda ts: ring_shift(ts, mesh, axis_name))[0]


def ring_attention_with_prefix(q, k, v, k_prefix, v_prefix, prefix_len, tail_len,
                               mesh: Mesh | None, *, axis_name: str = "sp"):
    """Continued-prefill attention under sequence parallelism: the tail's
    chunk rings as in ``ring_attention``, and the resident prefix [B, P,
    KVH, D] (read from the cache, whole on every rank) is folded into each
    rank's online softmax in one pass first."""
    n = mesh_size(mesh, axis_name)
    idx = 0 if n == 1 else mesh.index(axis_name)
    return _ring([q], [k], [v], [idx], q.shape[1], n, tail_len,
                 lambda ts: ring_shift(ts, mesh, axis_name),
                 prefix=(k_prefix, v_prefix, prefix_len))[0]


def ring_attention_local(q, k, v, seq_len, num_chunks: int, *, k_prefix=None, v_prefix=None,
                         prefix_len=None):
    """The whole ring in one process: the full sequence [B, S, ...] split
    into ``num_chunks`` chunks, rotated in place; the output [B, S, H, D]
    (with a prefix where ``k_prefix`` is given).  What every rank of a
    mesh computes, all at once."""
    chunk = sequence_chunk(q.shape[1], num_chunks)
    split = [t.split(chunk, dim=1) for t in (q, k, v)]
    prefix = None if k_prefix is None else (k_prefix, v_prefix, prefix_len)
    valid = seq_len
    outs = _ring(list(split[0]), list(split[1]), list(split[2]), list(range(num_chunks)),
                 chunk, num_chunks, valid, _rotate_in_process, prefix=prefix)
    return torch.cat(outs, dim=1)
