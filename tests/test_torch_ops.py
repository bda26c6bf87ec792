"""The port's plain ops (dynamo_tpu_torch.ops) against the JAX reference:
rms_norm, rope under every scaling, the cache write, and both attention
functions — each held against the JAX plain version and against the Pallas
kernel in interpret mode, on the same numpy inputs, in float32 (atol 1e-5).
The port's page worklist packer must equal the reference's exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import attention as jax_attn
from dynamo_tpu.ops import norms as jax_norms
from dynamo_tpu.ops import rope as jax_rope
from dynamo_tpu.ops.pallas import (
    pack_page_meta as jax_pack_page_meta,
    paged_attention_decode as pallas_decode,
    paged_window_attention_decode as pallas_window,
    ragged_paged_attention as pallas_ragged,
)
from dynamo_tpu_torch.ops import attention as attn
from dynamo_tpu_torch.ops import kernels
from dynamo_tpu_torch.ops.norms import rms_norm
from dynamo_tpu_torch.ops.rope import apply_rope, rope_table

ATOL = 1e-5
RTOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def close(ours, ref, mask=None):
    ours, ref = np.asarray(ours), np.asarray(ref)
    if mask is not None:
        ours, ref = ours[mask], ref[mask]
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    close(rms_norm(t(x), t(w), 1e-5), jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "linear", "factor": 4.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
    {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64,
     "beta_fast": 32.0, "beta_slow": 1.0},
])
def test_rope_tables_and_apply_match_reference(scaling):
    cos, sin = rope_table(256, 16, 10000.0, scaling=scaling)
    jcos, jsin = jax_rope.rope_table(256, 16, 10000.0, scaling=scaling)
    close(cos, jcos)
    close(sin, jsin)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 256, (6,)).astype(np.int32)
    close(
        apply_rope(t(x), t(pos), cos, sin),
        jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcos, jsin),
    )


def test_write_decode_kv_drops_pad_slots():
    rng = np.random.default_rng(2)
    nb, bs, kvh, d = 4, 4, 2, 8
    k = rng.standard_normal((nb, bs, kvh, d)).astype(np.float32)
    v = rng.standard_normal((nb, bs, kvh, d)).astype(np.float32)
    k_new = rng.standard_normal((5, kvh, d)).astype(np.float32)
    v_new = rng.standard_normal((5, kvh, d)).astype(np.float32)
    slots = np.array([3, nb * bs, 9, nb * bs + 7, 0], np.int32)  # two pads
    ref_k, ref_v = jax_attn.write_decode_kv(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(slots),
    )
    ours_k, ours_v = t(k.copy()), t(v.copy())
    out_k, out_v = attn.write_decode_kv(ours_k, ours_v, t(k_new), t(v_new), t(slots))
    assert out_k is ours_k and out_v is ours_v  # written in place
    np.testing.assert_array_equal(ours_k.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(ours_v.numpy(), np.asarray(ref_v))


def build_cache(seed=0, num_blocks=16, bs=8, kvh=2, d=16, ctx=(5, 17, 29), maxb=4):
    """A paged cache holding ``ctx[i]`` positions for sequence i, pages
    scattered through the pool; the rest of the pool is random junk."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((num_blocks, bs, kvh, d)).astype(np.float32)
    v = rng.standard_normal((num_blocks, bs, kvh, d)).astype(np.float32)
    perm = rng.permutation(num_blocks)[: len(ctx) * maxb].astype(np.int32)
    tables = perm.reshape(len(ctx), maxb)
    return k, v, tables, np.asarray(ctx, np.int32)


@pytest.mark.parametrize("heads,kvh,window", [(4, 2, None), (8, 2, None), (4, 2, 6), (4, 4, None)])
def test_paged_decode_matches_reference_and_pallas(heads, kvh, window):
    k, v, tables, ctx = build_cache(kvh=kvh)
    q = np.random.default_rng(3).standard_normal((3, heads, 16)).astype(np.float32)
    ours = attn.paged_decode_attention(t(q), t(k), t(v), t(tables), t(ctx), sliding_window=window)
    ref = jax_attn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx), sliding_window=window,
    )
    pallas = pallas_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx), interpret=True, sliding_window=window,
    )
    close(ours, ref)
    close(ours, pallas)
    # the kernel wrapper takes the plain version for CPU tensors
    close(kernels.paged_attention_decode(
        t(q), t(k), t(v), t(tables), t(ctx), sliding_window=window), ref)


@pytest.mark.parametrize("window", [None, 5])
def test_paged_window_matches_reference_and_pallas(window):
    k, v, tables, ctx = build_cache(ctx=(9, 17, 29))
    w = 3
    q = np.random.default_rng(4).standard_normal((3, w, 4, 16)).astype(np.float32)
    ours = attn.paged_window_attention(t(q), t(k), t(v), t(tables), t(ctx), sliding_window=window)
    ref = jax_attn.paged_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx), sliding_window=window,
    )
    pallas = pallas_window(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx), interpret=True, sliding_window=window,
    )
    close(ours, ref)
    close(ours, pallas)


def ragged_meta(spans, lanes, tb=8, t_pad=None):
    """Pack (lane, start_pos, length) spans densely onto one token axis."""
    total = sum(n for _, _, n in spans)
    t_pad = t_pad or -(-total // tb) * tb
    token_lane = np.full((t_pad,), lanes, np.int32)
    token_pos = np.full((t_pad,), -1, np.int32)
    ctx = np.zeros((lanes,), np.int32)
    cur = 0
    for lane, start, n in spans:
        token_lane[cur: cur + n] = lane
        token_pos[cur: cur + n] = np.arange(start, start + n)
        ctx[lane] = start + n
        cur += n
    return token_lane, token_pos, ctx


RAGGED_CASES = {
    "decode_only": dict(spans=[(0, 4, 1), (1, 16, 1), (2, 28, 1)]),
    "prefill_span": dict(spans=[(2, 16, 13)]),
    "mixed_single_token_tail": dict(spans=[(0, 4, 1), (1, 8, 9), (2, 28, 1)]),
    "lane_hole_and_pads": dict(spans=[(0, 4, 1), (2, 20, 9)], t_pad=32),
    "single_lane_from_zero": dict(spans=[(1, 0, 17)]),
    "sliding_window": dict(spans=[(0, 4, 1), (1, 8, 9), (2, 20, 9)], window=6),
    "gqa_4_groups": dict(spans=[(0, 2, 3), (2, 25, 4)], heads=8),
}


@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ragged_matches_reference_and_pallas(case):
    spec = RAGGED_CASES[case]
    window = spec.get("window")
    heads = spec.get("heads", 4)
    k, v, tables, _ = build_cache()
    token_lane, token_pos, ctx = ragged_meta(spec["spans"], 3, t_pad=spec.get("t_pad"))
    q = np.random.default_rng(5).standard_normal((len(token_lane), heads, 16)).astype(np.float32)
    live = token_pos >= 0
    ours = attn.ragged_paged_attention(
        t(q), t(k), t(v), t(tables), t(ctx), t(token_lane), t(token_pos),
        sliding_window=window,
    )
    ref = jax_attn.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx), jnp.asarray(token_lane), jnp.asarray(token_pos),
        sliding_window=window,
    )
    meta = kernels.pack_page_meta(
        token_lane, token_pos, tables, tb_tokens=8, block_size=8, sliding_window=window,
    )
    for ours_a, ref_a in zip(meta, jax_pack_page_meta(
        token_lane, token_pos, tables, tb_tokens=8, block_size=8, sliding_window=window,
    )):
        np.testing.assert_array_equal(ours_a, ref_a)
    pallas = pallas_ragged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(token_lane),
        jnp.asarray(token_pos), *(jnp.asarray(a) for a in meta), tb_tokens=8,
        interpret=True, sliding_window=window,
    )
    close(ours, ref, live)
    close(ours, pallas, live)
    wrapped = kernels.ragged_paged_attention(
        t(q), t(k), t(v), t(tables), t(token_lane), t(token_pos),
        *(t(a) for a in meta), tb_tokens=8, sliding_window=window,
    )
    close(wrapped, ref, live)


def test_kernel_checks_refuse_fp8_caches_and_mixed_dtypes():
    from dynamo_tpu_torch.ops.kernels.common import check_cache

    q = torch.zeros((2, 4, 16), dtype=torch.bfloat16)
    fp8 = torch.zeros((4, 8, 2, 16), dtype=torch.float8_e4m3fn)
    # an fp8 (or any float) cache is read under bf16 or float32 queries; an
    # fp8 query, a non-float cache and a k/v pair of two dtypes are refused
    check_cache(q, fp8, fp8, 16, 16)
    check_cache(q.float(), fp8, fp8, 16, 16)
    with pytest.raises(ValueError, match="query dtype"):
        check_cache(q.to(torch.float8_e4m3fn), fp8, fp8, 16, 16)
    with pytest.raises(ValueError, match="not supported by the kernels"):
        check_cache(q, fp8.view(torch.int8), fp8.view(torch.int8), 16, 16)
    f32 = torch.zeros((4, 8, 2, 16), dtype=torch.float32)
    with pytest.raises(ValueError, match="differ in dtype"):
        check_cache(q, f32, fp8, 16, 16)
    with pytest.raises(ValueError, match="head dim"):
        check_cache(q.float()[..., :8].contiguous(), f32[..., :8].contiguous(),
                    f32[..., :8].contiguous(), 8, 8)
    check_cache(q.float(), f32, f32, 16, 16)


@pytest.mark.parametrize("page_slots", [None, 12])
def test_pack_page_meta_equals_reference(page_slots):
    _, _, tables, _ = build_cache()
    token_lane, token_pos, _ = ragged_meta([(0, 4, 1), (1, 8, 9), (2, 28, 1)], 3, t_pad=24)
    ours = kernels.pack_page_meta(
        token_lane, token_pos, tables, tb_tokens=8, block_size=8, page_slots=page_slots,
    )
    ref = jax_pack_page_meta(
        token_lane, token_pos, tables, tb_tokens=8, block_size=8, page_slots=page_slots,
    )
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        kernels.pack_page_meta(token_lane, token_pos, tables, tb_tokens=8,
                               block_size=8, page_slots=1)
