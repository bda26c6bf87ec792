"""The port's MLA attention (plain versions in dynamo_tpu_torch.ops.attention,
the wrappers in ops.kernels.mla_attention) and its rope extension against
the JAX reference on the same numpy inputs, in float32: the ragged plain
version against the JAX twin (ops/attention.ragged_mla_paged_attention) and
the Pallas ragged kernel in interpret mode; the decode plain version against
the reference's gather branch of _mla_decode_attn and the Pallas decode
kernel in interpret mode.  atol 2e-5: summation order of float32 products
over up to 32 positions of width 48.  Pad rows and idle lanes are junk on
the plain path and are compared only where they are defined."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import attention as jax_attn
from dynamo_tpu.ops import rope as jax_rope
from dynamo_tpu.ops.pallas import pack_page_meta as jax_pack_page_meta
from dynamo_tpu.ops.pallas import ragged_mla_attention as pallas_ragged_mla
from dynamo_tpu.ops.pallas.mla_attention import mla_paged_attention_decode as pallas_mla_decode
from dynamo_tpu_torch.ops import attention as attn
from dynamo_tpu_torch.ops import kernels
from dynamo_tpu_torch.ops.kernels import mla_attention as mla_kernels
from dynamo_tpu_torch.ops.rope import rope_table, yarn_mscale

ATOL = 2e-5
H, R, P, BS, MAXB, NBLOCKS = 4, 32, 16, 8, 4, 16
SCALE = 0.17
V2_LITE_ROPE = {"type": "yarn", "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707,
                "original_max_position_embeddings": 4096, "beta_fast": 32, "beta_slow": 1}


def t(a):
    return torch.from_numpy(np.array(a))


def close(ours, ref, mask=None):
    ours, ref = np.asarray(ours), np.asarray(ref)
    if mask is not None:
        ours, ref = ours[mask], ref[mask]
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=ATOL)


def latent_cache(seed=0):
    rng = np.random.default_rng(seed)
    ck = rng.standard_normal((NBLOCKS, BS, R)).astype(np.float32)
    kr = rng.standard_normal((NBLOCKS, BS, P)).astype(np.float32)
    tables = rng.permutation(NBLOCKS)[: 3 * MAXB].astype(np.int32).reshape(3, MAXB)
    return ck, kr, tables


def jax_decode_gather(q_lat, q_rope, ck, kr, tables, ctx, scale):
    """The gather branch of dynamo_tpu/models/deepseek.py _mla_decode_attn."""
    b = q_lat.shape[0]
    length = tables.shape[1] * ck.shape[1]
    ckg = ck[tables].reshape(b, length, ck.shape[-1])
    krg = kr[tables].reshape(b, length, kr.shape[-1])
    logits = (jnp.einsum("bhr,btr->bht", q_lat, ckg.astype(jnp.float32))
              + jnp.einsum("bhp,btp->bht", q_rope.astype(jnp.float32),
                           krg.astype(jnp.float32))) * scale
    valid = jnp.arange(length)[None, :] < ctx[:, None]
    logits = jnp.where(valid[:, None, :], logits, jax_attn.NEG_INF)
    return jnp.einsum("bht,btr->bhr", jax.nn.softmax(logits, axis=-1), ckg.astype(jnp.float32))


@pytest.mark.parametrize("ctx", [(5, 17, 29), (32, 1, 0)], ids=["mixed", "full_one_idle"])
def test_mla_decode_matches_reference_and_pallas(ctx):
    ck, kr, tables = latent_cache()
    ctx = np.asarray(ctx, np.int32)
    rng = np.random.default_rng(1)
    q_lat = rng.standard_normal((3, H, R)).astype(np.float32)
    q_rope = rng.standard_normal((3, H, P)).astype(np.float32)
    live = ctx > 0
    ours = attn.mla_paged_decode_attention(
        t(q_lat), t(q_rope), t(ck), t(kr), t(tables), t(ctx), scale=SCALE)
    assert ours.dtype == torch.float32 and ours.shape == (3, H, R)
    args = [jnp.asarray(a) for a in (q_lat, q_rope, ck, kr, tables, ctx)]
    close(ours, jax_decode_gather(*args, SCALE), live)
    pallas = pallas_mla_decode(*args, scale=SCALE, interpret=True)
    close(ours, pallas, live)
    # the Pallas kernel writes zeros for an idle lane; the port's kernel too
    assert np.all(np.asarray(pallas)[~live] == 0)
    before = mla_kernels.decode_plain_calls
    close(kernels.mla_paged_attention_decode(
        t(q_lat), t(q_rope), t(ck), t(kr), t(tables), t(ctx), scale=SCALE), ours)
    assert mla_kernels.decode_plain_calls == before + 1


def ragged_meta(spans, lanes=3, tb=8, t_pad=None):
    total = sum(n for _, _, n in spans)
    t_pad = t_pad or -(-total // tb) * tb
    token_lane = np.full((t_pad,), lanes, np.int32)
    token_pos = np.full((t_pad,), -1, np.int32)
    cur = 0
    for lane, start, n in spans:
        token_lane[cur: cur + n] = lane
        token_pos[cur: cur + n] = np.arange(start, start + n)
        cur += n
    return token_lane, token_pos


RAGGED_CASES = {
    # the reference kernel test's mix: a span, a decode token, a span
    "reference_mix": dict(spans=[(0, 2, 3), (1, 16, 1), (2, 24, 5)]),
    "decode_only": dict(spans=[(0, 4, 1), (1, 16, 1), (2, 28, 1)]),
    "prefill_from_zero": dict(spans=[(1, 0, 17)]),
    "lane_hole_and_pad_blocks": dict(spans=[(0, 4, 1), (2, 20, 9)], t_pad=32),
}


@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ragged_mla_matches_reference_and_pallas(case):
    spec = RAGGED_CASES[case]
    ck, kr, tables = latent_cache()
    token_lane, token_pos = ragged_meta(spec["spans"], t_pad=spec.get("t_pad"))
    n = len(token_lane)
    rng = np.random.default_rng(2)
    q_lat = rng.standard_normal((n, H, R)).astype(np.float32)
    q_rope = rng.standard_normal((n, H, P)).astype(np.float32)
    live = token_pos >= 0
    ours = attn.ragged_mla_paged_attention(
        t(q_lat), t(q_rope), t(ck), t(kr), t(tables), t(token_lane), t(token_pos),
        scale=SCALE)
    assert ours.dtype == torch.float32 and ours.shape == (n, H, R)
    ref = jax_attn.ragged_mla_paged_attention(
        *(jnp.asarray(a) for a in (q_lat, q_rope, ck, kr, tables, token_lane, token_pos)),
        scale=SCALE)
    close(ours, ref, live)
    meta = kernels.pack_page_meta(token_lane, token_pos, tables, tb_tokens=8, block_size=BS)
    for a, b in zip(meta, jax_pack_page_meta(token_lane, token_pos, tables, tb_tokens=8,
                                             block_size=BS)):
        np.testing.assert_array_equal(a, b)
    pallas = pallas_ragged_mla(
        *(jnp.asarray(a) for a in (q_lat, q_rope, ck, kr, token_lane, token_pos)),
        *(jnp.asarray(a) for a in meta), scale=SCALE, tb_tokens=8, interpret=True)
    close(ours, pallas, live)
    assert np.all(np.asarray(pallas)[~live] == 0)  # pad rows: zeros in the kernels
    before = mla_kernels.ragged_plain_calls
    wrapped = kernels.ragged_mla_attention(
        t(q_lat), t(q_rope), t(ck), t(kr), t(tables), t(token_lane), t(token_pos),
        *(t(a) for a in meta), scale=SCALE, tb_tokens=8)
    close(wrapped, ours, live)
    assert mla_kernels.ragged_plain_calls == before + 1


def test_ragged_mla_token_chunks_match_one_gather():
    ck, kr, tables = latent_cache()
    token_lane, token_pos = ragged_meta([(0, 4, 1), (1, 8, 9), (2, 20, 9)])
    rng = np.random.default_rng(4)
    q_lat = rng.standard_normal((len(token_lane), H, R)).astype(np.float32)
    q_rope = rng.standard_normal((len(token_lane), H, P)).astype(np.float32)
    args = [t(a) for a in (q_lat, q_rope, ck, kr, tables, token_lane, token_pos)]
    one = attn.ragged_mla_paged_attention(*args, scale=SCALE, max_gather_tokens=4096)
    chunked = attn.ragged_mla_paged_attention(*args, scale=SCALE, max_gather_tokens=5)
    torch.testing.assert_close(chunked, one, atol=1e-6, rtol=1e-6)


def test_mla_wrappers_refuse_fp8_mixed_dtypes_other_widths_and_devices():
    q_lat = torch.zeros((2, 4, 32))
    q_rope = torch.zeros((2, 4, 8), dtype=torch.bfloat16)
    ck = torch.zeros((4, 16, 32), dtype=torch.bfloat16)
    kr = torch.zeros((4, 16, 8), dtype=torch.bfloat16)
    mla_kernels._check(q_lat, q_rope, ck, kr)
    fp8 = torch.float8_e4m3fn
    # fp8 caches are read (and upcast) under bf16 or float32 queries; an fp8
    # query is refused
    mla_kernels._check(q_lat, q_rope, ck.to(fp8), kr.to(fp8))
    mla_kernels._check(q_lat, q_rope.float(), ck.to(torch.float8_e5m2), kr.to(torch.float8_e5m2))
    with pytest.raises(ValueError, match="q_rope must be float32 or bfloat16"):
        mla_kernels._check(q_lat, q_rope.to(fp8), ck.to(fp8), kr.to(fp8))
    with pytest.raises(ValueError, match="q_lat must be float32"):
        mla_kernels._check(q_lat.bfloat16(), q_rope, ck, kr)
    with pytest.raises(ValueError, match="share one dtype"):
        mla_kernels._check(q_lat, q_rope, ck, kr.float())
    with pytest.raises(ValueError, match="share one dtype"):
        mla_kernels._check(q_lat, q_rope, ck.to(torch.int8), kr.to(torch.int8))
    with pytest.raises(ValueError, match="widths"):
        mla_kernels._check(q_lat[..., :16].contiguous(), q_rope, ck[..., :16].contiguous(), kr)
    meta = lambda x: x.to("meta")  # noqa: E731
    tables = torch.zeros((2, 1), dtype=torch.int32)
    ctx = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.mla_paged_attention_decode(
            meta(q_lat), meta(q_rope), meta(ck), meta(kr), meta(tables), meta(ctx), scale=1.0)


def test_yarn_mscale_and_attention_factor_follow_the_reference():
    m = yarn_mscale(V2_LITE_ROPE)
    assert m == pytest.approx(0.1 * 0.707 * math.log(40) + 1)
    assert m == pytest.approx(1.2608, abs=1e-4)
    assert m == jax_rope.yarn_mscale(V2_LITE_ROPE)
    assert yarn_mscale(None) == 1.0
    assert yarn_mscale({"type": "yarn", "factor": 40}) == 1.0  # no mscale_all_dim
    for apply in (True, False):
        cos, sin = rope_table(512, 64, 10000.0, scaling=V2_LITE_ROPE,
                              yarn_apply_attention_factor=apply)
        jcos, jsin = jax_rope.rope_table(512, 64, 10000.0, scaling=V2_LITE_ROPE,
                                         yarn_apply_attention_factor=apply)
        close(cos, jcos)
        close(sin, jsin)
    plain, _ = rope_table(8, 64, 10000.0, scaling=V2_LITE_ROPE,
                          yarn_apply_attention_factor=False)
    assert plain[0, 0].item() == 1.0  # cos(0) with no factor baked in
