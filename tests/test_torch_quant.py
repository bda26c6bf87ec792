"""The port's quantized paths against the JAX reference, on the same numpy
inputs, on the CPU:

- int8 weight-only quantization (``ops/quant.py``): ``quantize_matrix``'s
  values and scales, ``mm`` and ``qeinsum`` bitwise equal to
  dynamo_tpu/ops/quant.py's, ``quantize_params`` over a family's
  ``quant_leaves``, and ``params_from_jax`` carrying the reference's
  ``QuantizedMatrix`` nodes;
- the fp8 casts of a cache write (``to_cache_dtype``): byte-equal to the
  reference's ``astype`` over every bfloat16 and float16 value and a float32
  sweep (subnormals, 448, 464, 480, large values, infinities and NaN);
  torch's own cast differs there (it saturates e4m3fn at 448 and keeps the
  sign of an e5m2 NaN), and the test shows where;
- rows 1-5's plain versions over fp8 e4m3fn and e5m2 caches against the
  JAX twins and the Pallas kernels in interpret mode (rtol/atol 2e-4, the
  reference's tolerance in tests/engine/test_quantized_unified.py);
- the Llama unified forward over one fp8 cache against the reference's, and
  the cache bytes both write.

A single-row float32 product may take another accumulation order in either
library (a matrix-vector path), so the products are held bitwise at eight
rows."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.models import deepseek as jax_ds
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.models.registry import get_family as jax_family
from dynamo_tpu.ops import attention as jax_attn
from dynamo_tpu.ops import quant as jax_quant
from dynamo_tpu.ops.pallas import pack_page_meta as jax_pack_page_meta
from dynamo_tpu.ops.pallas import paged_window_attention_decode as pallas_window
from dynamo_tpu.ops.pallas import ragged_mla_attention as pallas_ragged_mla
from dynamo_tpu.ops.pallas import ragged_paged_attention as pallas_ragged
from dynamo_tpu.ops.pallas.mla_attention import mla_paged_attention_decode as pallas_mla_decode
from dynamo_tpu.ops.pallas.mla_attention import (
    mla_paged_window_attention_decode as pallas_mla_window,
)
from dynamo_tpu_torch.models import deepseek, llama
from dynamo_tpu_torch.models.llama import _tensor_from_numpy, params_from_jax
from dynamo_tpu_torch.models.registry import get_family
from dynamo_tpu_torch.ops import attention as attn
from dynamo_tpu_torch.ops import kernels
from dynamo_tpu_torch.ops.quant import (
    QuantizedMatrix,
    dequantize_matrix,
    is_quantized,
    mm,
    qeinsum,
    quantize_matrix,
    quantize_params,
)

from tests.test_torch_mla import jax_decode_gather

TOL = 2e-4  # the reference's forward tolerance on one fp8 cache
FP8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def t(a):
    return _tensor_from_numpy(a)


def bits(x) -> np.ndarray:
    """The raw bytes of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


# ---------------------------------------------------------------------------
# int8 weight-only quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 96), (3, 64, 96), (2, 4, 32, 48)],
                         ids=["matrix", "layer_stack", "expert_banks"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matrix_mm_and_qeinsum_are_bitwise_the_reference(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero out channel: scale 1
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    ours = quantize_matrix(t(np.asarray(jw)))
    ref = jax_quant.quantize_matrix(jw)
    assert ours.q.dtype == torch.int8 and ours.s.dtype == torch.float32
    assert ours.q.shape == ref.q.shape and ours.s.shape == ref.s.shape
    np.testing.assert_array_equal(ours.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(bits(ours.s), bits(ref.s))
    np.testing.assert_array_equal(bits(dequantize_matrix(ours)),
                                  bits(jax_quant.dequantize_matrix(ref)))
    x = rng.standard_normal((*shape[:-2], 8, shape[-2])).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    if len(shape) == 2:
        np.testing.assert_array_equal(bits(mm(t(np.asarray(jx)), ours)),
                                      bits(jax_quant.mm(jx, ref)))
        np.testing.assert_array_equal(bits(mm(t(np.asarray(jx)), t(np.asarray(jw)))),
                                      bits(jax_quant.mm(jx, jw)))
    else:  # a layer of the stack: the leading index slices both leaves
        layer = ours[1]
        assert isinstance(layer, QuantizedMatrix) and layer.shape == tuple(shape[1:])
        spec = "ech,ehi->eci" if len(shape) == 4 else "ch,hi->ci"
        jref = jax_quant.QuantizedMatrix(q=ref.q[1], s=ref.s[1])
        np.testing.assert_array_equal(bits(qeinsum(spec, t(np.asarray(jx[1])), layer)),
                                      bits(jax_quant.qeinsum(spec, jx[1], jref)))


@pytest.mark.parametrize("family", ["llama", "deepseek_v2"])
def test_quantize_params_follows_the_reference_leaves_and_carries_its_nodes(family):
    """The family's quant_leaves are the reference's; quantizing the same
    float tree gives the reference's int8 tree bitwise; params_from_jax
    carries the reference's quantized nodes into the port's class."""
    assert get_family(family).quant_leaves == jax_family(family).quant_leaves
    if family == "llama":
        jcfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(), tie_word_embeddings=False)
        jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    else:
        jparams = jax_ds.init_params(jax_ds.DeepseekConfig.tiny_mla(), jax.random.PRNGKey(0))
    leaves = get_family(family).quant_leaves
    jq = jax_quant.quantize_params(jparams, leaves)
    carried = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    ours = quantize_params(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"),
                           leaves)
    assert is_quantized(ours) and is_quantized(carried)
    assert not is_quantized(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))

    def walk(a, b, c, path=""):
        if isinstance(c, dict):
            assert set(a) == set(b) == set(c), path
            for k in c:
                walk(a[k], b[k], c[k], f"{path}/{k}")
            return
        if isinstance(c, jax_quant.QuantizedMatrix):
            assert path.rsplit("/", 1)[1] in leaves
            for x in (a, b):
                assert isinstance(x, QuantizedMatrix), path
                np.testing.assert_array_equal(x.q.numpy(), np.asarray(c.q))
                np.testing.assert_array_equal(bits(x.s), bits(c.s))
        else:
            assert path.rsplit("/", 1)[1] not in leaves
            np.testing.assert_array_equal(bits(a), bits(np.asarray(c)))

    walk(ours, carried, jq)
    if family == "deepseek_v2":
        # the absorbed up-projections stay full precision
        assert isinstance(ours["moe_layers"]["w_uk"], torch.Tensor)
        assert isinstance(ours["moe_layers"]["w_gate"], QuantizedMatrix)
        assert ours["moe_layers"]["w_gate"].s.shape[-2] == 1  # per (layer, expert, out)


# ---------------------------------------------------------------------------
# the fp8 casts
# ---------------------------------------------------------------------------

def _sweep(source: str) -> np.ndarray:
    if source == "bfloat16":  # every bfloat16 value
        return np.arange(65536, dtype=np.uint32).astype(np.uint16).view(ml_dtypes.bfloat16)
    if source == "float16":  # every float16 value
        return np.arange(65536, dtype=np.uint32).astype(np.uint16).view(np.float16)
    special = np.array([
        0.0, -0.0, 2.0**-10, 2.0**-9, 1.5 * 2.0**-9, 2.0**-7, 2.0**-6, 2.0**-16, 2.0**-17,
        1.5 * 2.0**-17, 0.1, 1.0, 1.0625, 240.0, 440.0, 448.0, 449.0, 456.0, 464.0, 464.5,
        465.0, 480.0, 500.0, -448.0, -464.0, -480.0, 57344.0, 61440.0, 65536.0, 1e6, -1e6,
        1e30, np.inf, -np.inf, np.nan, -np.nan], np.float32)
    payload_nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FA00000, 0xFF800001],
                            np.uint32).view(np.float32)
    rnd = np.random.default_rng(0).integers(0, 2**32, 200_000, dtype=np.uint64)
    return np.concatenate([special, payload_nans, rnd.astype(np.uint32).view(np.float32)])


@pytest.mark.parametrize("target", sorted(FP8))
@pytest.mark.parametrize("source", ["float32", "bfloat16", "float16"])
def test_fp8_cache_cast_is_bytewise_the_reference(source, target):
    x = _sweep(source)
    ref = bits(jnp.asarray(x).astype(getattr(jnp, target)))
    ours = attn.to_cache_dtype(t(x), FP8[target])
    assert ours.dtype == FP8[target]
    np.testing.assert_array_equal(bits(ours), ref)
    # where torch's own cast differs from the reference's
    plain = bits(t(x).to(FP8[target]))
    wide = x.astype(np.float32)
    differs = plain != ref
    if target == "float8_e4m3fn":  # torch saturates at 448: the reference gives NaN
        assert np.all(np.abs(wide[differs]) > 464)
        assert differs.any()
    else:  # only NaNs' bytes
        assert np.all(np.isnan(wide[differs]))
    # an fp8 array of the reference becomes the same bits in the port
    np.testing.assert_array_equal(bits(t(np.asarray(jnp.asarray(x).astype(
        getattr(jnp, target))))), ref)


def test_cache_writes_cast_and_read_back_through_uint8_views():
    """The cache writes (decode rows, prefill spans) store the reference's
    bytes; a one-byte cache is allocated and indexed through its uint8
    view."""
    rng = np.random.default_rng(3)
    nb, bs, kvh, d = 4, 4, 2, 8
    k_new = (rng.standard_normal((5, kvh, d)) * 300).astype(np.float32)
    v_new = rng.standard_normal((5, kvh, d)).astype(np.float32)
    slots = np.array([3, nb * bs, 9, nb * bs + 7, 0], np.int32)
    for target, dtype in FP8.items():
        jk = jnp.zeros((nb, bs, kvh, d), getattr(jnp, target))
        ref_k, ref_v = jax_attn.write_decode_kv(jk, jk, jnp.asarray(k_new), jnp.asarray(v_new),
                                                jnp.asarray(slots))
        leaf = attn.alloc_cache_leaf((1, nb, bs, kvh, d), dtype, "cpu")
        ours_k, ours_v = attn.write_decode_kv(leaf[0], leaf[0].clone(), t(k_new), t(v_new),
                                              t(slots))
        np.testing.assert_array_equal(bits(ours_k), bits(ref_k))
        np.testing.assert_array_equal(bits(ours_v), bits(ref_v))
        taken = attn.cache_take(ours_k, torch.tensor([[2, 0]]))
        assert taken.dtype == dtype and taken.shape == (1, 2, bs, kvh, d)
        np.testing.assert_array_equal(bits(taken), bits(ref_k)[[[2, 0]]])


# ---------------------------------------------------------------------------
# rows 1-5 over fp8 caches
# ---------------------------------------------------------------------------

def close(ours, ref, mask=None):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    if mask is not None:
        ours, ref = ours[mask], ref[mask]
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def fp8_pair(a: np.ndarray, target: str):
    """An fp8 cache as (port tensor, reference array) of the same bytes."""
    ref = jnp.asarray(a).astype(getattr(jnp, target))
    return t(np.asarray(ref)), ref


def ragged_tokens(spans, lanes, tb=8):
    total = sum(n for _, _, n in spans)
    t_pad = -(-total // tb) * tb
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


@pytest.mark.parametrize("target", sorted(FP8))
def test_gqa_rows_1_and_2_over_fp8_caches(target):
    rng = np.random.default_rng(11)
    nb, bs, kvh, d, maxb = 16, 8, 2, 16, 4
    k8, jk8 = fp8_pair(rng.standard_normal((nb, bs, kvh, d)).astype(np.float32), target)
    v8, jv8 = fp8_pair(rng.standard_normal((nb, bs, kvh, d)).astype(np.float32), target)
    tables = rng.permutation(nb)[: 3 * maxb].astype(np.int32).reshape(3, maxb)
    # row 2: decode (W = 1) and a verify window (W = 3)
    ctx = np.array([9, 17, 29], np.int32)
    for w in (1, 3):
        q = rng.standard_normal((3, w, 4, d)).astype(np.float32)
        ours = kernels.paged_window_attention_decode(t(q), k8, v8, t(tables), t(ctx))
        jargs = (jnp.asarray(q), jk8, jv8, jnp.asarray(tables), jnp.asarray(ctx))
        close(ours, jax_attn.paged_window_attention(*jargs))
        close(ours, pallas_window(*jargs, interpret=True))
    # row 1: a span, decode tokens and pads
    token_lane, token_pos, ctx = ragged_tokens([(0, 4, 1), (1, 8, 9), (2, 20, 9)], 3)
    q = rng.standard_normal((len(token_lane), 4, d)).astype(np.float32)
    live = token_pos >= 0
    meta = kernels.pack_page_meta(token_lane, token_pos, tables, tb_tokens=8, block_size=bs)
    ours = kernels.ragged_paged_attention(
        t(q), k8, v8, t(tables), t(token_lane), t(token_pos), *(t(a) for a in meta), tb_tokens=8)
    ref = jax_attn.ragged_paged_attention(
        jnp.asarray(q), jk8, jv8, jnp.asarray(tables), jnp.asarray(ctx),
        jnp.asarray(token_lane), jnp.asarray(token_pos))
    pallas = pallas_ragged(jnp.asarray(q), jk8, jv8, jnp.asarray(token_lane),
                           jnp.asarray(token_pos), *(jnp.asarray(a) for a in meta),
                           tb_tokens=8, interpret=True)
    close(ours, ref, live)
    close(ours, pallas, live)


@pytest.mark.parametrize("target", sorted(FP8))
def test_mla_rows_3_to_5_over_fp8_caches(target):
    rng = np.random.default_rng(12)
    h, r, p, bs, maxb, nb, scale = 4, 32, 16, 8, 4, 16, 0.17
    ck8, jck8 = fp8_pair(rng.standard_normal((nb, bs, r)).astype(np.float32), target)
    kr8, jkr8 = fp8_pair(rng.standard_normal((nb, bs, p)).astype(np.float32), target)
    tables = rng.permutation(nb)[: 3 * maxb].astype(np.int32).reshape(3, maxb)
    ctx = np.array([5, 17, 29], np.int32)
    # row 4: decode
    q_lat = rng.standard_normal((3, h, r)).astype(np.float32)
    q_rope = rng.standard_normal((3, h, p)).astype(np.float32)
    ours = kernels.mla_paged_attention_decode(t(q_lat), t(q_rope), ck8, kr8, t(tables), t(ctx),
                                              scale=scale)
    jargs = (jnp.asarray(q_lat), jnp.asarray(q_rope), jck8, jkr8, jnp.asarray(tables),
             jnp.asarray(ctx))
    close(ours, jax_decode_gather(*jargs, scale))
    close(ours, pallas_mla_decode(*jargs, scale=scale, interpret=True))
    # row 5: a verify window of 3 queries
    q_lat = rng.standard_normal((3, 3, h, r)).astype(np.float32)
    q_rope = rng.standard_normal((3, 3, h, p)).astype(np.float32)
    ours = kernels.mla_paged_window_attention_decode(
        t(q_lat), t(q_rope), ck8, kr8, t(tables), t(ctx), scale=scale)
    jargs = (jnp.asarray(q_lat), jnp.asarray(q_rope), jck8, jkr8, jnp.asarray(tables),
             jnp.asarray(ctx))
    close(ours, pallas_mla_window(*jargs, scale=scale, interpret=True))
    # row 3: ragged
    token_lane, token_pos, _ = ragged_tokens([(0, 2, 3), (1, 16, 1), (2, 24, 5)], 3)
    n = len(token_lane)
    q_lat = rng.standard_normal((n, h, r)).astype(np.float32)
    q_rope = rng.standard_normal((n, h, p)).astype(np.float32)
    live = token_pos >= 0
    meta = kernels.pack_page_meta(token_lane, token_pos, tables, tb_tokens=8, block_size=bs)
    for a, b in zip(meta, jax_pack_page_meta(token_lane, token_pos, tables, tb_tokens=8,
                                             block_size=bs)):
        np.testing.assert_array_equal(a, b)
    ours = kernels.ragged_mla_attention(
        t(q_lat), t(q_rope), ck8, kr8, t(tables), t(token_lane), t(token_pos),
        *(t(a) for a in meta), scale=scale, tb_tokens=8)
    jq = (jnp.asarray(q_lat), jnp.asarray(q_rope))
    ref = jax_attn.ragged_mla_paged_attention(
        *jq, jck8, jkr8, jnp.asarray(tables), jnp.asarray(token_lane), jnp.asarray(token_pos),
        scale=scale)
    pallas = pallas_ragged_mla(*jq, jck8, jkr8, jnp.asarray(token_lane), jnp.asarray(token_pos),
                               *(jnp.asarray(a) for a in meta), scale=scale, tb_tokens=8,
                               interpret=True)
    close(ours, ref, live)
    close(ours, pallas, live)


def test_llama_unified_forward_over_one_fp8_cache_matches_the_reference():
    """The reference's test_fp8_unified_forward_kernel_vs_twin, with the
    port's forward beside it: logits within 2e-4 of the JAX twin and of the
    Pallas kernel in interpret mode, and the fp8 bytes all three wrote
    equal."""
    cfg, jcfg = llama.LlamaConfig.tiny(), jax_llama.LlamaConfig.tiny()
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    bs, lanes, maxb, tb = 4, 4, 4, 4
    jcache = jax_llama.init_kv_cache(jcfg, num_blocks=32, block_size=bs,
                                     dtype=jnp.float8_e4m3fn)
    cache = llama.init_kv_cache(cfg, 32, bs, torch.float8_e4m3fn, "cpu")
    assert cache["k"].dtype == torch.float8_e4m3fn
    tables = np.arange(lanes * maxb, dtype=np.int32).reshape(lanes, maxb)
    token_lane, token_pos, ctx = ragged_tokens([(0, 0, 6), (1, 3, 1), (2, 5, 1), (3, 2, 1)],
                                               lanes, tb=tb)
    t_pad = len(token_lane)
    safe_lane = np.clip(token_lane, 0, lanes - 1)
    safe_pos = np.clip(token_pos, 0, None)
    slot = np.where(token_pos >= 0, tables[safe_lane, safe_pos // bs] * bs + safe_pos % bs,
                    32 * bs).astype(np.int32)
    meta = jax_pack_page_meta(token_lane, token_pos, tables, tb_tokens=tb, block_size=bs,
                              page_slots=8)
    tokens = (np.arange(3, 3 + t_pad) % cfg.vocab_size).astype(np.int32)
    rows = np.array([5, 6, 7, 8], np.int32)
    jcos, jsin = jax_llama.make_rope_tables(jcfg)
    cos, sin = llama.make_rope_tables(cfg, "cpu")
    arrays = (tokens, tables, ctx, token_pos, slot, token_lane)
    jargs = (jparams, jcfg, jnp.asarray(tokens), jcache, *(jnp.asarray(a) for a in arrays[1:]),
             *(jnp.asarray(a) for a in meta), jnp.asarray(rows), jcos, jsin)
    ref_logits, ref_cache = jax_llama.llama_forward_unified(*jargs, attention="jax", tb_tokens=tb)
    pal_logits, _ = jax_llama.llama_forward_unified(*jargs, attention="pallas_interpret",
                                                    tb_tokens=tb, pages_per_step=2)
    ours, ours_cache = llama.llama_forward_unified(
        params, cfg, t(tokens), cache, *(t(a) for a in arrays[1:]), *(t(a) for a in meta),
        t(rows), cos, sin, tb_tokens=tb)
    close(ours, ref_logits)
    close(ours, pal_logits)
    for name in ("k", "v"):
        np.testing.assert_array_equal(bits(ours_cache[name]), bits(ref_cache[name]))


def test_deepseek_init_kv_cache_takes_the_cache_dtype():
    cfg = deepseek.DeepseekConfig.tiny_mla()
    cache = deepseek.init_kv_cache(cfg, 8, 4, torch.float8_e5m2, "cpu")
    assert {v.dtype for v in cache.values()} == {torch.float8_e5m2}
    assert cache["k"].shape[-1] == cfg.kv_lora_rank
    assert float(cache["k"].float().abs().sum()) == 0.0
