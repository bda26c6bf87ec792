"""The port's sampling tail (dynamo_tpu_torch.ops.sampling) and random
stream (dynamo_tpu_torch.ops.random) against the JAX reference: greedy ids
identical including ties, sampled ids identical when both draw the same
Gumbel noise and when the port draws it from the same keys, the threefry
bits identical, and the logits transforms within fp32 tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import sampling as jax_sampling
from dynamo_tpu_torch.ops import random, sampling

ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def sampling_inputs(seed, b=6, v=64):
    rng = np.random.default_rng(seed)
    # coarse logits: many exact ties, the case where sort order matters
    logits = np.round(rng.standard_normal((b, v)) * 2) / 2
    return (
        logits.astype(np.float32),
        np.array([0.0, 0.7, 1.0, 1.3, 2.0, 0.9], np.float32)[:b],
        np.array([0, 5, 0, 3, 0, 1], np.int32)[:b],
        np.array([1.0, 0.9, 0.5, 1.0, 0.3, 1.0], np.float32)[:b],
        np.array([True, False, False, False, False, False])[:b],
    )


def jax_keys(seed, b):
    return jax.random.split(jax.random.PRNGKey(seed), b)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sampled_ids_match_reference_with_shared_noise(seed):
    logits, temp, top_k, top_p, greedy = sampling_inputs(seed)
    b, v = logits.shape
    keys = jax_keys(seed, b)
    ref = jax_sampling.sample_tokens(
        jnp.asarray(logits), keys, jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), jnp.asarray(greedy),
    )
    # jax.random.categorical is argmax(logits + gumbel(key)) over the same
    # (sorted) row: hand the port the noise of the same keys
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (v,)))(keys))
    ours = sampling.sample_tokens(
        t(logits), t(noise), t(temp), t(top_k), t(top_p), t(greedy),
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_greedy_ids_match_reference_including_ties():
    logits = np.zeros((3, 16), np.float32)
    logits[0, [2, 7, 11]] = 1.0   # three-way tie
    logits[1, :] = 0.5            # all tied
    logits[2, [15, 0]] = 3.0
    zeros = np.zeros((3,), np.float32)
    args = (zeros, np.zeros((3,), np.int32), np.ones((3,), np.float32),
            np.ones((3,), bool))
    ref = jax_sampling.sample_tokens(
        jnp.asarray(logits), jax_keys(0, 3), *(jnp.asarray(a) for a in args)
    )
    ours = sampling.sample_tokens(t(logits), torch.zeros((3, 16)), *(t(a) for a in args))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_top_k_one_among_ties_picks_the_reference_token():
    """top_k=1 keeps only the first token of the descending sort: among
    ties the reference's reversed ascending sort puts the HIGHER index
    first, which a plain descending sort would not."""
    logits = np.zeros((2, 8), np.float32)
    logits[:, [1, 4, 6]] = 2.0
    temp = np.array([1.0, 1.0], np.float32)
    top_k = np.array([1, 1], np.int32)
    top_p = np.ones((2,), np.float32)
    greedy = np.zeros((2,), bool)
    keys = jax_keys(7, 2)
    ref = jax_sampling.sample_tokens(
        jnp.asarray(logits), keys, jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), jnp.asarray(greedy),
    )
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (8,)))(keys))
    ours = sampling.sample_tokens(t(logits), t(noise), t(temp), t(top_k), t(top_p), t(greedy))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert list(ours.numpy()) == [6, 6]


def test_penalties_and_logit_bias_match_reference():
    rng = np.random.default_rng(5)
    b, v = 4, 32
    logits = rng.standard_normal((b, v)).astype(np.float32)
    gen = rng.integers(0, 3, (b, v)).astype(np.int32)
    prompt = rng.integers(0, 2, (b, v)).astype(np.int32)
    pres = np.array([0.0, 0.5, 1.0, -0.5], np.float32)
    freq = np.array([0.0, 0.2, 0.0, 1.0], np.float32)
    rep = np.array([1.0, 1.3, 0.8, 1.1], np.float32)
    ref = jax_sampling.apply_penalties(*(jnp.asarray(a) for a in (logits, gen, prompt, pres, freq, rep)))
    ours = sampling.apply_penalties(*(t(a) for a in (logits, gen, prompt, pres, freq, rep)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)
    ids = np.array([[1, 5, v, v], [2, 2, 0, v], [v, v, v, v], [31, 0, 3, 4]], np.int32)
    vals = rng.standard_normal((b, 4)).astype(np.float32)
    ref_b = jax_sampling.apply_logit_bias(ref, jnp.asarray(ids), jnp.asarray(vals))
    ours_b = sampling.apply_logit_bias(ours, t(ids), t(vals))
    np.testing.assert_allclose(ours_b.numpy(), np.asarray(ref_b), atol=ATOL)


def test_logprobs_match_reference():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 40)).astype(np.float32)
    tokens = np.array([0, 17, 39], np.int32)
    np.testing.assert_allclose(
        sampling.token_logprobs(t(logits), t(tokens)).numpy(),
        np.asarray(jax_sampling.token_logprobs(jnp.asarray(logits), jnp.asarray(tokens))),
        atol=ATOL,
    )
    vals, ids = sampling.topk_logprobs(t(logits), 5)
    ref_vals, ref_ids = jax_sampling.topk_logprobs(jnp.asarray(logits), 5)
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_vals), atol=ATOL)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))


def raw_keys(seed, n):
    return np.random.default_rng(seed).integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)


def test_threefry_fold_in_and_bits_are_the_reference_bits():
    keys = raw_keys(0, 6)
    data = np.array([0, 1, 7, 4096, 2**31 + 5, 2**32 - 1], np.uint32)
    ref = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(data)))
    ours = random.fold_in(t(keys.astype(np.int64)), t(data.astype(np.int64)))
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.int64))
    # the 32-bit words behind uniform/gumbel, odd and even sizes
    for size in (7, 64):
        bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (size,)))(jnp.asarray(ref)))
        counts = torch.arange(size, dtype=torch.int64)[None, :]
        b0, b1 = random.threefry2x32(
            ours[:, 0:1], ours[:, 1:2], torch.zeros_like(counts), counts)
        np.testing.assert_array_equal((b0 ^ b1).numpy(), bits.astype(np.int64))


def test_gumbel_matches_reference_up_to_the_last_log_bit():
    keys = raw_keys(1, 4)
    ref = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (300,)))(jnp.asarray(keys)))
    ours = random.gumbel(t(keys.astype(np.int64)), 300).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sampled_ids_match_reference_from_the_same_keys(seed):
    logits, temp, top_k, top_p, greedy = sampling_inputs(seed)
    b, v = logits.shape
    keys = raw_keys(seed, b)
    ref = jax_sampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), jnp.asarray(greedy),
    )
    noise = random.gumbel(t(keys.astype(np.int64)), v)
    ours = sampling.sample_tokens(t(logits), noise, t(temp), t(top_k), t(top_p), t(greedy))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
