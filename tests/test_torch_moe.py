"""The port's MoE ops (dynamo_tpu_torch.ops.moe) against the JAX reference
(dynamo_tpu/ops/moe.py) on the same numpy inputs: router expert ids must be
identical (ties included), routing weights and combined outputs agree
within float32 tolerance (atol 1e-5: summation order of the f32 matmuls and
the combine)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import moe as jax_moe
from dynamo_tpu_torch.ops import moe

ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def inputs(seed, tokens=12, hidden=16, experts=8, inter=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((tokens, hidden)).astype(np.float32)
    w_router = rng.standard_normal((hidden, experts)).astype(np.float32)
    banks = [rng.standard_normal(s).astype(np.float32) / 4 for s in (
        (experts, hidden, inter), (experts, hidden, inter), (experts, inter, hidden))]
    bias = rng.standard_normal((experts,)).astype(np.float32) * 0.1
    return x, w_router, banks, bias


@pytest.mark.parametrize("norm_topk_prob", [True, False])
def test_softmax_router_matches_reference(norm_topk_prob):
    x, w_router, _, _ = inputs(0)
    ids, probs = moe.moe_router(t(x), t(w_router), 3, norm_topk_prob=norm_topk_prob)
    ref_ids, ref_probs = jax_moe.moe_router(
        jnp.asarray(x), jnp.asarray(w_router), 3, norm_topk_prob=norm_topk_prob)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs), atol=ATOL, rtol=0)


def test_router_ties_put_the_lower_expert_first():
    """Equal router scores (a zero router row): jax.lax.top_k orders ties by
    index, and so must the port."""
    x = np.ones((3, 4), np.float32)
    w_router = np.zeros((4, 6), np.float32)
    w_router[:, 4] = 1.0  # expert 4 wins, the rest tie
    ids, _ = moe.moe_router(t(x), t(w_router), 3)
    ref_ids, _ = jax_moe.moe_router(jnp.asarray(x), jnp.asarray(w_router), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    assert ids[0].tolist() == [4, 0, 1]


@pytest.mark.parametrize("n_group,topk_group", [(1, 1), (4, 2)])
def test_sigmoid_noaux_router_matches_reference(n_group, topk_group):
    x, w_router, _, bias = inputs(1)
    ids, probs = moe.moe_router_sigmoid_noaux(
        t(x), t(w_router), t(bias), 3, n_group=n_group, topk_group=topk_group)
    ref_ids, ref_probs = jax_moe.moe_router_sigmoid_noaux(
        jnp.asarray(x), jnp.asarray(w_router), jnp.asarray(bias), 3,
        n_group=n_group, topk_group=topk_group)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs), atol=ATOL, rtol=0)


MOE_CASES = {
    # name: (tokens, top_k, capacity_factor, scoring, n_group, topk_group, norm)
    "softmax_norm": (12, 2, 2.0, "softmax", 1, 1, True),
    "softmax_raw_weights": (12, 2, 2.0, "softmax", 1, 1, False),
    "capacity_drops": (12, 3, 0.5, "softmax", 1, 1, True),
    "sigmoid_grouped": (10, 2, 2.0, "sigmoid_noaux", 4, 2, True),
    "single_token_capacity_one": (1, 2, 1.0, "softmax", 1, 1, True),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_reference(case):
    tokens, k, cf, scoring, n_group, topk_group, norm = MOE_CASES[case]
    x, w_router, (wg, wu, wd), bias = inputs(2, tokens=tokens)
    kw = dict(top_k=k, capacity_factor=cf, scoring=scoring, n_group=n_group,
              topk_group=topk_group, norm_topk_prob=norm)
    ours = moe.moe_ffn(t(x), t(w_router), t(wg), t(wu), t(wd), router_bias=t(bias), **kw)
    ref = jax_moe.moe_ffn(jnp.asarray(x), jnp.asarray(w_router), jnp.asarray(wg),
                          jnp.asarray(wu), jnp.asarray(wd), router_bias=jnp.asarray(bias),
                          **kw)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if case == "capacity_drops":
        # capacity int(12 * 3 / 8 * 0.5) = 2 slots an expert: some pairs drop
        ids, _ = moe.moe_router(t(x), t(w_router), k)
        assert np.bincount(ids.numpy().ravel(), minlength=8).max() > 2


def test_dispatch_drops_in_token_order_and_idle_tokens_first():
    """Capacity is taken over the padded token count and slots go token
    major: with idle (zero) tokens ahead of live ones, the idle tokens take
    the first slots and the late live pairs drop to exactly 0."""
    rng = np.random.default_rng(3)
    x = np.zeros((6, 8), np.float32)
    x[3:] = rng.standard_normal((3, 8)).astype(np.float32)
    ids = np.array([[0, 1]] * 6, np.int32)          # every token wants experts 0 and 1
    probs = np.full((6, 2), 0.5, np.float32)
    banks = [rng.standard_normal(s).astype(np.float32) for s in ((2, 8, 4), (2, 8, 4), (2, 4, 8))]
    ours = moe.moe_dispatch_combine(t(x), t(ids), t(probs), *(t(b) for b in banks), capacity=4)
    ref = jax_moe.moe_dispatch_combine(jnp.asarray(x), jnp.asarray(ids), jnp.asarray(probs),
                                       *(jnp.asarray(b) for b in banks), capacity=4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert np.all(ours.numpy()[4:] == 0)  # tokens 4 and 5 are over capacity
    assert np.any(ours.numpy()[3] != 0)
