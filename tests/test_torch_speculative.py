"""Prompt-lookup speculative decoding in the port against the JAX reference,
in float32 on the CPU:
- the plain MLA window op against the reference's gather branch of
  _mla_window_attn and the Pallas window kernel in interpret mode (atol
  2e-5), with an idle lane, and at W=1 equal to the decode op;
- last_writer_rows, the W cap of the GQA window kernel, the drafter;
- the llama and DeepSeek verify forwards (logits and caches within 1e-4),
  including a window clamped at the engine's last position (one slot named
  twice) and, for DeepSeek, position-major MoE dispatch under a capacity
  that drops routed pairs;
- TorchLlmEngine(speculative="ngram") against JaxLlmEngine on
  tiny-chat-model and tiny_mla: identical greedy and seeded streams and
  equal drafted / accepted counts (mixed sampled and greedy lanes, a lane
  that reaches max_len inside a window), the config validation, and the
  CLI flags."""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import deepseek as jax_ds
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.ops import attention as jax_attn
from dynamo_tpu.ops.pallas.mla_attention import (
    mla_paged_window_attention_decode as pallas_mla_window,
)
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.cli.run import engine_overrides, parse_args
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import deepseek, llama
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.models.registry import get_family
from dynamo_tpu_torch.ops import attention as attn
from dynamo_tpu_torch.ops import kernels
from dynamo_tpu_torch.ops.kernels import mla_attention as mla_kernels
from dynamo_tpu_torch.ops.kernels.paged_attention import check_window
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import (
    BASE,
    CFG,
    JCFG,
    JPARAMS,
    PARAMS,
    collect,
    collect_logprobs,
    request,
)
from tests.test_torch_llama import assert_trees_equal, tree_to_numpy

OP_ATOL = 2e-5
ATOL = 1e-4
H, R, P, BS, MAXB, NBLOCKS = 4, 32, 16, 8, 4, 16
SCALE = 0.17


def t(a):
    return torch.from_numpy(np.array(a))


def close(ours, ref, mask=None, atol=OP_ATOL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    if mask is not None:
        ours, ref = ours[mask], ref[mask]
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=atol)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def jax_window_gather(q_lat, q_rope, ck, kr, tables, ctx, scale):
    """The gather branch of dynamo_tpu/models/deepseek.py _mla_window_attn."""
    b, w = q_lat.shape[:2]
    length = tables.shape[1] * ck.shape[1]
    ckg = ck[tables].reshape(b, length, ck.shape[-1]).astype(jnp.float32)
    krg = kr[tables].reshape(b, length, kr.shape[-1]).astype(jnp.float32)
    logits = (jnp.einsum("bwhr,btr->bhwt", q_lat, ckg)
              + jnp.einsum("bwhp,btp->bhwt", q_rope.astype(jnp.float32), krg)) * scale
    q_pos = ctx[:, None] - w + jnp.arange(w)[None, :]
    mask = jnp.arange(length)[None, None, :] <= q_pos[:, :, None]
    logits = jnp.where(mask[:, None], logits, jax_attn.NEG_INF)
    return jnp.einsum("bhwt,btr->bwhr", jax.nn.softmax(logits, axis=-1), ckg)


@pytest.mark.parametrize("w,ctx", [(3, (5, 17, 32)), (4, (9, 0, 30)), (1, (5, 17, 0))],
                         ids=["w3", "w4_idle_lane", "w1"])
def test_mla_window_matches_reference_and_pallas(w, ctx):
    rng = np.random.default_rng(w)
    ck = rng.standard_normal((NBLOCKS, BS, R)).astype(np.float32)
    kr = rng.standard_normal((NBLOCKS, BS, P)).astype(np.float32)
    tables = rng.permutation(NBLOCKS)[: 3 * MAXB].astype(np.int32).reshape(3, MAXB)
    ctx = np.asarray(ctx, np.int32)
    q_lat = rng.standard_normal((3, w, H, R)).astype(np.float32)
    q_rope = rng.standard_normal((3, w, H, P)).astype(np.float32)
    live = ctx > 0
    ours = attn.mla_paged_window_attention(
        t(q_lat), t(q_rope), t(ck), t(kr), t(tables), t(ctx), scale=SCALE)
    assert ours.dtype == torch.float32 and ours.shape == (3, w, H, R)
    args = [jnp.asarray(a) for a in (q_lat, q_rope, ck, kr, tables, ctx)]
    close(ours, jax_window_gather(*args, SCALE))  # idle lanes too: same junk
    pallas = pallas_mla_window(*args, scale=SCALE, interpret=True)
    close(ours, pallas, live)
    assert np.all(np.asarray(pallas)[~live] == 0)  # and so does the port's kernel
    before = mla_kernels.window_plain_calls
    close(kernels.mla_paged_window_attention_decode(
        t(q_lat), t(q_rope), t(ck), t(kr), t(tables), t(ctx), scale=SCALE), ours)
    assert mla_kernels.window_plain_calls == before + 1
    if w == 1:  # the window at W=1 is the decode op
        dec = attn.mla_paged_decode_attention(
            t(q_lat[:, 0]), t(q_rope[:, 0]), t(ck), t(kr), t(tables), t(ctx), scale=SCALE)
        close(ours[:, 0], dec)


def test_last_writer_slots_keep_the_last_of_repeated_slots():
    """``last_writer_rows``: of the entries naming one slot only the last
    writes it, the rest and the pads write the dump row (64 here), chosen
    on the device."""
    slots = torch.tensor([5, 9, 64, 9, 9, 2, 70, 5], dtype=torch.int32)
    leaf = attn.alloc_cache_leaf((1, 16, 4, 1, 2), torch.float32, "cpu")
    rows = attn.last_writer_rows(slots, leaf)
    # 9 last at 4, 2 at 5, 5 last at 7
    assert rows.tolist() == [[64, 64, 64, 64, 9, 2, 64, 5]]
    assert attn.last_writer_rows(torch.tensor([3, 1, 70], dtype=torch.int32),
                                 leaf).tolist() == [[3, 1, 64]]
    # the write then gives the reference's scatter result
    vals = torch.arange(8, dtype=torch.float32)[:, None, None].expand(8, 1, 2).contiguous()
    other = attn.alloc_cache_leaf((1, 16, 4, 1, 2), torch.float32, "cpu")
    attn.write_rows(attn.cache_rows(leaf), attn.cache_rows(other), rows[0], vals, vals)
    ref = jnp.zeros((64, 1, 2)).at[jnp.asarray(slots.numpy())].set(
        jnp.asarray(vals.numpy()), mode="drop")
    np.testing.assert_array_equal(leaf.view(64, 1, 2).numpy(), np.asarray(ref))


def test_gqa_window_cap_names_spec_tokens():
    check_window(5, 32, 8)  # Llama-3-8B at spec_tokens 4: 20 rows
    with pytest.raises(ValueError, match="spec_tokens"):
        check_window(17, 32, 8)
    # the engine asks the family before building a kernel engine
    check = get_family("llama").check_verify_width
    check(llama.LlamaConfig.llama3_8b(), 5)
    with pytest.raises(ValueError, match="spec_tokens"):
        check(llama.LlamaConfig.llama3_8b(), 17)
    assert get_family("deepseek_v2").check_verify_width is None


# ---------------------------------------------------------------------------
# verify forwards
# ---------------------------------------------------------------------------

LANES, TBS, TBLOCKS, WIN = 3, 4, 20, 4


def verify_inputs(tables, ctx, max_len, seed):
    """A verify window per lane (ctx = context before the window), slots
    clamped at ``max_len - 1`` like the engine's."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, 500, (LANES, WIN)).astype(np.int32)
    slots = np.full((LANES, WIN), TBLOCKS * TBS, np.int32)
    lens = np.zeros((LANES,), np.int32)
    for lane, c in enumerate(ctx):
        if c == 0:
            continue  # an idle lane
        lens[lane] = c + WIN - 1
        for j in range(WIN):
            pos = min(c - 1 + j, max_len - 1)
            slots[lane, j] = tables[lane, pos // TBS] * TBS + pos % TBS
    return tokens, lens, slots


def run_verify(ours_fn, ref_fn, params, jparams, cfg, jcfg, cache, jcache, cos, sin, jcos, jsin,
               prefill, jprefill):
    """Prefill three lanes' prompts (lane 2 idle), then verify: one lane
    mid-table, one whose window runs past max_len = 20 (clamped slots)."""
    # five blocks a lane: the engine's table at max_len 20
    tables = np.random.default_rng(0).permutation(TBLOCKS).astype(np.int32).reshape(4, 5)[:LANES]
    prompts = {0: 9, 1: 19}
    for lane, n in prompts.items():
        ids = np.zeros((32,), np.int32)
        ids[:n] = np.random.default_rng(lane).integers(2, 500, n)
        _, jcache = jprefill(jparams, jcfg, jnp.asarray(ids), jcache, jnp.asarray(tables[lane]),
                             jnp.int32(n), jnp.int32(0), jcos, jsin)
        prefill(params, cfg, t(ids), cache, t(tables[lane]), n, 0, cos, sin)
    tokens, lens, slots = verify_inputs(tables, (10, 19, 0), max_len=20, seed=7)
    assert len(set(slots[1].tolist())) < WIN  # the clamp names one slot twice
    ref, jcache = ref_fn(jparams, jcfg, jnp.asarray(tokens), jcache, jnp.asarray(tables),
                         jnp.asarray(lens), jnp.asarray(slots), jcos, jsin, attention="jax")
    ours, _ = ours_fn(params, cfg, t(tokens), cache, t(tables), t(lens), t(slots), cos, sin)
    assert ours.shape == (LANES, WIN, cfg.vocab_size)
    live = lens > 0
    np.testing.assert_allclose(ours.numpy()[live], np.asarray(ref)[live], atol=ATOL, rtol=0)
    assert_trees_equal(cache, tree_to_numpy(jcache), atol=ATOL)


def test_llama_verify_forward_matches_reference():
    jcfg, cfg = jax_llama.LlamaConfig.tiny(), llama.LlamaConfig.tiny()
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(8))
    params = params_from_jax(tree_to_numpy(jparams), device="cpu")
    jcos, jsin = jax_llama.make_rope_tables(jcfg)
    cos, sin = llama.make_rope_tables(cfg, device="cpu")
    # tables cut at max_len = 20 as the engine's are: window rope rows past
    # them clamp, as the reference's gather does
    run_verify(llama.llama_forward_verify, jax_llama.llama_forward_verify, params, jparams,
               cfg, jcfg, llama.init_kv_cache(cfg, TBLOCKS, TBS, device="cpu"),
               jax_llama.init_kv_cache(jcfg, TBLOCKS, TBS), cos[:20], sin[:20], jcos[:20],
               jsin[:20], llama.llama_forward_prefill, jax_llama.llama_forward_prefill)


@pytest.mark.parametrize("capacity", [4.0, 0.5], ids=["no_drops", "drops"])
def test_deepseek_verify_forward_matches_reference(capacity):
    """Position-major dispatch: with a capacity that drops routed pairs, a
    batch-major window would drop other pairs than the reference."""
    jcfg = dataclasses.replace(jax_ds.DeepseekConfig.tiny_mla(), capacity_factor=capacity)
    cfg = dataclasses.replace(deepseek.DeepseekConfig.tiny_mla(), capacity_factor=capacity)
    jparams = jax_ds.init_params(jcfg, jax.random.PRNGKey(9))
    params = params_from_jax(tree_to_numpy(jparams), device="cpu")
    jcos, jsin = jax_ds.make_rope_tables(jcfg)
    cos, sin = deepseek.make_rope_tables(cfg, device="cpu")

    def ref_verify(*args, attention):
        return jax_ds.deepseek_forward_verify(*args, attention=attention)

    run_verify(deepseek.deepseek_forward_verify, ref_verify, params, jparams, cfg, jcfg,
               deepseek.init_kv_cache(cfg, TBLOCKS, TBS, device="cpu"),
               jax_ds.init_kv_cache(jcfg, TBLOCKS, TBS), cos[:20], sin[:20], jcos[:20],
               jsin[:20], deepseek.deepseek_forward_prefill, jax_ds.deepseek_forward_prefill)


# ---------------------------------------------------------------------------
# the engine against JaxLlmEngine
# ---------------------------------------------------------------------------

# the token-counter weights continue t with t+1: a prompt holding the run
# its greedy output will take lets prompt lookup draft and accept
RUN = list(range(10, 40)) + [10, 11]
PATTERN = [7, 11, 19, 7, 11, 19, 7, 11, 19, 7, 11]


def test_ngram_drafter():
    engine = TorchLlmEngine(
        EngineConfig(model=CFG, speculative="ngram", spec_tokens=3, spec_ngram=2, **BASE),
        params=PARAMS, device="cpu")
    # the last 2-gram [7, 11] last occurred at index 6: continuation [19, 7, 11]
    assert engine._ngram_draft(PATTERN) == [19, 7, 11]
    assert engine._ngram_draft([1, 2, 3, 4]) == []
    assert engine._ngram_draft([5, 6]) == []
    assert not engine.unified_batch
    assert engine.stats()["unified_fallbacks"] == {"speculative": 1}


async def run_pair(reqs, jcfg=JCFG, jparams=JPARAMS, cfg=CFG, params=PARAMS, jax_kw=None,
                   **kw):
    """The same requests through both engines, every request submitted
    before the engine thread starts, so both engines schedule the same
    steps.  Returns (ours, ref, our stats, ref stats)."""
    kw = {**BASE, **kw}
    engines = (
        (JaxLlmEngine(JaxEngineConfig(model=jcfg, decode_overlap=False, **kw, **(jax_kw or {})),
                      params=jparams), JaxContext),
        (TorchLlmEngine(EngineConfig(model=cfg, **kw), params=params, device="cpu"), Context),
    )
    out = []
    for engine, ctx_cls in engines:
        tasks = [asyncio.ensure_future(collect(engine, r, ctx_cls)) for r in reqs]
        await asyncio.sleep(0.05)  # every request queued
        engine.start()
        try:
            out.append(await asyncio.gather(*tasks))
        finally:
            engine.stop()
    return out[1], out[0], engines[1][0].stats(), engines[0][0].stats()


def assert_spec_counts_equal(stats, ref_stats):
    for key in ("spec_drafted_tokens_total", "spec_accepted_tokens_total",
                "spec_rejected_tokens_total"):
        assert stats[key] == ref_stats[key], key


async def test_speculative_greedy_streams_match_reference():
    reqs = [request(RUN, max_tokens=24, ignore_eos=True),
            request([5, 9, 13, 17, 21], max_tokens=12, ignore_eos=True),
            request(PATTERN, max_tokens=12, ignore_eos=True)]
    ours, ref, stats, ref_stats = await run_pair(reqs, speculative="ngram", spec_tokens=4)
    assert ours == ref
    assert ours[0][0] == list(range(12, 36))
    assert_spec_counts_equal(stats, ref_stats)
    assert stats["spec_accepted_tokens_total"] > 0
    assert stats["spec_verify_steps_total"] > 0
    assert stats["decode_windows_unified_total"] == 0


async def test_speculative_sampled_and_mixed_lanes_match_reference():
    """Seeded sampled lanes ride verify steps (the greedy lanes draft):
    position 0 draws the plain decode step's noise; a penalized greedy lane
    takes one token a step."""
    seeded = SamplingOptions(temperature=8.0, seed=77)
    penalized = SamplingOptions(use_greedy=True, frequency_penalty=0.5)
    reqs = [request(RUN, max_tokens=16, ignore_eos=True),
            request(range(40, 48), 12, seeded, ignore_eos=True),
            request(list(range(60, 80)) + [60, 61], 12, penalized, ignore_eos=True),
            request(list(range(100, 130)) + [100, 101], max_tokens=14, ignore_eos=True)]
    ours, ref, stats, ref_stats = await run_pair(reqs, speculative="ngram", spec_tokens=3,
                                                 prefill_chunk_tokens=8)
    assert ours == ref
    assert ours[1][0] != list(range(48, 60))  # the noise moved the sampled lane
    assert_spec_counts_equal(stats, ref_stats)
    assert stats["spec_accepted_tokens_total"] > 0


async def test_speculative_logprobs_match_reference():
    """Accepted positions carry their own logprobs and top-k rows."""
    sampling = SamplingOptions(use_greedy=True, top_logprobs=3)
    req = request(RUN, max_tokens=12, sampling=sampling, ignore_eos=True)
    out = []
    for engine, ctx_cls in (
        (JaxLlmEngine(JaxEngineConfig(model=JCFG, decode_overlap=False, speculative="ngram",
                                      **BASE), params=JPARAMS), JaxContext),
        (TorchLlmEngine(EngineConfig(model=CFG, speculative="ngram", **BASE), params=PARAMS,
                        device="cpu"), Context),
    ):
        engine.start()
        try:
            out.append(await collect_logprobs(engine, req, ctx_cls))
        finally:
            engine.stop()
        assert engine.stats()["spec_accepted_tokens_total"] > 0
    (ref_tokens, ref_lps, ref_tops), (tokens, lps, tops) = out
    assert tokens == ref_tokens == list(range(12, 24))
    assert lps == pytest.approx(ref_lps, abs=1e-4)
    assert [[i for i, _ in row] for row in tops] == [[i for i, _ in row] for row in ref_tops]
    assert [v for row in tops for _, v in row] == pytest.approx(
        [v for row in ref_tops for _, v in row], abs=1e-4)


async def test_lane_reaching_max_len_inside_a_window_matches_reference():
    reqs = [request(list(range(10, 30)) + [10, 11], max_tokens=100, ignore_eos=True),
            request(list(range(200, 215)) + [200, 201], max_tokens=100, ignore_eos=True)]
    ours, ref, stats, ref_stats = await run_pair(reqs, speculative="ngram", spec_tokens=4,
                                                 max_model_len=40, num_blocks=24)
    assert ours == ref
    assert ours[0] == (list(range(12, 30)), "length")
    assert_spec_counts_equal(stats, ref_stats)


async def test_mla_speculative_matches_reference():
    """tiny_mla: the reference verifies through its Pallas window kernel in
    interpret mode, the port through the plain window op."""
    jcfg = jax_ds.DeepseekConfig.tiny_mla(vocab_size=481)
    cfg = deepseek.DeepseekConfig.tiny_mla(vocab_size=481)
    jparams = jax_ds.init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_jax(tree_to_numpy(jparams), device="cpu")
    reqs = [request(PATTERN, max_tokens=12, ignore_eos=True),
            request(RUN, max_tokens=10, ignore_eos=True)]
    ours, ref, stats, ref_stats = await run_pair(
        reqs, jcfg, jparams, cfg, params, jax_kw=dict(attention_impl="pallas_interpret"),
        model_family="deepseek_v2", speculative="ngram", spec_tokens=3)
    assert ours == ref
    assert_spec_counts_equal(stats, ref_stats)
    assert stats["spec_drafted_tokens_total"] > 0


@pytest.mark.parametrize("bad,match", [
    (dict(speculative="medusa"), "speculative"),
    (dict(speculative="ngram", spec_ngram=0), "spec_ngram"),
    (dict(speculative="ngram", spec_tokens=0), "spec_tokens"),
])
def test_speculative_config_validation_follows_reference(bad, match):
    with pytest.raises(ValueError, match=match):
        TorchLlmEngine(EngineConfig(model=CFG, **BASE, **bad), params=PARAMS, device="cpu")
    with pytest.raises(ValueError, match=match):
        JaxLlmEngine(JaxEngineConfig(model=JCFG, **BASE, **bad), params=JPARAMS)


def test_cli_parses_the_speculative_flags():
    args = parse_args(["run", "in=http", "out=torch", "--model-path", "m",
                       "--speculative", "ngram", "--spec-tokens", "3", "--spec-ngram", "3"])
    assert engine_overrides(args) == dict(num_blocks=256, max_batch_size=8, seed=0,
                                          speculative="ngram", spec_tokens=3, spec_ngram=3)
    plain = engine_overrides(parse_args(["run", "--model-path", "m"]))
    assert "speculative" not in plain
    with pytest.raises(SystemExit):
        parse_args(["run", "--model-path", "m", "--speculative", "medusa"])
