"""The parts of the port's decode pipeline below the engine's routing, on
the CPU in float32:
- the sync-free cache write (``slot_rows`` into the dump row past each
  leaf) against the old ``live_slots`` write: the same cache on every live
  slot, no live slot written by a pad, a live write at slot 0 among pads;
- the sampling tail on the device (``DecodeGraph.sample``: the threefry
  fold and Gumbel draw inside the step, greedy lanes masked) against a
  draw on the host from the engine's host keys: equal noise bits, tokens,
  logprobs and generated counts;
- the step ``DecodeGraph`` captures on a card, driven the way a replay
  drives it (inputs written into its persistent buffers in place, then
  run; twice, the second window fed back from the first), against the
  same window computed eagerly from fresh tensors, at decode_steps 1 and 3;
- the tiny DeepSeek (MLA + MoE) engine with overlap on against
  JaxLlmEngine with overlap on and off, and speculative decoding composed
  with decode_steps=4 (tests/engine/test_speculative.py:201-252)."""

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.models import deepseek as jax_ds
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.sequence import Sequence
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import deepseek
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.ops import attention as attn
from dynamo_tpu_torch.ops.random import fold_in, gumbel
from dynamo_tpu_torch.ops.sampling import (
    apply_logit_bias,
    apply_penalties,
    sample_tokens,
    token_logprobs,
)
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import request
from tests.test_torch_llama import tree_to_numpy
from tests.test_torch_overlap import assert_same, jax_engine, run_matrix, serve, torch_engine

# the token-counter weights continue RUN with 12, 13, ...: prompt lookup
# drafts them from the prompt's own run
RUN = list(range(10, 40)) + [10, 11]


# ---------------------------------------------------------------------------
# the sync-free cache write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_shape", [(2, 8), (1, 12)])  # GQA heads, an MLA latent
def test_sync_free_write_matches_the_live_slots_write(row_shape):
    layers, blocks, bs = 3, 4, 4
    n = blocks * bs
    gen = torch.Generator().manual_seed(0)
    shape = (layers, blocks, bs, *row_shape)
    k = attn.alloc_cache_leaf(shape, torch.float32, "cpu")
    v = attn.alloc_cache_leaf(shape, torch.float32, "cpu")
    k.copy_(torch.randn(shape, generator=gen))
    v.copy_(torch.randn(shape, generator=gen))
    ref_k, ref_v = k.clone(), v.clone()
    # live writes at slot 0 and the last slot among pads past the pool, at
    # -1 and far out (the reference drops them)
    slots = torch.tensor([0, n, 5, -1, n - 1, n + 9, 9, n], dtype=torch.int32)
    live = (slots >= 0) & (slots < n)
    k_new = torch.randn((layers, len(slots), *row_shape), generator=gen)
    v_new = torch.randn((layers, len(slots), *row_shape), generator=gen)

    rows = attn.slot_rows(slots, k)
    assert rows.shape == (layers, len(slots)) and rows.dtype == torch.int64
    k_rows, v_rows = attn.cache_rows(k), attn.cache_rows(v)
    for layer in range(layers):
        attn.write_rows(k_rows, v_rows, rows[layer], k_new[layer], v_new[layer])
        attn.write_decode_kv(ref_k[layer], ref_v[layer], k_new[layer], v_new[layer], slots)
    assert torch.equal(k, ref_k) and torch.equal(v, ref_v)
    # every pad landed on the dump row past the leaf, and only there
    assert torch.equal(rows[:, ~live], torch.full_like(rows[:, ~live], layers * n))
    dump = k_rows[layers * n]
    assert any(torch.equal(dump, k_new[-1, i]) for i in np.flatnonzero(~live.numpy()))
    # the leaf keeps its shape and strides: kernels, copies and tiers see N blocks
    assert k.shape == shape and k.is_contiguous()


def test_cache_rows_refuses_a_leaf_without_a_dump_row():
    with pytest.raises(ValueError, match="dump row"):
        attn.cache_rows(torch.zeros((2, 4, 4, 2, 8)))


# ---------------------------------------------------------------------------
# the sampling tail on the device
# ---------------------------------------------------------------------------

def seq_on_lane(lane: int, sampling: SamplingOptions, prompt=(3, 4, 5)) -> Sequence:
    seq = Sequence(seq_id=f"s{lane}", request=PreprocessedRequest(
        token_ids=list(prompt), sampling=sampling, stop=StopConditions(max_tokens=4)))
    seq.lane = lane
    return seq


LANE_SAMPLING = {
    0: SamplingOptions(temperature=0.9, seed=11, frequency_penalty=0.4),
    1: SamplingOptions(use_greedy=True, logit_bias={"7": 3.0, "9": -2.0}),
    3: SamplingOptions(temperature=1.7, top_k=30, top_p=0.8, seed=5, repetition_penalty=1.2),
}


def seeded_tail(engine, rng) -> list[Sequence]:
    """Sequences on lanes 0, 1 and 3 (lane 2 idle), their keys seeded, the
    penalty counts random, the tail uploaded."""
    seqs = [seq_on_lane(lane, s) for lane, s in LANE_SAMPLING.items()]
    for seq in seqs:
        engine._seed_lane_key(seq)
    vocab = engine.config.model.vocab_size
    lanes = engine.config.max_batch_size
    engine._gen_counts.copy_(torch.from_numpy(rng.integers(0, 3, (lanes, vocab)).astype(np.int32)))
    engine._prompt_counts.copy_(
        torch.from_numpy(rng.integers(0, 2, (lanes, vocab)).astype(np.int32)))
    engine._device_sampling_tail(seqs)
    return seqs


def host_noise(engine, seqs, fold_lens, vocab: int) -> torch.Tensor:
    """[lanes, vocab] Gumbel noise drawn on the host: each sampled lane's
    key (the engine's host copy) folded with its ``fold_lens`` entry, zero
    rows for greedy and idle lanes."""
    noise = torch.zeros((engine.config.max_batch_size, vocab), dtype=torch.float32)
    lanes = [s.lane for s in seqs if engine._sampled(s)]
    if lanes:
        keys = torch.from_numpy(engine._lane_keys[lanes].astype(np.int64))
        folds = torch.from_numpy(np.asarray(fold_lens)[lanes].astype(np.int64))
        noise[lanes] = gumbel(fold_in(keys, folds), vocab)
    return noise


def host_tail(engine, seqs, logits, lens, gate):
    """The sampling tail on host arrays with host noise."""
    lanes = engine.config.max_batch_size
    temp, top_k, top_p, greedy, pres, freq, rep, bias_ids, bias_vals = (
        torch.from_numpy(a) for a in engine._sampling_arrays(seqs, [s.lane for s in seqs], lanes))
    logits = apply_penalties(logits, engine._gen_counts, engine._prompt_counts, pres, freq, rep)
    logits = apply_logit_bias(logits, bias_ids, bias_vals)
    noise = host_noise(engine, seqs, lens.numpy(), logits.shape[-1])
    tokens = sample_tokens(logits, noise, temp, top_k, top_p, greedy)
    lps = token_logprobs(logits, tokens)
    engine._gen_counts[engine._lane_idx, tokens.long()] += gate
    return noise, tokens, lps


def test_device_sampling_tail_matches_the_host_draw():
    rng = np.random.default_rng(0)
    ours_engine, ref_engine = torch_engine(), torch_engine()
    seqs = seeded_tail(ours_engine, np.random.default_rng(1))
    seeded_tail(ref_engine, np.random.default_rng(1))
    vocab = ours_engine.config.model.vocab_size
    logits = torch.from_numpy(rng.normal(0, 3, (4, vocab)).astype(np.float32))
    lens = torch.tensor([9, 14, 0, 33], dtype=torch.int32)
    gate = (lens > 0).to(torch.int32)
    d = ours_engine._decode
    draw = gumbel(fold_in(d.tail["keys"], lens.long()), vocab) * d.tail["sampled"][:, None]
    noise, ref_tokens, ref_lps = host_tail(ref_engine, seqs, logits, lens, gate)
    assert torch.equal(draw.view(torch.int32)[[0, 3]], noise.view(torch.int32)[[0, 3]])
    assert not draw[[1, 2]].any()
    tokens, lps, best = d.sample(logits, lens, gate, noise=True)
    assert best is None
    assert torch.equal(tokens, ref_tokens) and torch.equal(lps, ref_lps)
    assert torch.equal(ours_engine._gen_counts, ref_engine._gen_counts)
    # unchanged host values upload nothing new; a change uploads
    buffer = d.tail.buffer.clone()
    ours_engine._device_sampling_tail(seqs)
    assert torch.equal(d.tail.buffer, buffer)
    seqs[1].request.sampling.temperature = 2.0
    seqs[1].request.sampling.use_greedy = False
    ours_engine._device_sampling_tail(seqs)
    assert d.tail["sampled"][1] == 1.0 and d.tail["temp"][1] == 2.0


# ---------------------------------------------------------------------------
# the captured step, driven as a replay drives it
# ---------------------------------------------------------------------------

GRAPH = dict(max_batch_size=4, num_blocks=16, block_size=4, max_model_len=48)


def eager_window(engine, seqs, tokens_in, lens, tables, steps):
    """The reference window from fresh tensors: the old plain decode
    (host slots, host noise), iterated."""
    bs, oob = engine.config.block_size, engine.config.num_blocks * engine.config.block_size
    lens = lens.clone()
    active = lens > 0
    gate = active.to(torch.int32)
    outs = []
    for _ in range(steps):
        pos = (lens - 1).clamp(min=0)
        slots = torch.where(active, tables[torch.arange(4), pos // bs] * bs + pos % bs, oob)
        logits, _ = engine.family.forward_decode(
            engine.params, engine.config.model, tokens_in, engine.cache, tables, lens,
            slots.to(torch.int32), engine.cos, engine.sin)
        _, tokens_in, lps = host_tail(engine, seqs, logits, lens, gate)
        outs.append((tokens_in, lps))
        lens = torch.where(active, lens + 1, lens)
    return outs


@pytest.mark.parametrize("steps", [1, 3])
def test_captured_step_driven_like_a_replay_matches_the_eager_window(steps):
    drive_like_a_replay(steps)


def test_zero_bias_width_window_matches_the_eager_window():
    """logit_bias_k=0: the tail's bias rows are [lanes, 0] views of the
    staged buffer, the window adds no bias (lane 1's logit_bias is dropped,
    as the reference's zero-width scatter drops it) and still equals the
    eager window."""
    engine = drive_like_a_replay(2, logit_bias_k=0)
    assert engine._decode.tail["bias_ids"].shape == (4, 0)
    assert engine._decode.tail["bias_vals"].shape == (4, 0)


def drive_like_a_replay(steps: int, **overrides):
    """Two decode windows from the graph's buffers, written in place as
    before a replay (the second fed back from the first), against the eager
    window from fresh tensors."""
    ours_engine = torch_engine(decode_steps=steps, **GRAPH, **overrides)
    ref_engine = torch_engine(decode_steps=steps, **GRAPH, **overrides)
    gen = torch.Generator().manual_seed(3)
    for name, leaf in ours_engine.cache.items():
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
        ref_engine.cache[name].copy_(leaf)
    seqs = seeded_tail(ours_engine, np.random.default_rng(2))
    seeded_tail(ref_engine, np.random.default_rng(2))
    # lane 0 owns block 0 at position 0 (slot 0); idle lane 2's zero row
    # would name slot 0 too, unless masked
    tables = np.zeros((4, ours_engine.max_blocks_per_seq), np.int32)
    tables[0, :3] = [0, 5, 6]
    tables[1, :4] = [1, 2, 3, 4]
    tables[3, :5] = [7, 8, 9, 10, 11]
    lens = np.array([1, 9, 0, 15], np.int32)
    tokens = np.array([12, 40, 99, 300], np.int32)
    d = ours_engine._decode
    views = {name: d.window[name].data_ptr() for name in ("tokens", "use_fb", "lens")}
    d.tables.upload({"tables": tables})
    feedback = tokens.copy()
    for window in range(2):
        # window 0 from host tokens, window 1 fed back from window 0
        fed = window > 0
        d.window.upload({"tokens": np.zeros(4, np.int32) if fed else tokens,
                         "use_fb": np.full(4, fed), "lens": lens})
        assert {n: d.window[n].data_ptr() for n in views} == views  # written in place
        d.run(noise=True)
        ref = eager_window(ref_engine, seqs, torch.from_numpy(feedback), torch.from_numpy(lens),
                           torch.from_numpy(tables), steps)
        active = lens > 0  # an idle lane samples junk, which nothing reads
        for s, (ref_tokens, ref_lps) in enumerate(ref):
            assert torch.equal(d.out_tokens[s][active], ref_tokens[active]), (window, s)
            assert torch.equal(d.out_lps[s][active], ref_lps[active]), (window, s)
        for name in ours_engine.cache:
            assert torch.equal(ours_engine.cache[name], ref_engine.cache[name])
        assert torch.equal(ours_engine._gen_counts, ref_engine._gen_counts)
        last = ref[-1][0].numpy()
        assert torch.equal(d.feedback[active], torch.from_numpy(last[active]))
        feedback = np.where(active, last, feedback).astype(np.int32)
        lens = np.where(active, lens + steps, lens).astype(np.int32)
    return ours_engine


# ---------------------------------------------------------------------------
# DeepSeek with overlap; speculation with fused decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla_models():
    jcfg = jax_ds.DeepseekConfig.tiny_mla(vocab_size=481)
    cfg = deepseek.DeepseekConfig.tiny_mla(vocab_size=481)
    jparams = jax_ds.init_params(jcfg, jax.random.PRNGKey(3))
    return dict(jcfg=jcfg, jparams=jparams, cfg=cfg,
                params=params_from_jax(tree_to_numpy(jparams), device="cpu"))


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(decode_steps=4),
    dict(num_blocks=10, max_model_len=40, prefill_buckets=(16, 32)),
], ids=["single_step", "decode_steps_4", "preemption"])
async def test_mla_overlap_matches_reference(mla_models, overrides):
    seeded = SamplingOptions(temperature=6.0, seed=77)
    reqs = [request(range(3 + 5 * i, 12 + 3 * i), max_tokens=8, ignore_eos=True)
            for i in range(3)]
    reqs.append(request(range(100, 107), 8, seeded, ignore_eos=True))
    ref_sync, ref_over, ours, stats = await run_matrix(
        reqs, model_family="deepseek_v2", **mla_models, **overrides)
    assert_same(ref_sync, ref_over, ours)
    assert stats["decode_windows_overlapped_total"] > 0
    if "num_blocks" in overrides:
        assert stats["num_preemptions_total"] > 0, "geometry failed to force preemption"


SPEC4 = dict(speculative="ngram", spec_tokens=3, decode_steps=4)


async def test_speculation_composes_with_fused_decode():
    """Greedy: the spec × decode_steps=4 engine equals the plain
    single-step engine and the reference's spec × fused engine, drafts
    accepted; a seeded sampled lane takes the fused plain path (nothing
    drafted) and equals a plain decode_steps=4 engine; a drafting greedy
    lane beside a seeded sampled one equals the plain engine."""
    greedy = [request(p, max_tokens=12, ignore_eos=True)
              for p in (RUN, [5, 9, 13, 17, 21], list(range(30, 60)))]
    sampled = [request(RUN, 16, SamplingOptions(temperature=0.8, seed=1234),
                       ignore_eos=True)]
    mixed = [request(RUN, 12, ignore_eos=True),
             request([40, 41, 42, 43, 44], 12, SamplingOptions(temperature=0.8, seed=77),
                     ignore_eos=True)]
    for reqs, plain_kw, drafted in ((greedy, {}, True), (sampled, dict(decode_steps=4), False),
                                    (mixed, {}, True)):
        plain = await serve(torch_engine(**plain_kw), Context, reqs)
        spec_engine = torch_engine(**SPEC4)
        spec = await serve(spec_engine, Context, reqs)
        ref = await serve(jax_engine(False, **SPEC4), JaxContext, reqs)
        assert spec == plain == ref
        stats = spec_engine.stats()
        assert (stats["spec_drafted_tokens_total"] > 0) == drafted
        if drafted:
            assert stats["spec_accepted_tokens_total"] > 0
        assert stats["decode_windows_overlapped_total"] == 0
