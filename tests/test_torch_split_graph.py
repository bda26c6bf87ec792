"""The split prefill and speculative verify steps at the reference's fixed
shapes, on the CPU in float32.

- TorchLlmEngine, every split prefill and verify step driven the way a
  graph replay drives it (its inputs written into ``PrefillGraph`` /
  ``VerifyGraph``'s persistent buffers in place, the step run from those
  buffers), against JaxLlmEngine byte for byte, for the llama family
  (tests/data/tiny-chat-model) and the DeepSeek MLA family (tiny_mla):
  whole, chunked (``prefill_chunk_tokens`` 32) and prefix-hit prefills,
  ``decode_steps`` 4, n-gram speculation (``spec_tokens`` 4, prompts that
  repeat a phrase) with equal drafted and accepted counts, greedy and
  seeded lanes.
- The shape signature of every split step, the counterpart of
  tests/engine/test_aot_precompile.py: each forward carries its key's
  shapes, ``warmup()`` runs every key the engine can take (the reference's
  ``aot_precompile`` rule) and the verify window, no step after it brings
  a new key, and it leaves no cached block behind.
- Lengths as tensors: the four split prefill forwards and
  ``write_prefill_kv`` given 0-d tensor lengths (a captured step reads no
  length on the host) are bitwise the same calls given ints, a pad row
  never landing in a live slot.
"""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import deepseek as jax_ds
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import deepseek, llama
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.ops import attention as attn
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import BASE, CFG, JCFG, JPARAMS, PARAMS, collect, request
from tests.test_torch_llama import tree_to_numpy
from tests.test_torch_speculative import PATTERN, RUN


@pytest.fixture(scope="module")
def families():
    jcfg = jax_ds.DeepseekConfig.tiny_mla(vocab_size=481)
    jparams = jax_ds.init_params(jcfg, jax.random.PRNGKey(3))
    return {
        "llama": dict(jcfg=JCFG, jparams=JPARAMS, cfg=CFG, params=PARAMS, kw={}),
        "deepseek": dict(jcfg=jcfg, jparams=jparams,
                         cfg=deepseek.DeepseekConfig.tiny_mla(vocab_size=481),
                         params=params_from_jax(tree_to_numpy(jparams), device="cpu"),
                         kw=dict(model_family="deepseek_v2")),
    }


def engines(fam: dict, **kw):
    """(reference, port) over the same weights, the unified step off (the
    split step is every prefill's path), the reference synchronous."""
    kw = {**BASE, **fam["kw"], "unified_batch": False, **kw}
    ref = JaxLlmEngine(JaxEngineConfig(model=fam["jcfg"], decode_overlap=False, **kw),
                       params=fam["jparams"])
    ours = TorchLlmEngine(EngineConfig(model=fam["cfg"], **kw), params=fam["params"],
                          device="cpu")
    return ref, ours


def addresses(views: dict) -> dict:
    return {name: t.data_ptr() for name, t in views.items()}


def replay_probe(engine) -> dict:
    """Count the split prefills and verify windows that run from the
    graphs' buffers, each checked at its key's persistent addresses
    (written in place, as a replay reads them), and the keys used."""
    pg, vg = engine._prefill, engine._verify
    addrs = {key: addresses(pg.inputs.view(key)) for key in pg.keys}
    seen = {"prefills": 0, "verifies": 0, "keys": set(), "calls": 0}
    run_prefill, step_prefill = pg.run, engine._run_prefill

    def probe_prefill(key):
        assert addresses(pg.inputs.view(key)) == addrs[key]
        seen["prefills"] += 1
        seen["keys"].add(key)
        return run_prefill(key)

    def count_prefill(seq):
        seen["calls"] += 1
        return step_prefill(seq)

    pg.run, engine._run_prefill = probe_prefill, count_prefill
    if vg is not None:
        verify_addrs, run_verify = addresses(vg.inputs.views), vg.run

        def probe_verify(noise):
            assert addresses(vg.inputs.views) == verify_addrs
            seen["verifies"] += 1
            return run_verify(noise)

        vg.run = probe_verify
    return seen


async def serve_waves(engine, ctx_cls, waves) -> list:
    """Each wave's requests queued whole before the engine starts (so both
    engines schedule the same steps), wave after wave."""
    out = []
    for wave in waves:
        tasks = [asyncio.ensure_future(collect(engine, r, ctx_cls)) for r in wave]
        await asyncio.sleep(0.05)
        engine.start()
        try:
            out.append(await asyncio.gather(*tasks))
        finally:
            engine.stop()
    return out


SEEDED = SamplingOptions(temperature=5.0, seed=13, frequency_penalty=0.6)


def waves(case: str, vocab: int) -> list[list[dict]]:
    rng = np.random.default_rng(11)

    def toks(n):
        return rng.integers(3, vocab, n).tolist()

    shared = toks(37)
    if case == "spec":
        # a run the counter weights continue (drafts accepted), a repeated
        # phrase, a seeded sampled lane riding the verify windows
        return [[request(RUN, max_tokens=12, ignore_eos=True),
                 request(PATTERN, max_tokens=8, ignore_eos=True),
                 request(toks(9), 6, SEEDED, ignore_eos=True)]]
    # whole prompts (within the chunk budget), a long prompt in chunks, a
    # seeded sampled lane; then a prompt that extends a finished one
    return [[request(toks(11), max_tokens=4, ignore_eos=True),
             request(toks(50), max_tokens=3, ignore_eos=True),
             request(toks(20), 4, SEEDED, ignore_eos=True),
             request(shared, max_tokens=2, ignore_eos=True)],
            [request(shared + toks(6), max_tokens=3, ignore_eos=True)]]


CASES = {
    "chunked": dict(prefill_chunk_tokens=32),
    "decode_steps4": dict(decode_steps=4),
    "spec": dict(speculative="ngram", spec_tokens=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("family", ["llama", "deepseek"])
async def test_replayed_split_steps_match_reference(family, case, families):
    fam = families[family]
    ref_engine, ours_engine = engines(fam, **CASES[case])
    batches = waves(case, fam["cfg"].vocab_size)
    ref = await serve_waves(ref_engine, JaxContext, batches)
    seen = replay_probe(ours_engine)
    ours = await serve_waves(ours_engine, Context, batches)
    assert ours == ref
    stats, ref_stats = ours_engine.stats(), ref_engine.stats()
    # every split prefill ran from its key's buffers
    assert seen["prefills"] == seen["calls"] > 0
    if case == "spec":
        for key in ("spec_drafted_tokens_total", "spec_accepted_tokens_total"):
            assert stats[key] == ref_stats[key], key
        assert stats["spec_accepted_tokens_total"] > 0
        assert seen["verifies"] == stats["spec_verify_steps_total"] > 0
    else:
        assert stats["prefix_hits_total"] == ref_stats["prefix_hits_total"] > 0
        kinds = {key[0] for key in seen["keys"]}
        assert kinds == {"prefill", "prefix"}


# ---------------------------------------------------------------------------
# shape signatures
# ---------------------------------------------------------------------------

def record_signatures(engine) -> list:
    """Every split prefill forward's key, from the shapes it was given."""
    sigs = []
    fam = engine.family
    whole, prefix = fam.forward_prefill, fam.forward_prefill_with_prefix

    def spy_whole(params, cfg, token_ids, cache, block_ids, *rest):
        assert block_ids.shape == (engine.max_blocks_per_seq,)
        sigs.append(("prefill", token_ids.shape[0]))
        return whole(params, cfg, token_ids, cache, block_ids, *rest)

    def spy_prefix(params, cfg, token_ids, cache, full_ids, tail_ids, *rest):
        assert full_ids.shape == tail_ids.shape
        sigs.append(("prefix", token_ids.shape[0], full_ids.shape[0]))
        return prefix(params, cfg, token_ids, cache, full_ids, tail_ids, *rest)

    engine.family = dataclasses.replace(fam, forward_prefill=spy_whole,
                                        forward_prefill_with_prefix=spy_prefix)
    return sigs


@pytest.mark.parametrize("kw,whole_buckets", [
    (dict(decode_steps=4), [16, 32, 64, 128]),
    (dict(prefill_chunk_tokens=32), [16, 32]),
    (dict(speculative="ngram", spec_tokens=4), [16, 32, 64, 128]),
], ids=["whole_prompts", "chunks_of_32", "speculative"])
async def test_every_split_step_carries_a_warmed_key(kw, whole_buckets):
    engine = TorchLlmEngine(EngineConfig(model=CFG, **{**BASE, "unified_batch": False, **kw}),
                            params=PARAMS, device="cpu")
    pg = engine._prefill
    # the reference's rule over every prompt length: whole prompts within
    # the chunk budget, continued windows at every bucket up to the longest
    # window at each table width (prefix hits too, without chunks)
    assert sorted(b for kind, b, *_ in pg.keys if kind == "prefill") == whole_buckets
    tables = sorted({t for kind, _, *t in pg.keys if kind == "prefix" for t in t})
    assert tables == [4, 8, 16, 32]
    sigs = record_signatures(engine)
    verify_idle = []
    if engine._verify is not None:
        verify_step = engine._verify.step
        engine._verify.step = lambda noise, top=0, idle=False: (
            verify_idle.append(idle), verify_step(noise, top, idle))[1]
    await engine.warmup()
    # each key run once with nothing live
    assert sorted(sigs) == pg.keys
    assert verify_idle == ([True, True] if engine._verify is not None else [])
    assert engine.allocator.cached_blocks == 0 and engine.allocator.used_blocks == 0
    stats = engine.stats()
    assert stats["prefill_graphs_captured"] == stats["verify_graphs_captured"] == 0  # no card
    sigs.clear()
    vocab = CFG.vocab_size
    rng = np.random.default_rng(8)
    shared = rng.integers(3, vocab, 30).tolist()
    for wave in (
        [request(rng.integers(3, vocab, n).tolist(), max_tokens=5, ignore_eos=True)
         for n in (3, 17, 33, 90)],
        [request(RUN, max_tokens=9, ignore_eos=True),
         request(shared, max_tokens=3, ignore_eos=True)],
        [request(shared + [5, 6, 7], max_tokens=4, ignore_eos=True)],
    ):
        await serve_waves(engine, Context, [wave])
    stats = engine.stats()
    assert stats["prefix_hits_total"] > 0
    assert {s[0] for s in sigs} == {"prefill", "prefix"}
    assert set(sigs) <= set(pg.keys)  # no new key after warmup
    assert stats["prefill_graphs_captured_after_warmup"] == 0
    assert stats["verify_graphs_captured_after_warmup"] == 0


async def test_warmup_takes_prompt_lengths():
    """``warmup(prompt_lens)`` captures the keys those lengths reach, as the
    reference's ``aot_precompile(prompt_lens)``: a 50-token prompt in chunks
    of 32 runs only them."""
    engine = TorchLlmEngine(EngineConfig(model=CFG, **{**BASE, "unified_batch": False,
                                                       "prefill_chunk_tokens": 32}),
                            params=PARAMS, device="cpu")
    sigs = record_signatures(engine)
    await engine.warmup([50])
    warmed = set(sigs)
    assert warmed == {("prefix", 16, 16), ("prefix", 32, 16)}
    sigs.clear()
    prompt = np.random.default_rng(3).integers(3, CFG.vocab_size, 50).tolist()
    await serve_waves(engine, Context, [[request(prompt, max_tokens=3, ignore_eos=True)]])
    assert sigs and set(sigs) <= warmed


def test_unified_engines_warm_no_split_key():
    """With the unified step on, the split prefill serves only the windows
    the unified step skips: warmup captures none of its keys."""
    engine = TorchLlmEngine(EngineConfig(model=CFG, **BASE), params=PARAMS, device="cpu")
    sigs = record_signatures(engine)
    asyncio.run(engine.warmup())
    assert engine.unified_batch and engine._prefill.keys and not sigs
    assert engine._prefill.warmed


def test_warmup_defers_keys_past_the_budget():
    """A key whose activations (``key_bytes``: four float32 score tensors
    of the window) exceed the budget is left to its first use, counted in
    ``prefill_graph_keys_deferred``; the rest are warmed, the largest
    first; a deferred key still serves."""
    engine = TorchLlmEngine(EngineConfig(model=CFG, **{**BASE, "unified_batch": False,
                                                       "speculative": "ngram"}),
                            params=PARAMS, device="cpu")
    pg = engine._prefill
    bs = engine.config.block_size
    for key in pg.keys:
        keys = key[1] + (key[2] * bs if key[0] == "prefix" else 0)
        assert pg.key_bytes(key) == 4 * CFG.num_heads * key[1] * keys * 4
    budget = sorted(map(pg.key_bytes, pg.keys))[len(pg.keys) // 2]
    sigs = record_signatures(engine)
    pg.warm(pg.keys, budget)
    assert pg.deferred == {k for k in pg.keys if pg.key_bytes(k) > budget} != set()
    assert sorted(sigs) == sorted(set(pg.keys) - pg.deferred)
    assert [pg.key_bytes(k) for k in sigs] == sorted(map(pg.key_bytes, sigs), reverse=True)
    assert engine.stats()["prefill_graph_keys_deferred"] == len(pg.deferred)
    whole = max(k for k in pg.deferred if k[0] == "prefill")
    prompt = np.random.default_rng(4).integers(3, CFG.vocab_size, whole[1] - 3).tolist()
    sigs.clear()
    (outs,) = asyncio.run(serve_waves(engine, Context, [[request(prompt, max_tokens=2,
                                                                  ignore_eos=True)]]))
    assert len(outs[0][0]) == 2 and sigs[0] == whole


async def test_serve_passes_warmup_prompt_lengths(monkeypatch):
    """``serve_http(warmup_prompt_lens=...)`` and the CLI's
    ``--warmup-prompt-lens`` reach ``warmup(prompt_lens)``."""
    from dynamo_tpu_torch.cli.run import parse_args
    from dynamo_tpu_torch.serve import serve_http

    seen = []
    real = TorchLlmEngine.warmup

    async def spy(self, prompt_lens=None):
        seen.append(prompt_lens)
        await real(self, prompt_lens)

    monkeypatch.setattr(TorchLlmEngine, "warmup", spy)
    handle = await serve_http("tests/data/tiny-chat-model", host="127.0.0.1", port=0,
                              device="cpu", warmup_prompt_lens=[50], num_blocks=64,
                              max_model_len=256, unified_batch=False)
    try:
        stats = handle.engine.stats()
    finally:
        await handle.shutdown()
    assert seen == [[50]] and stats["warmup_s"] is not None
    args = parse_args(["run", "--model-path", "m", "--warmup-prompt-lens", "50", "300"])
    assert args.warmup_prompt_lens == [50, 300]
    assert parse_args(["run", "--model-path", "m"]).warmup_prompt_lens is None


@pytest.mark.parametrize("noise", [False, True])
def test_idle_split_steps_change_nothing(noise):
    """The capture's warm-up steps (no valid token, no lane; every lane
    idle) leave the cache's live slots, the counts and the output buffers'
    meaning as they were."""
    engine = TorchLlmEngine(EngineConfig(model=CFG, **{**BASE, "speculative": "ngram"}),
                            params=PARAMS, device="cpu")
    gen = torch.Generator().manual_seed(2)
    for leaf in engine.cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    engine._gen_counts.copy_(torch.randint(0, 3, engine._gen_counts.shape, generator=gen))
    engine._prompt_counts.copy_(torch.randint(0, 3, engine._prompt_counts.shape, generator=gen))
    before = ({k: v.clone() for k, v in engine.cache.items()}, engine._gen_counts.clone(),
              engine._prompt_counts.clone())
    pg = engine._prefill
    for key in (pg.keys[0], pg.keys[-1]):
        pg.upload(key, {**pg._idle_arrays(key), "lane": np.int32(1), "gate": np.int32(1),
                        "seq_len": np.int32(key[1])})
        pg.step(key, idle=True)
    engine._verify.step(noise, idle=True)
    assert all(torch.equal(engine.cache[k], before[0][k]) for k in before[0])
    assert torch.equal(engine._gen_counts, before[1])
    assert torch.equal(engine._prompt_counts, before[2])


# ---------------------------------------------------------------------------
# lengths as tensors
# ---------------------------------------------------------------------------

def as_len(n: int) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


@pytest.mark.parametrize("family", ["llama", "deepseek"])
def test_prefill_forwards_take_tensor_lengths_bitwise(family):
    """Whole prompt, then a continued window over the resident prefix:
    logits and every cache slot bitwise the int-length calls'; the padded
    tables name block 0 (live here) past their end, where the tensor-length
    write drops its pad rows into the dump row."""
    mod = llama if family == "llama" else deepseek
    cfg = llama.LlamaConfig.tiny() if family == "llama" else deepseek.DeepseekConfig.tiny_mla()
    params = mod.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cos, sin = mod.make_rope_tables(cfg, device="cpu")
    whole = mod.llama_forward_prefill if family == "llama" else mod.deepseek_forward_prefill
    prefix = (mod.llama_forward_prefill_with_prefix if family == "llama"
              else mod.deepseek_forward_prefill_with_prefix)
    caches = [mod.init_kv_cache(cfg, 16, 4, device="cpu") for _ in range(2)]
    ids = torch.from_numpy(np.random.default_rng(0).integers(2, 500, 16).astype(np.int32))
    table = torch.tensor([7, 3, 0, 11, 0, 0], dtype=torch.int32)  # block 0 live at 2

    def same(a, b):
        assert torch.equal(a, b)
        assert all(torch.equal(caches[0][k], caches[1][k]) for k in caches[0])

    same(whole(params, cfg, ids, caches[0], table, 9, 0, cos, sin)[0],
         whole(params, cfg, ids, caches[1], table, as_len(9), 0, cos, sin)[0])
    tail_ids = torch.tensor([0, 11, 0, 0, 0, 0], dtype=torch.int32)
    same(prefix(params, cfg, ids[:8], caches[0], table, tail_ids, 5, 8, cos, sin)[0],
         prefix(params, cfg, ids[:8], caches[1], table, tail_ids, as_len(5), as_len(8),
                cos, sin)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float8_e4m3fn], ids=["f32", "fp8"])
def test_write_prefill_kv_takes_a_tensor_length_bitwise(dtype):
    """A tensor length and an int write the same bytes: the first 9 rows
    into their blocks' slots (the scatter the int path made before the
    lengths moved to the device), every pad row into the dump row past the
    leaf, no other slot touched."""
    rng = np.random.default_rng(1)
    k_new = torch.from_numpy(rng.normal(0, 2, (12, 2, 3)).astype(np.float32))
    v_new = torch.from_numpy(rng.normal(0, 2, (12, 2, 3)).astype(np.float32))
    block_ids = torch.tensor([0, 5, 2], dtype=torch.int32)  # pads of row 9+ name block 2
    fill = torch.from_numpy(rng.normal(0, 2, (2, 8, 4, 2, 3)).astype(np.float32))
    expect = []
    for new in (k_new, v_new):
        rows = attn.to_cache_dtype(fill, dtype).reshape(-1, 2, 3).clone()
        for i in range(9):  # layer 1's slots of the valid rows
            rows[8 * 4 + int(block_ids[i // 4]) * 4 + i % 4] = attn.to_cache_dtype(new[i], dtype)
        expect.append(torch.cat([rows, attn.to_cache_dtype(new[11:], dtype)]))
    for length in (9, as_len(9)):
        leaves = [attn.alloc_cache_leaf((2, 8, 4, 2, 3), dtype, "cpu") for _ in range(2)]
        for leaf in leaves:
            leaf.copy_(attn.to_cache_dtype(fill, dtype))
        attn.write_prefill_kv(leaves[0][1], leaves[1][1], k_new, v_new, block_ids, length)
        for leaf, want in zip(leaves, expect):
            assert torch.equal(attn.cache_rows(leaf).view(torch.uint8), want.view(torch.uint8))
    with pytest.raises(ValueError, match="dump row"):
        plain = torch.zeros((2, 8, 4, 2, 3))
        attn.write_prefill_kv(plain[1], plain[1].clone(), k_new, v_new, block_ids, as_len(9))
