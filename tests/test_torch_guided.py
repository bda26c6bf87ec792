"""Guided JSON decoding in the port (dynamo_tpu_torch/llm/guided.py and the
engine's mask in every sampling tail) against the JAX reference, on the CPU
with the reference's tiny random-weight llama (float32) and
tests/data/tiny-chat-model's tokenizer:
- the mask table built from the tokenizer equals dynamo_tpu.llm.guided's,
  and cursor walks over the same token sequences agree mode for mode;
- tests/engine/test_guided_engine.py's cases, each on both engines:
  admissible prefixes (greedy and seeded), early stop on a closed
  document, the synchronous fallback under overlap, the refusals with the
  reference's messages, unguided lanes unaffected, continued (chunked and
  prefix-hit) prefill, a soak under preemption and cancellation, and the
  counters;
- greedy and seeded guided streams byte-identical to JaxLlmEngine's;
- a table installed after warmup() masks the graphed windows' buffers as
  an eager step does (the table sits at one address)."""

import asyncio
import json
import random
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.llm import guided as jax_guided
from dynamo_tpu.llm.tokenizer import HfTokenizer as JaxTokenizer
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm import guided
from dynamo_tpu_torch.llm.guided import JsonCursor
from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_llama import tree_to_numpy

MODEL_DIR = Path(__file__).parent / "data" / "tiny-chat-model"
# the reference's guided tests run random weights (LlamaConfig.tiny()): a
# walk then reaches every kind of token, where the tiny chat model's
# counter weights would keep to one
JCFG = jax_llama.LlamaConfig.tiny()
CFG = llama.LlamaConfig.tiny()
JPARAMS = jax_llama.init_params(JCFG, jax.random.PRNGKey(0))
PARAMS = params_from_jax(tree_to_numpy(JPARAMS), device="cpu")
BASE = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32, 64),
            max_model_len=128)
STACKS = ("jax", "torch")


@pytest.fixture(scope="module")
def tokenizer():
    return HfTokenizer.from_model_dir(MODEL_DIR)


@pytest.fixture(scope="module")
def guided_parts(tokenizer, tmp_path_factory):
    cache = tmp_path_factory.mktemp("guided-cache")
    masks, strings = guided.build_for_tokenizer(tokenizer, cache_dir=str(cache))
    # the second call comes from the persisted cache and is identical
    masks2, _ = guided.build_for_tokenizer(tokenizer, cache_dir=str(cache))
    assert (masks2.mask == masks.mask).all()
    return masks, strings


def make_engine(stack, guided_parts=None, tokenizer=None, **overrides):
    """A started engine of ``stack`` with the table installed (when
    given), and its Context class."""
    cfg = {**BASE, **overrides}
    if stack == "jax":
        engine = JaxLlmEngine(JaxEngineConfig(model=JCFG, **cfg), params=JPARAMS)
        ctx_cls = JaxContext
    else:
        cfg.pop("enable_prefix_caching", None)  # always on in the port
        engine = TorchLlmEngine(EngineConfig(model=CFG, **cfg), params=PARAMS, device="cpu")
        ctx_cls = Context
    if guided_parts is not None:
        masks, strings = guided_parts
        engine.set_guided(masks, strings, tokenizer.eos_token_ids)
    engine.start()
    return engine, ctx_cls


def guided_request(max_tokens=48, seed=None, temperature=None, tokens=(3, 100, 200, 5),
                   output_format="json") -> dict:
    return PreprocessedRequest(
        token_ids=list(tokens),
        sampling=SamplingOptions(
            use_greedy=temperature is None, temperature=temperature, seed=seed
        ),
        stop=StopConditions(max_tokens=max_tokens),
        eos_token_ids=[1],
        output_format=output_format,
    ).to_wire()


async def collect(engine, ctx_cls, wire):
    stream = await engine.generate(ctx_cls(wire))
    tokens, finish = [], None
    async for item in stream:
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is None:
            continue
        if ann.data.finish_reason is FinishReason.ERROR:
            raise RuntimeError(ann.data.error)
        tokens += ann.data.token_ids
        if ann.data.finish_reason is not None:
            finish = FinishReason(ann.data.finish_reason.value)
    return tokens, finish


def replay(tokens, guided_parts, tokenizer) -> JsonCursor:
    masks, strings = guided_parts
    cursor = JsonCursor(masks, strings, eos_ids=tokenizer.eos_token_ids)
    for tid in tokens:
        cursor.advance(tid)
        assert not cursor.failed, f"inadmissible token {tid} ({strings[tid]!r}) in output"
    return cursor


# ---------------------------------------------------------------------------
# the table and the cursor against the reference's
# ---------------------------------------------------------------------------


def test_mask_table_equals_reference(guided_parts, tmp_path):
    masks, strings = guided_parts
    ref_masks, ref_strings = jax_guided.build_for_tokenizer(
        JaxTokenizer.from_model_dir(MODEL_DIR), cache_dir=str(tmp_path))
    assert strings == ref_strings
    assert masks.mode_index == ref_masks.mode_index
    assert masks.eos_allowed_modes == ref_masks.eos_allowed_modes
    np.testing.assert_array_equal(masks.mask, ref_masks.mask)


@pytest.mark.parametrize("seed", range(3))
def test_cursor_walks_equal_reference(guided_parts, tokenizer, seed):
    """The same token walks (admissible tokens drawn from each mode's row,
    with a stray token now and then) through both cursors: the same mode,
    completion and failure after every token."""
    masks, strings = guided_parts
    ours = JsonCursor(masks, strings, eos_ids=tokenizer.eos_token_ids)
    ref = jax_guided.JsonCursor(
        jax_guided.JsonTokenMasks(mask=masks.mask, mode_index=dict(masks.mode_index),
                                  eos_allowed_modes=list(masks.eos_allowed_modes)),
        strings, eos_ids=tokenizer.eos_token_ids)
    rng = np.random.default_rng(seed)
    for _ in range(60):
        mode = ours.mode_id
        allowed = np.flatnonzero(masks.mask[mode]) if mode >= 0 else np.arange(len(strings))
        stray = rng.random() < 0.05 or not len(allowed)
        tid = int(rng.integers(len(strings)) if stray else rng.choice(allowed))
        ours.advance(tid)
        ref.advance(tid)
        assert (ours.mode_id, ours.complete, ours.failed, ours.stack) == (
            ref.mode_id, ref.complete, ref.failed, ref.stack)


# ---------------------------------------------------------------------------
# the engine cases, on both engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("sampling", ["greedy", "temp"])
async def test_guided_output_is_valid_json_prefix(guided_parts, tokenizer, stack, sampling):
    engine, ctx = make_engine(stack, guided_parts, tokenizer)
    try:
        kwargs = {"temperature": 0.9, "seed": 7} if sampling == "temp" else {}
        tokens, finish = await collect(engine, ctx, guided_request(**kwargs))
        assert tokens
        replay(tokens, guided_parts, tokenizer)
        if finish is FinishReason.STOP:
            json.loads(tokenizer.decode(tokens, skip_special_tokens=True))
    finally:
        engine.stop()


@pytest.mark.parametrize("sampling", ["greedy", "temp"])
async def test_guided_streams_equal_reference(guided_parts, tokenizer, sampling):
    """Byte-identical guided streams, greedy and seeded, with staggered
    mixed lanes (guided and not) in one batch."""
    kwargs = {"temperature": 0.9, "seed": 11} if sampling == "temp" else {}
    reqs = [guided_request(max_tokens=24, tokens=range(3 + i, 9 + 2 * i),
                           output_format="json" if i % 2 == 0 else None, **kwargs)
            for i in range(4)]
    out = {}
    for stack in STACKS:
        engine, ctx = make_engine(stack, guided_parts, tokenizer, decode_overlap=False)
        try:
            out[stack] = await asyncio.gather(*(collect(engine, ctx, r) for r in reqs))
            out[stack + "_stats"] = {k: engine.stats()[k] for k in (
                "guided_requests_total", "guided_completions_total")}
        finally:
            engine.stop()
    assert out["torch"] == out["jax"]
    assert out["torch_stats"] == out["jax_stats"]
    for tokens, _ in out["torch"][::2]:
        replay(tokens, guided_parts, tokenizer)


@pytest.mark.parametrize("stack", STACKS)
async def test_guided_completion_stops_early(guided_parts, tokenizer, stack):
    engine, ctx = make_engine(stack, guided_parts, tokenizer)
    try:
        tokens, finish = await collect(engine, ctx, guided_request(max_tokens=96))
        cursor = replay(tokens, guided_parts, tokenizer)
        if cursor.complete:
            assert finish is FinishReason.STOP
            assert len(tokens) <= 96
        else:
            assert finish is FinishReason.LENGTH
    finally:
        engine.stop()


@pytest.mark.parametrize("stack", STACKS)
async def test_guided_falls_back_to_sync_decode(guided_parts, tokenizer, stack):
    """A guided lane gates its NEXT sample by a host automaton: the
    overlapped pipeline runs none of its windows."""
    engine, ctx = make_engine(stack, guided_parts, tokenizer, decode_overlap=True)
    try:
        tokens, _ = await collect(engine, ctx, guided_request())
        assert tokens
        stats = engine.stats()
        assert stats["decode_windows_overlapped_total"] == 0
        assert stats["decode_windows_sync_total"] > 0
        if stack == "torch":
            assert stats["unified_fallbacks"].get("guided", 0) > 0
            assert stats["decode_windows_unified_total"] == 0
    finally:
        engine.stop()


@pytest.mark.parametrize("stack", STACKS)
async def test_guided_rejected_without_mask_table(stack):
    engine, ctx = make_engine(stack)
    try:
        with pytest.raises(ValueError, match="not enabled"):
            await engine.generate(ctx(guided_request()))
    finally:
        engine.stop()


@pytest.mark.parametrize("stack", STACKS)
async def test_guided_refusals_match_reference(guided_parts, tokenizer, stack):
    """The same messages: fused decode, speculation, an unknown format."""
    refusals = (
        (dict(decode_steps=4), "json", "requires decode_steps=1"),
        (dict(speculative="ngram"), "json", "does not compose with speculative"),
        ({}, "yaml", "unsupported output_format 'yaml'"),
    )
    for overrides, fmt, message in refusals:
        engine, ctx = make_engine(stack, guided_parts, tokenizer, **overrides)
        try:
            with pytest.raises(ValueError, match=message):
                await engine.generate(ctx(guided_request(output_format=fmt)))
            assert engine.stats()["guided_requests_total"] == 0
        finally:
            engine.stop()


@pytest.mark.parametrize("stack", STACKS)
async def test_unguided_lanes_unaffected(guided_parts, tokenizer, stack):
    """Installing the table changes nothing an unguided request samples."""
    wire = guided_request(max_tokens=8, tokens=(3, 7, 11, 13), output_format=None)
    plain, ctx = make_engine(stack)
    try:
        expected, _ = await collect(plain, ctx, wire)
    finally:
        plain.stop()
    engine, ctx = make_engine(stack, guided_parts, tokenizer)
    try:
        got, _ = await collect(engine, ctx, wire)
    finally:
        engine.stop()
    assert got == expected


@pytest.mark.parametrize("mode", ["chunked", "prefix_hit"])
async def test_guided_composes_with_continued_prefill(guided_parts, tokenizer, mode):
    """Only the FINAL chunk's sample is masked, and a prefix hit's tail
    prefill samples masked: both engines, the same stream."""
    kwargs = ({"prefill_chunk_tokens": 16} if mode == "chunked"
              else {"enable_prefix_caching": True})
    wire = guided_request(max_tokens=24, tokens=range(3, 40))  # 3 chunks at 16
    out = {}
    for stack in STACKS:
        engine, ctx = make_engine(stack, guided_parts, tokenizer, decode_overlap=False,
                                  **kwargs)
        try:
            if mode == "prefix_hit":
                # warm the prefix with an UNGUIDED request for the same prompt
                plain = dict(wire)
                plain.pop("output_format")
                await collect(engine, ctx, plain)
            out[stack] = await collect(engine, ctx, wire)
            if mode == "prefix_hit":
                assert engine.stats()["prefix_hits_total"] >= 1
        finally:
            engine.stop()
    assert out["torch"] == out["jax"]
    assert out["torch"][0]
    replay(out["torch"][0], guided_parts, tokenizer)


@pytest.mark.parametrize("stack", STACKS)
async def test_soak_mixed_guided_unguided_under_preemption(guided_parts, tokenizer, stack):
    """Guided and unguided requests over a pool far too small for the load
    (constant preemption and recompute), a third cancelled mid-stream:
    every guided stream replays admissible, no block leaks, and the engine
    still serves."""
    engine, ctx_cls = make_engine(stack, guided_parts, tokenizer, num_blocks=24,
                                  prefill_buckets=(16, 64), max_model_len=64)
    try:
        async def one(i: int):
            r = random.Random(i)
            n = r.randint(2, 30)
            wire = PreprocessedRequest(
                token_ids=list(range(3, 3 + n)),
                sampling=SamplingOptions(use_greedy=(i % 2 == 0),
                                         temperature=None if i % 2 == 0 else 0.8, seed=i),
                stop=StopConditions(max_tokens=r.randint(1, 20)),
                eos_token_ids=[1],
                output_format="json" if i % 4 == 0 else None,
            ).to_wire()
            ctx = ctx_cls(wire)
            stream = await engine.generate(ctx)
            cancel_at = r.randint(1, 5) if i % 3 == 1 else None
            tokens = []
            async for item in stream:
                ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
                if ann.data is None:
                    continue
                if ann.data.finish_reason is not None and ann.data.finish_reason.value == "error":
                    raise RuntimeError(ann.data.error)
                tokens += ann.data.token_ids
                if cancel_at is not None and len(tokens) >= cancel_at:
                    ctx.ctx.stop_generating()
            return i, tokens

        results = await asyncio.gather(*[one(i) for i in range(24)])
        for i, tokens in results:
            assert tokens
            if i % 4 == 0:
                replay(tokens, guided_parts, tokenizer)
        for _ in range(200):
            if engine.allocator.used_blocks == 0 and engine.scheduler.num_running == 0:
                break
            await asyncio.sleep(0.02)
        assert engine.allocator.used_blocks == 0
        assert engine.scheduler.num_running == 0
        tokens, _ = await collect(engine, ctx_cls, guided_request(max_tokens=6))
        assert tokens  # alive after the storm
    finally:
        engine.stop()


@pytest.mark.parametrize("stack", STACKS)
async def test_guided_counters_in_stats(guided_parts, tokenizer, stack):
    """A document that closes counts once, also when its closing token
    coincides with max_tokens (LENGTH)."""
    engine, ctx = make_engine(stack, guided_parts, tokenizer)
    try:
        done = None
        for seed in range(12):
            tokens, finish = await collect(
                engine, ctx, guided_request(max_tokens=96, temperature=1.3, seed=seed))
            if replay(tokens, guided_parts, tokenizer).complete:
                done = (tokens, finish, seed)
                break
        assert done is not None, "no seed completed a document in 96 tokens"
        tokens, finish, seed = done
        assert finish is FinishReason.STOP
        stats = engine.stats()
        assert stats["guided_requests_total"] == seed + 1
        completions = stats["guided_completions_total"]
        assert completions >= 1
        tokens2, _ = await collect(
            engine, ctx, guided_request(max_tokens=len(tokens), temperature=1.3, seed=seed))
        assert tokens2 == tokens
        assert engine.stats()["guided_completions_total"] == completions + 1
    finally:
        engine.stop()


# ---------------------------------------------------------------------------
# the table's address: graphs captured before the table read it
# ---------------------------------------------------------------------------


async def test_table_installed_after_warmup_masks_replayed_windows(guided_parts, tokenizer):
    """Warm first, then install: the decode window and the split prefill
    read the resident table in place (a copy, never a new tensor), so a
    window driven from the graphs' buffers masks exactly as the eager step
    over the same table, and the stream equals the reference's."""
    engine = TorchLlmEngine(EngineConfig(model=CFG, decode_overlap=False, **BASE),
                            params=PARAMS, device="cpu")
    await engine.warmup()
    table = engine._guided_table
    address = table.data_ptr()
    assert bool(table.all())  # all true until installed
    masks, strings = guided_parts
    engine.set_guided(masks, strings, tokenizer.eos_token_ids)
    assert engine._guided_table is table and table.data_ptr() == address
    want = np.zeros(tuple(table.shape), bool)
    want[:, : masks.mask.shape[1]] = masks.mask[:, : CFG.vocab_size]
    np.testing.assert_array_equal(table.numpy(), want)

    # the decode graph's tail: lane 0 guided in the terminal mode, lane 1
    # unguided; the masked logits are the table's rows
    d = engine._decode
    terminal = masks.mode_index[guided.JsonTokenMasks.TERMINAL]
    logits = torch.randn((BASE["max_batch_size"], CFG.vocab_size), generator=torch.Generator().manual_seed(0))
    from dynamo_tpu_torch.engine.graphs import guided_mask

    modes = torch.tensor([terminal, -1, 0, -1], dtype=torch.int32)
    masked = guided_mask(logits, table, modes)
    assert torch.equal(torch.isfinite(masked[0]), table[terminal])
    assert torch.equal(masked[1], logits[1]) and torch.equal(masked[3], logits[3])
    assert torch.equal(torch.isfinite(masked[2]), table[0])
    assert "gmodes" in d.tail.views

    engine.start()
    try:
        ours = await collect(engine, Context, guided_request(max_tokens=24))
    finally:
        engine.stop()
    ref, ctx = make_engine("jax", guided_parts, tokenizer, decode_overlap=False)
    try:
        theirs = await collect(ref, ctx, guided_request(max_tokens=24))
    finally:
        ref.stop()
    assert ours == theirs
    replay(ours[0], guided_parts, tokenizer)
