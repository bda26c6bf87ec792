"""Disaggregated prefill/decode in the port (dynamo_tpu_torch/llm/disagg.py
over TorchLlmEngine's extract / inject, the transfer plane and the queue)
against the reference's (dynamo_tpu/llm/disagg.py over JaxLlmEngine), on
the CPU at tiny widths: tests/llm/test_disagg.py's, test_disagg_stream.py's
and test_disagg_requeue.py's cases, run against the port.

- Remote-prefill exactness: the decode side's stream equals one engine's
  and the reference's disaggregated pair's, byte for byte, for llama (over
  TCP and the same-process route) and ``deepseek_v2`` (MLA leaves of two
  widths; streamed too), on fp8 and bf16 caches, with logprobs across the
  boundary (within fp32 tolerance of the reference's), and under a
  speculative decode worker.
- Streamed parity (chunks shipped while later ones compute), the stream-off
  fallback, out-of-order and duplicate parts, an inject abandoned
  mid-flight, inject failure, a late transfer, the timeout fallback, the
  requeue of a stalled stream, and the staleness rule.
- Guided JSON across the split, and the refusal that releases its blocks.
- One cross-process case: the prefill worker in a subprocess
  (``device="cpu"``) over the control-plane server and TCP."""

import asyncio
import importlib
import itertools
import os
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import deepseek as jax_ds
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm import guided
from dynamo_tpu_torch.llm.disagg import (
    DisaggConfig,
    DisaggDecodeEngine,
    DisaggRouter,
    PrefillQueue,
    PrefillWorker,
    disagg_config_key,
    kv_stream_enabled,
)
from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
from dynamo_tpu_torch.models import deepseek, llama
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.ops.kernels import block_copy
from dynamo_tpu_torch.parallel.kv_transfer import LOCAL_SERVERS, KvTransferPayload
from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.robustness.faults import FAULTS
from dynamo_tpu_torch.runtime import Context, DistributedRuntime
from dynamo_tpu_torch.utils.config import RuntimeConfig

from tests.test_torch_llama import tree_to_numpy

REPO = Path(__file__).parent.parent
JCFG = jax_llama.LlamaConfig.tiny()
CFG = llama.LlamaConfig.tiny()
JPARAMS = jax_llama.init_params(JCFG, jax.random.PRNGKey(0))
PARAMS = params_from_jax(tree_to_numpy(JPARAMS), device="cpu")
JDS = jax_ds.DeepseekConfig.tiny_mla()
DS = deepseek.DeepseekConfig.tiny_mla()
JDS_PARAMS = jax_ds.init_params(JDS, jax.random.PRNGKey(0))
DS_PARAMS = params_from_jax(tree_to_numpy(JDS_PARAMS), device="cpu")
BASE = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32),
            max_model_len=64)
PKG = {"jax": "dynamo_tpu", "torch": "dynamo_tpu_torch"}
LP_TOL = 1e-4  # logprobs of two frameworks' float32 forwards
_names = itertools.count()


def mod(stack: str, name: str):
    return importlib.import_module(f"{PKG[stack]}.{name}")


def make_engine(stack="torch", family="llama", **overrides):
    cfg = {**BASE, **overrides}
    if stack == "jax":
        model, params = (JCFG, JPARAMS) if family == "llama" else (JDS, JDS_PARAMS)
        engine = JaxLlmEngine(JaxEngineConfig(model=model, model_family=family, **cfg),
                              params=params)
    else:
        model, params = (CFG, PARAMS) if family == "llama" else (DS, DS_PARAMS)
        engine = TorchLlmEngine(EngineConfig(model=model, model_family=family, **cfg),
                                params=params, device="cpu")
    engine.start()
    return engine


def make_leaf_names():
    return list(llama.init_kv_cache(CFG, 1, 4, torch.float32, "cpu"))


def request(tokens, max_tokens=6, top_logprobs=0, output_format=None) -> dict:
    return PreprocessedRequest(
        token_ids=list(tokens),
        sampling=SamplingOptions(use_greedy=True, top_logprobs=top_logprobs),
        stop=StopConditions(max_tokens=max_tokens),
        eos_token_ids=[1],
        output_format=output_format,
    ).to_wire()


async def collect(stream, detail=False):
    tokens, lps, tops = [], [], []
    async for item in stream:
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is None:
            continue
        if ann.data.finish_reason is not None and ann.data.finish_reason.value == "error":
            raise RuntimeError(ann.data.error)
        tokens.extend(ann.data.token_ids)
        lps.extend(ann.data.logprobs or [])
        tops.extend(ann.data.top_logprobs or [])
    return (tokens, lps, tops) if detail else tokens


async def single(stack, prompts, family="llama", engine_kw=None, **req_kw):
    """The prompts through one engine of ``stack``, local prefill."""
    engine = make_engine(stack, family, **(engine_kw or {}))
    try:
        ctx = mod(stack, "runtime").Context
        return [await collect(await engine.generate(ctx(request(p, **req_kw))),
                              detail=req_kw.get("top_logprobs", 0) > 0)
                for p in prompts]
    finally:
        engine.stop()


class Pair:
    """A decode engine behind DisaggDecodeEngine and a prefill engine behind
    a PrefillWorker pump, of one stack, over a fresh memory plane."""

    def __init__(self, stack="torch", family="llama", tcp=False, decode_kw=None,
                 prefill_kw=None, stream=None, start_worker=True, max_local=4):
        self.stack, self.family, self.tcp = stack, family, tcp
        self.decode_kw, self.prefill_kw = decode_kw or {}, prefill_kw or {}
        self.stream, self.start_worker, self.max_local = stream, start_worker, max_local
        self.worker = self.disagg = self.prefill = self.decode = self.rt = None

    async def __aenter__(self):
        m = mod(self.stack, "llm.disagg")
        self.rt = await mod(self.stack, "runtime").DistributedRuntime.create(
            mod(self.stack, "utils.config").RuntimeConfig(
                control_plane=f"memory://tdisagg-{next(_names)}"))
        self.decode = make_engine(self.stack, self.family, **self.decode_kw)
        self.prefill = make_engine(self.stack, self.family, **self.prefill_kw)
        router = m.DisaggRouter(self.rt, "tiny", m.DisaggConfig(max_local_prefill_length=self.max_local))
        self.queue = m.PrefillQueue(self.rt, "ns", "backend")
        self.disagg = m.DisaggDecodeEngine(self.rt, self.decode, router, self.queue)
        await self.disagg.start()
        if self.tcp:
            mod(self.stack, "parallel.kv_transfer").LOCAL_SERVERS.pop(
                self.disagg.transfer_server.address, None)
        if self.start_worker:
            self.worker = m.PrefillWorker(self.rt, self.prefill, self.queue, stream=self.stream)
            self.worker.start()
        return self

    async def run(self, prompts, **req_kw):
        ctx = mod(self.stack, "runtime").Context
        detail = req_kw.get("top_logprobs", 0) > 0
        return await asyncio.gather(*[
            collect(await self.disagg.generate(ctx(request(p, **req_kw))), detail=detail)
            for p in prompts])

    async def drained(self):
        for _ in range(200):
            if self.decode.allocator.used_blocks == 0:
                break
            await asyncio.sleep(0.02)
        return self.decode.allocator.used_blocks == 0 and self.prefill.allocator.used_blocks == 0

    async def __aexit__(self, *exc):
        if self.worker is not None:
            await self.worker.stop()
        if self.disagg is not None:
            await self.disagg.stop()
        self.decode.stop()
        self.prefill.stop()
        await self.rt.close()


# ---------------------------------------------------------------------------
# decision, config, queue
# ---------------------------------------------------------------------------


def test_disagg_decision_equals_reference():
    ref_m = mod("jax", "llm.disagg")
    for cfg in (dict(max_local_prefill_length=512, max_prefill_queue_size=4),
                dict(max_local_prefill_length=8, max_prefill_queue_size=2,
                     max_transfer_seconds=0.5)):
        ours, ref = DisaggRouter.__new__(DisaggRouter), ref_m.DisaggRouter.__new__(ref_m.DisaggRouter)
        ours.config, ref.config = DisaggConfig(**cfg), ref_m.DisaggConfig(**cfg)
        for n, q, est in itertools.product((4, 100, 1000), (0, 3, 10), (0.0, 0.2, 2.0)):
            assert ours.prefill_remote(n, q, est) == ref.prefill_remote(n, q, est)
    assert disagg_config_key("tiny") == ref_m.disagg_config_key("tiny")


async def test_disagg_config_hot_reload():
    rt = await DistributedRuntime.create(RuntimeConfig(control_plane=f"memory://hot-{next(_names)}"))
    try:
        router = DisaggRouter(rt, "tiny")
        await router.start()
        assert router.config.max_local_prefill_length == 512
        await rt.plane.kv.put(disagg_config_key("tiny"),
                              b'{"max_local_prefill_length": 4, "max_prefill_queue_size": 2}')
        for _ in range(100):
            if router.config.max_local_prefill_length == 4:
                break
            await asyncio.sleep(0.02)
        assert (router.config.max_local_prefill_length, router.config.max_prefill_queue_size) == (4, 2)
        await router.stop()
    finally:
        await rt.close()


async def test_queue_pop_meta_reports_broker_age():
    rt = await DistributedRuntime.create(RuntimeConfig(control_plane=f"memory://age-{next(_names)}"))
    try:
        queue = PrefillQueue(rt, "ns", "backend")
        await queue.enqueue({"seq_id": "x"})
        await asyncio.sleep(0.05)
        item, age = await queue.dequeue_with_age(timeout=1.0)
        assert item["seq_id"] == "x" and 0.04 <= age < 5.0
    finally:
        await rt.close()


def test_staleness_tolerates_clock_skew():
    worker = PrefillWorker.__new__(PrefillWorker)
    worker.clock_skew_margin_s = 30.0
    now = time.time()
    assert not worker._is_stale({"ttl_s": 10, "deadline_ts": now - 110}, queue_age_s=2.0)
    assert worker._is_stale({"ttl_s": 10, "deadline_ts": now + 300}, queue_age_s=11.0)
    assert not worker._is_stale({"ttl_s": 10, "deadline_ts": now - 10}, None)
    assert worker._is_stale({"ttl_s": 10, "deadline_ts": now - 40}, None)
    assert worker._is_stale({"deadline_ts": now - 40}, queue_age_s=1.0)


# ---------------------------------------------------------------------------
# exactness against one engine and the reference's pair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["tcp", "device"])
async def test_remote_prefill_exactness(route):
    prompts = [list(range(3, 13)), list(range(20, 31))]
    want = await single("torch", prompts)
    plain0 = block_copy.plain_calls
    async with Pair("torch", tcp=route == "tcp") as pair:
        got = await pair.run(prompts)
        assert pair.disagg.remote_prefills == 2 and pair.worker.prefills_done == 2
        assert pair.prefill.extract_calls == 2 and pair.decode.inject_calls == 2
        assert await pair.drained()
    # on the CPU the wrappers take their plain versions: a gather a leaf
    # for each extract, a scatter a leaf for each inject
    leaves = len(make_leaf_names())
    assert block_copy.plain_calls - plain0 >= 2 * 2 * leaves
    async with Pair("jax", tcp=route == "tcp") as ref_pair:
        ref = await ref_pair.run(prompts)
    assert got == want == ref


async def test_short_prompt_stays_local():
    async with Pair("torch", max_local=512, start_worker=False) as pair:
        prompt = list(range(3, 9))
        got = await pair.run([prompt], max_tokens=4)
        assert got == await single("torch", [prompt], max_tokens=4)
        assert (pair.disagg.local_prefills, pair.disagg.remote_prefills) == (1, 0)
        assert await pair.queue.size() == 0


async def test_concurrent_disagg_requests():
    prompts = [list(range(3 + i, 11 + i)) for i in range(3)]
    async with Pair("torch") as pair:
        got = await pair.run(prompts, max_tokens=4)
        assert pair.disagg.remote_prefills == 3
    assert got == await single("torch", prompts, max_tokens=4)


@pytest.mark.parametrize("route", ["device", "tcp", "tcp_streamed"])
async def test_deepseek_remote_prefill_exactness(route):
    """The MLA cache's leaves have two widths (latent and rope keys);
    single-shot on both routes, and streamed in chunks of 8 over TCP."""
    streamed = route == "tcp_streamed"
    prompt = list(range(3, 27 if streamed else 13))
    kw = dict(family="deepseek_v2", tcp=route != "device", stream=streamed,
              prefill_kw=dict(prefill_chunk_tokens=8) if streamed else None)
    async with Pair("torch", **kw) as pair:
        got = await pair.run([prompt])
        assert pair.disagg.remote_prefills == 1
        assert pair.disagg.kv_transfer_parts_total == (3 if streamed else 1)
        widths = {leaf.shape[-1] for leaf in pair.decode.cache.values()}
        assert len(widths) == 2
    async with Pair("jax", **kw) as ref_pair:
        ref = await ref_pair.run([prompt])
    assert got == ref == await single("torch", [prompt], family="deepseek_v2")


async def test_disagg_logprobs_cross_boundary():
    prompt = list(range(3, 13))
    async with Pair("torch") as pair:
        ((tokens, lps, tops),) = await pair.run([prompt], max_tokens=4, top_logprobs=3)
    async with Pair("jax") as ref_pair:
        ((rtokens, rlps, rtops),) = await ref_pair.run([prompt], max_tokens=4, top_logprobs=3)
    assert tokens == rtokens and len(lps) == len(tokens) == len(tops)
    np.testing.assert_allclose(lps, rlps, atol=LP_TOL)
    for row, rrow in zip(tops, rtops):
        assert [i for i, _ in row] == [i for i, _ in rrow]
        np.testing.assert_allclose([v for _, v in row], [v for _, v in rrow], atol=LP_TOL)
        assert [v for _, v in row] == sorted((v for _, v in row), reverse=True)
    assert tops[0][0][0] == tokens[0]


@pytest.mark.parametrize("cache", ["fp8", "bf16"])
async def test_remote_prefill_exactness_fp8_cache(cache):
    """fp8 e4m3fn and bf16 cache leaves over TCP (their raw bytes under the
    reference's dtype names)."""
    prompt = list(range(3, 13))
    kw = dict(kv_cache_dtype=cache)
    async with Pair("torch", tcp=True, decode_kw=kw, prefill_kw=kw) as pair:
        got = await pair.run([prompt])
        assert pair.disagg.remote_prefills == 1
        want = {"fp8": torch.float8_e4m3fn, "bf16": torch.bfloat16}[cache]
        assert {leaf.dtype for leaf in pair.decode.cache.values()} == {want}
    async with Pair("jax", tcp=True, decode_kw=kw, prefill_kw=kw) as ref_pair:
        ref = await ref_pair.run([prompt])
    assert got == ref == await single("torch", [prompt], engine_kw=kw)


async def test_remote_prefill_with_speculative_decode():
    prompt = [7, 11, 19, 7, 11, 19, 7, 11, 19, 7, 11]
    kw = dict(speculative="ngram", spec_tokens=3)
    async with Pair("torch", decode_kw=kw) as pair:
        got = await pair.run([prompt], max_tokens=8)
        assert pair.disagg.remote_prefills == 1
        assert pair.decode.stats()["spec_drafted_tokens_total"] > 0
    async with Pair("jax", decode_kw=kw) as ref_pair:
        ref = await ref_pair.run([prompt], max_tokens=8)
    assert got == ref == await single("torch", [prompt], max_tokens=8)


# ---------------------------------------------------------------------------
# streamed transfer
# ---------------------------------------------------------------------------


async def test_streamed_parity_and_hidden_accounting():
    """24 tokens in chunks of 8 over TCP: two parts mid-prefill and the
    closing part, the stream equal to one engine's, the single-shot
    transfer's and the reference's streamed pair's."""
    prompt = list(range(3, 27))
    async with Pair("torch", tcp=True, prefill_kw=dict(prefill_chunk_tokens=8),
                    stream=True) as pair:
        streamed = await pair.run([prompt])
        d = pair.disagg
        assert pair.worker.kv_parts_sent_total == 3
        assert (d.kv_transfer_parts_total, d.kv_transfer_streams_total,
                d.kv_transfer_duplicate_parts_total) == (3, 1, 0)
        assert d.kv_transfer_hidden_seconds_total > 0
        stats = d.stats()
        assert 0 < stats["disagg_transfer_hidden_ratio"] <= 1
        assert stats["kv_transfer_bandwidth_bps"] > 0
        assert pair.prefill.extract_calls == 3 and pair.decode.inject_calls == 3
        await pair.worker.stop()
        pair.worker = PrefillWorker(pair.rt, pair.prefill, pair.queue, stream=False)
        pair.worker.start()
        single_shot = await pair.run([prompt])
        assert (d.kv_transfer_streams_total, d.kv_transfer_parts_total) == (2, 4)
        assert await pair.drained()
    async with Pair("jax", tcp=True, prefill_kw=dict(prefill_chunk_tokens=8),
                    stream=True) as ref_pair:
        ref = await ref_pair.run([prompt])
        assert ref_pair.worker.kv_parts_sent_total == 3
    assert streamed == single_shot == ref == await single("torch", [prompt])


async def test_kv_stream_env_gate(monkeypatch):
    monkeypatch.setenv("DYN_KV_STREAM", "0")
    assert not kv_stream_enabled()
    worker = PrefillWorker(None, None, None)
    assert worker.stream is False
    await worker.stop()
    monkeypatch.setenv("DYN_KV_STREAM", "1")
    worker = PrefillWorker(None, None, None, stream=False)
    assert worker.stream is False
    await worker.stop()
    monkeypatch.delenv("DYN_KV_STREAM")
    assert kv_stream_enabled()


async def test_streamed_fallback_when_stream_disabled():
    prompt = list(range(3, 27))
    async with Pair("torch", prefill_kw=dict(prefill_chunk_tokens=8), stream=False) as pair:
        got = await pair.run([prompt])
        assert pair.worker.kv_parts_sent_total == 1
        assert pair.disagg.kv_transfer_parts_total == 1
        assert pair.disagg.kv_transfer_hidden_seconds_total == 0.0
    assert got == await single("torch", [prompt])


def leaves_for(engine, n_blocks: int) -> dict:
    return {k: torch.zeros((v.shape[0], n_blocks, *v.shape[2:]), dtype=torch.float32)
            for k, v in engine.cache.items()}


async def test_mixed_version_payloads_and_out_of_order_parts():
    """One sink: a legacy single-part payload takes the pop-claim path; a
    stream whose closing part comes first, with a duplicate, completes only
    once every index is injected."""
    async with Pair("torch", start_worker=False) as pair:
        d, engine = pair.disagg, pair.decode
        loop = asyncio.get_running_loop()
        legacy = engine.reserve_blocks(8)
        fut1 = loop.create_future()
        d._pending["legacy"] = (fut1, legacy, None)
        await d._on_transfer(KvTransferPayload(seq_id="legacy", first_token=7,
                                               block_ids=legacy[:2], blocks=leaves_for(engine, 2)))
        assert fut1.result()[0] == 7 and not d._assembly
        blocks = engine.reserve_blocks(12)
        fut = loop.create_future()
        d._pending["ooo"] = (fut, blocks, None)

        def part(idx, last):
            return KvTransferPayload(seq_id="ooo", first_token=42 if last else -1,
                                     block_ids=blocks[idx: idx + 1], blocks=leaves_for(engine, 1),
                                     part_index=idx, last=last, block_start=idx)

        await d._on_transfer(part(2, True))
        await d._on_transfer(part(0, False))
        await d._on_transfer(part(0, False))  # a duplicate
        assert not fut.done() and d.kv_transfer_duplicate_parts_total == 1
        await d._on_transfer(part(1, False))
        assert fut.result()[0] == 42
        assert d.kv_transfer_parts_total == 4 and not d._assembly
        engine.release_blocks(legacy)
        engine.release_blocks(blocks)


async def test_abandoned_mid_inject_defers_release(monkeypatch):
    async with Pair("torch", start_worker=False) as pair:
        d, engine = pair.disagg, pair.decode
        baseline = engine.allocator.used_blocks
        blocks = engine.reserve_blocks(8)
        reserved = engine.allocator.used_blocks
        fut = asyncio.get_running_loop().create_future()
        d._pending["aband"] = (fut, blocks, None)
        gate, entered = asyncio.Event(), asyncio.Event()

        async def slow_inject(block_ids, leaves):
            entered.set()
            await gate.wait()

        monkeypatch.setattr(engine, "inject_blocks", slow_inject)
        task = asyncio.ensure_future(d._on_transfer(KvTransferPayload(
            seq_id="aband", first_token=-1, block_ids=blocks[:1],
            blocks=leaves_for(engine, 1), part_index=0, last=False, block_start=0)))
        await entered.wait()
        assert d._pending.pop("aband") is not None
        d._release_landing("aband", blocks)
        assert engine.allocator.used_blocks == reserved  # deferred
        gate.set()
        await task
        assert engine.allocator.used_blocks == baseline and not d._assembly
        await d._on_transfer(KvTransferPayload(
            seq_id="aband", first_token=9, block_ids=blocks[1:2],
            blocks=leaves_for(engine, 1), part_index=1, last=True, block_start=1))
        assert engine.allocator.used_blocks == baseline


async def test_inject_failure_surfaces_to_requester():
    """A real inject that fails (leaves of the wrong shape) wakes the
    requester with the engine's exception; the release path frees the
    landing zone."""
    async with Pair("torch", start_worker=False) as pair:
        d, engine = pair.disagg, pair.decode
        baseline = engine.allocator.used_blocks
        blocks = engine.reserve_blocks(8)
        fut = asyncio.get_running_loop().create_future()
        d._pending["boom"] = (fut, blocks, None)
        await d._on_transfer(KvTransferPayload(
            seq_id="boom", first_token=-1, block_ids=blocks[:1],
            blocks=leaves_for(engine, 2), part_index=0, last=False, block_start=0))
        with pytest.raises(ValueError, match="inject: leaf"):
            fut.result()
        assert "boom" not in d._pending
        d._release_landing("boom", blocks)
        assert not d._assembly and engine.allocator.used_blocks == baseline


async def test_late_transfer_dropped_and_claimed_cancelled_releases(monkeypatch):
    async with Pair("torch", start_worker=False) as pair:
        d, engine = pair.disagg, pair.decode
        d.prefill_timeout_s = 0.2
        prompt = list(range(3, 13))
        got = await pair.run([prompt], max_tokens=4)  # times out, serves locally
        assert got == await single("torch", [prompt], max_tokens=4)
        assert not d._pending and d.remote_prefill_timeouts == 1
        injected = []

        async def spy(block_ids, blocks):
            injected.append(block_ids)

        real_inject = engine.inject_blocks
        monkeypatch.setattr(engine, "inject_blocks", spy)
        await d._on_transfer(KvTransferPayload(seq_id="whatever", first_token=1,
                                               block_ids=[0, 1], blocks={}))
        assert injected == []
        monkeypatch.setattr(engine, "inject_blocks", real_inject)
        assert await pair.drained()
        block_ids = engine.reserve_blocks(8)
        fut = asyncio.get_running_loop().create_future()
        fut.cancel()
        d._pending["s1"] = (fut, block_ids, None)
        await d._on_transfer(KvTransferPayload(seq_id="s1", first_token=1,
                                               block_ids=block_ids[:2], blocks=leaves_for(engine, 2)))
        assert engine.allocator.used_blocks == 0 and not d._pending


async def test_remote_prefill_timeout_falls_back_to_local(monkeypatch):
    monkeypatch.setenv("DYN_DISAGG_PREFILL_TIMEOUT_S", "0.5")
    monkeypatch.setenv("DYN_DISAGG_CLOCK_SKEW_S", "0")
    prompt = list(range(3, 13))
    async with Pair("torch", start_worker=False) as pair:
        got = await pair.run([prompt])
        assert got == await single("torch", [prompt])
        stats = pair.disagg.stats()
        assert (stats["remote_prefill_timeouts"], stats["local_prefills"]) == (1, 1)
        assert await pair.drained()
        # a worker that comes up after the timeout drops the stale item
        worker = PrefillWorker(pair.rt, pair.prefill, pair.queue)
        worker.start()
        try:
            for _ in range(100):
                if worker.stale_dropped:
                    break
                await asyncio.sleep(0.02)
            assert worker.stats() == {"prefills_done": 0, "stale_dropped": 1,
                                      "kv_parts_sent_total": 0}
        finally:
            await worker.stop()


@pytest.mark.parametrize("resume", ["1", "0"])
async def test_stalled_stream_requeues_or_falls_back(monkeypatch, resume):
    """The 2nd shipment of a stream dies: with DYN_RESUME the decode side
    re-enqueues the uncovered tail (no local fallback), without it the
    request degrades to a local prefill; the stream is exact either way."""
    monkeypatch.setenv("DYN_DISAGG_PREFILL_TIMEOUT_S", "1.0")
    monkeypatch.setenv("DYN_RESUME", resume)
    counters.reset()
    FAULTS.reset()
    prompt = list(range(3, 27))
    try:
        async with Pair("torch", tcp=True, prefill_kw=dict(prefill_chunk_tokens=8),
                        stream=True) as pair:
            d = pair.disagg
            FAULTS.arm("kv.transfer:nth=2")
            got = await pair.run([prompt])
            assert FAULTS.fired.get("kv.transfer") == 1
            if resume == "1":
                assert (d.remote_prefill_requeues, d.local_prefills, d.remote_prefills) == (1, 0, 1)
                assert counters.get("dyn_resume_prefill_requeues_total") == 1
                assert d.stats()["disagg_prefill_requeues_total"] == 1
            else:
                assert (d.remote_prefill_requeues, d.local_prefills,
                        d.remote_prefill_timeouts) == (0, 1, 1)
            assert pair.prefill.allocator.used_blocks == 0
    finally:
        counters.reset()
        FAULTS.reset()
    assert got == await single("torch", [prompt])


# ---------------------------------------------------------------------------
# guided JSON across the split
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def guided_parts(tmp_path_factory):
    tok = HfTokenizer.from_model_dir(REPO / "tests" / "data" / "tiny-chat-model")
    masks, strings = guided.build_for_tokenizer(tok, cache_dir=str(tmp_path_factory.mktemp("g")))
    return masks, strings, tok.eos_token_ids, tok


async def test_guided_composes_with_disagg_split(guided_parts):
    """The prefill engine masks its first sample, the decode engine's
    cursor adopts it; the stream replays admissible and equals the
    reference's."""
    masks, strings, eos, _ = guided_parts
    pre = PreprocessedRequest(token_ids=[3, 100, 200, 5], sampling=SamplingOptions(use_greedy=True),
                              stop=StopConditions(max_tokens=16), eos_token_ids=[1],
                              output_format="json")
    out = {}
    for s in ("jax", "torch"):
        prefill, decode = make_engine(s), make_engine(s)
        try:
            for e in (prefill, decode):
                e.set_guided(masks, strings, eos)
            wire_pre = mod(s, "llm.protocols.common").PreprocessedRequest.from_wire(pre.to_wire())
            first, _lp, _top, blocks, n_used = await prefill.prefill_extract(wire_pre)
            target = decode.reserve_blocks(len(pre.token_ids) + 1)
            await decode.inject_blocks(target[:n_used], blocks)
            stream = await decode.generate_prefilled(mod(s, "runtime").Context(pre.to_wire()),
                                                     target, first)
            out[s] = await collect(stream)
            out[s + "_stats"] = decode.stats()["guided_requests_total"]
        finally:
            prefill.stop()
            decode.stop()
    assert out["torch"] == out["jax"] and out["torch_stats"] == out["jax_stats"] == 1
    cursor = guided.JsonCursor(masks, strings, eos_ids=eos)
    for tid in out["torch"]:
        cursor.advance(tid)
        assert not cursor.failed, (tid, strings[tid])


@pytest.mark.parametrize("bad_first", ["close_brace", "eos"])
async def test_disagg_refusal_releases_blocks(guided_parts, bad_first):
    masks, strings, eos, tok = guided_parts
    decode = make_engine("torch")
    decode.set_guided(masks, strings, eos)
    try:
        pre = PreprocessedRequest(token_ids=[3, 100, 200, 5], sampling=SamplingOptions(use_greedy=True),
                                  stop=StopConditions(max_tokens=8), eos_token_ids=[1],
                                  output_format="json")
        token = tok.encode("}")[0] if bad_first == "close_brace" else eos[0]
        target = decode.reserve_blocks(len(pre.token_ids) + 1)
        assert decode.allocator.used_blocks > 0
        with pytest.raises(ValueError, match="guided-enabled prefill"):
            await decode.generate_prefilled(Context(pre.to_wire()), target, token)
        assert decode.allocator.used_blocks == 0
        assert decode.stats()["guided_requests_total"] == 0
    finally:
        decode.stop()


# ---------------------------------------------------------------------------
# the prefill worker in another process
# ---------------------------------------------------------------------------

PREFILL_WORKER_SCRIPT = textwrap.dedent(
    """
    import asyncio, sys

    import torch

    async def main():
        from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
        from dynamo_tpu_torch.llm.disagg import PrefillQueue, PrefillWorker
        from dynamo_tpu_torch.models.llama import LlamaConfig
        from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
        from dynamo_tpu_torch.utils.config import RuntimeConfig

        control_plane, params_path = sys.argv[1], sys.argv[2]
        engine = TorchLlmEngine(
            EngineConfig(model=LlamaConfig.tiny(), num_blocks=64, block_size=4,
                         max_batch_size=4, prefill_buckets=(16, 32), max_model_len=64),
            params=torch.load(params_path), device="cpu",
        )
        engine.start()
        rt = await DistributedRuntime.create(RuntimeConfig(control_plane=control_plane))
        worker = PrefillWorker(rt, engine, PrefillQueue(rt, "ns", "backend"))
        worker.start()
        print("PREFILL_READY", flush=True)
        await asyncio.sleep(3600)

    asyncio.run(main())
    """
)


async def test_cross_process_disagg_exactness(tmp_path):
    from dynamo_tpu_torch.runtime.controlplane.server import ControlPlaneServer

    server = ControlPlaneServer(port=0)
    await server.start()
    address = f"127.0.0.1:{server.port}"
    torch.save(PARAMS, tmp_path / "params.pt")
    script = tmp_path / "prefill_worker.py"
    script.write_text(PREFILL_WORKER_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    stderr_path = tmp_path / "prefill_worker.stderr"
    with open(stderr_path, "wb") as stderr_file:
        proc = await asyncio.create_subprocess_exec(
            sys.executable, str(script), address, str(tmp_path / "params.pt"),
            stdout=asyncio.subprocess.PIPE, stderr=stderr_file, env=env)
    rt = disagg = decode = None
    try:
        line = await asyncio.wait_for(proc.stdout.readline(), 45)
        assert b"PREFILL_READY" in line, stderr_path.read_text()[-3000:]
        decode = make_engine("torch")
        rt = await DistributedRuntime.create(RuntimeConfig(control_plane=address))
        router = DisaggRouter(rt, "tiny", DisaggConfig(max_local_prefill_length=4))
        disagg = DisaggDecodeEngine(rt, decode, router, PrefillQueue(rt, "ns", "backend"))
        await disagg.start()
        prompt = list(range(3, 13))
        tokens, lps, _ = await collect(
            await disagg.generate(Context(request(prompt, top_logprobs=2))), detail=True)
        assert tokens == (await single("torch", [prompt]))[0]
        assert disagg.remote_prefills == 1 and len(lps) == len(tokens)
        for _ in range(100):
            if decode.allocator.used_blocks == 0:
                break
            await asyncio.sleep(0.02)
        assert decode.allocator.used_blocks == 0
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
        if disagg is not None:
            await disagg.stop()
        if decode is not None:
            decode.stop()
        if rt is not None:
            await rt.close()
        await server.stop()


def test_disagg_bench_runs_on_the_cpu(capsys):
    """The port's disagg bench (tiny, CPU): every measured prefill remote,
    the streamed mode ships more parts and hides transfer time, the fleet
    section prefers the near worker over a discovered dcn link."""
    from dynamo_tpu_torch.bench import disagg_bench

    assert disagg_bench.main(["--device", "cpu"]) == 0
    result = __import__("json").loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["disagg"]["all_prefills_remote"] is True
    ab = result["streamed_ab"]
    assert ab["streamed"]["kv_parts"] > ab["single_shot"]["kv_parts"] == result["num_requests"]
    assert ab["streamed"]["transfer_hidden_fraction"] > 0
    assert result["fleet"]["topology_discovered"] and result["fleet"]["preferred_is_near"]
    assert result["extract_calls"] == result["inject_calls"] > 0
