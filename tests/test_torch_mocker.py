"""The port's mocker (``llm/mocker.py``) against the reference's: the same
requests and config give the same token streams, KV events and load
stats; pool exhaustion preempts without killing the loop (the counterpart
of tests/llm/test_mocker_preemption.py); ``apply_resume``'s continuation
route gives the stream a replay would, behind its ack.

Requests are drawn from a numpy seed and queued before either engine's loop
starts, so both schedule the same batches in the same order."""

import asyncio
import dataclasses

import numpy as np
import pytest

from dynamo_tpu.llm import mocker as ref_mocker
from dynamo_tpu.llm.protocols import common as ref_common
from dynamo_tpu.runtime import engine as ref_engine
from dynamo_tpu_torch.llm import mocker
from dynamo_tpu_torch.llm.protocols import common
from dynamo_tpu_torch.runtime import engine as rt_engine
from dynamo_tpu_torch.runtime.resume import RESUME_ACK_EVENT

SIDES = {
    "port": (mocker, common, rt_engine),
    "ref": (ref_mocker, ref_common, ref_engine),
}
# stats that depend on the wall clock, not on the schedule: the rolling
# rates, and the flight ring's bytes (its records hold timestamps and rates)
CLOCKED = {"goodput_tokens_per_second", "prefill_tokens_per_second", "mfu_perc",
           "flight_buffer_bytes"}


def draw_requests(seed: int, n: int) -> list[tuple[list[int], int]]:
    """Prompts that share prefixes (so prefix hits happen) and output
    lengths, from a numpy seed."""
    rng = np.random.default_rng(seed)
    roots = [rng.integers(0, 1000, int(rng.integers(16, 80))).tolist() for _ in range(3)]
    out = []
    for _ in range(n):
        prompt = list(roots[int(rng.integers(0, 3))])
        prompt += rng.integers(0, 1000, int(rng.integers(1, 40))).tolist()
        out.append((prompt, int(rng.integers(1, 40))))
    return out


async def collect(stream, common_mod) -> list:
    items = []
    async for item in stream:
        ann = common_mod.Annotated.from_wire(item, common_mod.LLMEngineOutput.from_wire)
        if ann.data is None:
            items.append(("annotation", ann.event))
        else:
            items.append((list(ann.data.token_ids),
                          None if ann.data.finish_reason is None else str(ann.data.finish_reason)))
    return items


async def run_side(side: str, requests, config: dict, wires=None):
    mod, common_mod, engine_mod = SIDES[side]
    events = []
    engine = mod.MockerEngine(mod.MockerConfig(**config), event_sink=events.append)
    streams = []
    for i, (prompt, osl) in enumerate(requests):
        wire = common_mod.PreprocessedRequest(
            token_ids=prompt, sampling=common_mod.SamplingOptions(use_greedy=True),
            stop=common_mod.StopConditions(max_tokens=osl, ignore_eos=True),
        ).to_wire()
        if wires is not None:
            wire = wires(i, wire)
        streams.append(await engine.generate(engine_mod.Context(wire, engine_mod.EngineContext(f"r{i}"))))
    engine.start()  # every request queued: both sides schedule the same batches
    try:
        outs = await asyncio.wait_for(
            asyncio.gather(*(collect(s, common_mod) for s in streams)), timeout=60)
    finally:
        engine.stop()
    return outs, [dataclasses.asdict(e) for e in events], engine.stats(), engine


@pytest.mark.parametrize("seed", range(3))
async def test_streams_events_and_stats_equal_the_reference(seed):
    requests = draw_requests(seed, 12)
    config = dict(num_blocks=64, block_size=16, max_batch_size=4, speedup=5000.0)
    ours = await run_side("port", requests, config)
    ref = await run_side("ref", requests, config)
    assert ours[0] == ref[0]
    for (prompt, osl), items in zip(requests, ours[0]):
        tokens = [t for toks, _ in items for t in toks]
        assert tokens == [(prompt[-1] + 1 + i) % 1000 for i in range(osl)]
        assert items[-1][1] is not None
    assert ours[1] == ref[1]
    assert {e["kind"] for e in ours[1]} >= {"stored"}
    assert ours[2].keys() == ref[2].keys()
    assert {k: v for k, v in ours[2].items() if k not in CLOCKED} == \
        {k: v for k, v in ref[2].items() if k not in CLOCKED}
    assert ours[3].allocator.prefix_hits_total == ref[3].allocator.prefix_hits_total > 0


async def test_pool_exhaustion_preempts_without_killing_the_loop():
    # 6 blocks * 16 = 96 token slots; two 20+60 requests need 5 blocks each,
    # so decode must exhaust the pool and preempt the younger sequence while
    # both are in the same decode snapshot.
    prompts = [list(range(100, 120)), list(range(200, 220))]
    osl = 60
    config = dict(num_blocks=6, block_size=16, max_batch_size=4, speedup=2000.0)
    ours = await run_side("port", [(p, osl) for p in prompts], config)
    ref = await run_side("ref", [(p, osl) for p in prompts], config)
    assert ours[3].scheduler.preemptions_total >= 1, "scenario never preempted"
    assert ours[3].scheduler.preemptions_total == ref[3].scheduler.preemptions_total
    # the loop survived and recompute kept the exact greedy chain
    for prompt, items in zip(prompts, ours[0]):
        assert [t for toks, _ in items for t in toks] == \
            [(prompt[-1] + 1 + i) % 1000 for i in range(osl)]
    assert ours[0] == ref[0] and ours[1] == ref[1]
    assert ours[3]._task is None  # stopped cleanly, not crashed


async def test_continuation_resume_gives_the_replay_stream():
    """A ``resume_from`` request continues after its accepted tokens: the
    first item is the resume ack, the rest the tail a plain run gives."""
    requests = draw_requests(7, 4)
    config = dict(num_blocks=64, block_size=16, max_batch_size=4, speedup=5000.0)
    plain = await run_side("port", requests, config)
    accepted = {}

    def resume(i, wire):
        toks = [t for ts, _ in plain[0][i] for t in ts]
        accepted[i] = toks[: len(toks) // 2]
        return dict(wire, resume_from={"v": 1, "prompt_hash": "", "accepted": accepted[i],
                                       "sampling": {}})

    ours = await run_side("port", requests, config, wires=resume)
    ref = await run_side("ref", requests, config, wires=resume)
    assert ours[0] == ref[0]
    for i, items in enumerate(ours[0]):
        head, rest = items[0], items[1:]
        tail = [t for toks, _ in plain[0][i] for t in toks][len(accepted[i]):]
        if accepted[i]:
            assert head == ("annotation", RESUME_ACK_EVENT)
        else:
            rest = items
        assert [t for toks, _ in rest for t in toks] == tail
