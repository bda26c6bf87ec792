"""The mesh engine's lifecycle on the CPU, and the mesh dryrun: a tp = 2
engine (rank 0 here, its shard worker a child process) serves guided JSON,
a multimodal request and disaggregation's reserve, extract and inject,
reads every rank's launch counters, and leaves no child process at
``stop()``; a
killed shard worker makes rank 0 fail its requests within the timeout;
``dryrun_multichip(4)`` (the counterpart of the reference's dryrun) runs its
prefill, its sampled decode and its int8 check on four ranks."""

import asyncio
import os
import signal
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest, StopConditions
from dynamo_tpu_torch.parallel.dryrun import dryrun_multichip
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_engine import collect, request
from tests.test_torch_tp import CFG, ENGINE


def test_dryrun_multichip_runs():
    """The counterpart of the reference's dryrun on four ranks: dp=1 x
    tp=4, one prefill, one sampled decode, int8 within 0.1; the ring
    prefill over sp = 4 within 2e-3 of it, the pp = 2 x tp = 2 decode within
    a relative 2e-3 of one rank's, and the pp = 2 x ep = 2 Mixtral drive's
    tokens equal to one rank's."""
    out = dryrun_multichip(4, device="cpu")
    assert (out["dp"], out["tp"]) == (1, 4)
    assert out["prefill_shape"] == [512] and len(out["tokens"]) == 4
    assert out["int8_rel_err"] < 0.1
    assert out["sp"] == 4 and out["sp_prefill_max_abs_diff"] <= 2e-3
    assert out["pp_tp"] == [2, 2] and out["pp_rel_err"] <= 2e-3
    assert out["pp_mixtral"] == {"pp": 2, "ep": 2, "steps": 16, "tokens_equal": True}


def _children() -> list[str]:
    """This process's live child processes that are shard workers."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            stat = Path(f"/proc/{pid}/stat").read_text()
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ").decode()
        except OSError:
            continue
        fields = stat.rsplit(")", 1)[1].split()
        if int(fields[1]) == os.getpid() and fields[0] != "Z" and "shard_worker" in cmd:
            out.append(cmd)
    return out


def test_mesh_engine_refuses_later_items_and_stops_its_workers():
    """The calls a mesh engine once refused serve on it: the
    guided table installs, a multimodal request streams, disaggregation
    reserves, extracts whole blocks and injects them; every rank's counters
    read, and ``stop()`` leaves no child process."""
    engine = TorchLlmEngine(EngineConfig(model=CFG, mesh=MeshConfig(tp=2), **ENGINE),
                            device="cpu")
    try:
        assert len(_children()) == 1
        engine.set_guided(SimpleNamespace(mask=np.ones(tuple(engine._guided_table.shape), bool)),
                          [""] * CFG.vocab_size, [1])
        assert engine.guided_masks is not None
        engine.start()

        async def drive():
            pre = PreprocessedRequest(token_ids=[5, 6, 7], stop=StopConditions(max_tokens=3))
            stream = await engine.generate_multimodal(Context(pre.to_wire()),
                                                      np.zeros((4, 64), np.float32))
            items = [item async for item in stream]
            ids = engine.reserve_blocks(8)
            first, _, _, blocks, n = await engine.prefill_extract(
                PreprocessedRequest(token_ids=list(range(3, 11))))
            await engine.inject_blocks(ids[:n], blocks)
            engine.release_blocks(ids)
            return items, first, blocks, n

        items, first, blocks, n = asyncio.run(drive())
        assert items and 0 <= first < CFG.vocab_size
        assert blocks["k"].shape == (CFG.num_layers, n, ENGINE["block_size"], CFG.num_kv_heads,
                                     CFG.head_dim)
        counts = engine.mesh_counts()
        assert len(counts) == 2 and "paged_attention.plain_calls" in counts[1]
        assert all(c["block_copy.plain_calls"] >= 4 for c in counts)
    finally:
        procs = list(engine._mesh_leader.procs)
        engine.stop()
    assert [p.returncode for p in procs] == [0]
    assert _children() == []


def test_killed_rank_fails_rank_zero_within_the_timeout(monkeypatch):
    monkeypatch.setenv("DYN_MESH_TIMEOUT_S", "20")
    engine = TorchLlmEngine(EngineConfig(model=CFG, mesh=MeshConfig(tp=2), **ENGINE),
                            device="cpu")
    procs = list(engine._mesh_leader.procs)

    async def run():
        engine.start()
        tokens, finish = await collect(engine, request(range(10, 20), 4), Context)
        assert finish == "length" and len(tokens) == 4
        os.kill(procs[0].pid, signal.SIGKILL)
        procs[0].wait()
        t0 = time.monotonic()
        tokens, finish = await asyncio.wait_for(
            collect(engine, request(range(30, 40), 4), Context), timeout=30)
        return finish, time.monotonic() - t0

    try:
        finish, waited = asyncio.run(run())
        assert finish == "error" and waited < 25
        assert engine._mesh_leader.broken is not None
    finally:
        engine.stop()
    assert _children() == []
