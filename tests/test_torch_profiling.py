"""Device traces of the port (dynamo_tpu_torch/utils/profiling.py) and their
summary (bench/trace_summary.py): DYN_PROFILER_TRACE_DIR makes
TorchLlmEngine.start() open a torch.profiler trace that stop() writes, as the
reference's engine does with jax.profiler, without changing a stream; the
engine's annotations land in it; the summary's sums on a trace of known
intervals."""

import asyncio

import jax
import numpy as np
import pytest

from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu_torch.bench import trace_summary
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models.llama import LlamaConfig, params_from_jax
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.utils import profiling

PARAMS = params_from_jax(
    jax.tree.map(np.asarray, jax_llama.init_params(jax_llama.LlamaConfig.tiny(),
                                                   jax.random.PRNGKey(1))), device="cpu")


async def run_engine(unified: bool) -> tuple[list[list[int]], TorchLlmEngine]:
    engine = TorchLlmEngine(EngineConfig(
        model=LlamaConfig.tiny(), num_blocks=32, block_size=4, max_batch_size=2,
        prefill_buckets=(16,), max_model_len=64, unified_batch=unified,
        prefill_chunk_tokens=8), params=PARAMS, device="cpu")
    engine.start()
    try:
        async def one(tokens):
            req = PreprocessedRequest(token_ids=tokens, sampling=SamplingOptions(use_greedy=True),
                                      stop=StopConditions(max_tokens=6, ignore_eos=True))
            out = []
            async for item in await engine.generate(Context(req.to_wire())):
                ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
                if ann.data is not None:
                    out.extend(ann.data.token_ids)
            return out

        streams = await asyncio.gather(one(list(range(3, 15))), one([7, 8, 9]))
    finally:
        engine.stop()
    return streams, engine


@pytest.mark.parametrize("unified", [True, False], ids=["unified", "split"])
async def test_trace_dir_env_writes_the_serve_window_at_stop(tmp_path, monkeypatch, unified):
    plain, _ = await run_engine(unified)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("DYN_PROFILER_TRACE_DIR", str(trace_dir))
    traced, engine = await run_engine(unified)
    assert traced == plain  # the trace changes no token
    assert engine._profiler_trace_dir is None  # stop() released it
    traces = list(trace_dir.glob("trace_*.json.gz"))
    assert len(traces) == 1
    names = {e.get("name") for e in trace_summary.load_events(trace_dir)
             if e.get("cat") == "user_annotation"}
    want = {"unified_window"} if unified else {"split_prefill", "split_prefill_attention"}
    assert want <= names
    assert not profiling._active  # annotate is a no-op again


async def test_one_engine_owns_the_env_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("DYN_PROFILER_TRACE_DIR", str(tmp_path))
    cfg = EngineConfig(model=LlamaConfig.tiny(), num_blocks=16, block_size=4,
                       max_batch_size=2, max_model_len=32)
    first = TorchLlmEngine(cfg, params=PARAMS, device="cpu")
    second = TorchLlmEngine(cfg, params=PARAMS, device="cpu")
    first.start()
    second.start()
    try:
        assert first._profiler_trace_dir == str(tmp_path)
        assert second._profiler_trace_dir is None
    finally:
        second.stop()
        first.stop()
    assert len(list(tmp_path.glob("trace_*.json.gz"))) == 1


def test_trace_context_and_annotate(tmp_path):
    assert isinstance(profiling.annotate("x"), type(profiling.annotate("y")))
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("bench.burst"):
            np.ones(4).sum()
    events = trace_summary.load_events(tmp_path)
    assert any(e.get("name") == "bench.burst" for e in events)
    assert not profiling._active


def _x(cat, name, ts, dur, pid=1, tid=1, corr=None):
    event = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}
    if corr is not None:
        event["args"] = {"correlation": corr}
    return event


def test_summary_sums_a_known_trace():
    events = [
        _x("user_annotation", "bench.burst", 0, 1000, tid=9),
        _x("user_annotation", "split_prefill", 10, 300),
        _x("user_annotation", "split_prefill_attention", 50, 100),
        _x("user_annotation", "unified_window", 500, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 5, corr=1),    # in attention
        _x("cuda_runtime", "cudaLaunchKernel", 200, 5, corr=2),   # in split_prefill only
        _x("cuda_runtime", "cudaGraphLaunch", 505, 5, corr=3),    # in unified_window
        _x("cuda_runtime", "cudaLaunchKernel", 700, 5, corr=4),   # in no engine range
        _x("kernel", "attn_gemm", 100, 200, pid=0, tid=7, corr=1),
        _x("kernel", "proj_gemm", 250, 100, pid=0, tid=7, corr=2),  # overlaps the first
        _x("kernel", "ragged_tc_kernel", 520, 40, pid=0, tid=7, corr=3),
        _x("kernel", "ragged_tc_kernel", 560, 60, pid=0, tid=7, corr=3),
        _x("gpu_memcpy", "Memcpy HtoD", 800, 100, pid=0, tid=8),
        _x("kernel", "after_window", 1500, 10, pid=0, tid=7, corr=4),
    ]
    out = trace_summary.summarize(events, match=["ragged"])
    assert out["window_ms"] == 1.0
    # device busy: [100, 350) + [520, 620) + [800, 900) = 450 us
    assert out["device_busy_ms"] == 0.45
    assert out["device_idle_share"] == 0.55
    assert out["kernel_launches"] == 4
    assert out["kernels_top"][0] == {"name": "attn_gemm", "ms": 0.2, "launches": 1}
    assert out["matches"] == {"ragged": {"ms": 0.1, "launches": 2}}
    assert out["annotations"] == {
        "split_prefill": {"ranges": 1, "device_ms": 0.3, "device_ms_per_range": 0.3},
        "split_prefill_attention": {"ranges": 1, "device_ms": 0.2,
                                    "device_ms_per_range": 0.2},
        "unified_window": {"ranges": 1, "device_ms": 0.1, "device_ms_per_range": 0.1},
    }
    with pytest.raises(ValueError, match="no 'bench.prefix' annotation"):
        trace_summary.summarize(events, window="bench.prefix")
