"""The port's engine accounting (dynamo_tpu_torch/observability) against
the reference's (dynamo_tpu/observability), on the CPU:

- ``model_cost``: every field equal for the tiny Llama, the Llama-3-8B
  geometry, tiny_mla and DeepSeek-V2-Lite, under bf16, fp8 and float32
  caches and int8 weights.  The reference's count duck-types GQA fields, so
  for DeepSeek it counts KV bytes as 2 L H (hidden / H) a position, about
  seven times the latent cache's L (kv_lora_rank + rope) at V2-Lite widths:
  the port copies that count (its MFU is the reference's), and the fence
  below fails the day either side changes it;
- the peak table (an H100 row matched on the CUDA device's name, the PCIe
  part first) and the DYN_PEAK_* / DYN_UTIL_WINDOW_S overrides;
- ``UtilizationTracker`` and ``StepTelemetry`` on the same step stream give
  the reference's rates, totals and snapshot;
- after the same requests, ``TorchLlmEngine``'s token, FLOP and byte totals
  equal ``JaxLlmEngine``'s (decode overlap off and on, unified and split
  steps, fused decode_steps, an fp8 cache with int8 weights)."""

import asyncio
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import deepseek as jax_ds
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.observability import perf as jax_perf
from dynamo_tpu.observability.step_metrics import StepTelemetry as JaxStepTelemetry
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.models import deepseek, llama
from dynamo_tpu_torch.observability import perf
from dynamo_tpu_torch.observability.step_metrics import StepTelemetry
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import BASE, CFG, JCFG, JPARAMS, PARAMS, collect, request

CONFIGS = {
    "llama_tiny": (llama.LlamaConfig.tiny(), jax_llama.LlamaConfig.tiny()),
    "llama3_8b": (llama.LlamaConfig.llama3_8b(), jax_llama.LlamaConfig.llama3_8b()),
    "tiny_mla": (deepseek.DeepseekConfig.tiny_mla(), jax_ds.DeepseekConfig.tiny_mla()),
    "deepseek_v2_lite": (deepseek.DeepseekConfig.deepseek_v2_lite(),
                         jax_ds.DeepseekConfig.deepseek_v2_lite()),
}
# (the port's kv_cache_dtype, the reference's): names, and dtype objects
CACHES = {
    "model": (None, None),
    "fp8": ("fp8", "fp8"),
    "bf16": ("bf16", "bf16"),
    "f32_dtype": (torch.float32, jnp.float32),
    "fp8_dtype": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
    "f16_dtype": (torch.float16, jnp.float16),
}


@pytest.mark.parametrize("cache", sorted(CACHES))
@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("model", sorted(CONFIGS))
def test_model_cost_fields_equal_the_reference(model, quantize, cache):
    ours_cfg, ref_cfg = CONFIGS[model]
    ours_kv, ref_kv = CACHES[cache]
    ours = perf.model_cost(ours_cfg, quantize=quantize, kv_cache_dtype=ours_kv)
    ref = jax_perf.model_cost(ref_cfg, quantize=quantize, kv_cache_dtype=ref_kv)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.flops(7, 123) == ref.flops(7, 123)
    assert ours.bytes_moved(7, 123, 2.0) == ref.bytes_moved(7, 123, 2.0)


def test_deepseek_cost_keeps_the_reference_gqa_count():
    """The reference's miscount on DeepSeek, fenced: KV bytes as GQA heads
    of hidden / H (no num_kv_heads, no head_dim on the config), not the
    latent; every layer's MLP as routed experts (first_k_dense and the
    shared experts ignored); the MLA projections as a GQA attention's."""
    cfg = deepseek.DeepseekConfig.deepseek_v2_lite()
    cost = perf.model_cost(cfg, kv_cache_dtype="bf16")
    layers, heads, hidden = cfg.num_layers, cfg.num_heads, cfg.hidden_size
    head_dim = hidden // heads
    assert cost.kv_bytes_per_token == 2 * layers * heads * head_dim * 2
    latent = layers * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
    assert 7.0 < cost.kv_bytes_per_token / latent < 7.2
    experts = cfg.num_experts * 3 * hidden * cfg.moe_intermediate_size + hidden * cfg.num_experts
    attn = 4 * hidden * heads * head_dim
    embed = cfg.vocab_size * hidden * (1 if cfg.tie_word_embeddings else 2)
    assert cost.param_count == embed + layers * (attn + experts)


def test_peak_table_and_env_overrides(monkeypatch):
    for name in ("DYN_PEAK_TFLOPS", "DYN_PEAK_GBPS", "DYN_UTIL_WINDOW_S"):
        monkeypatch.delenv(name, raising=False)
    assert perf.detect_peaks("cpu") == (0.5e12, 50e9)
    assert perf.detect_peaks() == (0.5e12, 50e9)
    names = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
             "NVIDIA H100 PCIe": (756e12, 2.0e12),
             "Some Other Card": (0.5e12, 50e9)}
    for name, want in names.items():
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None, n=name: n)
        assert perf.detect_peaks("cuda:0") == want
    assert [row[0] for row in perf.NOMINAL_PEAKS][:2] == ["h100 pcie", "h100"]
    # no H100 row in the reference's table: the port keeps its own
    assert not any("h100" in row[0] for row in jax_perf.NOMINAL_PEAKS)
    monkeypatch.setenv("DYN_PEAK_TFLOPS", "100")
    monkeypatch.setenv("DYN_PEAK_GBPS", "not a number")
    assert perf.detect_peaks("cuda:0") == (100e12, 50e9)
    monkeypatch.setenv("DYN_PEAK_GBPS", "2000")
    assert perf.detect_peaks("cuda:0") == (100e12, 2000e9)
    monkeypatch.setenv("DYN_UTIL_WINDOW_S", "3.5")
    tracker = perf.UtilizationTracker(perf.model_cost(CONFIGS["llama_tiny"][0]))
    assert tracker.window_s == 3.5 and tracker.peak_flops == 100e12
    monkeypatch.delenv("DYN_UTIL_WINDOW_S")
    assert perf.UtilizationTracker(tracker.cost).window_s == 10.0


def test_tracker_and_step_telemetry_equal_the_reference_on_one_step_stream(monkeypatch):
    monkeypatch.delenv("DYN_UTIL_WINDOW_S", raising=False)
    ours_cfg, ref_cfg = CONFIGS["llama3_8b"]
    kw = dict(peak_flops=989e12, peak_bytes_per_s=3.35e12, window_s=5.0)
    ours = perf.UtilizationTracker(perf.model_cost(ours_cfg, kv_cache_dtype="fp8"), **kw)
    ref = jax_perf.UtilizationTracker(jax_perf.model_cost(ref_cfg, kv_cache_dtype="fp8"), **kw)
    steps = [dict(duration_s=0.011 * (i % 3 + 1), prefill_tokens=(i % 4 == 0) * 37,
                  decode_tokens=i % 8, attn_ctx_tokens=300 * i, weight_streams=float(i % 2),
                  emitted_tokens=i % 5, now=100.0 + 0.7 * i) for i in range(20)]
    for s in steps:
        ours.observe_step(**s)
        ref.observe_step(**s)
    assert ours.rates(now=114.0) == ref.rates(now=114.0)
    assert ours.rates(now=500.0) == ref.rates(now=500.0)  # an empty window
    a, b = ours.stats(), ref.stats()
    assert a.keys() == b.keys()
    for key in a:
        if key.endswith("total") or key.endswith("total_s"):
            assert a[key] == b[key], key
    telem, ref_telem = StepTelemetry(8), JaxStepTelemetry(8)
    for i in range(5):
        fact = dict(iteration=i, num_running=i % 3, num_waiting=i, kv_active_blocks=10 * i,
                    kv_total_blocks=64, step_duration_s=0.01 * i, prefill_tokens=i,
                    decode_tokens=2 * i)
        telem.observe_step(**fact)
        ref_telem.observe_step(**fact)
    assert telem.stats() == ref_telem.stats()


# the token, FLOP and byte totals (the step counts are not among them: an
# engine thread may loop once more, idle, before it is stopped)
ACCOUNTING = ("prefill_tokens_total", "decode_tokens_total", "tokens_emitted_total",
              "model_flops_total", "model_bytes_total")


async def serve(engine, ctx_cls, reqs):
    tasks = [asyncio.ensure_future(collect(engine, r, ctx_cls)) for r in reqs]
    await asyncio.sleep(0.05)
    engine.start()
    try:
        return await asyncio.gather(*tasks)
    finally:
        engine.stop()


@pytest.mark.parametrize("mode", [
    dict(decode_overlap=False),
    dict(decode_overlap=True, prefill_chunk_tokens=8),
    dict(decode_overlap=True, decode_steps=3),
    dict(decode_overlap=True, kv_cache_dtype="fp8", quantize="int8"),
], ids=["sync", "overlap_chunked", "fused_steps", "fp8_int8"])
async def test_engine_totals_equal_the_reference_after_the_same_requests(mode):
    reqs = [request(range(3 + i, 12 + 5 * i), max_tokens=7, ignore_eos=True)
            for i in range(3)]
    conf = {**BASE, **mode}
    ref_engine = JaxLlmEngine(JaxEngineConfig(model=JCFG, unified_batch=True, **conf),
                              params=JPARAMS)
    ours_engine = TorchLlmEngine(EngineConfig(model=CFG, **conf), params=PARAMS, device="cpu")
    ref_out = await serve(ref_engine, JaxContext, reqs)
    ours_out = await serve(ours_engine, Context, reqs)
    assert ours_out == ref_out
    ours, ref = ours_engine.stats(), ref_engine.stats()
    for key in ACCOUNTING:
        assert ours[key] == ref[key], (key, ours[key], ref[key])
    assert ours["tokens_emitted_total"] == sum(len(tokens) for tokens, _ in ours_out)
    assert ours["prefill_tokens_total"] >= sum(len(range(3 + i, 12 + 5 * i)) for i in range(3))
    assert 0.0 <= ours["mfu_perc"] <= 1.0 and 0.0 <= ours["bandwidth_util_perc"] <= 1.0
    assert ours["busy_time_total_s"] > 0
    for key in ("batch_occupancy_perc", "step_kv_usage_perc", "last_step_duration_s"):
        assert key in ours
