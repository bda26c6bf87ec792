"""Utilization accounting: the analytical FLOPs/bytes cost model and the
rolling MFU tracker (a copy of dynamo_tpu/observability/perf.py with the
port's own peak table).

- :func:`model_cost` derives a :class:`ModelCost` (parameter count, weight
  bytes streamed a forward, linear FLOPs a token, attention FLOPs an
  attended context position, KV-cache bytes a token) from a family config
  by duck-typing the common geometry fields, exactly as the reference does.
  MoE families count ACTIVE expert FLOPs and TOTAL expert bytes.  Other
  attention geometries (MLA) take the GQA approximation: for DeepSeek the
  reference's count ignores ``first_k_dense``, the shared experts and the
  MLA projections, and counts KV bytes as ``2 * L * H * head_dim`` (the
  config has no ``head_dim``: ``hidden // heads``), not ``L *
  (kv_lora_rank + qk_rope_head_dim)``; the port keeps that count, so its
  MFU is the reference's.
- :class:`UtilizationTracker` turns the engine's per-step facts (prefill and
  decode tokens, attended context positions, weight streams, emitted
  tokens, step wall time) into rolling-window MFU, bandwidth utilization and
  goodput, plus cumulative totals.

Peaks come from ``DYN_PEAK_TFLOPS`` / ``DYN_PEAK_GBPS`` when set, else the
port's table matched on the CUDA device's name (NVIDIA's data sheets: dense
bf16 tensor-core FLOP/s, HBM bytes/s), else a conservative CPU row.
``DYN_UTIL_WINDOW_S`` (default 10 s) bounds the rolling window.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from dynamo_tpu_torch.utils import knobs

# (bf16 dense peak FLOP/s, HBM bytes/s) per device, matched as a lowercase
# substring of torch.cuda.get_device_name(); the first hit wins
NOMINAL_PEAKS: tuple[tuple[str, float, float], ...] = (
    ("h100 pcie", 756e12, 2.0e12),
    ("h100", 989e12, 3.35e12),
    ("cpu", 0.5e12, 50e9),
)
_FALLBACK_PEAKS = (0.5e12, 50e9)

_DTYPE_BYTES = {
    "float8_e4m3fn": 1, "float8_e5m2": 1, "fp8": 1, "float8": 1,
    "int8": 1, "bfloat16": 2, "bf16": 2, "float16": 2, "f16": 2,
    "float32": 4, "f32": 4, "float64": 8,
}


def _dtype_bytes(dtype: object, default: int = 2) -> int:
    """Bytes an element of ``dtype``: a name, a torch dtype (``torch.bfloat16``
    is named ``bfloat16`` here), or anything numpy can read."""
    if dtype is None:
        return default
    if isinstance(dtype, str):
        return _DTYPE_BYTES.get(dtype, default)
    name = getattr(dtype, "__name__", None) or getattr(dtype, "name", None)
    if name is None and str(dtype).startswith("torch."):
        name = str(dtype).removeprefix("torch.")
    if name is not None:
        return _DTYPE_BYTES.get(str(name), default)
    try:
        import numpy as np

        return int(np.dtype(dtype).itemsize)
    except Exception:  # noqa: BLE001
        return default


@dataclass(frozen=True)
class ModelCost:
    """Analytical per-token cost of one model geometry."""

    param_count: int                # resident weight parameters
    weight_bytes: int               # bytes to stream ALL weights once
    linear_flops_per_token: int     # matmul FLOPs per token (2·active params)
    attn_flops_per_ctx_token: int   # QK^T + AV FLOPs per attended ctx token
    kv_bytes_per_token: int         # KV cache bytes written per new token

    def flops(self, tokens: int, attn_ctx_tokens: int) -> float:
        """FLOPs to compute ``tokens`` new positions that together attended
        ``attn_ctx_tokens`` context positions."""
        return (
            tokens * self.linear_flops_per_token
            + attn_ctx_tokens * self.attn_flops_per_ctx_token
        )

    def bytes_moved(
        self, tokens: int, attn_ctx_tokens: int, weight_streams: float
    ) -> float:
        """HBM bytes: weights streamed ``weight_streams`` times, KV written
        per new token, KV read per attended context token."""
        return (
            weight_streams * self.weight_bytes
            + tokens * self.kv_bytes_per_token
            + attn_ctx_tokens * self.kv_bytes_per_token
        )


def model_cost(
    model, *, quantize: str | None = None, kv_cache_dtype: object = None
) -> ModelCost:
    """A :class:`ModelCost` from a family config by duck-typing the shared
    geometry fields, the reference's count field for field.  Never raises:
    absent fields fall back to conservative defaults."""
    h = int(getattr(model, "hidden_size", 0) or 1)
    layers = int(getattr(model, "num_layers", 0) or 1)
    heads = int(getattr(model, "num_heads", 0) or 1)
    head_dim = int(getattr(model, "head_dim", 0) or max(h // heads, 1))
    kv_heads = int(getattr(model, "num_kv_heads", 0) or heads)
    inter = int(getattr(model, "intermediate_size", 0) or 4 * h)
    vocab = int(getattr(model, "vocab_size", 0) or 1)
    tied = bool(getattr(model, "tie_word_embeddings", False))

    attn_params = h * heads * head_dim + 2 * h * kv_heads * head_dim + heads * head_dim * h

    num_experts = int(getattr(model, "num_experts", 0) or 0)
    if num_experts > 1:
        expert_inter = int(
            getattr(model, "expert_intermediate_size", 0)
            or getattr(model, "moe_intermediate_size", 0)
            or inter
        )
        active_experts = int(
            getattr(model, "experts_per_token", 0)
            or getattr(model, "num_experts_per_tok", 0)
            or 2
        )
        mlp_params_total = num_experts * 3 * h * expert_inter + h * num_experts
        mlp_params_active = active_experts * 3 * h * expert_inter + h * num_experts
    else:
        mlp_params_total = mlp_params_active = 3 * h * inter

    embed = vocab * h
    head_params = 0 if tied else vocab * h
    param_count = embed + head_params + layers * (attn_params + mlp_params_total)
    # active matmul params a token: the embedding lookup is a gather, the
    # unembedding projection always runs
    active_params = vocab * h + layers * (attn_params + mlp_params_active)

    weight_dtype_bytes = _dtype_bytes(getattr(model, "dtype", None))
    if quantize == "int8":
        weight_dtype_bytes = 1

    kv_dtype_bytes = _dtype_bytes(kv_cache_dtype, default=weight_dtype_bytes)

    return ModelCost(
        param_count=param_count,
        weight_bytes=param_count * weight_dtype_bytes,
        linear_flops_per_token=2 * active_params,
        # per attended context position per layer: 2·heads·head_dim for
        # QK^T plus the same for attention·V
        attn_flops_per_ctx_token=4 * layers * heads * head_dim,
        kv_bytes_per_token=2 * layers * kv_heads * head_dim * kv_dtype_bytes,
    )


def detect_peaks(device=None) -> tuple[float, float]:
    """(peak FLOP/s, peak bytes/s) of ``device`` (a CUDA device's name in the
    table, the CPU row otherwise): env override, then the table, then the
    conservative fallback."""
    env_tflops = knobs.get("DYN_PEAK_TFLOPS")
    env_gbps = knobs.get("DYN_PEAK_GBPS")
    kind = "cpu"
    if not (env_tflops and env_gbps):
        try:
            import torch

            dev = torch.device(device) if device is not None else None
            if dev is not None and dev.type == "cuda":
                kind = torch.cuda.get_device_name(dev).lower()
        except Exception:  # noqa: BLE001
            kind = ""
    flops, gbps = _FALLBACK_PEAKS
    for needle, f, b in NOMINAL_PEAKS:
        if needle in kind:
            flops, gbps = f, b
            break
    if env_tflops:
        flops = env_tflops * 1e12
    if env_gbps:
        gbps = env_gbps * 1e9
    return flops, gbps


@dataclass
class _Sample:
    t: float
    duration_s: float
    flops: float
    bytes_moved: float
    emitted_tokens: int
    prefill_tokens: int
    decode_tokens: int


class UtilizationTracker:
    """Rolling MFU / bandwidth utilization / goodput over the engine's step
    stream.  The device thread writes once a scheduler iteration; ``stats()``
    readers share a lock with it.  ``window_s`` (``DYN_UTIL_WINDOW_S``)
    bounds staleness and memory."""

    def __init__(
        self,
        cost: ModelCost,
        *,
        peak_flops: float | None = None,
        peak_bytes_per_s: float | None = None,
        window_s: float | None = None,
        device=None,
    ):
        self.cost = cost
        if peak_flops is None or peak_bytes_per_s is None:
            detected_f, detected_b = detect_peaks(device)
            peak_flops = peak_flops if peak_flops is not None else detected_f
            peak_bytes_per_s = (
                peak_bytes_per_s if peak_bytes_per_s is not None else detected_b
            )
        self.peak_flops = max(float(peak_flops), 1.0)
        self.peak_bytes_per_s = max(float(peak_bytes_per_s), 1.0)
        if window_s is None:
            window_s = knobs.get("DYN_UTIL_WINDOW_S")
        self.window_s = max(window_s, 0.1)
        self._samples: deque[_Sample] = deque()
        self._lock = threading.Lock()
        # cumulative totals (monotone)
        self.prefill_tokens_total = 0
        self.decode_tokens_total = 0
        self.emitted_tokens_total = 0
        self.flops_total = 0.0
        self.bytes_total = 0.0
        self.busy_time_total_s = 0.0

    def observe_step(
        self,
        *,
        duration_s: float,
        prefill_tokens: int = 0,
        decode_tokens: int = 0,
        attn_ctx_tokens: int = 0,
        weight_streams: float = 0.0,
        emitted_tokens: int = 0,
        now: float | None = None,
    ) -> None:
        tokens = prefill_tokens + decode_tokens
        flops = self.cost.flops(tokens, attn_ctx_tokens) if tokens else 0.0
        moved = (
            self.cost.bytes_moved(tokens, attn_ctx_tokens, weight_streams)
            if (tokens or weight_streams)
            else 0.0
        )
        t = time.monotonic() if now is None else now
        with self._lock:
            self.prefill_tokens_total += prefill_tokens
            self.decode_tokens_total += decode_tokens
            self.emitted_tokens_total += emitted_tokens
            self.flops_total += flops
            self.bytes_total += moved
            if tokens:
                self.busy_time_total_s += duration_s
            self._samples.append(
                _Sample(
                    t=t, duration_s=duration_s, flops=flops, bytes_moved=moved,
                    emitted_tokens=emitted_tokens, prefill_tokens=prefill_tokens,
                    decode_tokens=decode_tokens,
                )
            )
            self._prune(t)

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        samples = self._samples
        while samples and samples[0].t < horizon:
            samples.popleft()

    def rates(self, now: float | None = None) -> dict:
        """Windowed rates.  The denominator is the wall time the window
        spans (not summed step time): idle gaps drag MFU down."""
        t = time.monotonic() if now is None else now
        with self._lock:
            self._prune(t)
            samples = list(self._samples)
        if not samples:
            return {
                "mfu_perc": 0.0, "bandwidth_util_perc": 0.0,
                "goodput_tokens_per_second": 0.0,
                "prefill_tokens_per_second": 0.0,
                "tokens_per_second": 0.0,
            }
        span = max(t - samples[0].t, sum(s.duration_s for s in samples), 1e-6)
        flops = sum(s.flops for s in samples)
        moved = sum(s.bytes_moved for s in samples)
        emitted = sum(s.emitted_tokens for s in samples)
        computed = sum(s.prefill_tokens + s.decode_tokens for s in samples)
        return {
            "mfu_perc": min(flops / span / self.peak_flops, 1.0),
            "bandwidth_util_perc": min(moved / span / self.peak_bytes_per_s, 1.0),
            "goodput_tokens_per_second": emitted / span,
            "prefill_tokens_per_second": sum(
                s.prefill_tokens for s in samples
            ) / span,
            "tokens_per_second": computed / span,
        }

    def stats(self) -> dict:
        """Merged into ``TorchLlmEngine.stats()`` under the reference's names."""
        out = self.rates()
        out.update(
            prefill_tokens_total=self.prefill_tokens_total,
            decode_tokens_total=self.decode_tokens_total,
            tokens_emitted_total=self.emitted_tokens_total,
            model_flops_total=self.flops_total,
            model_bytes_total=self.bytes_total,
            busy_time_total_s=self.busy_time_total_s,
        )
        return out
