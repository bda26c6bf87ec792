"""TorchLlmEngine — the port's inference engine (a subset of
dynamo_tpu/engine/engine.py's JaxLlmEngine).

Architecture, as in the reference:
- a dedicated device thread runs the scheduler/step loop, keeping the
  asyncio event loop free for network I/O;
- requests enter through the streaming-engine interface
  (``generate(Context[dict]) -> ResponseStream[dict]`` speaking
  PreprocessedRequest / Annotated[LLMEngineOutput] wire dicts);
- with the unified step on (the default), each scheduler iteration that
  carries prefill work runs the ragged unified step (mixed prefill spans +
  decode tokens, one forward through the family's ragged attention
  kernel); any other iteration runs the split step: one prefill forward a
  sequence (whole prompt, or a chunk over its resident prefix, with plain
  dense attention), then one decode dispatch for the running lanes (the
  family's paged decode kernel).  A window the unified step cannot serve
  falls back to the split step under a reason slug (``unified_fallbacks``
  in ``stats()``);
- speculative decoding (``speculative="ngram"``, prompt-lookup drafts,
  exact greedy verification) turns the unified step off, as the reference
  does: every prefill then runs the split step, and a decode iteration in
  which enough lanes drafted runs the verify step, one forward over a
  window of spec_tokens + 1 positions a lane through the family's window
  attention kernel;
- with an offload tier mounted (``host_offload_blocks`` > 0, then
  optionally disk and a remote block store), registered blocks evicted from
  the device cache offload to host memory (one block-gather kernel launch
  a cache leaf, one copy to pinned memory), cascade down-tier, and restore
  on a later prefix hit (one copy to the device, one block-scatter kernel
  launch a leaf) instead of being recomputed.  Paging is on demand: the
  reference's predictive prefetch pager is a later slice.
All steps end in the same sampling tail.

Decode overlaps by default (``decode_overlap``), as in the reference: a
decode-only window is dispatched with its input tokens fed back on the
device from the previous window's output, and the previous window is
retired (its tokens read back from pinned memory behind a CUDA event, and
emitted) while the new one runs; finishes found meanwhile release their
lane and blocks only when the window holding them retires.  Unified
windows take part in the pipeline the same way.  ``decode_steps = k`` fuses
k decode iterations into one window.  On a CUDA device every decode window
and every unified window without a ``top_logprobs`` lane is one CUDA graph
replay (``engine/graphs.py``): the unified step has one graph per token
bucket, every input at its bucket's fixed shape, as the reference compiles
one program per bucket; ``warmup()`` captures them all before serving.  A
unified window the graphs cannot take (more admissions than seed slots,
more tokens than the largest bucket) is skipped by name to the split step,
as the reference skips it.  The split prefill and verify steps stay
eager.

The cache may hold a narrower float dtype than the model
(``kv_cache_dtype``: fp8 e4m3fn or e5m2, float16, ...; every write casts to
it, every kernel upcasts at load) and the projections may be int8
weight-only (``quantize="int8"``, ``ops/quant.py``); both keep the unified
step and its graphs.  Every scheduler iteration feeds the reference's
utilization accounting (``observability/``: tokens, attended context,
weight streams, emitted tokens) into ``stats()``'s MFU and bandwidth share.

Guided decoding, multimodal prompts, disaggregated prefill, prefetch and
multi-device meshes are later slices; the engine refuses configurations
that would need them.

There is no attention fallback: on the card attention runs through the
hand-written kernels (``attention_impl="kernel"``) and a kernel that fails
to build or launch raises; on the CPU the kernel wrappers take their plain
versions (``"plain"``).
"""

from __future__ import annotations

import asyncio
import math
import os
import queue as thread_queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.graphs import DecodeGraph, UnifiedGraph
from dynamo_tpu_torch.engine.kv_manager import BlockAllocator
from dynamo_tpu_torch.engine.scheduler import Scheduler
from dynamo_tpu_torch.engine.sequence import Sequence, SeqStatus
from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.models.registry import get_family
from dynamo_tpu_torch.observability import StepTelemetry, UtilizationTracker, model_cost
from dynamo_tpu_torch.ops.kernels import block_copy
from dynamo_tpu_torch.ops.kernels import build as kernel_build
from dynamo_tpu_torch.ops.kernels import pack_page_meta
from dynamo_tpu_torch.ops.quant import is_quantized, quantize_params
from dynamo_tpu_torch.ops.random import fold_in, gumbel
from dynamo_tpu_torch.ops.sampling import (
    apply_logit_bias,
    apply_penalties,
    sample_tokens,
    token_logprobs,
    topk_logprobs,
)
from dynamo_tpu_torch.runtime.engine import Context, ResponseStream
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("engine")


@dataclass
class _InflightWindow:
    """One dispatched but unretired window (the overlap pipeline's
    in-flight slot): its tokens and logprobs on their way to pinned host
    memory behind ``event``.  The next window's input tokens come from
    ``DecodeGraph.feedback`` on the device."""
    tokens: torch.Tensor      # [steps, lanes] int32, host (pinned on a card)
    lps: torch.Tensor         # [steps, lanes] float32, host
    event: Any                # torch.cuda.Event after the copies, or None
    active: list              # sequences RUNNING at dispatch, lane order
    lane_ids: list            # their lanes
    steps: int
    # sequences whose finish was found while THIS window was in flight:
    # emitted already, but their lane and blocks are released only when
    # this window retires (its lagged steps may still write into them)
    deferred: list = field(default_factory=list)


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes", "on")


def _round_chunk_tokens(chunk_tokens: int, block_size: int) -> int:
    """Chunk windows round UP to whole blocks."""
    return max(1, (chunk_tokens + block_size - 1) // block_size) * block_size


# width of the per-lane OpenAI logit_bias rows: requests with more entries
# keep the strongest biases, as the reference's default compile width does
LOGIT_BIAS_K = 64

# least fraction of running lanes with a draft for the verify step to run;
# below it the plain decode step serves the iteration.  Decode is
# weight-bandwidth-bound: one verify forward streams the weights once, so a
# non-drafting lane riding in it pays only the w-wide logits and sampling;
# the gate bounds that tax, so one self-drafting request cannot load a whole
# mixed batch with it
SPEC_MIN_FRACTION = 0.25


@dataclass
class EngineConfig:
    # the family's config (LlamaConfig, DeepseekConfig): the engine reads
    # only vocab_size, max_position_embeddings, dtype and, where the family
    # has one, sliding_window
    model: Any
    model_family: str = "llama"        # registry key
    num_blocks: int = 256
    block_size: int = 16
    max_batch_size: int = 8
    max_model_len: int | None = None
    prefill_buckets: tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048, 4096)
    seed: int = 0
    # KV cache storage dtype: None = the model's; a torch dtype, or a name
    # (resolve_kv_cache_dtype: "fp8" = float8_e4m3fn, "float8_e5m2", "bf16",
    # "f16", "f32", ...).  fp8 halves the bytes of a bf16 cache; every write
    # casts to it as the reference's .astype does, and the kernels and plain
    # versions upcast every read.
    kv_cache_dtype: object = None
    # "auto": "kernel" on a CUDA device, "plain" on the CPU.  "kernel" builds
    # and loads the CUDA library at construction and raises when it cannot;
    # "plain" is refused on a CUDA device.
    attention_impl: str = "auto"
    # prompts longer than this prefill in chunks of this many tokens
    # (rounded up to a block multiple).  None with the unified step on = the
    # largest prefill bucket (rounded down to a block multiple): the unified
    # step then never overflows its largest bucket, the case where the
    # reference falls back to its split prefill path.  None with the unified
    # step off = whole-prompt prefill, as in the reference.
    prefill_chunk_tokens: int | None = None
    # Ragged unified-batch step for iterations that carry prefill work.
    # Speculative engines turn it off (their decode lanes keep the verify
    # route); the split step is then the prefill path.
    unified_batch: bool = True
    # Speculative decoding: "ngram" = prompt-lookup self-drafting (the last
    # spec_ngram tokens are matched against the sequence's history and the
    # continuation proposed); one verify forward scores spec_tokens + 1
    # positions a lane.  Exact: a lane emits beyond one token only while
    # drafts match what greedy decode would produce (sampled and penalized
    # lanes take one token a step).
    speculative: str | None = None
    spec_tokens: int = 4
    spec_ngram: int = 2
    # G2 host-DRAM tier: registered blocks evicted from the device cache
    # offload here and restore on a later prefix hit instead of recomputing
    # (0 = off).  Reference: block manager G1→G2 offload,
    # lib/llm/src/block_manager/offload.rs:77-80.
    host_offload_blocks: int = 0
    # G3 SSD tier: host-LRU evictions cascade to a memmap disk pool and
    # restore from there (0 = off; needs host_offload_blocks > 0).  The
    # pool's file is disk_offload_path, else a fresh file in the temp dir.
    disk_offload_blocks: int = 0
    disk_offload_path: str | None = None
    # G4 remote tier: "host:port" of a BlockStoreServer
    # (llm/block_manager/remote.py); bottom-tier evictions cascade there
    # over TCP and prefix hits restore from it (None = off; needs
    # host_offload_blocks > 0).
    remote_store_addr: str | None = None
    # Predictive prefetch over the offload tiers.  The port pages on demand
    # only (the reference's prefetch=False); True raises until the pager is
    # ported with the router hints it reads.
    prefetch: bool = False
    # Overlapped decode pipeline: dispatch the next decode window with its
    # input tokens fed back on the device and retire the previous window
    # (readback, emission) while the new one runs (in-flight depth 1).  The
    # pipeline drains wherever host state gates the device: a lane the
    # feedback does not cover, preemption, aborts, verify; windows with a
    # top_logprobs lane run synchronously.  Speculative engines turn it off
    # (drafts come from host token history, which lags a window).
    decode_overlap: bool = True
    # Fused multi-step decode: one window runs this many decode iterations
    # (slots from the pre-extended block tables, tokens fed back on the
    # device).  > 1 turns the unified step off.
    decode_steps: int = 1
    # Weight-only quantization ("int8" | None): the family's quant_leaves
    # become int8 + per-channel scale (ops/quant.py), dequantized at use.
    quantize: str | None = None

    def resolved_max_len(self) -> int:
        hard = self.num_blocks * self.block_size
        soft = self.max_model_len or self.model.max_position_embeddings
        return min(soft, self.model.max_position_embeddings, hard)


_KV_DTYPE_NAMES = {
    "fp8": "float8_e4m3fn",
    "float8": "float8_e4m3fn",
    "float8_e4m3fn": "float8_e4m3fn",
    "float8_e5m2": "float8_e5m2",
    "bf16": "bfloat16",
    "bfloat16": "bfloat16",
    "f32": "float32",
    "float32": "float32",
    "f16": "float16",
    "float16": "float16",
}


def resolve_kv_cache_dtype(spec):
    """None | torch dtype | name -> the dtype the cache is made in (None:
    the model's)."""
    if spec is None or not isinstance(spec, str):
        return spec
    name = _KV_DTYPE_NAMES.get(spec.lower())
    if name is None:
        raise ValueError(
            f"unknown kv_cache_dtype {spec!r} (want one of {sorted(set(_KV_DTYPE_NAMES))})"
        )
    return getattr(torch, name)


class TorchLlmEngine:
    def __init__(
        self,
        config: EngineConfig,
        params: dict | None = None,
        *,
        device: str | torch.device | None = None,
    ):
        self.config = config
        cfg = config.model
        self.device = resolve_device(device)
        self.family = get_family(config.model_family)
        self.max_len = config.resolved_max_len()
        self.max_blocks_per_seq = (self.max_len + config.block_size - 1) // config.block_size
        self.buckets = sorted({min(b, self.max_len) for b in config.prefill_buckets})
        if self.buckets[-1] < self.max_len:
            self.buckets.append(self.max_len)

        impl = config.attention_impl
        if impl == "auto":
            impl = "kernel" if self.device.type == "cuda" else "plain"
        if impl == "kernel":
            kernel_build.library()  # raises KernelBuildError: no fallback
            if self.device.type != "cuda":
                raise ValueError("attention_impl='kernel' needs a CUDA device")
        elif impl == "plain":
            if self.device.type == "cuda":
                raise ValueError(
                    "attention_impl='plain' on a CUDA device: on the card the "
                    "port runs attention only through its kernels"
                )
        else:
            raise ValueError(f"unknown attention_impl {impl!r} (want auto|kernel|plain)")
        self.attention_impl = impl

        dev = self.device
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(config.seed)
            params = self.family.init_params(cfg, gen, dev)
        self.params = self._maybe_quantize(_to_device(params, dev))
        self.kv_cache_dtype = resolve_kv_cache_dtype(config.kv_cache_dtype) or cfg.dtype
        self.cache = self.family.init_kv_cache(
            cfg, config.num_blocks, config.block_size, self.kv_cache_dtype, dev
        )
        self.cos, self.sin = self.family.make_rope_tables(cfg, dev, self.max_len)
        lanes = config.max_batch_size
        # per-lane sampling state: generated-token counts (presence/frequency
        # penalties) and prompt-token counts (repetition penalty scope), on
        # the device; per-lane raw threefry keys on the host
        self._gen_counts = torch.zeros((lanes, cfg.vocab_size), dtype=torch.int32, device=dev)
        self._prompt_counts = torch.zeros_like(self._gen_counts)
        self._lane_idx = torch.arange(lanes, device=dev)
        self._host_rng = np.random.Generator(np.random.PCG64(config.seed))
        self._lane_keys = np.zeros((lanes, 2), np.uint32)

        self.spec_enabled = bool(config.speculative)
        if self.spec_enabled:
            if config.speculative != "ngram":
                raise ValueError(
                    f"unknown speculative mode {config.speculative!r} (want 'ngram')"
                )
            if self.family.forward_verify is None:
                raise ValueError(
                    f"model family {config.model_family!r} has no verification "
                    "forward (speculative decoding unsupported)"
                )
            if config.spec_tokens < 1:
                raise ValueError("spec_tokens must be >= 1")
            if config.spec_ngram < 1:
                raise ValueError("spec_ngram must be >= 1")
            if impl == "kernel" and self.family.check_verify_width is not None:
                self.family.check_verify_width(cfg, config.spec_tokens + 1)
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._verify_steps = 0

        # unified-batch fallbacks: reason slug -> count (stats()), each
        # reason logged once per engine
        self._unified_fallbacks: dict[str, int] = {}
        self._unified_fallback_logged: set[str] = set()
        if config.decode_steps < 1:
            raise ValueError("decode_steps must be >= 1")
        unified = config.unified_batch
        if unified and self.spec_enabled:
            self._unified_skip("speculative", "speculative lanes keep their verify route")
            unified = False
        elif unified and config.decode_steps > 1:
            self._unified_skip("multi_step_decode",
                               "fused multi-step decode windows cannot carry chunks")
            unified = False
        elif unified and not self.kv_cache_dtype.is_floating_point:
            # float narrowings (fp8, f16, bf16) keep the unified step: every
            # kernel and plain version upcasts cache reads and the writes
            # cast.  A non-float cache has no kernel read path.
            self._unified_skip(
                "unsupported_kv_dtype",
                f"kv_cache_dtype {config.kv_cache_dtype!r} has no unified kernel read path")
            unified = False
        self.unified_batch = unified
        # the overlapped decode pipeline (EngineConfig.decode_overlap) and
        # its single in-flight window
        self.decode_overlap = bool(config.decode_overlap)
        if self.decode_overlap and self.spec_enabled:
            logger.info("decode overlap disabled: speculative decoding drafts from "
                        "host token history")
            self.decode_overlap = False
        self._inflight: _InflightWindow | None = None
        self._overlap_windows = 0     # windows dispatched with token feedback
        self._admission_drains = 0    # pipeline drains forced by a new lane
        self._offload_drains = 0      # windows in flight at an offload/restore sync
        # the host values behind the sampling tail's device buffers: a
        # window uploads them only when they changed
        self._tail_cache: tuple | None = None
        # decode hot-loop phase accounting (DYN_ENGINE_PHASE_TIMING=1): wall
        # seconds and counts a phase, in stats()["phase_ms"]
        self._phase_timing = _env_flag("DYN_ENGINE_PHASE_TIMING")
        self.phase_stats: dict[str, list[float]] = {}

        if config.prefill_chunk_tokens is not None:
            self.chunk_tokens = _round_chunk_tokens(
                config.prefill_chunk_tokens, config.block_size
            )
        elif unified:
            self.chunk_tokens = max(
                config.block_size,
                (self.buckets[-1] // config.block_size) * config.block_size,
            )
        else:
            self.chunk_tokens = None  # the split step prefills whole prompts
        if self.chunk_tokens is not None and self.chunk_tokens < self.max_len:
            # chunks get a bucket of their own, and so does the unified
            # step's steady-state mixed window (a full chunk plus one decode
            # token per lane)
            self.buckets = sorted(set(self.buckets) | {self.chunk_tokens})
            mixed = -(-(self.chunk_tokens + lanes) // 8) * 8
            if unified and mixed < self.max_len:
                self.buckets = sorted(set(self.buckets) | {mixed})
        # ragged kernel geometry: the flat token axis pads to whole blocks of
        # tb tokens (the page worklist's one width is UnifiedGraph's)
        self._unified_tb = math.gcd(config.block_size, 8) or 1
        self._unified_windows = 0
        self._sync_windows = 0
        self._decode_steps_total = 0
        self._tokens_emitted = 0
        # the reference's accounting (engine.py:660-682): the latest step's
        # snapshot, and the rolling MFU / bandwidth share / goodput from the
        # cost model of this geometry, quantization and cache dtype; the
        # step's facts below are reset every scheduler iteration
        self.step_telemetry = StepTelemetry(lanes)
        self.utilization = UtilizationTracker(
            model_cost(cfg, quantize=config.quantize, kv_cache_dtype=config.kv_cache_dtype),
            device=dev,
        )
        self._step_prefill_tokens = 0
        self._step_decode_tokens = 0
        self._step_attn_ctx = 0          # attended context positions
        self._step_weight_streams = 0.0  # full weight passes dispatched

        if config.prefetch:
            raise NotImplementedError(
                "predictive prefetch comes with a later slice of the port (ROADMAP "
                "Queue 1 item 4, the router hints it reads); prefetch=False pages "
                "offloaded blocks back on demand"
            )
        # the offload tiers below the device cache (G2 host → G3 disk → G4
        # remote): one payload a block, each leaf's [L, ...] slice
        self.host_tier = None
        self._host_evictions: list[int] | None = None
        # where restores spend their time: the tier reads into staging (host
        # clock), the copies to the device and the scatter kernels (CUDA
        # events on a card, the host clock on the CPU)
        self._restore_ms = {"stage": 0.0, "copy": 0.0, "scatter": 0.0}
        offload_sink = None
        if config.host_offload_blocks:
            from dynamo_tpu_torch.engine.offload import HostOffloadTier

            self.host_tier = HostOffloadTier(
                config.host_offload_blocks,
                {k: (v.shape[0], *v.shape[2:]) for k, v in self.cache.items()},
                {k: v.dtype for k, v in self.cache.items()},
                disk_blocks=config.disk_offload_blocks,
                disk_path=config.disk_offload_path,
                remote_addr=config.remote_store_addr,
            )
            offload_sink = self._offload_blocks
            # a hash that left EVERY tier (fell off the bottom of the
            # G2→G3→G4 cascade) while no longer device-resident: routers
            # must forget it
            self.host_tier.evict_observer = self._host_evicted
        elif config.disk_offload_blocks or config.remote_store_addr:
            # a silently ignored tier config is worse than a loud one: the
            # operator believes offload is on while nothing mounts
            raise ValueError(
                "KV offload tiers configured but unusable: disk/remote tiers "
                "need host_offload_blocks > 0"
            )
        # prefix caching: completed blocks stay resident and a matching
        # prompt prefills only its uncached tail (the unified step reads the
        # resident prefix through the paged cache)
        self.allocator = BlockAllocator(
            config.num_blocks, config.block_size, enable_prefix_caching=True,
            offload_sink=offload_sink, host_tier=self.host_tier,
        )
        self.scheduler = Scheduler(
            self.allocator, max_batch_size=lanes,
            prefill_chunk_tokens=self.chunk_tokens,
            bucket_cost=self._bucket_len,
            unified_batch=self.unified_batch,
        )
        self._iterations = 0
        self.warmup_s: float | None = None  # warmup()'s wall seconds
        # per-lane block-table host rows, rewritten only for lanes whose
        # block list changed; the device copy is uploaded only then
        self._bt_host = np.zeros((lanes, self.max_blocks_per_seq), np.int32)
        self._bt_lane_key: list = [None] * lanes
        self._bt_clean = False
        # the decode window's persistent inputs and its graphs; the unified
        # step reads its block tables, sampling tail and feedback too.  All
        # graphs share one memory pool (UnifiedGraph says why that is safe)
        pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self._decode = DecodeGraph(self, LOGIT_BIAS_K, pool)
        # the unified window's graphs, one a reachable token bucket (the
        # reference's ucap: one chunk window plus a full complement of
        # decode lanes), and its seed slots: only newly admitted prefills
        # re-seed their penalty counts, and admission is bounded by the
        # scheduler's per-step cap
        self._unified_seed_slots = max(1, self.scheduler.max_prefills_per_step)
        self._unified: UnifiedGraph | None = None
        if self.unified_batch:
            if self.chunk_tokens is not None:
                ucap = self._bucket_len(min(self.chunk_tokens + lanes, self.max_len))
            else:
                ucap = self.buckets[-1]
            tb = self._unified_tb
            planner = None
            if self.family.unified_planner is not None:
                planner = self.family.unified_planner(
                    cfg, block_size=config.block_size, tb_tokens=tb, device=dev,
                    cache_dtype=self.kv_cache_dtype)
            self._unified = UnifiedGraph(
                self, self._decode, sorted({-(-b // tb) * tb for b in self.buckets if b <= ucap}),
                self._unified_seed_slots, planner, pool)

        # thread plumbing
        self._submit_q: thread_queue.Queue = thread_queue.Queue()
        self._wake = threading.Event()
        self._stop = False
        self._thread: threading.Thread | None = None

    def _maybe_quantize(self, params: dict) -> dict:
        """``EngineConfig.quantize`` applied to the parameter tree; a tree
        that already holds quantized leaves (the reference's int8 weights,
        carried by ``params_from_jax``) passes through."""
        mode = self.config.quantize
        if not mode:
            return params
        if mode != "int8":
            raise ValueError(f"unknown quantize mode {mode!r} (want 'int8')")
        if not self.family.quant_leaves:
            raise ValueError(
                f"model family {self.config.model_family!r} does not support "
                "weight-only quantization (no quant_leaves)"
            )
        if is_quantized(params):
            return params
        return quantize_params(params, self.family.quant_leaves)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = False
        self._thread = threading.Thread(
            target=self._device_loop, name="torch-engine", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if self.host_tier is not None:
            self.host_tier.close()  # release + delete the G3 memmap

    # -- async engine interface -------------------------------------------
    async def warmup(self) -> None:
        """Capture every serving graph before the first request, as the
        reference's ``warmup`` / ``aot_precompile`` compile every serving
        program: the unified step's graph of every reachable token bucket
        (noise drawn and not) and the decode window's two graphs.  On the
        CPU each step runs once with nothing live.  The captures write
        nothing live; the prefix registry is flushed after all the same, as
        the reference flushes after its warmup requests, so no warmup state
        reaches serving.  Runs on the device thread once the engine is
        started, else in the caller's.  A capture that fails raises."""
        if self._thread is None:
            self._warm_graphs()
            return
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def done(exc: BaseException | None) -> None:
            def resolve() -> None:
                if fut.done():
                    return
                if exc is not None:
                    fut.set_exception(exc)
                else:
                    fut.set_result(None)

            loop.call_soon_threadsafe(resolve)

        self._submit_q.put(("warmup", done))
        self._wake.set()
        await fut

    def _warm_graphs(self) -> None:
        t0 = time.perf_counter()
        self._sync_pipeline()
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if self._unified is not None:
            self._unified.warm()
        self._decode.warm()
        self.allocator.clear_published()
        self.warmup_s = time.perf_counter() - t0
        logger.info("warmup: %d unified and %d decode graphs in %.1f s",
                    self.stats()["unified_graphs_captured"],
                    self.stats()["decode_graphs_captured"], self.warmup_s)

    async def generate(self, request: Context[dict]) -> ResponseStream[dict]:
        if request.data.get("image") is not None or request.data.get("video") is not None:
            raise ValueError("this model deployment does not accept image/video input")
        pre = PreprocessedRequest.from_wire(request.data)
        if pre.output_format is not None:
            raise ValueError(
                "guided decoding (output_format) is not served by this engine yet"
            )
        ctx = request.ctx
        if len(pre.token_ids) >= self.max_len:
            raise ValueError(
                f"prompt length {len(pre.token_ids)} exceeds engine max length {self.max_len}"
            )
        seq = Sequence(seq_id=ctx.id or uuid.uuid4().hex, request=pre)
        return self._start_sequence(seq, ctx)

    def _start_sequence(self, seq: Sequence, ctx) -> ResponseStream[dict]:
        """Wire the emit callback, submit to the device thread, watch for
        cancellation."""
        loop = asyncio.get_running_loop()
        out_q: asyncio.Queue = asyncio.Queue()

        def emit(tokens: list[int], finish: FinishReason | None,
                 error: str | None = None,
                 logprobs: list[float] | None = None,
                 top_logprobs: list[list[list]] | None = None) -> None:
            out = LLMEngineOutput(
                token_ids=tokens, finish_reason=finish, error=error,
                logprobs=logprobs, top_logprobs=top_logprobs,
            )
            wire = Annotated.from_data(out).to_wire(LLMEngineOutput.to_wire)
            loop.call_soon_threadsafe(out_q.put_nowait, wire)
            if finish is not None:
                loop.call_soon_threadsafe(out_q.put_nowait, None)

        seq.emit = emit
        self._submit_q.put(("add", seq))
        self._wake.set()

        cancel_task = spawn_logged(self._watch_cancel(ctx, seq))

        async def gen() -> AsyncIterator[dict]:
            try:
                while True:
                    item = await out_q.get()
                    if item is None:
                        break
                    yield item
            finally:
                cancel_task.cancel()

        return ResponseStream(gen(), ctx)

    async def _watch_cancel(self, ctx, seq: Sequence) -> None:
        await ctx.stopped()
        self._submit_q.put(("abort", seq))
        self._wake.set()

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        """ForwardPassMetrics and engine counters, under the reference's key
        names (the subset this engine has)."""
        out = {
            # the latest step's snapshot and the utilization accounting
            # (rolling MFU / bandwidth share / goodput, token, FLOP and byte
            # totals); the engine's own keys below win (its emitted count
            # is current mid-step, the tracker's at the step's end)
            **self.step_telemetry.stats(),
            **self.utilization.stats(),
            "kv_active_blocks": self.allocator.used_blocks,
            "kv_total_blocks": self.allocator.num_blocks,
            "kv_cached_blocks": self.allocator.cached_blocks,
            "gpu_cache_usage_perc": self.allocator.usage,
            "num_requests_waiting": self.scheduler.num_waiting,
            "num_requests_running": self.scheduler.num_running,
            "request_total_slots": self.config.max_batch_size,
            "iterations_total": self._iterations,
            "prefix_hits_total": self.allocator.prefix_hits_total,
            "prefix_cached_tokens_total": self.allocator.prefix_cached_tokens_total,
            "spec_drafted_tokens_total": self._spec_drafted,
            "spec_accepted_tokens_total": self._spec_accepted,
            # drafted positions whose compute bought nothing a client received
            "spec_rejected_tokens_total": max(0, self._spec_drafted - self._spec_accepted),
            "spec_verify_steps_total": self._verify_steps,
            "decode_windows_overlapped_total": self._overlap_windows,
            "decode_windows_sync_total": self._sync_windows,
            "decode_windows_unified_total": self._unified_windows,
            "admission_drains_total": self._admission_drains,
            # syncs of the stream by an offload or a restore while a window
            # was in flight (each one drains it)
            "offload_drains_total": self._offload_drains,
            # reason slug -> windows (or the engine init) that fell back
            # from the unified step to the split step
            "unified_fallbacks": dict(self._unified_fallbacks),
            "decode_steps_total": self._decode_steps_total,
            "num_preemptions_total": self.scheduler.preemptions_total,
            "tokens_emitted_total": self._tokens_emitted,
            "preempted_tokens_total": self.scheduler.preempted_tokens_total,
            "attention_impl": self.attention_impl,
            "kv_cache_dtype": str(self.kv_cache_dtype).removeprefix("torch."),
            "quantize": self.config.quantize,
            "warmup_s": self.warmup_s,
            "device": str(self.device),
            **self._decode.stats(),
            **(self._unified.stats() if self._unified is not None else {
                "unified_graph_replays_total": 0, "unified_graphs_captured": 0,
                "unified_graph_capture_ms": 0.0, "unified_graph_pool_mb": 0.0,
                "unified_graphs_captured_after_warmup": 0}),
        }
        if self.host_tier is not None:
            out.update(self.host_tier.stats())
            out["offload_tiers"] = self.host_tier.tiers_snapshot()
            out.update({f"restore_{k}_ms_total": v for k, v in self._restore_ms.items()})
        if self.phase_stats:
            # snapshot: the device thread inserts keys concurrently
            out["phase_ms"] = {
                name: {"total_ms": round(tot * 1e3, 2), "n": n,
                       "mean_ms": round(tot / n * 1e3, 3)}
                for name, (tot, n) in list(self.phase_stats.items())
            }
        return out

    # -- device thread -----------------------------------------------------
    def _device_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        logger.info(
            "engine loop started on %s (max_len=%d blocks=%d lanes=%d buckets=%s)",
            self.device, self.max_len, self.config.num_blocks,
            self.config.max_batch_size, self.buckets,
        )
        while not self._stop:
            try:
                # evictions queued outside a device-thread mutator offload
                # here, before anything can write into the evicted blocks
                self.allocator.flush_offloads()
                self._drain_submissions()
                if not self.scheduler.has_work():
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                t_step = time.perf_counter()
                emitted_before = self._tokens_emitted
                self._step_prefill_tokens = self._step_decode_tokens = 0
                self._step_attn_ctx = 0
                self._step_weight_streams = 0.0
                decision = self.scheduler.schedule()
                if not (self.unified_batch and self._maybe_run_unified(decision)):
                    self._run_split_step(decision)
                self._iterations += 1
                self._observe_step(time.perf_counter() - t_step,
                                   self._tokens_emitted - emitted_before)
            except Exception:  # noqa: BLE001 — scheduler-level bug: keep the
                # thread alive (callers would hang forever), don't hot-spin
                logger.exception("engine step failed")
                time.sleep(0.1)
        # shutdown with a window in flight: retire it so its tokens reach
        # their streams
        try:
            self._sync_pipeline()
        except Exception:  # noqa: BLE001
            logger.exception("pipeline drain at shutdown failed")

    def _observe_step(self, duration_s: float, emitted: int) -> None:
        """Feed the iteration's facts to the step telemetry and the
        utilization tracker (the reference's engine.py:2352-2369)."""
        self.step_telemetry.observe_step(
            iteration=self._iterations,
            num_running=self.scheduler.num_running,
            num_waiting=self.scheduler.num_waiting,
            kv_active_blocks=self.allocator.used_blocks,
            kv_total_blocks=self.allocator.num_blocks,
            step_duration_s=duration_s,
            prefill_tokens=self._step_prefill_tokens,
            decode_tokens=self._step_decode_tokens,
        )
        self.utilization.observe_step(
            duration_s=duration_s,
            prefill_tokens=self._step_prefill_tokens,
            decode_tokens=self._step_decode_tokens,
            attn_ctx_tokens=self._step_attn_ctx,
            weight_streams=self._step_weight_streams,
            emitted_tokens=emitted,
        )

    def _count_window(self, decode_tokens: int, attn_ctx: int, streams: float) -> None:
        """The utilization facts of one dispatched window: decode positions,
        the context positions they attended, weight passes."""
        self._step_decode_tokens += decode_tokens
        self._step_attn_ctx += attn_ctx
        self._step_weight_streams += streams

    def _count_prefill(self, start: int, end: int) -> None:
        """Prompt positions [start, end) computed: each position p attends
        p + 1 context positions (causal)."""
        self._step_prefill_tokens += end - start
        self._step_attn_ctx += (end * (end + 1) - start * (start + 1)) // 2

    def _run_split_step(self, decision) -> None:
        """The split step: one prefill forward for each sequence the
        scheduler planned, then one decode dispatch for the running lanes
        (verify, where enough lanes drafted).  A failed prefill fails its
        own sequence only."""
        for seq in decision.prefills:
            if seq.status == SeqStatus.FINISHED:
                continue  # failed or aborted before this step got to it
            try:
                self._run_prefill(seq)
            except Exception as exc:  # noqa: BLE001
                logger.exception("prefill failed for %s", seq.seq_id)
                self._fail_sequence(seq, exc)
        decodes = [s for s in self.scheduler.running if s.status == SeqStatus.RUNNING]
        if not decodes:
            if self._inflight is not None:
                # nothing to decode while a window is in flight: retire it
                # so its tokens emit and deferred finishes release
                self._sync_pipeline()
            return
        try:
            self._run_decode(decodes)
        except Exception as exc:  # noqa: BLE001
            logger.exception("decode step failed")
            # a poisoned in-flight window must not feed the next dispatch
            self._abandon_pipeline(decodes)
            for seq in decodes:
                if seq.status == SeqStatus.RUNNING:
                    self._fail_sequence(seq, exc)

    def _unified_skip(self, reason: str, detail: str | None = None) -> None:
        """Count a fallback from the unified step under a reason slug, and
        log each reason once per engine."""
        self._unified_fallbacks[reason] = self._unified_fallbacks.get(reason, 0) + 1
        if reason not in self._unified_fallback_logged:
            self._unified_fallback_logged.add(reason)
            logger.info("unified batch fallback [%s]: %s", reason,
                        detail or "window served by the split step")

    # -- ragged unified-batch step ----------------------------------------
    def _maybe_run_unified(self, decision) -> bool:
        """Serve this iteration as ONE ragged dispatch mixing prefill spans
        and decode tokens.  Returns False when the split step must serve it:
        a decode-only iteration (the exact-lane decode step, a designed
        route) or a window the unified step cannot take (counted)."""
        prefills = list(decision.prefills)
        decodes = [
            s for s in self.scheduler.running
            if s.status == SeqStatus.RUNNING and s not in prefills
        ]
        spans: list[tuple[Sequence, int, int]] = []
        for seq in prefills:
            n = len(seq.all_token_ids)
            start = max(seq.prefilled_tokens, seq.cached_tokens)
            end = min(seq.chunk_target, n) if seq.chunk_target else n
            if end <= start:
                # a degenerate window: the split step owns it
                self._unified_skip("degenerate_span")
                return False
            spans.append((seq, start, end))
        if not spans:
            # decode-only iterations keep the exact-lane decode program (a
            # designed route, not a fallback)
            return False
        # decode lanes and spans pack densely: every token costs one slot
        total = len(decodes) + sum(end - start for _, start, end in spans)
        tb = self._unified_tb
        bucket = -(-self._bucket_len(total) // tb) * tb  # whole token blocks
        if total > bucket or bucket not in self._unified.buckets:
            # past the largest graph bucket (the scheduler's chunk budget
            # keeps every window inside it)
            self._unified_skip("bucket_overflow")
            return False
        unseeded = sum(1 for seq, start, _ in spans if start == seq.cached_tokens)
        if unseeded > self._unified_seed_slots:
            # more admissions than the step's fixed seed scatter holds
            self._unified_skip("seed_overflow")
            return False
        # the per-window overlap gate, as _overlap_ok: top_logprobs lanes
        # ship K-wide rows whose readback belongs on the synchronous path
        overlap = self.decode_overlap and not any(
            s.request.sampling.top_logprobs > 0 for s in prefills + decodes
        )
        try:
            return self._run_unified(spans, decodes, bucket, overlap)
        except Exception as exc:  # noqa: BLE001
            logger.exception("unified step failed")
            self._abandon_pipeline(prefills + decodes)
            for seq in prefills + decodes:
                if seq.status in (SeqStatus.PREFILLING, SeqStatus.RUNNING):
                    self._fail_sequence(seq, exc)
            return True  # the step was consumed (by failing its batch)

    def _run_unified(
        self,
        spans: list[tuple[Sequence, int, int]],
        decodes: list[Sequence],
        bucket: int,
        overlap: bool,
    ) -> bool:
        """Build the ragged batch, dispatch once, then read back at once or
        put the window in flight (overlap).  A newly admitted sequence needs
        no pipeline drain here: its prefill tokens come from the host while
        resident decode lanes read the previous window's feedback on the
        device."""
        timing = self._phase_timing
        t = time.perf_counter() if timing else 0.0
        lanes = self.config.max_batch_size
        tb = self._unified_tb
        bs = self.config.block_size
        oob = self.config.num_blocks * bs
        prev = self._inflight

        # prefix restores from the offload tiers run as in _run_prefill, but a
        # failed restore fails ONLY its sequence (one bad tier read must not
        # take down every request in the window).  The plan goes back first
        # so free_sequence can unregister the garbage landing blocks and
        # release the tier pins.
        failed: list[Sequence] = []
        for seq, _, _ in spans:
            restore = self.allocator.take_restore_plan(seq.seq_id)
            if restore:
                try:
                    self._restore_blocks(restore)
                except Exception as exc:  # noqa: BLE001
                    logger.exception("prefix restore failed for %s", seq.seq_id)
                    self.allocator.put_back_restore_plan(seq.seq_id, restore)
                    self._fail_sequence(seq, exc)
                    failed.append(seq)
        if failed:
            spans = [(s, a, b) for s, a, b in spans if s not in failed]
            if not spans:
                return False  # decode-only now: the split step serves it

        # decode slot growth: overlap allocates at the DEVICE context and
        # never preempts (a lagged window may still write into a victim's
        # blocks): on OOM the pipeline drains and the preempting split step
        # serves this iteration.  Sync mode drains first and preempts like
        # the plain decode path.
        slots: dict[str, int] = {}
        if overlap:
            for seq in decodes:
                dev_ctx = min(seq.context_len + seq.inflight_tokens, self.max_len)
                slot = self.scheduler.try_slots_at(seq, dev_ctx, 1, max_pos=self.max_len - 1)
                if slot is None:
                    self._unified_skip("slot_oom")
                    self._sync_pipeline()
                    return False
                slots[seq.seq_id] = slot
        else:
            self._sync_pipeline()
            for seq in list(decodes):
                if seq.status != SeqStatus.RUNNING:
                    continue  # preempted as a victim earlier in this loop
                slot = self.scheduler.ensure_slots(seq, 1, max_pos=self.max_len - 1)
                if slot is None:
                    self.scheduler.preempt(seq)
                    continue
                slots[seq.seq_id] = slot
            decodes = [s for s in decodes if s.status == SeqStatus.RUNNING]
            # ensure_slots may have victimized a PREFILLING span owner
            spans = [
                (s, a, b) for s, a, b in spans
                if s.status in (SeqStatus.PREFILLING, SeqStatus.RUNNING)
            ]
            if not decodes and not spans:
                return True  # everything preempted: step consumed

        token_ids = np.zeros((bucket,), np.int32)
        use_fb = np.zeros((bucket,), bool)
        token_pos = np.full((bucket,), -1, np.int32)
        token_slot = np.full((bucket,), oob, np.int32)
        token_lane = np.full((bucket,), lanes, np.int32)
        context_lens = np.zeros((lanes,), np.int32)
        sample_rows = np.zeros((lanes,), np.int32)
        sample_gate = np.zeros((lanes,), np.int32)
        seeds: list[tuple[int, np.ndarray, np.ndarray]] = []

        emit_seqs: list[Sequence] = []
        cursor = 0
        for seq in decodes:
            lane = seq.lane
            dev_ctx = min(seq.context_len + (seq.inflight_tokens if overlap else 0),
                          self.max_len)
            token_ids[cursor] = seq.all_token_ids[-1]
            # the host's last token lags the device while a window holding
            # this lane is in flight: the step reads the feedback instead
            use_fb[cursor] = overlap and seq.inflight_tokens > 0
            token_pos[cursor] = dev_ctx - 1
            token_slot[cursor] = slots[seq.seq_id]
            token_lane[cursor] = lane
            context_lens[lane] = dev_ctx
            sample_rows[lane] = cursor
            sample_gate[lane] = 1
            emit_seqs.append(seq)
            cursor += 1
        for seq, start, end in spans:
            lane = seq.lane
            tokens = seq.all_token_ids
            span = end - start
            blocks = np.asarray(self.allocator.block_ids(seq.seq_id), np.int32)
            token_ids[cursor: cursor + span] = tokens[start:end]
            ppos = np.arange(start, end, dtype=np.int32)
            token_pos[cursor: cursor + span] = ppos
            token_slot[cursor: cursor + span] = blocks[ppos // bs] * bs + ppos % bs
            token_lane[cursor: cursor + span] = lane
            context_lens[lane] = end
            sample_rows[lane] = cursor + span - 1
            final = end >= len(tokens)
            sample_gate[lane] = 1 if final else 0
            if start == seq.cached_tokens:
                # first window of this admission: (re)seed the lane's
                # sampling state, as the reference's seed scatter does
                seeds.append((
                    lane, self._count_row(seq.request.token_ids),
                    self._count_row(seq.output_ids),
                ))
                self._seed_lane_key(seq)
                seq.sampling_seeded = True
            if final:
                emit_seqs.append(seq)
            cursor += span

        self._decode_tables(decodes + [s for s, _, _ in spans])
        page_phys, page_lane, page_ord, page_count = pack_page_meta(
            token_lane, token_pos, self._bt_host, tb_tokens=tb, block_size=bs,
            page_slots=self._unified.page_slots,
            sliding_window=getattr(self.config.model, "sliding_window", None),
        )
        # a family whose kernel balances its walk by a host plan makes it
        # here, once a step, for every layer
        ug = self._unified
        plan = ug.planner.plan(page_count) if ug.planner else None
        self._device_sampling_tail(emit_seqs)
        noise = any(self._sampled(s) for s in emit_seqs)
        want = max((s.request.sampling.top_logprobs for s in emit_seqs), default=0)
        if timing:
            t = self._phase("decode.schedule", t)
        ug.upload(bucket, {
            "token_ids": token_ids, "use_fb": use_fb, "token_pos": token_pos,
            "token_slot": token_slot, "token_lane": token_lane,
            "context_lens": context_lens, "sample_rows": sample_rows,
            "sample_gate": sample_gate, "page_count": page_count, "page_phys": page_phys,
            "page_lane": page_lane, "page_ord": page_ord,
        }, plan, seeds)
        if timing:
            t = self._phase("decode.upload", t)
        # a window with a top_logprobs lane runs the step eagerly for its
        # K-wide rows; any other is its bucket's graph replay
        top = ug.step(bucket, noise, top=want) if want else ug.run(bucket, noise)
        tokens, lps = ug.out_tokens, ug.out_lps
        if timing:
            t = self._phase("decode.dispatch", t)

        for seq, start, end in spans:
            seq.prefilled_tokens = end
            self._count_prefill(start, end)
            all_tokens = seq.all_token_ids
            if end >= len(all_tokens):
                if seq.status == SeqStatus.PREFILLING:
                    seq.status = SeqStatus.RUNNING
                self.allocator.publish_stored(seq.seq_id, all_tokens)
            else:
                self.allocator.publish_stored(seq.seq_id, all_tokens[:end])
        self._count_window(len(decodes), int(sum(context_lens[s.lane] for s in decodes)), 1)
        self._unified_windows += 1
        if decodes:
            self._decode_steps_total += 1

        if not overlap:
            self._sync_windows += 1
            self._emit(emit_seqs, tokens, lps, top)
            if timing:
                self._phase("decode.post", t)
            return True
        # overlap: the window retires one iteration from now, while the NEXT
        # window (possibly carrying a fresh admission) computes
        host_tokens, host_lps, event = self._readback(tokens[None], lps[None])
        for seq in emit_seqs:
            seq.inflight_tokens += 1
        if emit_seqs:
            self._inflight = _InflightWindow(
                tokens=host_tokens, lps=host_lps, event=event, active=emit_seqs,
                lane_ids=[s.lane for s in emit_seqs], steps=1,
            )
        else:
            # a chunk-only window samples nothing worth retiring
            self._inflight = None
        if prev is not None:
            self._retire_window(prev)
        return True

    @staticmethod
    def _sampled(seq: Sequence) -> bool:
        """Whether a lane draws noise (temperature sampling) or is greedy."""
        s = seq.request.sampling
        return not (s.use_greedy or s.temperature is None or s.temperature <= 1e-5)

    def _step_noise(self, seqs, rows: list[int], n_rows: int, fold_lens,
                    vocab: int) -> torch.Tensor:
        """[n_rows, vocab] Gumbel noise on the host's side of a synchronous
        step (split prefill, verify): sequence i's row ``rows[i]`` holds
        its lane key folded with ``fold_lens[rows[i]]`` (the context length
        the reference folds with, ``jax.random.fold_in(key, context_len)``),
        drawn with the port's threefry stream — so a seeded request draws
        the same noise at the same position whatever batch or step it rides
        in, and the reference's.  Greedy lanes draw nothing (zero rows).
        Decode and unified windows draw on the device
        (``DecodeGraph.sample``)."""
        noise = torch.zeros((n_rows, vocab), dtype=torch.float32, device=self.device)
        sampled = [(row, s) for row, s in zip(rows, seqs) if self._sampled(s)]
        if sampled:
            row_ids = [row for row, _ in sampled]
            keys = torch.from_numpy(self._lane_keys[[s.lane for _, s in sampled]].astype(np.int64))
            folds = torch.from_numpy(np.asarray(fold_lens)[row_ids].astype(np.int64))
            noise[row_ids] = gumbel(fold_in(keys, folds).to(self.device), vocab)
        return noise

    def _emit(self, seqs, tokens, lps, top) -> None:
        """Synchronous readback and emission of a one-step window."""
        tokens_h = tokens.cpu().numpy()
        lps_h = lps.cpu().numpy()
        tkv_h = tki_h = None
        if top is not None:
            tkv_h, tki_h = (t.cpu().numpy() for t in top)
        for seq in seqs:
            if seq.status != SeqStatus.RUNNING:
                continue
            lane = seq.lane
            self._process_token(
                seq, int(tokens_h[lane]), float(lps_h[lane]),
                top=(tkv_h[lane], tki_h[lane]) if top is not None else None,
            )

    def _readback(self, tokens: torch.Tensor, lps: torch.Tensor):
        """Start the copies of a window's tokens and logprobs to host
        memory: pinned and non-blocking behind a CUDA event on a card (the
        reference's ``copy_to_host_async``).  Returns (tokens, logprobs,
        event or None)."""
        if self.device.type != "cuda":
            return tokens.clone(), lps.clone(), None
        host_tokens = torch.empty(tokens.shape, dtype=tokens.dtype, pin_memory=True)
        host_lps = torch.empty(lps.shape, dtype=lps.dtype, pin_memory=True)
        host_tokens.copy_(tokens, non_blocking=True)
        host_lps.copy_(lps, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host_tokens, host_lps, event

    def _fail_sequence(self, seq: Sequence, exc: BaseException) -> None:
        """Terminate one sequence on an engine-side error: free its
        resources and resolve its caller with the failure."""
        self.scheduler.finish(seq)
        if seq.emit:
            seq.emit([], FinishReason.ERROR, f"{type(exc).__name__}: {exc}")

    def _drain_submissions(self) -> None:
        while True:
            try:
                op, seq = self._submit_q.get_nowait()
            except thread_queue.Empty:
                return
            if op == "warmup":  # seq is the caller's completion callback
                try:
                    self._warm_graphs()
                except Exception as exc:  # noqa: BLE001 — the caller raises it
                    seq(exc)
                else:
                    seq(None)
            elif op == "add":
                self.scheduler.add(seq)
            elif op == "abort":
                if seq.status == SeqStatus.RUNNING:
                    # abort frees the lane's blocks: drain the pipeline first
                    # so no lagged window writes into storage the allocator
                    # is about to reclaim (only RUNNING lanes ride a window)
                    self._sync_pipeline()
                if seq.status != SeqStatus.FINISHED:
                    self.scheduler.abort(seq)
                    seq.status = SeqStatus.FINISHED
                    if seq.emit:
                        seq.emit([], FinishReason.CANCELLED)

    def _bucket_len(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _sampling_arrays(self, seqs: list[Sequence], rows: list[int], n_rows: int):
        """[n_rows]-wide sampling parameters; sequence i fills row ``rows[i]``."""
        vocab = self.config.model.vocab_size
        kb = LOGIT_BIAS_K
        temp = np.zeros((n_rows,), np.float32)
        top_k = np.zeros((n_rows,), np.int32)
        top_p = np.ones((n_rows,), np.float32)
        greedy = np.ones((n_rows,), bool)
        pres = np.zeros((n_rows,), np.float32)
        freq = np.zeros((n_rows,), np.float32)
        rep = np.ones((n_rows,), np.float32)
        # OpenAI logit_bias: fixed-width sparse rows, pad id = vocab (dropped)
        bias_ids = np.full((n_rows, kb), vocab, np.int32)
        bias_vals = np.zeros((n_rows, kb), np.float32)
        for row, seq in zip(rows, seqs):
            s = seq.request.sampling
            temp[row] = s.temperature if s.temperature is not None else 0.0
            top_k[row] = s.top_k or 0
            top_p[row] = s.top_p if s.top_p is not None else 1.0
            greedy[row] = bool(
                s.use_greedy or s.temperature is None or s.temperature <= 0.0
            )
            pres[row] = s.presence_penalty or 0.0
            freq[row] = s.frequency_penalty or 0.0
            rep[row] = s.repetition_penalty if s.repetition_penalty else 1.0
            if s.logit_bias:
                # drop out-of-vocab ids BEFORE truncating so they cannot
                # displace valid biases; over-wide requests keep the
                # strongest biases
                entries = sorted(
                    (
                        (int(t), float(v))
                        for t, v in s.logit_bias.items()
                        if 0 <= int(t) < vocab
                    ),
                    key=lambda e: -abs(e[1]),
                )[:kb]
                for j, (tok, val) in enumerate(entries):
                    bias_ids[row, j] = tok
                    bias_vals[row, j] = val
        return temp, top_k, top_p, greedy, pres, freq, rep, bias_ids, bias_vals

    def _count_row(self, token_ids: list[int]) -> np.ndarray:
        """Per-vocab token counts [vocab] int32 (penalty bookkeeping)."""
        vocab = self.config.model.vocab_size
        if not token_ids:
            return np.zeros((vocab,), np.int32)
        return np.bincount(
            np.asarray(token_ids, np.int64) % vocab, minlength=vocab
        ).astype(np.int32)

    def _seed_lane_key(self, seq: Sequence) -> np.ndarray:
        """Per-lane seed row: from the request seed when given (reproducible
        sampling; packed [hi32, lo32] like the reference's keys), else from
        the engine stream."""
        seed = seq.request.sampling.seed
        if seed is not None:
            s = int(seed) & ((1 << 64) - 1)
            row = np.array([s >> 32, s & 0xFFFFFFFF], np.uint32)
        else:
            row = self._host_rng.integers(0, 2**32, size=2, dtype=np.uint32)
        self._lane_keys[seq.lane if seq.lane >= 0 else 0] = row
        return row

    def _decode_tables(self, active: list[Sequence]) -> torch.Tensor:
        """The device block-table buffer (``DecodeGraph.tables``, which the
        decode graphs read).  Host rows are persistent and rewritten only
        for lanes whose (sequence, block list) changed; the buffer is
        uploaded only then.  Stale rows of vacated lanes are harmless
        (context 0 ⇒ nothing read or written)."""
        dirty = not self._bt_clean
        for seq in active:
            lane = seq.lane
            blocks = self.allocator.block_ids(seq.seq_id)
            key = self._bt_lane_key[lane]
            if key is not None and key[0] == seq.seq_id and key[1] == blocks:
                continue
            row = self._bt_host[lane]
            n = len(blocks)
            row[:n] = blocks
            row[n:] = 0
            self._bt_lane_key[lane] = (seq.seq_id, list(blocks))
            dirty = True
        if dirty:
            self._decode.tables.upload({"tables": self._bt_host})
            self._bt_clean = True
        return self._decode.tables["tables"]

    def _device_sampling_tail(self, seqs: list[Sequence]) -> None:
        """Write the sampling tail's device buffers (lane keys, the sampled
        mask, the sampling arrays) for ``seqs``, skipping the upload while
        the host values are unchanged: at steady-state decode the batch
        composition changes rarely."""
        lanes = self.config.max_batch_size
        arrays = self._sampling_arrays(seqs, [s.lane for s in seqs], lanes)
        sampled = np.zeros((lanes,), np.float32)
        for seq in seqs:
            if self._sampled(seq):
                sampled[seq.lane] = 1.0
        host = dict(zip(
            ("temp", "top_k", "top_p", "greedy", "pres", "freq", "rep", "bias_ids",
             "bias_vals"), arrays,
        ), keys=self._lane_keys.astype(np.int64), sampled=sampled)
        cached = self._tail_cache
        if cached is not None and all(np.array_equal(cached[k], v) for k, v in host.items()):
            return
        self._decode.tail.upload(host)
        self._tail_cache = {k: np.copy(v) for k, v in host.items()}

    def _phase(self, name: str, t0: float) -> float:
        """Add the wall time since ``t0`` to ``phase_stats[name]`` and
        return a fresh timestamp (phase-timing mode only)."""
        t1 = time.perf_counter()
        s = self.phase_stats.setdefault(name, [0.0, 0])
        s[0] += t1 - t0
        s[1] += 1
        return t1

    def _run_plain_decode(self, seqs: list[Sequence]) -> None:
        """The synchronous decode window: ``decode_steps`` iterations, read
        back at once.  A window with a top_logprobs lane runs the step
        eagerly for its K-wide rows; any other is the graph replay."""
        timing = self._phase_timing
        t = time.perf_counter() if timing else 0.0
        lanes = self.config.max_batch_size
        steps = self.config.decode_steps
        token_ids = np.zeros((lanes,), np.int32)
        context_lens = np.zeros((lanes,), np.int32)

        candidates: list[Sequence] = []
        for seq in list(seqs):
            if seq.status != SeqStatus.RUNNING:
                continue  # preempted as a victim earlier in this loop
            # pre-extend the block table over the whole window (the device
            # derives each iteration's slot from it)
            if self.scheduler.ensure_slots(seq, steps, max_pos=self.max_len - 1) is None:
                # could not allocate even after preemption: preempt self
                self.scheduler.preempt(seq)
                continue
            candidates.append(seq)
        # build arrays only after all allocations settled: a victim must not
        # keep a live lane pointing at freed (possibly re-allocated) blocks
        active = [s for s in candidates if s.status == SeqStatus.RUNNING]
        if not active:
            return
        for seq in active:
            token_ids[seq.lane] = seq.all_token_ids[-1]
            context_lens[seq.lane] = seq.context_len
        self._decode_tables(active)
        want = max((s.request.sampling.top_logprobs for s in active), default=0)
        if timing:
            t = self._phase("decode.schedule", t)
        self._device_sampling_tail(active)
        d = self._decode
        d.window.upload({"tokens": token_ids, "use_fb": np.zeros((lanes,), bool),
                         "lens": context_lens})
        if timing:
            t = self._phase("decode.upload", t)
        noise = any(self._sampled(s) for s in active)
        top = None
        if want:
            top = d.step(noise, top=want)
        else:
            d.run(noise)
        if timing:
            t = self._phase("decode.dispatch", t)
        tokens_h = d.out_tokens.cpu().numpy()
        lps_h = d.out_lps.cpu().numpy()
        tkv_h = tki_h = None
        if top is not None:
            tkv_h, tki_h = (x.cpu().numpy() for x in top)
        if timing:
            t = self._phase("decode.readback", t)
        self._sync_windows += 1
        self._decode_steps_total += steps
        self._count_window(len(active) * steps, int(context_lens.sum()) * steps, steps)
        for s in range(steps):
            for seq in active:
                if seq.status != SeqStatus.RUNNING:
                    continue  # finished at an earlier step in this window
                lane = seq.lane
                self._process_token(
                    seq, int(tokens_h[s, lane]), float(lps_h[s, lane]),
                    top=(tkv_h[s, lane], tki_h[s, lane]) if top is not None else None,
                )
        if timing:
            self._phase("decode.post", t)

    # -- the overlapped decode pipeline --------------------------------------
    def _overlap_ok(self, seqs: list[Sequence]) -> bool:
        """Overlap serves a window only when no lane needs per-token host
        state: top_logprobs lanes ship K-wide rows whose readback belongs on
        the synchronous path.  A mixed batch falls back whole."""
        if not self.decode_overlap:
            return False
        return not any(
            s.status == SeqStatus.RUNNING and s.request.sampling.top_logprobs > 0
            for s in seqs
        )

    def _sync_pipeline(self) -> None:
        """Retire the in-flight window (if any): host state catches up with
        the device before anything that needs it — preemption, aborts,
        verify, the synchronous decode path."""
        w = self._inflight
        if w is None:
            return
        self._inflight = None
        self._retire_window(w)

    def _abandon_pipeline(self, seqs: list[Sequence]) -> None:
        """Step-failure cleanup: drop the in-flight window without retiring
        it (its results may be poisoned) and zero the in-flight token
        counts, so a recovered loop rebuilds from host state.  The window's
        deferred finishes still release their lanes and blocks, after its
        work ended (completion, not success, gates the release)."""
        w = self._inflight
        self._inflight = None
        if w is not None:
            if w.event is not None:
                try:
                    w.event.synchronize()
                except Exception:  # noqa: BLE001 — a failed window still ended
                    pass
            for seq in w.deferred:
                self.scheduler.finish(seq)
            for seq in w.active:
                seq.inflight_tokens = 0
        for seq in seqs:
            seq.inflight_tokens = 0

    def _retire_window(self, w: _InflightWindow) -> None:
        """Readback and emission of a dispatched window, normally after the
        next window was dispatched: the card computes while the host waits
        here (phase ``decode.retire``)."""
        timing = self._phase_timing
        t = time.perf_counter() if timing else 0.0
        try:
            if w.event is not None:
                w.event.synchronize()
            tokens_h, lps_h = w.tokens.numpy(), w.lps.numpy()
            if timing:
                t = self._phase("decode.retire", t)
            for seq in w.active:
                seq.inflight_tokens = max(0, seq.inflight_tokens - w.steps)
            for s in range(tokens_h.shape[0]):
                for seq in w.active:
                    if seq.status != SeqStatus.RUNNING:
                        continue  # finished at an earlier step in this window
                    self._process_token(seq, int(tokens_h[s, seq.lane]),
                                        float(lps_h[s, seq.lane]))
        finally:
            # sequences that finished while THIS window was in flight: its
            # lagged steps have run, so lane and blocks go back to the pools
            # (even when the emission above raised: the window is no longer
            # reachable, and a skipped release would leak them)
            for seq in w.deferred:
                self.scheduler.finish(seq)
        if timing:
            self._phase("decode.post", t)

    def _finish_decoded(self, seq: Sequence) -> None:
        """Finish a sequence from a decode path.  While the in-flight window
        holds its lane the release is deferred: freed blocks could be handed
        to (or prefix-matched by) another sequence while the lagged window
        still writes into them.  Emission already happened."""
        w = self._inflight
        if w is not None and seq.lane in w.lane_ids:
            seq.status = SeqStatus.FINISHED
            w.deferred.append(seq)
        else:
            self.scheduler.finish(seq)

    def _run_overlap_decode(self, seqs: list[Sequence]) -> None:
        """Dispatch a decode window with its tokens fed back on the device,
        then retire the previous window while this one runs."""
        timing = self._phase_timing
        t = time.perf_counter() if timing else 0.0
        lanes = self.config.max_batch_size
        steps = self.config.decode_steps
        prev = self._inflight

        active = [s for s in seqs if s.status == SeqStatus.RUNNING]
        if prev is not None:
            # the feedback only carries tokens for sequences in the previous
            # window: a NEW sequence (a fresh prefill, a lane reused after a
            # deferred release) forces a drain and a host rebuild.  A
            # shrinking batch keeps the pipeline hot: vacated lanes get
            # context 0, so they write only the dump row.
            members = set(map(id, prev.active))
            if any(id(s) not in members for s in active):
                self._admission_drains += 1
                self._sync_pipeline()
                prev = None
                active = [s for s in active if s.status == SeqStatus.RUNNING]
        if not active:
            self._sync_pipeline()
            return

        # pre-extend every block table over the window at the DEVICE context
        # (host context + dispatched, unretired tokens).  No preemption: it
        # would free blocks a lagged window still writes; on OOM the pipeline
        # drains and the preempting synchronous path serves this iteration.
        for seq in active:
            # clamp at max_len: a lane the host is about to LENGTH-finish can
            # have windows in flight past the end, whose tokens are dropped
            dev_ctx = min(seq.context_len + seq.inflight_tokens, self.max_len)
            if self.scheduler.try_slots_at(seq, dev_ctx, steps,
                                           max_pos=self.max_len - 1) is None:
                self._sync_pipeline()
                return self._run_plain_decode(seqs)

        token_ids = np.zeros((lanes,), np.int32)
        use_fb = np.zeros((lanes,), bool)  # idle lanes read token 0, as synchronous ones
        context_lens = np.zeros((lanes,), np.int32)
        for seq in active:
            context_lens[seq.lane] = min(seq.context_len + seq.inflight_tokens, self.max_len)
            token_ids[seq.lane] = seq.all_token_ids[-1]
            use_fb[seq.lane] = prev is not None
        self._decode_tables(active)
        if timing:
            t = self._phase("decode.schedule", t)
        self._device_sampling_tail(active)
        d = self._decode
        # token feedback: this window's input IS the last window's output
        # on the device; the host never waits for the tokens it dispatches
        d.window.upload({"tokens": token_ids, "use_fb": use_fb, "lens": context_lens})
        if timing:
            t = self._phase("decode.upload", t)
        d.run(any(self._sampled(s) for s in active))
        if timing:
            t = self._phase("decode.dispatch", t)
        host_tokens, host_lps, event = self._readback(d.out_tokens, d.out_lps)
        for seq in active:
            seq.inflight_tokens += steps
        self._inflight = _InflightWindow(
            tokens=host_tokens, lps=host_lps, event=event, active=list(active),
            lane_ids=[s.lane for s in active], steps=steps,
        )
        self._overlap_windows += 1
        self._decode_steps_total += steps
        self._count_window(len(active) * steps, int(context_lens.sum()) * steps, steps)
        if prev is not None:
            self._retire_window(prev)

    # -- split prefill -------------------------------------------------------
    def _run_prefill(self, seq: Sequence) -> None:
        """One prefill forward for ``seq``: the whole prompt, or the window
        the scheduler planned over the already-written prefix (cached blocks
        and/or completed chunks), then the first token's sample when the
        window reaches the prompt's end."""
        if seq.mm_embeds is not None:
            raise NotImplementedError(
                "multimodal prefill comes with a later slice of the port "
                "(ROADMAP Queue 1 item 7)"
            )
        if seq.prefill_only:
            raise NotImplementedError(
                "disaggregated prefill comes with a later slice of the port "
                "(ROADMAP Queue 1 item 8)"
            )
        restore = self.allocator.take_restore_plan(seq.seq_id)
        if restore:
            try:
                self._restore_blocks(restore)
            except BaseException:
                # the plan must survive a failed restore: _fail_sequence →
                # free_sequence needs it to unregister the garbage landing
                # blocks and release the tier pins
                self.allocator.put_back_restore_plan(seq.seq_id, restore)
                raise
        cfg = self.config.model
        bs = self.config.block_size
        dev = self.device
        tokens = seq.all_token_ids
        n = len(tokens)
        blocks = self.allocator.block_ids(seq.seq_id)
        self._seed_lane_key(seq)
        seq.sampling_seeded = True
        lane = seq.lane
        # nonzero only on preemption recompute (the tokens include generated)
        gen_row = self._count_row(seq.output_ids)
        start = max(seq.prefilled_tokens, seq.cached_tokens)
        end = min(seq.chunk_target, n) if (
            self.chunk_tokens is not None and seq.chunk_target
        ) else n
        final = end >= n
        if start > 0 or not final:
            # continued prefill over the resident prefix (none at start 0:
            # an intermediate first chunk still needs its sample gate)
            tail = tokens[start:end]
            padded = np.zeros((self._bucket_len(len(tail)),), np.int32)
            padded[: len(tail)] = tail
            table_len = self.allocator.blocks_needed(self._bucket_len(min(n + 1, self.max_len)))
            full_ids = np.zeros((table_len,), np.int32)
            full_ids[: len(blocks)] = blocks
            tail_ids = np.zeros((table_len,), np.int32)
            tail_ids[: len(blocks) - start // bs] = blocks[start // bs:]
            logits, _ = self.family.forward_prefill_with_prefix(
                self.params, cfg, torch.from_numpy(padded).to(dev), self.cache,
                torch.from_numpy(full_ids).to(dev), torch.from_numpy(tail_ids).to(dev),
                len(tail), start, self.cos, self.sin,
            )
            prompt_row = self._count_row(seq.request.token_ids)
            fold = n
        else:
            padded = np.zeros((self._bucket_len(end),), np.int32)
            padded[:end] = tokens[:end]
            block_ids = np.zeros((self.max_blocks_per_seq,), np.int32)
            block_ids[: len(blocks)] = blocks
            logits, _ = self.family.forward_prefill(
                self.params, cfg, torch.from_numpy(padded).to(dev), self.cache,
                torch.from_numpy(block_ids).to(dev), end, 0, self.cos, self.sin,
            )
            # the reference counts the prompt's in-vocabulary ids (the
            # tokens include the generated ones on a recompute)
            ids = np.asarray(tokens[:end], np.int64)
            ids = ids[(ids >= 0) & (ids < cfg.vocab_size)]
            prompt_row = np.bincount(ids, minlength=cfg.vocab_size).astype(np.int32) - gen_row
            fold = end
        token, lp, top = self._prefill_sample(
            logits, seq, lane, prompt_row, gen_row, fold, 1 if final else 0
        )
        seq.prefilled_tokens = end
        self._count_prefill(start, end)
        self._step_weight_streams += 1
        if not final:
            # an intermediate chunk: K/V written, its sample discarded
            self.allocator.publish_stored(seq.seq_id, tokens[:end])
            return
        if seq.status == SeqStatus.PREFILLING:
            seq.status = SeqStatus.RUNNING
        self.allocator.publish_stored(seq.seq_id, tokens)
        self._process_token(seq, token, lp, top=top)

    def _prefill_sample(self, logits, seq, lane, prompt_row, gen_row, fold, gate):
        """The split prefill's sampling tail (one row): reseed the lane's
        penalty counts, penalties, logit bias, the sample with the lane's
        key folded with ``fold``, and ``gate`` added to the generated count
        of the sampled token (0 for an intermediate chunk)."""
        dev = self.device
        temp, top_k, top_p, greedy, pres, freq, rep, bias_ids, bias_vals = (
            torch.from_numpy(a).to(dev) for a in self._sampling_arrays([seq], [0], 1)
        )
        prompt_t = torch.from_numpy(prompt_row).to(dev)
        gen_t = torch.from_numpy(gen_row).to(dev)
        self._prompt_counts[lane] = prompt_t
        self._gen_counts[lane] = gen_t
        plogits = apply_penalties(logits[None], gen_t[None], prompt_t[None], pres, freq, rep)
        plogits = apply_logit_bias(plogits, bias_ids, bias_vals)
        noise = self._step_noise([seq], [0], 1, [fold], plogits.shape[-1])
        tokens = sample_tokens(plogits, noise, temp, top_k, top_p, greedy)
        lps = token_logprobs(plogits, tokens)
        top = None
        want = seq.request.sampling.top_logprobs
        if want > 0:
            vals, ids = topk_logprobs(plogits, min(want, plogits.shape[-1]))
            top = (vals[0].cpu().numpy(), ids[0].cpu().numpy())
        self._gen_counts[lane, tokens.long()] += gate
        return int(tokens[0]), float(lps[0]), top

    # -- decode: plain or speculative verify ---------------------------------
    def _run_decode(self, seqs: list[Sequence]) -> None:
        if self.spec_enabled:
            # draft first: the w-wide verify step only earns its keep when
            # enough lanes drafted (a non-drafting lane pays w positions'
            # logits for one token)
            running = [s for s in seqs if s.status == SeqStatus.RUNNING]
            drafts = {
                seq.seq_id: self._ngram_draft(seq.all_token_ids)
                for seq in running if self._spec_ok(seq)
            }
            n_drafting = sum(1 for d in drafts.values() if d)
            if n_drafting and n_drafting >= len(running) * SPEC_MIN_FRACTION:
                # verify consumes host drafts and gates emission by its
                # acceptance count: synchronous
                self._sync_pipeline()
                return self._run_verify_decode(seqs, drafts)
        if self._overlap_ok(seqs):
            return self._run_overlap_decode(seqs)
        self._sync_pipeline()
        return self._run_plain_decode(seqs)

    def _ngram_draft(self, tokens: list[int]) -> list[int]:
        """Prompt-lookup drafting: find the most recent earlier occurrence
        of the sequence's final ``spec_ngram`` tokens and propose the
        continuation that followed it (up to ``spec_tokens``)."""
        g = self.config.spec_ngram
        k = self.config.spec_tokens
        if len(tokens) < g + 1:
            return []
        # a bounded host scan: matches far behind the tail rarely help
        arr = np.asarray(tokens[-4096:], np.int64)
        tail = arr[-g:]
        # windows of width g ending strictly before the final position
        windows = np.lib.stride_tricks.sliding_window_view(arr[:-1], g)
        matches = np.flatnonzero((windows == tail).all(axis=1))
        if len(matches) == 0:
            return []
        j = int(matches[-1])  # the most recent prior occurrence
        return arr[j + g: j + g + k].tolist()

    def _spec_ok(self, seq: Sequence) -> bool:
        """Greedy verification is exact only for greedy, penalty-free
        sampling (logit_bias is static per lane and stays exact)."""
        s = seq.request.sampling
        greedy = bool(s.use_greedy or s.temperature is None or s.temperature <= 0.0)
        return (
            greedy
            and not s.presence_penalty
            and not s.frequency_penalty
            and (not s.repetition_penalty or s.repetition_penalty == 1.0)
        )

    def _run_verify_decode(self, seqs: list[Sequence], drafts: dict) -> None:
        """Speculative decode step: one forward over each lane's window (its
        last token, then its draft, padded to w = spec_tokens + 1), and the
        accepted prefix emitted."""
        lanes = self.config.max_batch_size
        w = self.config.spec_tokens + 1
        bs = self.config.block_size
        oob = self.config.num_blocks * bs
        candidates: list[Sequence] = []
        for seq in list(seqs):
            if seq.status != SeqStatus.RUNNING:
                continue
            # cover the whole window; rejected positions are rewritten later
            if self.scheduler.ensure_slots(seq, w, max_pos=self.max_len - 1) is None:
                self.scheduler.preempt(seq)
                continue
            candidates.append(seq)
        active = [s for s in candidates if s.status == SeqStatus.RUNNING]
        if not active:
            return
        token_mat = np.zeros((lanes, w), np.int32)
        slot_mat = np.full((lanes, w), oob, np.int32)
        context_lens = np.zeros((lanes,), np.int32)
        base_lens = np.zeros((lanes,), np.int32)
        spec_ok = np.zeros((lanes,), bool)
        for seq in active:
            lane = seq.lane
            draft = drafts.get(seq.seq_id) or []
            spec_ok[lane] = bool(draft)
            row = [seq.all_token_ids[-1]] + draft
            token_mat[lane] = (row + [row[-1]] * w)[:w]  # pads are never accepted unless equal
            blocks = self.allocator.block_ids(seq.seq_id)
            ctx = seq.context_len
            context_lens[lane] = ctx + w - 1
            # the key fold of a plain decode step at this context: a
            # sampled lane draws the same noise here as there
            base_lens[lane] = ctx
            for j in range(w):
                # positions past the engine's last clamp to it (the write
                # keeps the last of them); the lane finishes there
                pos = min(ctx - 1 + j, self.max_len - 1)
                slot_mat[lane, j] = blocks[pos // bs] * bs + pos % bs
        tables = self._decode_tables(active)
        dev = self.device
        token_dev = torch.from_numpy(token_mat).to(dev)
        context_dev = torch.from_numpy(context_lens).to(dev)
        logits, _ = self.family.forward_verify(
            self.params, self.config.model, token_dev, self.cache, tables, context_dev,
            torch.from_numpy(slot_mat).to(dev), self.cos, self.sin,
        )  # [lanes, w, vocab]
        tokens, n_accept, lps, top = self._verify_sample(
            logits, active, token_dev, context_dev, torch.from_numpy(spec_ok).to(dev),
            base_lens,
        )
        tokens_h = tokens.cpu().numpy()
        n_h = n_accept.cpu().numpy()
        lps_h = lps.cpu().numpy()
        tkv_h = tki_h = None
        if top is not None:
            tkv_h, tki_h = (x.cpu().numpy() for x in top)
        # attempted = the whole window of every drafting lane (pads can
        # accept too), so accepted <= drafted
        self._spec_drafted += int(spec_ok.sum()) * (w - 1)
        self._verify_steps += 1
        # one verify forward streams the weights once and computes w
        # positions a lane, each attending the lane's whole context
        self._count_window(len(active) * w, int(context_lens.sum()) * w, 1)
        for seq in active:
            lane = seq.lane
            n = int(n_h[lane])
            self._spec_accepted += max(0, n - 1)
            for i in range(n):
                if seq.status != SeqStatus.RUNNING:
                    break
                self._process_token(
                    seq, int(tokens_h[lane, i]), float(lps_h[lane, i]),
                    top=(tkv_h[lane, i], tki_h[lane, i]) if top is not None else None,
                )

    def _verify_sample(self, logits, seqs, token_mat, context_lens, spec_ok, base_lens):
        """The verify step's sampling tail: window position 0 through the
        full sampling machinery (the lane's key folded with its plain-decode
        context), later positions greedy after penalties and bias; the
        leading-match acceptance count per lane; the accepted tokens added
        to the generated counts.  Returns (tokens [lanes, w], n_accept
        [lanes], logprobs [lanes, w], top (vals, ids) [lanes, w, k] or
        None)."""
        lanes, w, vocab = logits.shape
        temp, top_k, top_p, greedy, pres, freq, rep, bias_ids, bias_vals = (
            torch.from_numpy(a).to(self.device)
            for a in self._sampling_arrays(seqs, [s.lane for s in seqs], lanes)
        )
        noise = self._step_noise(seqs, [s.lane for s in seqs], lanes, base_lens, vocab)
        want = max((s.request.sampling.top_logprobs for s in seqs), default=0)
        outs, lps, tops = [], [], []
        for i in range(w):
            li = apply_penalties(
                logits[:, i], self._gen_counts, self._prompt_counts, pres, freq, rep
            )
            li = apply_logit_bias(li, bias_ids, bias_vals)
            if i == 0:
                ti = sample_tokens(li, noise, temp, top_k, top_p, greedy)
            else:
                ti = torch.argmax(li, dim=-1).to(torch.int32)
            outs.append(ti)
            lps.append(token_logprobs(li, ti))
            if want > 0:
                tops.append(topk_logprobs(li, min(want, vocab)))
        tokens = torch.stack(outs, dim=1)
        # leading-match acceptance: window token i is kept iff every earlier
        # draft matched and it equals the model's output at position i - 1
        active = context_lens > 0
        acc = spec_ok & active
        n_accept = active.to(torch.int32)
        for i in range(1, w):
            acc = acc & (token_mat[:, i] == tokens[:, i - 1])
            n_accept = n_accept + acc.to(torch.int32)
        # generated counts of the accepted tokens only (a row may repeat an id)
        take = (torch.arange(w, device=self.device)[None, :] < n_accept[:, None]) & active[:, None]
        self._gen_counts.index_put_(
            (self._lane_idx[:, None].expand(lanes, w), tokens.long()),
            take.to(torch.int32), accumulate=True,
        )
        top = None
        if tops:
            top = (torch.stack([v for v, _ in tops], dim=1), torch.stack([k for _, k in tops], dim=1))
        return tokens, n_accept, torch.stack(lps, dim=1), top

    # -- KV offload tiers ----------------------------------------------------
    def _offload_blocks(self, pairs: list[tuple[int, int]]) -> list[int]:
        """Allocator eviction hook: copy the evicted blocks' cache slices to
        the offload tiers (device thread, before the new owners write): one
        gather-kernel launch a cache leaf into ``[L, n, ...]``, one copy into
        pinned host memory, a synchronize, then one ``put`` a block.  Returns
        hashes that failed to offload (host tier full of pins) — those must
        be announced removed."""
        ids = [bid for bid, _ in pairs]
        pinned = self.device.type == "cuda"
        gathered = {}
        for name in sorted(self.cache):
            staged = block_copy.gather_blocks(self.cache[name], ids, axis=1)
            if pinned:
                host = torch.empty(staged.shape, dtype=staged.dtype, pin_memory=True)
                host.copy_(staged, non_blocking=True)
                staged = host
            gathered[name] = staged
        if pinned:
            # the host bytes are read below: the copies must have landed
            # (which drains a window in flight: counted)
            self._offload_drains += self._inflight is not None
            torch.cuda.current_stream(self.device).synchronize()
        failed: list[int] = []
        # host-LRU evictions triggered by these puts are judged AFTER the
        # whole batch: a hash evicted mid-batch may be re-inserted by a
        # later put (no event), or end up in no tier (removed event)
        self._host_evictions = []
        try:
            for i, (_, h) in enumerate(pairs):
                content = {name: leaf[:, i] for name, leaf in gathered.items()}
                if not self.host_tier.put(h, content):
                    failed.append(h)
            for h in self._host_evictions:
                if (
                    not self.host_tier.has(h)
                    and not self.allocator.is_registered(h)
                    and h not in failed
                ):
                    failed.append(h)
        finally:
            self._host_evictions = None
        return failed

    def _host_evicted(self, seq_hash: int) -> None:
        """Offload-tier eviction observer.  During an offload batch the
        verdict is deferred to the end of the batch (a later put may
        re-insert the hash); outside a batch it is announced at once."""
        if self._host_evictions is not None:
            self._host_evictions.append(seq_hash)
            return
        if not self.allocator.is_registered(seq_hash):
            self.allocator.emit_removed([seq_hash])

    def _stage_restore(self, plan: list[tuple[int, int]]) -> tuple[list[int], dict]:
        """Read the plan's pinned blocks from the tiers (one batched read a
        tier, pins released) into host staging buffers ``[L, n, ...]`` a
        cache leaf, pinned on a card.  Returns (landing ids, buffers)."""
        n = len(plan)
        pinned = self.device.type == "cuda"
        staged = {
            name: torch.empty((leaf.shape[0], n, *leaf.shape[2:]), dtype=leaf.dtype,
                              pin_memory=pinned)
            for name, leaf in self.cache.items()
        }
        contents = self.host_tier.read_pinned_many([h for h, _ in plan])
        for i, (h, _) in enumerate(plan):
            content = contents.get(h)
            if content is None:
                raise RuntimeError(f"pinned offload block {h:#x} vanished from every tier")
            for name, arr in content.items():
                staged[name][:, i] = arr
        return [bid for _, bid in plan], staged

    def _restore_blocks(self, plan: list[tuple[int, int]]) -> None:
        """Land the plan's blocks from the offload tiers in their device
        blocks: stage on the host, one copy to the device and one
        scatter-kernel launch a cache leaf, then register the blocks."""
        t0 = time.perf_counter()
        ids, staged = self._stage_restore(plan)
        t1 = time.perf_counter()
        cuda = self.device.type == "cuda"
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record(stream)
        on_dev = {name: host.to(self.device, non_blocking=True) for name, host in staged.items()}
        if cuda:
            ev[1].record(stream)
        t2 = time.perf_counter()
        for name, blocks in on_dev.items():
            block_copy.scatter_blocks(self.cache[name], blocks, ids, axis=1)
        if cuda:
            ev[2].record(stream)
            # the staging buffers are released on return: their copies must
            # have landed first (which drains a window in flight: counted)
            self._offload_drains += self._inflight is not None
            stream.synchronize()
            copy_ms, scatter_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        else:
            copy_ms, scatter_ms = (t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3
        self._restore_ms["stage"] += (t1 - t0) * 1e3
        self._restore_ms["copy"] += copy_ms
        self._restore_ms["scatter"] += scatter_ms
        # content is on the device now: the landing blocks become matchable
        self.allocator.register_restored(plan)

    def _process_token(
        self, seq: Sequence, token: int, logprob: float | None = None, top=None,
    ) -> None:
        seq.output_ids.append(token)
        self._tokens_emitted += 1
        finish = seq.hit_stop(token)
        if finish is None and seq.context_len >= self.max_len:
            finish = FinishReason.LENGTH
        if seq.emit:
            top_rows = None
            want = seq.request.sampling.top_logprobs
            if top is not None and want > 0:
                vals, ids = top
                k = min(want, len(ids))
                top_rows = [[[int(ids[i]), float(vals[i])] for i in range(k)]]
            seq.emit(
                [token], finish,
                logprobs=None if logprob is None else [logprob],
                top_logprobs=top_rows,
            )
        if finish is not None:
            self._finish_decoded(seq)
        elif seq.context_len % self.config.block_size == 0:
            self.allocator.publish_stored(seq.seq_id, seq.all_token_ids)


def _to_device(tree, device):
    """A parameter tree on ``device`` (tensors and ``QuantizedMatrix``
    leaves)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
