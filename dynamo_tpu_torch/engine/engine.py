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
  in ``stats()``), and a family with no unified forward (Gemma-2, Gemma-3)
  keeps the split step throughout (``no_family_forward``);
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
  launch a leaf) instead of being recomputed; on a card the offloads and
  restores are queued behind the window in flight, never waited for.
  With a tier mounted the predictive prefetch pager (``prefetch``, on by
  default through ``DYN_PREFETCH``) pages hinted prefixes back between
  steps;
All steps end in the same sampling tail.

Decode overlaps by default (``decode_overlap``), as in the reference: a
decode-only window is dispatched with its input tokens fed back on the
device from the previous window's output, and the previous window is
retired (its tokens read back from pinned memory behind a CUDA event, and
emitted) while the new one runs; finishes found meanwhile release their
lane and blocks only when the window holding them retires.  Unified
windows take part in the pipeline the same way.  ``decode_steps = k`` fuses
k decode iterations into one window.  On a CUDA device every step without
a ``top_logprobs`` lane is one CUDA graph replay (``engine/graphs.py``):
the decode window; the unified step, one graph per token bucket, every
input at its bucket's fixed shape, as the reference compiles one program
per bucket; the split prefill, one graph per prefill key (whole prompt or
continued window, by bucket and table width); the verify window.
``warmup()`` captures them before serving (the split prefill's keys where
the split step is the engine's prefill path).  A unified window the graphs
cannot take (more admissions than seed slots, more tokens than the largest
bucket) is skipped by name to the split step, as the reference skips it.

The cache may hold a narrower float dtype than the model
(``kv_cache_dtype``: fp8 e4m3fn or e5m2, float16, ...; every write casts to
it, every kernel upcasts at load) and the projections may be int8
weight-only (``quantize="int8"``, ``ops/quant.py``); both keep the unified
step and its graphs.  Every scheduler iteration feeds the reference's
utilization accounting (``observability/``: tokens, attended context,
weight streams, emitted tokens) into ``stats()``'s MFU and bandwidth share.

Every loop iteration checks the ``engine.step`` fault seam and writes a
step record to the engine's flight recorder (preemptions, step errors and
unified-step fallbacks as events); a traced request gets ``engine.queue``,
``engine.prefill`` and ``engine.decode`` spans under its trace.

Guided JSON decoding (``output_format="json"``, after
``enable_guided_json``) masks every sampling tail with a row of the
resident ``[modes, vocab]`` admissible-token table, chosen by each lane's
host automaton (``llm/guided.py``); guided lanes take the split step and the
synchronous decode window, as the reference's do.  The disaggregation API
(``prefill_extract`` on a prefill engine; ``reserve_blocks``,
``inject_blocks``, ``generate_prefilled`` on a decode engine) moves a
prompt's KV blocks between engines: extraction gathers with the
block-gather kernel, injection scatters with the block-scatter kernel, both
queued on the stream behind the window in flight.  ``generate_multimodal``
takes a prompt's vision patch embeddings: its prefill runs whole on the
split step (``PrefillGraph`` key ``("mm", bucket)``: the embeddings spliced
before the text's token embeddings, the family's
``forward_prefill_embeds``), its blocks never publish, and its decode
tokens ride the decode and unified windows as any lane's.

On a mesh (``EngineConfig.mesh``: tp, ep, pp and sp) the engine is rank 0
of one process a rank (``engine/shard_worker.py``): it owns the only
scheduler and block manager and its own shard of the weights and the
cache, and every split prefill, decode, verify and multimodal forward is
broadcast to the shard workers, which run the same forward on their shards.
On a pp mesh the
decode is the family's pipelined one where it has one (GPipe microbatches
over the stages), and the prefills run the stages in turn; on an sp mesh
the llama family's prefills ring over the bucket's chunks, and every sp
rank runs the decode on its whole copy of the cache.  The unified step is
off there (slug ``mesh``, as the reference's), and the windows run
synchronously and eagerly: no overlap, no graph.  The verify runs rows 2
and 5 on each tp rank's head shard, where the reference runs XLA attention
on a mesh.  Guided JSON masks in rank 0's sampling tail.  Every offload,
restore, disaggregated extract and inject moves whole blocks
``[L, n, bs, KVH, D]`` (the reference's layout) on rank 0: the ``gather``
program assembles them from every rank's shard (row 6 on each), the
``scatter`` program sends each rank its slice (row 7 on each).  The
families without mesh forwards are refused on a mesh by name.

There is no attention fallback: on the card attention runs through the
hand-written kernels (``attention_impl="kernel"``) and a kernel that fails
to build or launch raises; on the CPU the kernel wrappers take their plain
versions (``"plain"``).
"""

from __future__ import annotations

import asyncio
import math
import queue as thread_queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable

import numpy as np
import torch

from dynamo_tpu_torch import native
from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.graphs import (
    DecodeGraph,
    PrefillGraph,
    StepGraphs,
    UnifiedGraph,
    VerifyGraph,
    launch_counters,
)
from dynamo_tpu_torch.engine.kv_manager import BlockAllocator, KvEvent, compute_block_hashes
from dynamo_tpu_torch.engine.scheduler import Scheduler
from dynamo_tpu_torch.engine.sequence import Sequence, SeqStatus
from dynamo_tpu_torch.llm.guided import JsonCursor, _modes_universe, build_for_tokenizer
from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.models.registry import get_family
from dynamo_tpu_torch.observability import (
    FlightRecorder,
    StepTelemetry,
    TraceContext,
    UtilizationTracker,
    get_recorder,
    model_cost,
)
from dynamo_tpu_torch.ops.kernels import block_copy
from dynamo_tpu_torch.ops.kernels import build as kernel_build
from dynamo_tpu_torch.ops.kernels import pack_page_meta
from dynamo_tpu_torch.ops.quant import is_quantized, quantize_params
from dynamo_tpu_torch.parallel.kv_transfer import StagedBlocks
from dynamo_tpu_torch.robustness.faults import ENGINE_STEP, FAULTS
from dynamo_tpu_torch.runtime.engine import Context, ResponseStream
from dynamo_tpu_torch.utils import knobs, profiling
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


def _round_chunk_tokens(chunk_tokens: int, block_size: int) -> int:
    """Chunk windows round UP to whole blocks."""
    return max(1, (chunk_tokens + block_size - 1) // block_size) * block_size


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
    # Predictive prefetch over the offload tiers (prefetch/): hinted
    # prefixes page disk→host→device between engine steps, bounded by a
    # device headroom reservation so prefetch can never preempt running
    # work, and hot prefixes pin host-resident.  None = DYN_PREFETCH env
    # (default on); only effective when an offload tier is mounted.
    # DYN_PREFETCH=0 (or False) restores fully demand-driven paging.
    prefetch: bool | None = None
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
    # Width of the per-lane OpenAI logit_bias rows (sparse {token: bias}
    # scattered onto the logits each step), fixed in every graph.  Requests
    # with more entries keep the largest-magnitude ones; 0 disables the
    # scatter (a request's logit_bias is then ignored), as in the reference.
    logit_bias_k: int = 64
    # Tensor, expert, pipeline and sequence parallelism (parallel/mesh.py):
    # the engine is rank 0 of a mesh of config.mesh.total() ranks, one
    # process a rank; ranks 1..N-1 are shard workers (engine/shard_worker.py)
    # it starts, or that joined the process group beforehand
    # (parallel/multihost.py).  None or one rank = no mesh.  Axes tp, ep, pp
    # and sp, checked as the reference checks them; dp is refused.
    mesh: Any = None
    # the mesh's process-group backend ("nccl" | "gloo"; None = nccl on
    # cards, gloo on the CPU, or DYN_MESH_BACKEND).  Ranks share a card
    # only over gloo named here or in the knob.
    mesh_backend: str | None = None

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
        event_sink: Callable[[KvEvent], None] | None = None,
    ):
        self.config = config
        cfg = config.model
        self.device = resolve_device(device)
        # the allocator's stored/removed/cleared events go to this sink (the
        # worker's KvEventPublisher); settable until start()
        self._event_sink = event_sink
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

        self.kv_cache_dtype = resolve_kv_cache_dtype(config.kv_cache_dtype) or cfg.dtype
        self.mesh = None
        self._mesh_leader = None
        # the reference's enable_prefix_caching, which the port has on
        # always but where an sp mesh turns it off (_check_mesh)
        self.prefix_caching = True
        mesh_cfg = config.mesh
        if mesh_cfg is not None and mesh_cfg.total() > 1:
            self._check_mesh(config)
            from dynamo_tpu_torch.engine.shard_worker import MeshLeader

            self._mesh_leader = MeshLeader.launch(mesh_cfg, device_type=self.device.type,
                                                  backend=config.mesh_backend)
            self.mesh = self._mesh_leader.mesh
            self.device = self.mesh.device
        dev = self.device
        if self.mesh is not None:
            from dynamo_tpu_torch.engine.shard_worker import CacheShards, MeshFamily, ShardSpec

            spec = ShardSpec(
                mesh=mesh_cfg, model_family=config.model_family, model=cfg,
                num_blocks=config.num_blocks, block_size=config.block_size,
                kv_cache_dtype=self.kv_cache_dtype, max_len=self.max_len, seed=config.seed,
                quantize=config.quantize, attention_impl=impl)
            try:
                self.params, self.cache, self.cos, self.sin = self._mesh_leader.build(
                    spec, self.family, params)
            except BaseException:
                self._mesh_leader.shutdown(timeout=5.0)
                raise
            # every step forward runs on all ranks through the leader
            self.family = MeshFamily(self.family, self._mesh_leader)
            self._shards = CacheShards(self.family, cfg, self.mesh, self.cache)
        else:
            if params is None:
                gen = torch.Generator(device=dev)
                gen.manual_seed(config.seed)
                params = self.family.init_params(cfg, gen, dev)
            self.params = self._maybe_quantize(_to_device(params, dev))
            self.cache = self.family.init_kv_cache(
                cfg, config.num_blocks, config.block_size, self.kv_cache_dtype, dev
            )
            self.cos, self.sin = self.family.make_rope_tables(cfg, dev, self.max_len)
            self._shards = None
        # the whole cache's leaves {name: (shape, dtype)}, the reference's
        # layout: what the offload tiers hold and the transfer wire carries
        # (on a mesh rank 0 holds only its shard of them)
        self.cache_shapes = {
            name: (self._shards.shapes[name] if self._shards else tuple(leaf.shape), leaf.dtype)
            for name, leaf in self.cache.items()}
        lanes = config.max_batch_size
        # per-lane sampling state: generated-token counts (presence/frequency
        # penalties) and prompt-token counts (repetition penalty scope), on
        # the device; per-lane raw threefry keys on the host
        self._gen_counts = torch.zeros((lanes, cfg.vocab_size), dtype=torch.int32, device=dev)
        self._prompt_counts = torch.zeros_like(self._gen_counts)
        self._lane_idx = torch.arange(lanes, device=dev)
        # guided decoding: the admissible-token table of every automaton
        # mode, allocated once (all true) so graphs captured before or
        # after set_guided read it at one address; set_guided copies into it
        self.guided_masks = None
        self._guided_strings: list[str] | None = None
        self._guided_eos: list[int] = []
        self._guided_requests = 0     # guided sequences admitted
        self._guided_completions = 0  # finished with a complete document
        self._guided_table = torch.ones((len(_modes_universe()), cfg.vocab_size),
                                        dtype=torch.bool, device=dev)
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

        # the perf flight recorder (observability/flight.py): a bounded ring
        # of step records and events (preemption, step_error,
        # unified_fallback), dumped on demand or on a step error;
        # DYN_FLIGHT=0 makes every hook a no-op
        self.flight = FlightRecorder(source="engine")
        self._flight_preemptions = 0  # the last preemption total recorded
        # unified-batch fallbacks: reason slug -> count (stats()), each
        # reason logged once per engine
        self._unified_fallbacks: dict[str, int] = {}
        self._unified_fallback_logged: set[str] = set()
        if config.decode_steps < 1:
            raise ValueError("decode_steps must be >= 1")
        if config.logit_bias_k < 0:
            raise ValueError("logit_bias_k must be >= 0")
        unified = config.unified_batch
        if unified and self.family.forward_unified is None:
            self._unified_skip("no_family_forward",
                               f"family {config.model_family!r} has no unified forward")
            unified = False
        elif unified and self.spec_enabled:
            self._unified_skip("speculative", "speculative lanes keep their verify route")
            unified = False
        elif unified and config.decode_steps > 1:
            self._unified_skip("multi_step_decode",
                               "fused multi-step decode windows cannot carry chunks")
            unified = False
        elif unified and self.mesh is not None:
            self._unified_skip("mesh", "multi-chip meshes keep the split step")
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
        if self.decode_overlap and self.mesh is not None:
            # a mesh step's collectives synchronise the host with every rank:
            # its windows run synchronously and eagerly
            self.decode_overlap = False
        self._inflight: _InflightWindow | None = None
        self._overlap_windows = 0     # windows dispatched with token feedback
        self._admission_drains = 0    # pipeline drains forced by a new lane
        self._offload_drains = 0      # windows in flight at a wait for a queued offload
        # the host values behind the sampling tail's device buffers: a
        # window uploads them only when they changed
        self._tail_cache: tuple | None = None
        # decode hot-loop phase accounting (DYN_ENGINE_PHASE_TIMING=1): wall
        # seconds and counts a phase, in stats()["phase_ms"]
        self._phase_timing = bool(knobs.get("DYN_ENGINE_PHASE_TIMING"))
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
        # the ragged kernel's layout: token-block size, worklist width and
        # pages a grid step (explicit knob > tuned row > heuristic default)
        self._resolve_kernel_layout(cfg)
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

        # the offload tiers below the device cache (G2 host → G3 disk → G4
        # remote): one payload a block, each leaf's [L, ...] slice
        self.host_tier = None
        self._host_evictions: list[int] | None = None
        # where restores spend their time: the tier reads into staging (host
        # clock), the copies to the device and the scatter kernels (CUDA
        # events on a card, the host clock on the CPU)
        self._restore_ms = {"stage": 0.0, "copy": 0.0, "scatter": 0.0}
        # the pager's restores, queued behind the window in flight on a card:
        # (events, staging buffers) each, kept until its scatters have run
        self._queued_restores: list[tuple[list, tuple]] = []
        # evictions offloading on a card: (pairs, host buffers, events) each,
        # put into the tiers once the last event has completed
        self._queued_offloads: list[tuple[list, dict, list]] = []
        self._offload_gather_ms = 0.0  # the offloads' gathers (CUDA events)
        # disaggregation: injects whose host-to-device copies are queued on
        # a card, (event, sources) each, kept until the event has run; and
        # the block ranges extracted and injected (the launch count of rows
        # 6-7 grows by one a cache leaf for each)
        self._queued_injects: list[tuple[Any, list]] = []
        self.extract_calls = 0
        self.inject_calls = 0
        self._landing = False         # _land_offloads is putting
        offload_sink = None
        if config.host_offload_blocks:
            from dynamo_tpu_torch.engine.offload import HostOffloadTier

            self.host_tier = HostOffloadTier(
                config.host_offload_blocks,
                {k: (shape[0], *shape[2:]) for k, (shape, _) in self.cache_shapes.items()},
                {k: dtype for k, (_, dtype) in self.cache_shapes.items()},
                disk_blocks=config.disk_offload_blocks,
                disk_path=config.disk_offload_path,
                remote_addr=config.remote_store_addr,
            )
            offload_sink = self._offload_blocks
            # a hash that left EVERY tier (fell off the bottom of the
            # G2→G3→G4 cascade) while no longer device-resident: routers
            # must forget it
            self.host_tier.evict_observer = self._host_evicted
            # a tier read of a hash whose offload is still queued lands the
            # queued offloads first
            self.host_tier.settle = self._settle_offloads
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
            config.num_blocks, config.block_size, enable_prefix_caching=self.prefix_caching,
            offload_sink=offload_sink, host_tier=self.host_tier,
            event_sink=self._sink_event,
        )
        # predictive prefetch: the pager and its device headroom (only with
        # an offload tier mounted: with nothing below the device cache there
        # is nothing to page in ahead of time)
        self.prefetch_pager = None
        self._prefetch_headroom_blocks = 0
        self._prefetch_failures = 0  # speculative restores that raised
        if self.host_tier is not None:
            from dynamo_tpu_torch.prefetch.hints import prefetch_enabled
            from dynamo_tpu_torch.prefetch.pager import PrefetchPager

            enabled = config.prefetch if config.prefetch is not None else prefetch_enabled()
            if enabled:
                self.prefetch_pager = PrefetchPager(
                    ttl_s=knobs.get("DYN_PREFETCH_TTL"),
                    blocks_per_step=knobs.get("DYN_PREFETCH_BLOCKS"),
                )
                self._prefetch_trace = TraceContext.new_root()
                self.allocator.prefetch_tracker = self.prefetch_pager
                self._prefetch_headroom_blocks = max(
                    self.allocator.watermark_blocks,
                    int(config.num_blocks * knobs.get("DYN_PREFETCH_HEADROOM")),
                )
            # nothing drains pin candidates without the pager, and
            # DYN_PREFETCH=0 must be bookkeeping-free demand paging
            self.host_tier.pin_enabled = self.prefetch_pager is not None
        self.scheduler = Scheduler(
            self.allocator, max_batch_size=lanes,
            prefill_chunk_tokens=self.chunk_tokens,
            bucket_cost=self._bucket_len,
            unified_batch=self.unified_batch,
        )
        self.scheduler.on_preempt = self._on_preempt
        self._iterations = 0
        self.warmup_s: float | None = None  # warmup()'s wall seconds
        # per-lane block-table host rows, rewritten only for lanes whose
        # block list changed; the device copy is uploaded only then
        self._bt_host = np.zeros((lanes, self.max_blocks_per_seq), np.int32)
        self._bt_lane_key: list = [None] * lanes
        self._bt_clean = False
        # the decode window's persistent inputs and its graphs; the unified
        # step reads its block tables, sampling tail and feedback too.  All
        # graphs share one memory pool (UnifiedGraph says why that is safe;
        # graphs.capture how it holds the largest step, not the sum)
        pool = torch.cuda.MemPool() if self.device.type == "cuda" else None
        self._decode = DecodeGraph(self, config.logit_bias_k, pool)
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
        # the split prefill's graphs, one a key it can take, and the verify
        # window's
        self._prefill = PrefillGraph(self, self._prefill_keys(), pool)
        self._verify = VerifyGraph(self, self._decode, pool) if self.spec_enabled else None
        if self.mesh is not None:
            # no CUDA graph holds a step whose collectives cross processes
            self._decode.eager = self._prefill.eager = True
            if self._verify is not None:
                self._verify.eager = True

        # thread plumbing
        self._profiler_trace_dir: str | None = None
        self._submit_q: thread_queue.Queue = thread_queue.Queue()
        # the keys of the sequences whose streams have not finished
        # (``_sequence_id``; added on the event loop, dropped at the final emit)
        self._live_seq_ids: set[str] = set()
        self._wake = threading.Event()
        self._stop = False
        self._thread: threading.Thread | None = None

    def _check_mesh(self, config: EngineConfig) -> None:
        """The reference's construction checks of a mesh (its engine.py:
        411-506, word for word; speculation on pp, :1026; offload without
        prefix caching, :933), and the refusal by name of a family without
        mesh forwards.  Where the reference turns prefix caching off (an sp
        mesh, a family whose continued prefill does not ring), the port
        turns its own off (``self.prefix_caching``) with the same warning."""
        mesh, cfg = config.mesh, config.model
        if mesh.dp > 1:
            raise ValueError(
                f"dp={mesh.dp} is not an engine mesh axis: scale decode throughput by "
                "replicating workers behind the router (components/router_service.py), "
                "not by adding dp to one engine's mesh"
            )
        if not self.family.decode_accepts_tp_mesh:
            raise ValueError(
                f"family {config.model_family!r} serves on no mesh: "
                "its forwards take no mesh"
            )
        pp = mesh.pp
        if pp > 1:
            ep_ok = mesh.ep == 1 or (self.family.forward_decode_pp is not None
                                     and getattr(cfg, "num_experts", 0) > 1)
            if mesh.sp > 1 or not ep_ok:
                # name only the axes at fault
                offending = {}
                if not ep_ok:
                    offending["ep"] = mesh.ep
                if mesh.sp > 1:
                    offending["sp"] = mesh.sp
                raise ValueError(
                    f"pp={pp} composes with tp (all families) and ep "
                    f"(MoE families with a pipelined decode); got "
                    f"{offending} for family {config.model_family!r}"
                )
            if config.max_batch_size % pp:
                raise ValueError(
                    f"max_batch_size={config.max_batch_size} must be divisible "
                    f"by the pp axis ({pp}): pipeline microbatches split the "
                    "decode batch evenly"
                )
            if cfg.num_layers % pp:
                raise ValueError(
                    f"num_layers={cfg.num_layers} must be divisible by the "
                    f"pp axis ({pp}): layers split evenly into stages"
                )
        sp = mesh.sp
        if sp > 1 and getattr(cfg, "sliding_window", None):
            raise ValueError(
                "sliding-window attention is incompatible with an sp "
                "mesh: the ring path has no window mask yet"
            )
        if sp > 1 and not self.family.prefix_prefill_accepts_sp:
            if config.prefill_chunk_tokens is not None:
                raise ValueError(
                    "prefill_chunk_tokens is incompatible with an sp "
                    f"mesh for family {config.model_family!r}: its "
                    "continued-prefill path has no ring attention"
                )
            logger.warning(
                "sp mesh: disabling prefix caching (family %r's "
                "continued-prefill path does not run ring attention)",
                config.model_family,
            )
            self.prefix_caching = False
        if sp > 1:
            bad = [b for b in self.buckets if b % sp]
            if bad:
                raise ValueError(
                    f"prefill buckets {bad} not divisible by the sp axis "
                    f"({sp}): ring attention shards the sequence evenly"
                )
            if config.prefill_chunk_tokens is not None:
                rounded = _round_chunk_tokens(config.prefill_chunk_tokens, config.block_size)
                if rounded % sp:
                    raise ValueError(
                        f"prefill_chunk_tokens (block-rounded to {rounded}) "
                        f"must be divisible by the sp axis ({sp}): chunk "
                        "windows ring-shard the sequence evenly"
                    )
        if config.speculative and pp > 1:
            raise ValueError("speculative decoding does not support pp meshes")
        if config.speculative and not self.family.verify_accepts_mesh:
            raise ValueError(
                f"family {config.model_family!r} verifies on no mesh: its verify forward "
                "takes no mesh")
        if config.host_offload_blocks and not self.prefix_caching:
            raise ValueError(
                "KV offload tiers configured but unusable: "
                "this model family/config has no prefix caching")
        for name in ("num_heads", "num_kv_heads"):
            n = getattr(cfg, name, None)
            if n is not None and n % mesh.tp:
                raise ValueError(f"{name}={n} is not divisible by the tp axis ({mesh.tp})")
        # the quantize mode's refusals (an unknown mode, a family without
        # quant leaves): the ranks quantize each leaf as it arrives
        self._maybe_quantize({})

    def mesh_counts(self) -> list[dict]:
        """Every rank's kernel launch counters ({"module.counter": n}), in
        rank order; rank 0's alone off a mesh."""
        if self._mesh_leader is None:
            from dynamo_tpu_torch.engine.shard_worker import _counts

            return [_counts()]
        return self._mesh_leader.counts()

    def zero_mesh_counts(self) -> None:
        """Every rank's kernel launch counters to 0."""
        if self._mesh_leader is None:
            from dynamo_tpu_torch.engine.shard_worker import _zero_counts

            _zero_counts()
            return
        self._mesh_leader.zero_counts()

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
        # DYN_PROFILER_TRACE_DIR: a trace of the whole serve window, written
        # in stop() by whichever engine started it
        self._profiler_trace_dir = profiling.maybe_start_trace_from_env()
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
        if self._profiler_trace_dir is not None:
            profiling.maybe_stop_trace()
            self._profiler_trace_dir = None
        if self.host_tier is not None:
            self.host_tier.close()  # release + delete the G3 memmap
        if self._mesh_leader is not None:
            self._mesh_leader.shutdown()  # stop and join every shard worker
            self._mesh_leader = None

    # -- async engine interface -------------------------------------------
    async def warmup(self, prompt_lens=None) -> None:
        """Capture every serving graph before the first request, as the
        reference's ``warmup`` / ``aot_precompile`` compile every serving
        program: the unified step's graph of every reachable token bucket
        (noise drawn and not), the decode window's two graphs, the verify
        window's two on a speculative engine and, where the split step is
        the engine's prefill path (the unified step off), the split
        prefill's graph of every key it can take (``_prefill_keys``), or
        of every key ``prompt_lens`` reach, as the reference's
        ``aot_precompile(prompt_lens)``.  Unlike a compiled program, a
        graph keeps its step's memory: by default a key whose activations
        (``PrefillGraph.key_bytes``) exceed the device memory free at
        warmup (with the pool's free blocks) is left to its first use
        (``prefill_graph_keys_deferred``); ``prompt_lens`` warms every key
        it reaches.  With the unified step on the split prefill serves
        only the windows the unified step skips; its keys are captured at
        first use.  A capture at first use is counted
        (``prefill_graphs_captured_after_warmup``).  On the CPU each step
        runs once with nothing live.  The captures write nothing live; the
        prefix registry is flushed after all the same, as the reference
        flushes after its warmup requests, so no warmup state reaches
        serving.  Runs on the device thread once the engine is started,
        else in the caller's.  A capture that fails raises."""
        if self._thread is None:
            self._warm_graphs(prompt_lens)
            return
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._submit_q.put(("warmup", (prompt_lens, self._resolver(fut))))
        self._wake.set()
        await fut

    def _warm_graphs(self, prompt_lens=None) -> None:
        t0 = time.perf_counter()
        if self.mesh is not None:
            # a mesh runs its steps eagerly: there is no graph to capture
            self.warmup_s = 0.0
            logger.info("warmup: nothing to capture on a mesh (eager steps)")
            return
        self._sync_pipeline()
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if self._unified is not None:
            self._unified.warm()
        self._decode.warm()
        budget = None
        if prompt_lens is None and self.device.type == "cuda":
            torch.cuda.empty_cache()
            budget = (torch.cuda.mem_get_info(self.device)[0]
                      + torch.cuda.memory_reserved(self.device)
                      - torch.cuda.memory_allocated(self.device))
        self._prefill.warm([] if self.unified_batch else self._prefill_keys(prompt_lens),
                           budget)
        if self._verify is not None:
            self._verify.warm()
        self.allocator.clear_published()
        self.warmup_s = time.perf_counter() - t0
        stats = self.stats()
        logger.info("warmup: %d unified, %d decode, %d prefill (%d keys left to first use) "
                    "and %d verify graphs in %.1f s",
                    stats["unified_graphs_captured"], stats["decode_graphs_captured"],
                    stats["prefill_graphs_captured"], stats["prefill_graph_keys_deferred"],
                    stats["verify_graphs_captured"], self.warmup_s)

    def _prefill_keys(self, prompt_lens=None) -> list[tuple]:
        """Every key ``_run_prefill`` can take for ``prompt_lens`` (default:
        every length the engine holds), by the reference's
        ``aot_precompile`` rule (dynamo_tpu/engine/engine.py:2095-2135): a
        whole prompt at its bucket (within the chunk budget when chunking),
        a continued window at every bucket up to the longest window (a
        chunk, or with chunking off a prefix hit's tail past one cached
        block) at the prompt's table width.  The reference compiles a
        prefix hit of an unchunked engine at first use; prefix caching is
        always on here, so it is warmed."""
        bs, chunk = self.config.block_size, self.chunk_tokens
        keys = set()
        lens = range(1, self.max_len) if prompt_lens is None else (
            min(int(n), self.max_len - 1) for n in prompt_lens)
        for n in lens:
            table_len = self.allocator.blocks_needed(self._bucket_len(min(n + 1, self.max_len)))
            longest = min(n, chunk) if chunk is not None else n - bs
            if longest >= 1:
                cap = self._bucket_len(longest)
                keys.update(("prefix", b, table_len) for b in self.buckets if b <= cap)
            if chunk is None or n <= chunk:
                keys.add(("prefill", self._bucket_len(n)))
        return sorted(keys)

    # -- guided decoding ---------------------------------------------------
    def enable_guided_json(self, tokenizer) -> None:
        """Install the compiled JSON admissible-token table for guided
        requests (``output_format="json"``).  The table lives at a fixed
        address, so graphs captured before this call read it too.

        Model vocabularies are often padded past the tokenizer's; padding
        columns are masked False (a padded id is never a valid JSON
        continuation)."""
        masks, strings = build_for_tokenizer(tokenizer)
        self.set_guided(masks, strings, tokenizer.eos_token_ids)

    def set_guided(self, masks, strings: list[str], eos_ids: list[int]) -> None:
        """Lower-level install (tests / pre-built tables): copied in place
        into the resident table."""
        vocab = self.config.model.vocab_size
        table = np.zeros((masks.mask.shape[0], vocab), bool)
        table[:, : masks.mask.shape[1]] = masks.mask[:, :vocab]
        self.guided_masks = masks
        self._guided_strings = strings
        self._guided_eos = list(eos_ids)
        self._guided_table.copy_(torch.from_numpy(table))

    def _make_guided_cursor(self, output_format: str):
        """Validate a guided request against this deployment and return a
        fresh cursor — loud 400-class errors beat silently-unconstrained
        output the client believes is schema-guaranteed."""
        if output_format not in ("json", "json_object"):
            raise ValueError(
                f"unsupported output_format {output_format!r} (want 'json')"
            )
        if self.guided_masks is None:
            raise ValueError(
                "guided JSON decoding is not enabled on this worker "
                "(engine.enable_guided_json(tokenizer) at serve time)"
            )
        if self.config.decode_steps > 1:
            # the fused window feeds tokens back on the device; the automaton
            # advances on the host between windows, so the mask would lag
            # the generated text by up to decode_steps-1 tokens
            raise ValueError(
                "guided JSON decoding requires decode_steps=1 "
                f"(engine runs fused decode_steps={self.config.decode_steps})"
            )
        if self.spec_enabled:
            # the verify step samples the whole draft window with one mask
            # state; drafts would need per-position automaton advances
            raise ValueError(
                "guided JSON decoding does not compose with speculative "
                "decoding on this engine"
            )
        # count AFTER validation: rejected requests are not "admitted"
        self._guided_requests += 1
        return JsonCursor(self.guided_masks, self._guided_strings, eos_ids=self._guided_eos)

    @staticmethod
    def _guided_mode(seq: Sequence) -> int:
        """The lane's mask-table row: -1 (all tokens allowed) when the
        sequence is unguided or its cursor bailed out."""
        return -1 if seq.guided is None else seq.guided.mode_id

    async def generate(self, request: Context[dict]) -> ResponseStream[dict]:
        if request.data.get("image") is not None or request.data.get("video") is not None:
            raise ValueError("this model deployment does not accept image/video input")
        pre = PreprocessedRequest.from_wire(request.data)
        ctx = request.ctx
        if len(pre.token_ids) >= self.max_len:
            raise ValueError(
                f"prompt length {len(pre.token_ids)} exceeds engine max length {self.max_len}"
            )
        seq = Sequence(seq_id=self._sequence_id(ctx), request=pre)
        seq.trace = getattr(ctx, "trace", None)
        if pre.output_format is not None:
            seq.guided = self._make_guided_cursor(pre.output_format)
        return self._start_sequence(seq, ctx)

    async def generate_multimodal(self, request: Context[dict], embeds) -> ResponseStream[dict]:
        """Generate with vision patch embeddings spliced before the text
        prompt (LLaVA-style).  ``embeds``: [n_patches, hidden] float array
        from the vision encoder's projector.  The prefill runs whole on the
        split step (``PrefillGraph`` key ``("mm", bucket)``); its blocks never
        publish (text-token hashes cannot describe patch content).  On a
        mesh every rank splices the embeddings (``embeds`` program)."""
        if self.family.forward_prefill_embeds is None:
            raise ValueError(
                f"model family {self.config.model_family!r} has no multimodal prefill"
            )
        pre = PreprocessedRequest.from_wire(request.data)
        ctx = request.ctx
        embeds = np.asarray(embeds, np.float32)
        if embeds.ndim != 2 or embeds.shape[1] != self.config.model.hidden_size:
            raise ValueError(
                f"embeds shape {embeds.shape} != [n, {self.config.model.hidden_size}]"
            )
        if len(pre.token_ids) + len(embeds) >= self.max_len:
            raise ValueError(
                f"prompt ({len(pre.token_ids)} text + {len(embeds)} patches) "
                f"exceeds engine max length {self.max_len}"
            )
        seq = Sequence(seq_id=self._sequence_id(ctx), request=pre, mm_embeds=embeds)
        seq.trace = getattr(ctx, "trace", None)
        if pre.output_format is not None:
            # a guided multimodal request on a deployment that cannot
            # constrain it fails as generate()'s does (the mm step applies
            # the mask row)
            seq.guided = self._make_guided_cursor(pre.output_format)
        return self._start_sequence(seq, ctx)

    @staticmethod
    def _resolver(fut: asyncio.Future):
        """A callback the device thread calls with a result or an exception
        to resolve ``fut`` on its event loop (a second call is ignored)."""
        loop = fut.get_loop()

        def from_thread(result=None) -> None:
            def resolve() -> None:
                if fut.done():
                    return
                if isinstance(result, BaseException):
                    fut.set_exception(result)
                else:
                    fut.set_result(result)

            loop.call_soon_threadsafe(resolve)

        return from_thread

    def _sequence_id(self, ctx) -> str:
        """The key of a new sequence: the request's id, or a fresh one where
        the request has none or a live sequence of this engine holds it.  A
        stream resumed after its worker died and a migration's pre-admitted
        copy of the same request can both land on one engine; under one key
        the first to end would free the other's blocks (the reference keys
        by ``ctx.id`` alone)."""
        seq_id = ctx.id
        if not seq_id or seq_id in self._live_seq_ids:
            seq_id = uuid.uuid4().hex
        self._live_seq_ids.add(seq_id)
        return seq_id

    def _start_sequence(self, seq: Sequence, ctx, first=None) -> ResponseStream[dict]:
        """Wire the emit callback, submit to the device thread, watch for
        cancellation.  ``first`` (token, logprob, top logprobs): a token the
        prefill worker sampled, emitted as the stream's first item; a
        sequence it finishes is freed instead of submitted."""
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
                self._live_seq_ids.discard(seq.seq_id)
                loop.call_soon_threadsafe(out_q.put_nowait, None)

        seq.emit = emit
        finish = None
        if first is not None:
            token, lp, top = first
            finish = seq.hit_stop(token)
            emit([token], finish, logprobs=None if lp is None else [lp],
                 top_logprobs=None if top is None else [top])
        if finish is None:
            self._submit_q.put(("add", seq))
            self._wake.set()
        else:
            self.allocator.free_sequence(seq.seq_id)

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

    # -- disaggregation API ------------------------------------------------
    async def prefill_extract(
        self, pre: PreprocessedRequest, *, device: bool = False, on_chunk=None,
    ) -> tuple[int, float, list | None, dict, int]:
        """Prefill-worker side: run prefill only, return (first_token,
        first_token_logprob, first_token_top_logprobs, blocks, n_blocks).
        ``blocks`` is the cache pytree restricted to the sequence's blocks,
        e.g. llama ``{"k": [L, n, bs, kvh, d], "v": ...}``, gathered by the
        block-gather kernel: host tensors by default (on a card a
        ``StagedBlocks`` whose pinned copies may still be queued: its
        ``ready`` event says when they landed), device tensors with
        ``device=True`` (the same-process path: no host staging).

        ``on_chunk`` (streamed transfer): called from the DEVICE thread as
        ``on_chunk(start_block, leaves, count)`` for each run of
        fully-written blocks after an intermediate prefill chunk, while
        later chunks still compute; it must not block.  The final return
        then carries only the TAIL blocks past the streamed watermark
        (``n_blocks`` stays the sequence total).  Without chunked prefill
        the call is the single-shot contract.  On a mesh the blocks are
        whole (every rank's shard gathered to rank 0: ``device=True`` keeps
        them on rank 0's card)."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        seq = Sequence(
            seq_id=uuid.uuid4().hex, request=pre, prefill_only=True,
            extract_device=device,
        )
        seq.on_chunk_done = on_chunk
        if pre.output_format is not None:
            # constrain the FIRST sampled token on the prefill side so the
            # decode worker's cursor (generate_prefilled) accepts it
            seq.guided = self._make_guided_cursor(pre.output_format)
        seq.on_prefill_done = self._resolver(fut)
        self._submit_q.put(("add", seq))
        self._wake.set()
        return await fut

    def reserve_blocks(self, num_tokens: int) -> list[int] | None:
        return self.allocator.reserve_blocks(num_tokens)

    def release_blocks(self, block_ids: list[int]) -> None:
        self.allocator.release_blocks(block_ids)

    async def inject_blocks(self, block_ids: list[int], blocks: dict) -> None:
        """Decode-worker side: write transferred KV blocks (a cache pytree
        of host or device tensors) into the cache with the block-scatter
        kernel, on the device thread (serialized with the steps); on a mesh
        whole blocks, each rank's slice scattered into its shard."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._submit_q.put(("inject", (list(block_ids), blocks, self._resolver(fut))))
        self._wake.set()
        await fut

    async def generate_prefilled(
        self, request: Context[dict], block_ids: list[int], first_token: int,
        first_token_logprob: float | None = None,
        first_token_top_logprobs: list | None = None,
    ) -> ResponseStream[dict]:
        """Decode-worker side: start decoding a sequence whose prompt KV was
        injected into ``block_ids`` and whose first token was already
        sampled by the prefill worker."""
        pre = PreprocessedRequest.from_wire(request.data)
        ctx = request.ctx
        loop = asyncio.get_running_loop()
        out_q: asyncio.Queue = asyncio.Queue()
        seq = Sequence(seq_id=self._sequence_id(ctx), request=pre, remote_prefilled=True)
        seq.trace = getattr(ctx, "trace", None)
        if pre.output_format is not None:
            # the remote prefill worker sampled first_token: advance a fresh
            # cursor over it.  A guided-enabled prefill worker always hands
            # over an admissible token; an unconstrained one can hand over
            # anything, an early EOS included — refuse loudly.  On refusal
            # the caller's reserved landing blocks must not leak: adopt and
            # free returns them to the pool before raising.
            cursor = None
            try:
                cursor = self._make_guided_cursor(pre.output_format)
                cursor.advance(first_token)
                if cursor.failed or (
                    first_token in self._guided_eos and not cursor.complete
                ):
                    raise ValueError(
                        "guided JSON decoding over disaggregated prefill "
                        "needs a guided-enabled prefill worker: the "
                        "remotely sampled first token is not a valid JSON "
                        "start"
                    )
            except ValueError:
                if cursor is not None:
                    # the cursor was admitted-counted, then rejected
                    self._guided_requests -= 1
                self.allocator.adopt_sequence(seq.seq_id, block_ids)
                self.allocator.free_sequence(seq.seq_id)
                raise
            seq.guided = cursor
            if cursor.complete:
                # a single token closed the whole document: count it here
                # (_process_token sees only later tokens)
                self._guided_completions += 1
        seq.output_ids.append(first_token)
        self.allocator.adopt_sequence(seq.seq_id, block_ids)
        return self._start_sequence(
            seq, ctx, first=(first_token, first_token_logprob, first_token_top_logprobs))

    async def clear_kv_blocks(self) -> None:
        """Admin flush: drop published prefix-cache state and the offload
        tiers' blocks (runs on the device thread to serialize with the
        allocator)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def done() -> None:
            loop.call_soon_threadsafe(lambda: fut.set_result(None) if not fut.done() else None)

        self._submit_q.put(("clear_kv", done))
        self._wake.set()
        await fut

    # -- predictive prefetch ------------------------------------------------
    def prefetch_hint(self, block_hashes: list[int], *, source: str = "arrival") -> bool:
        """Announce a prefix expected to be requested soon (thread-safe;
        called by the worker's PrefetchListener from the asyncio thread).
        The device loop pages the hinted blocks disk→host→device between
        steps.  Returns False when prefetch is off or there is nothing new
        to queue."""
        if self.prefetch_pager is None:
            return False
        queued = self.prefetch_pager.submit(block_hashes, source=source)
        if queued:
            self._wake.set()
        return queued

    def _sink_event(self, event: KvEvent) -> None:
        if self._event_sink is not None:
            self._event_sink(event)

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
            # flight-recorder summary (ring occupancy and dump bookkeeping)
            **self.flight.stats(),
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
            "guided_requests_total": self._guided_requests,
            "guided_completions_total": self._guided_completions,
            "decode_windows_overlapped_total": self._overlap_windows,
            "decode_windows_sync_total": self._sync_windows,
            "decode_windows_unified_total": self._unified_windows,
            "admission_drains_total": self._admission_drains,
            # waits for the device while a window was in flight (each one
            # drains it): a tier read of a block whose queued offload had
            # not landed
            "offload_drains_total": self._offload_drains,
            # reason slug -> windows (or the engine init) that fell back
            # from the unified step to the split step
            "unified_fallbacks": dict(self._unified_fallbacks),
            # the ragged kernel's resolved layout (source: knob / tuned /
            # default), and the windows whose worklist outgrew a tuned width
            # and were repacked at the full width
            "kernel_config": dict(self._kernel_config),
            "unified_ps_overflows_total": self._unified_ps_overflows,
            "decode_steps_total": self._decode_steps_total,
            "num_preemptions_total": self.scheduler.preemptions_total,
            "tokens_emitted_total": self._tokens_emitted,
            "preempted_tokens_total": self.scheduler.preempted_tokens_total,
            # recomputed after preemption or drafted and rejected: compute
            # that bought no token a client received
            "wasted_tokens_total": (self.scheduler.preempted_tokens_total
                                    + max(0, self._spec_drafted - self._spec_accepted)),
            "attention_impl": self.attention_impl,
            "kv_cache_dtype": str(self.kv_cache_dtype).removeprefix("torch."),
            "quantize": self.config.quantize,
            "warmup_s": self.warmup_s,
            "device": str(self.device),
            # the card's name (a worker process reports the card it runs on)
            "device_name": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else self.device.type),
            # the kernel wrappers' launch and plain-call counters (process
            # wide: a worker serves one engine), so a caller in another
            # process reads what the path launched
            "kernel_launches": {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": n
                                for (mod, name), n in launch_counters().items()},
            # the native host codecs this process loaded and the data plane's
            # frame streams by decoder (process wide, as kernel_launches)
            "native_codecs": native.stats(),
            **self._decode.stats(),
            **(self._unified.stats() if self._unified is not None
               else {**StepGraphs.zero_stats("unified"),
                     "unified_full_width_graphs_captured": 0}),
            **self._prefill.stats(),
            **(self._verify.stats() if self._verify is not None
               else StepGraphs.zero_stats("verify")),
        }
        if self._mesh_leader is not None:
            # the mesh this engine is rank 0 of, and its steps run on every
            # rank (each one a step broadcast)
            out["mesh"] = {"tp": self.mesh.config.tp, "ep": self.mesh.config.ep,
                           **{a: getattr(self.mesh.config, a) for a in ("pp", "sp")
                              if getattr(self.mesh.config, a) > 1},
                           "ranks": self.mesh.world_size, "backend": self.mesh.backend}
            out["mesh_steps_total"] = self._mesh_leader.steps
            # rank 0's wall seconds a program's steps took, and of those its
            # seconds in collectives, stage hand-offs and ring rotations
            out["mesh_step_time"] = {k: dict(v) for k, v in self._mesh_leader.step_time.items()}
        if self.host_tier is not None:
            out.update(self.host_tier.stats())
            out["offload_tiers"] = self.host_tier.tiers_snapshot()
            out.update({f"restore_{k}_ms_total": v for k, v in self._restore_ms.items()})
            if self.device.type == "cuda":  # CUDA events: measured on a card only
                out["offload_gather_ms_total"] = self._offload_gather_ms
        if self.prefetch_pager is not None:
            out.update(self.prefetch_pager.stats())
            # speculative restores that raised and were aborted (best-effort,
            # as the reference's)
            out["prefetch_restore_failures_total"] = self._prefetch_failures
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
                # chaos seam: an injected step failure exercises the loop's
                # keep-alive catch below (the thread survives, requests go on)
                FAULTS.check(ENGINE_STEP)
                # queued offloads and restores whose copies have landed: the
                # offloads enter the tiers, the restores' staging buffers go
                self._reap_queued()
                # evictions queued outside a device-thread mutator offload
                # here, before anything can write into the evicted blocks
                self.allocator.flush_offloads()
                self._drain_submissions()
                if self.prefetch_pager is not None and self.prefetch_pager.has_work():
                    # page hinted blocks up-tier between steps: a bounded
                    # slice when serving, full throttle when idle.  Progress
                    # while idle loops again at once: an idle engine's job
                    # is to page.
                    progress = self._run_prefetch(idle=not self.scheduler.has_work())
                    if progress and not self.scheduler.has_work():
                        continue
                if not self.scheduler.has_work():
                    if self._mesh_leader is not None:
                        self._mesh_leader.keepalive()
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
            except Exception as exc:  # noqa: BLE001 — scheduler-level bug: keep
                # the thread alive (callers would hang forever), don't hot-spin
                logger.exception("engine step failed")
                if self.flight.enabled:
                    self.flight.record_event("step_error", error=f"{type(exc).__name__}: {exc}")
                    self.flight.maybe_dump("step_error")
                time.sleep(0.1)
        # shutdown with a window in flight: retire it so its tokens reach
        # their streams; queued copies land before their buffers go
        try:
            self._sync_pipeline()
            self._reap_queued(wait=True)
        except Exception:  # noqa: BLE001
            logger.exception("pipeline drain at shutdown failed")

    def _observe_step(self, duration_s: float, emitted: int) -> None:
        """Feed the iteration's facts to the step telemetry, the
        utilization tracker and the flight recorder (the reference's
        engine.py:2352-2393)."""
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
        if not self.flight.enabled:
            return
        preempted = self.scheduler.preemptions_total
        if preempted > self._flight_preemptions:
            self.flight.record_event("preemption", count=preempted - self._flight_preemptions,
                                     total=preempted)
            self._flight_preemptions = preempted
        rates = self.utilization.rates()
        self.flight.record_step(
            iteration=self._iterations,
            num_running=self.scheduler.num_running,
            num_waiting=self.scheduler.num_waiting,
            kv_usage=self.allocator.usage,
            prefill_tokens=self._step_prefill_tokens,
            decode_tokens=self._step_decode_tokens,
            emitted_tokens=emitted,
            step_duration_s=duration_s,
            mfu=rates["mfu_perc"],
            goodput_tok_s=rates["goodput_tokens_per_second"],
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
            self._maybe_record_queue_span(seq)
            t_prefill = time.time()
            try:
                self._run_prefill(seq)
            except Exception as exc:  # noqa: BLE001
                logger.exception("prefill failed for %s", seq.seq_id)
                self._record_prefill_span(seq, t_prefill, status="error")
                self._fail_sequence(seq, exc)
            else:
                self._record_prefill_span(seq, t_prefill)
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

    def _resolve_kernel_layout(self, cfg) -> None:
        """The ragged kernel's layout, as the reference resolves it
        (dynamo_tpu/engine/engine.py: explicit ``DYN_AUTOTUNE_*`` knob >
        tuned kernel-perf row > heuristic default).  ``tb``: the flat token
        axis pads to whole blocks of this many tokens; ``ps``: the page
        worklist's one width a token bucket (``UnifiedGraph``'s), the full
        width ``tb x max_blocks_per_seq`` always fits, and a window whose
        worklist outgrows a tighter tuned width is repacked at the full
        width (``_run_unified``); ``pps``: pages a grid step, which the
        port's kernels accept and ignore.  A ``tb`` that does not divide
        every unified bucket, or that the family's kernel refuses, falls
        back to the default with a warning."""
        config = self.config
        tb_default = math.gcd(config.block_size, 8) or 1
        tuned = self._resolve_tuned_kernel_config(cfg)
        knob_tb = knobs.get("DYN_AUTOTUNE_TB")
        knob_ps = knobs.get("DYN_AUTOTUNE_PAGE_SLOTS")
        knob_pps = knobs.get("DYN_AUTOTUNE_PAGES_PER_STEP")
        tb = int(knob_tb or (tuned or {}).get("tb_tokens") or tb_default)
        if tb != tb_default and any(b % tb for b in self.buckets):
            logger.warning("kernel tb_tokens=%d does not divide unified buckets %s; "
                           "using heuristic default %d", tb, self.buckets, tb_default)
            tb = tb_default
        max_tb = self.family.unified_max_tb(cfg) if self.family.unified_max_tb else None
        if tb != tb_default and max_tb is not None and tb > max_tb:
            logger.warning("kernel tb_tokens=%d is refused by the %s family's unified "
                           "kernel (at most %d); using heuristic default %d",
                           tb, config.model_family, max_tb, tb_default)
            tb = tb_default
        tuned_fits = tuned is not None and int(tuned["tb_tokens"]) == tb
        pps = int(knob_pps or ((tuned or {}).get("pages_per_step") if tuned_fits else 0) or 1)
        ps_full = tb * self.max_blocks_per_seq
        pps = max(1, min(pps, ps_full))
        ps = int(knob_ps or ((tuned or {}).get("page_slots") if tuned_fits else 0) or ps_full)
        # the kernel's contract: page_slots is a positive multiple of
        # pages_per_step, the full width too
        ps = -(-max(pps, min(ps, ps_full)) // pps) * pps
        self._unified_tb = tb
        self._unified_ps = ps
        self._unified_pps = pps
        self._unified_ps_full = -(-ps_full // pps) * pps
        self._unified_ps_overflows = 0  # windows repacked at the full width
        if knob_tb or knob_ps or knob_pps:
            source = "knob"
        elif tuned_fits:
            source = "tuned"
        else:
            source = "default"
        self._kernel_config = {"tb_tokens": tb, "page_slots": ps, "pages_per_step": pps,
                               "source": source, "geometry": self._kernel_geometry}
        if source != "default":
            logger.info("unified kernel config (%s): tb_tokens=%d page_slots=%d "
                        "pages_per_step=%d", source, tb, ps, pps)

    def _resolve_tuned_kernel_config(self, cfg) -> dict | None:
        """The autotuned ragged-kernel row for this engine's (geometry,
        device kind, cache dtype) in the port's kernel-perf table
        (``ops/autotune.table_path``), or None.  Advisory, as the
        reference's: anything malformed degrades to None (the defaults),
        never to a startup crash, and ``DYN_AUTOTUNE=0`` skips the lookup.
        A table whose header says another platform than ``gpu``, or that it
        was recorded in interpret mode, is refused, loudly where
        ``DYN_KERNEL_PERF`` named it (an ignored explicit table must not
        look like tuning at work)."""
        self._kernel_geometry = None
        if knobs.get("DYN_AUTOTUNE") is False:
            return None
        try:
            from dynamo_tpu_torch.ops import autotune

            heads = int(getattr(cfg, "num_heads", 0) or 1)
            geom = autotune.Geometry(
                num_heads=heads,
                num_kv_heads=int(getattr(cfg, "num_kv_heads", 0) or heads),
                head_dim=int(getattr(cfg, "head_dim", 0) or getattr(cfg, "kv_lora_rank", 0)
                             or 128),
                block_size=self.config.block_size,
                lanes=self.config.max_batch_size,
                max_blocks_per_seq=self.max_blocks_per_seq,
            )
            self._kernel_geometry = geom.key
            table = autotune.load_table(autotune.table_path())
            refused = None
            if table.get("interpret"):
                refused = "recorded in interpret mode"
            elif table.get("platform", "gpu") != "gpu":
                refused = f"platform {table.get('platform')!r} is not gpu"
            if refused is not None:
                explicit = knobs.get("DYN_KERNEL_PERF")
                if explicit:
                    logger.warning("DYN_KERNEL_PERF=%s ignored (%s); using the "
                                   "heuristic kernel layout", explicit, refused)
                return None
            return autotune.resolve(
                table, geometry_key=geom.key, device_kind=autotune.device_kind(self.device),
                dtype=str(self.kv_cache_dtype).removeprefix("torch."),
            )
        except Exception as err:  # noqa: BLE001
            logger.warning("autotune table resolution failed: %s", err)
            return None

    def _unified_skip(self, reason: str, detail: str | None = None) -> None:
        """Count a fallback from the unified step under a reason slug, and
        log each reason once per engine."""
        self._unified_fallbacks[reason] = self._unified_fallbacks.get(reason, 0) + 1
        if self.flight.enabled:
            self.flight.record_event("unified_fallback", reason=reason)
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
        for seq in prefills:
            if seq.prefill_only or seq.mm_embeds is not None:
                # a disaggregated extract and a multimodal prefill keep
                # their split routes
                self._unified_skip("disagg_or_mm")
                return False
            if seq.guided is not None:
                self._unified_skip("guided")
                return False
        if any(seq.guided is not None for seq in decodes):
            self._unified_skip("guided")
            return False
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
            self._decode_started(seq)
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
            self._maybe_record_queue_span(seq)
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
        ug = self._unified
        sw = getattr(self.config.model, "sliding_window", None)
        full = False
        try:
            page_phys, page_lane, page_ord, page_count = pack_page_meta(
                token_lane, token_pos, self._bt_host, tb_tokens=tb, block_size=bs,
                page_slots=ug.page_slots, sliding_window=sw)
        except ValueError:
            if ug.full_slots <= ug.page_slots:
                raise
            # a tuned width too tight for this window's worklist: repack at
            # the full width (the bucket's one extra graph) instead of
            # failing the window
            self._unified_ps_overflows += 1
            full = True
            page_phys, page_lane, page_ord, page_count = pack_page_meta(
                token_lane, token_pos, self._bt_host, tb_tokens=tb, block_size=bs,
                page_slots=ug.full_slots, sliding_window=sw)
        # a family whose kernel balances its walk by a host plan makes it
        # here, once a step, for every layer
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
        }, plan, seeds, full=full)
        if timing:
            t = self._phase("decode.upload", t)
        # a window with a top_logprobs lane runs the step eagerly for its
        # K-wide rows; any other is its bucket's graph replay
        with profiling.annotate("unified_window"):
            wide = {"full": True} if full else {}
            top = ug.step(bucket, noise, top=want, **wide) if want else ug.run(bucket, noise, **wide)
        tokens, lps = ug.out_tokens, ug.out_lps
        if timing:
            t = self._phase("decode.dispatch", t)

        t_prefill = time.time()
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
            self._record_prefill_span(seq, t_prefill)
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

    # -- request spans (engine.queue / engine.prefill / engine.decode) ------
    def _record_prefill_span(self, seq: Sequence, start_ts: float,
                             status: str = "ok") -> None:
        """One span per prefill window (a chunked prefill shows every
        chunk).  The window that sampled the first token carries the
        engine-side TTFT (arrival → first sample), once a request: a
        preemption's recompute is not a first-token event."""
        if seq.trace is None:
            return
        # intermediate chunks leave the sequence PREFILLING
        final = seq.status is not SeqStatus.PREFILLING
        attrs = {"prefilled_tokens": seq.prefilled_tokens, "cached_tokens": seq.cached_tokens}
        if final and status == "ok" and not seq.ttft_recorded:
            seq.ttft_recorded = True
            attrs["ttft_s"] = max(0.0, time.time() - seq.arrival_ts)
        get_recorder().record("engine.prefill", seq.trace, start_ts, time.time(),
                              component="engine", status=status, attrs=attrs)

    def _on_preempt(self, seq: Sequence) -> None:
        """Scheduler preemption hook: close the victim's decode span and
        re-arm its queue span, which then measures the re-admission wait
        from the preemption instant (TTFT keeps ``arrival_ts``)."""
        self._record_decode_span(seq, status="preempted")
        if seq.trace is not None:
            seq.queue_span_recorded = False
            seq.queue_start_ts = time.time()

    def _maybe_record_queue_span(self, seq: Sequence) -> None:
        """One engine.queue span an admission: submission (or preemption)
        → the first step that put the sequence on the device."""
        if seq.trace is None or seq.queue_span_recorded:
            return
        seq.queue_span_recorded = True
        get_recorder().record(
            "engine.queue", seq.trace, seq.queue_start_ts or seq.arrival_ts, time.time(),
            component="engine",
            attrs={"prompt_tokens": seq.prompt_len, "cached_tokens": seq.cached_tokens},
        )

    def _decode_started(self, seq: Sequence) -> None:
        """At every decode dispatch: seed the lane's sampling state where
        the sequence skipped a local prefill (disaggregated decode side),
        and open its decode span at its first decode step."""
        if not seq.sampling_seeded:
            self._seed_lane_state(seq)
        if seq.decode_start_ts == 0.0:
            self._maybe_record_queue_span(seq)
            seq.decode_start_ts = time.time()

    def _record_decode_span(self, seq: Sequence, status: str = "ok") -> None:
        """Close the sequence's decode span (first decode step → finish; under
        the overlap the finish is found when its window retires)."""
        if seq.trace is None or seq.decode_start_ts == 0.0:
            return
        get_recorder().record(
            "engine.decode", seq.trace, seq.decode_start_ts, time.time(),
            component="engine", status=status, attrs={"tokens_out": len(seq.output_ids)},
        )
        seq.decode_start_ts = 0.0

    def _fail_sequence(self, seq: Sequence, exc: BaseException) -> None:
        """Terminate one sequence on an engine-side error: free its
        resources and resolve its caller with the failure."""
        self._record_decode_span(seq, status="error")
        self.scheduler.finish(seq)
        if seq.on_prefill_done:
            seq.on_prefill_done(exc)
        elif seq.emit:
            seq.emit([], FinishReason.ERROR, f"{type(exc).__name__}: {exc}")

    def _drain_submissions(self) -> None:
        while True:
            try:
                op, seq = self._submit_q.get_nowait()
            except thread_queue.Empty:
                return
            if op == "warmup":  # seq: the prompt lengths and the caller's callback
                prompt_lens, done = seq
                try:
                    self._warm_graphs(prompt_lens)
                except Exception as exc:  # noqa: BLE001 — the caller raises it
                    done(exc)
                else:
                    done(None)
            elif op == "clear_kv":  # seq: the caller's callback
                # retire the window in flight first: its deferred finishes
                # release their blocks before the published state is cleared,
                # not into a cleared pool after it; queued offloads land
                # before the tiers are cleared
                self._sync_pipeline()
                self._reap_queued(wait=True)
                cleared = self.allocator.clear_published()
                if self.host_tier is not None:
                    self.host_tier.clear()
                logger.info("cleared %d published kv block hashes", cleared)
                seq()
            elif op == "inject":  # seq: the landing ids, the blocks, the callback
                # evictions queued by the reservation for THIS inject (or any
                # other asyncio-thread mutator) offload before the inject
                # overwrites their blocks: their gathers are queued on the
                # stream ahead of its scatters
                self.allocator.flush_offloads()
                block_ids, blocks, done = seq
                try:
                    self._inject(block_ids, blocks)
                except Exception as exc:  # noqa: BLE001 — fail the caller,
                    # don't leave its future hanging
                    logger.exception("kv inject failed")
                    done(exc)
                else:
                    done()
            elif op == "add":
                # read BEFORE add: after add the new sequence itself makes
                # the scheduler busy
                backlog = self.scheduler.has_work()
                self.scheduler.add(seq)
                if self.prefetch_pager is not None and seq.mm_embeds is None and (
                    backlog or not self.allocator.can_allocate(len(seq.request.token_ids))
                ):
                    # queue-hint: while this sequence waits for admission its
                    # offloaded prefix pages in behind the current batch.  An
                    # idle engine with room admits it this same iteration, so
                    # hashing the prompt here would be duplicate work.
                    hashes = compute_block_hashes(seq.request.token_ids,
                                                  self.config.block_size)
                    if hashes:
                        self.prefetch_pager.submit(hashes, source="queued")
            elif op == "abort":
                if seq.status == SeqStatus.RUNNING:
                    # abort frees the lane's blocks: drain the pipeline first
                    # so no lagged window writes into storage the allocator
                    # is about to reclaim (only RUNNING lanes ride a window)
                    self._sync_pipeline()
                if seq.status != SeqStatus.FINISHED:
                    self._record_decode_span(seq, status="cancelled")
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
        kb = self.config.logit_bias_k
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

    def _seed_lane_state(self, seq: Sequence) -> None:
        """A lane's penalty counts and key for a sequence that entered
        decode without a local prefill (its KV injected), as the reference's
        ``_seed_lane_state``; the rows are copied behind the stream's queued
        work (pinned, no wait)."""
        lane = seq.lane
        for counts, ids in ((self._prompt_counts, seq.request.token_ids),
                            (self._gen_counts, seq.output_ids)):
            row = torch.from_numpy(self._count_row(ids))
            if self.device.type == "cuda":
                row = row.pin_memory().to(self.device, non_blocking=True)
            counts[lane].copy_(row)
        self._seed_lane_key(seq)
        seq.sampling_seeded = True

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
        # each lane's guided mode: a row of the resident table (-1: none)
        gmodes = np.full((lanes,), -1, np.int32)
        for seq in seqs:
            if self._sampled(seq):
                sampled[seq.lane] = 1.0
            gmodes[seq.lane] = self._guided_mode(seq)
        host = dict(zip(
            ("temp", "top_k", "top_p", "greedy", "pres", "freq", "rep", "bias_ids",
             "bias_vals"), arrays,
        ), keys=self._lane_keys.astype(np.int64), sampled=sampled, gmodes=gmodes)
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
            self._decode_started(seq)
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
        state: guided lanes advance a host automaton that must gate the
        NEXT sample (the reason guidance pins decode_steps=1), and
        top_logprobs lanes ship K-wide rows whose readback belongs on the
        synchronous path.  A mixed batch falls back whole."""
        if not self.decode_overlap:
            return False
        return not any(
            s.status == SeqStatus.RUNNING
            and (s.guided is not None or s.request.sampling.top_logprobs > 0)
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
            self._decode_started(seq)
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
        window reaches the prompt's end.  A multimodal prompt prefills whole:
        its patch embeddings fill positions [0, mm_len), its text follows."""
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
        tokens = seq.all_token_ids
        n = len(tokens)
        blocks = self.allocator.block_ids(seq.seq_id)
        self._seed_lane_key(seq)
        seq.sampling_seeded = True
        # nonzero only on preemption recompute (the tokens include generated)
        gen_row = self._count_row(seq.output_ids)
        start = max(seq.prefilled_tokens, seq.cached_tokens)
        end = min(seq.chunk_target, n) if (
            self.chunk_tokens is not None and seq.chunk_target
        ) else n
        final = end >= n
        if seq.mm_embeds is not None:
            # the text at [mm_len, total), the patch embeddings below it,
            # spliced in the step; the penalty rows count the text only
            start, end, final = 0, seq.context_len, True
            padded = np.zeros((self._bucket_len(end),), np.int32)
            padded[seq.mm_len: end] = tokens
            embeds = np.zeros((len(padded), cfg.hidden_size), np.float32)
            embeds[: seq.mm_len] = seq.mm_embeds
            block_ids = np.zeros((self.max_blocks_per_seq,), np.int32)
            block_ids[: len(blocks)] = blocks
            ids = np.asarray(tokens, np.int64)
            ids = ids[(ids >= 0) & (ids < cfg.vocab_size)]
            key = ("mm", len(padded))
            arrays = {"block_ids": block_ids, "embeds": embeds, "n_patch": seq.mm_len,
                      "seq_len": end, "start_pos": 0, "fold": end,
                      "prompt": np.bincount(ids, minlength=cfg.vocab_size).astype(np.int32)
                      - gen_row}
        elif start > 0 or not final:
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
            key = ("prefix", len(padded), table_len)
            arrays = {"full_ids": full_ids, "tail_ids": tail_ids, "seq_len": len(tail),
                      "start_pos": start, "fold": n,
                      "prompt": self._count_row(seq.request.token_ids)}
        else:
            padded = np.zeros((self._bucket_len(end),), np.int32)
            padded[:end] = tokens[:end]
            block_ids = np.zeros((self.max_blocks_per_seq,), np.int32)
            block_ids[: len(blocks)] = blocks
            # the reference counts the prompt's in-vocabulary ids (the
            # tokens include the generated ones on a recompute)
            ids = np.asarray(tokens[:end], np.int64)
            ids = ids[(ids >= 0) & (ids < cfg.vocab_size)]
            key = ("prefill", len(padded))
            arrays = {"block_ids": block_ids, "seq_len": end, "start_pos": 0, "fold": end,
                      "prompt": np.bincount(ids, minlength=cfg.vocab_size).astype(np.int32)
                      - gen_row}
        sampling = dict(zip(
            ("temp", "top_k", "top_p", "greedy", "pres", "freq", "rep", "bias_ids", "bias_vals"),
            self._sampling_arrays([seq], [0], 1)))
        pg = self._prefill
        pg.upload(key, {**arrays, **sampling, "token_ids": padded, "lane": seq.lane,
                        "gate": 1 if final else 0, "gen": gen_row,
                        "key": self._lane_keys[[seq.lane]].astype(np.int64),
                        # intermediate chunks discard their sample: no mask
                        "gmode": np.array([self._guided_mode(seq) if final else -1],
                                          np.int32)})
        # a lane that wants top logprobs runs the step eagerly for its K-wide
        # row; any other is its key's graph replay
        want = seq.request.sampling.top_logprobs
        with profiling.annotate("split_prefill"):
            best = pg.step(key, top=want) if want else pg.run(key)
        token, lp = pg.result()
        seq.prefilled_tokens = end
        self._count_prefill(start, end)
        self._step_weight_streams += 1
        if not final:
            # an intermediate chunk: K/V written, its sample discarded
            if seq.mm_embeds is None:
                self.allocator.publish_stored(seq.seq_id, tokens[:end])
            if seq.prefill_only and seq.on_chunk_done is not None:
                self._stream_prefill_chunk(seq, blocks, end)
            return
        if seq.status == SeqStatus.PREFILLING:
            seq.status = SeqStatus.RUNNING
        top = None if best is None else tuple(x[0].cpu().numpy() for x in best)
        if seq.prefill_only:
            # disaggregated prefill: hand back the first token and the KV
            # blocks.  Streamed chunks already shipped the blocks below the
            # watermark: extract only the tail past it (the final chunk's
            # last block is never complete before now, so the tail is never
            # empty)
            n_used = self.allocator.blocks_needed(n)
            start_b = min(seq.streamed_blocks, n_used)
            blocks_out = self._extract_block_range(blocks, start_b, n_used, seq.extract_device)
            top_rows = None
            want_top = seq.request.sampling.top_logprobs
            if want_top > 0 and top is not None:
                vals, ids = top
                top_rows = [[int(ids[i]), float(vals[i])] for i in range(min(want_top, len(ids)))]
            self.scheduler.finish(seq)
            if seq.on_prefill_done:
                seq.on_prefill_done((token, lp, top_rows, blocks_out, n_used))
            return
        if seq.mm_embeds is None:
            # multimodal blocks never publish: text-token hashes cannot
            # describe patch-embedding content
            self.allocator.publish_stored(seq.seq_id, tokens)
        self._process_token(seq, token, lp, top=top)

    # -- whole blocks: one card's cache, or every rank's shard ---------------
    def _gather_cache(self, ids: list[int]) -> dict[str, torch.Tensor]:
        """Blocks ``ids`` of every cache leaf, whole ``[L, n, ...]``, on this
        engine's device: the block-gather kernel over the cache, or on a
        mesh over every rank's shard, assembled on rank 0 (``gather``)."""
        if self._shards is None:
            return {name: block_copy.gather_blocks(self.cache[name], ids, axis=1)
                    for name in sorted(self.cache)}
        return self._mesh_leader.gather(self.cache, self._shards, ids)

    # -- disaggregation: extract and inject ----------------------------------
    def _extract_block_range(self, blocks: list[int], start_b: int, end_b: int,
                             device: bool) -> dict:
        """Gather the cache leaves of ``blocks[start_b:end_b]`` with the
        block-gather kernel (device thread, no wait).  ``device``: the
        gathered tensors themselves.  Else host tensors: on a card copied
        into pinned memory behind the stream's queued work, the
        ``StagedBlocks``' ``ready`` event recorded after the copies (a
        reader waits for it off the engine thread; the staging lives as long
        as the dict)."""
        out = self._gather_cache(blocks[start_b:end_b])
        self.extract_calls += 1
        if device:
            return out
        staged = StagedBlocks()
        if self.device.type != "cuda":
            staged.update(out)
            return staged
        for name, gathered in out.items():
            host = torch.empty(gathered.shape, dtype=gathered.dtype, pin_memory=True)
            host.copy_(gathered, non_blocking=True)
            staged[name] = host
        staged.ready = torch.cuda.Event()
        staged.ready.record(torch.cuda.current_stream(self.device))
        return staged

    def _stream_prefill_chunk(self, seq: Sequence, blocks: list[int], end: int) -> None:
        """Streamed transfer: after an intermediate chunk wrote KV up to
        token ``end``, extract the newly COMPLETED blocks (never a partly
        written one) and hand them to ``seq.on_chunk_done`` while later
        chunks compute.  The watermark only moves forward, so a preemption
        recompute re-runs chunks without re-streaming blocks the receiver
        already injected."""
        done_b = end // self.config.block_size
        if done_b <= seq.streamed_blocks:
            return
        start_b = seq.streamed_blocks
        out = self._extract_block_range(blocks, start_b, done_b, seq.extract_device)
        seq.streamed_blocks = done_b
        try:
            seq.on_chunk_done(start_b, out, done_b - start_b)
        except Exception:  # noqa: BLE001 — a sink bug must not kill the device loop
            logger.exception("on_chunk_done failed for %s", seq.seq_id)

    def _inject(self, block_ids: list[int], blocks: dict) -> None:
        """Scatter transferred blocks into ``block_ids`` with the
        block-scatter kernel, cast to the cache's dtype (device thread).  On
        a card nothing waits: a ``StagedBlocks``' pending copies are waited
        for on the stream, host tensors go up through pinned memory in a
        non-blocking copy, and the sources stay alive until an event after
        the scatters has run (``_reap_queued``)."""
        n = len(block_ids)
        cuda = self.device.type == "cuda"
        for name, (shape, _) in self.cache_shapes.items():
            want = (shape[0], n, *shape[2:])
            got = tuple(blocks[name].shape)
            if got != want:
                raise ValueError(f"inject: leaf {name!r} is {got}, {n} blocks need {want}")
        ready = getattr(blocks, "ready", None)
        if self._shards is not None:
            # each rank's slice of the whole blocks leaves rank 0 through the
            # host (the scatter kernel on every rank's shard): staged copies
            # must have landed before the host reads them
            if ready is not None:
                ready.synchronize()
            self._mesh_leader.scatter(self.cache, self._shards, block_ids, blocks)
            self.inject_calls += 1
            return
        stream = torch.cuda.current_stream(self.device) if cuda else None
        if ready is not None:
            stream.wait_event(ready)
        keep = []
        for name in sorted(self.cache):
            src = blocks[name]
            if cuda and src.device.type == "cpu":
                if not src.is_pinned():
                    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                    pinned.copy_(src)
                    src = pinned
                on_dev = src.to(self.device, non_blocking=True)
                keep.append((src, on_dev))
                src = on_dev
            block_copy.scatter_blocks(self.cache[name], src, block_ids, axis=1)
        self.inject_calls += 1
        if keep:
            ev = torch.cuda.Event()
            ev.record(stream)
            self._queued_injects.append((ev, keep))

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
            self._decode_started(seq)
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
        self._decode_tables(active)
        self._device_sampling_tail(active)
        vg = self._verify
        vg.inputs.upload({"tokens": token_mat, "slots": slot_mat, "context_lens": context_lens,
                          "base_lens": base_lens, "spec_ok": spec_ok})
        # a window with a top_logprobs lane runs the step eagerly for its
        # K-wide rows; any other is the verify graph's replay
        want = max((s.request.sampling.top_logprobs for s in active), default=0)
        noise = any(self._sampled(s) for s in active)
        with profiling.annotate("verify_window"):
            top = vg.step(noise, top=want) if want else vg.run(noise)
        tokens_h, n_h, lps_h = vg.result()
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

    # -- KV offload tiers ----------------------------------------------------
    def _offload_blocks(self, pairs: list[tuple[int, int]]) -> list[int]:
        """Allocator eviction hook: copy the evicted blocks' cache slices to
        the offload tiers (device thread, before the new owners write): one
        gather-kernel launch a cache leaf into ``[L, n, ...]``, then one
        ``put`` a block.  Returns hashes that failed to offload (host tier
        full of pins) — those must be announced removed.  On a card the
        gathers and their copies into pinned host memory are queued behind
        the work in flight, never waited for: the blocks enter the tiers
        once the copies have landed (``_land_offloads``, which announces the
        failed hashes), and a tier read of a hash still on its way lands the
        queued offloads first (``HostOffloadTier.settle``: a wait while a
        window is in flight drains it, counted in ``offload_drains_total``)."""
        # a block the host tier already holds needs no copy (its put would
        # keep the held one), as long as no put of this batch, or of the
        # offloads still queued, can evict it: the host pool has a free
        # block for every one of them
        pool = self.host_tier.pool
        held = sum(pool.has_hash(h) for _, h in pairs)
        if held and pool.free_count >= len(pairs) - held + len(self.host_tier.pending):
            pairs = [(bid, h) for bid, h in pairs if not pool.has_hash(h)]
            if not pairs:
                return []
        ids = [bid for bid, _ in pairs]
        cuda = self.device.type == "cuda"
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record(stream)
        gathered = self._gather_cache(ids)
        if not cuda:
            return self._put_offloaded(pairs, gathered)
        ev[1].record(stream)  # the gathers' device time: ev[0] → ev[1]
        for name, staged in gathered.items():
            host = torch.empty(staged.shape, dtype=staged.dtype, pin_memory=True)
            host.copy_(staged, non_blocking=True)
            gathered[name] = host
        ev[2].record(stream)
        self._queued_offloads.append((pairs, gathered, ev))
        self.host_tier.pending.update(h for _, h in pairs)
        return []

    def _put_offloaded(self, pairs: list[tuple[int, int]], gathered: dict) -> list[int]:
        """``put`` each offloaded block's host slices into the tiers;
        returns the hashes that ended in no tier."""
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

    def _land_offloads(self, wait: bool) -> None:
        """Put the queued offloads whose copies have landed into the tiers,
        in the order they were queued; ``wait`` lands every one (a wait
        while a window is in flight drains it: counted).  A hash that
        ended in no tier and is not back on the device is announced
        removed.  Not re-entered from its own puts' tier reads."""
        queued = self._queued_offloads
        if self._landing:
            return
        self._landing = True
        try:
            while queued:
                pairs, gathered, ev = queued[0]
                if not ev[2].query():
                    if not wait:
                        return
                    self._offload_drains += self._inflight is not None
                    ev[2].synchronize()
                queued.pop(0)
                self._offload_gather_ms += ev[0].elapsed_time(ev[1])
                self.host_tier.pending.difference_update(h for _, h in pairs)
                failed = self._put_offloaded(pairs, gathered)
                self.allocator.emit_removed(
                    [h for h in failed if not self.allocator.is_registered(h)])
        finally:
            self._landing = False

    def _settle_offloads(self) -> None:
        """The tier's hook: a read of a hash whose offload is queued."""
        self._land_offloads(wait=True)

    def _reap_queued(self, wait: bool = False) -> None:
        """Land the queued offloads and release the queued injects' sources
        and restores' staging buffers whose device work has run (every one
        with ``wait``)."""
        self._land_offloads(wait)
        injects = self._queued_injects
        while injects and (wait or injects[0][0].query()):
            injects.pop(0)[0].synchronize()
        queued = self._queued_restores
        while queued:
            ev, _buffers = queued[0]
            if not ev[2].query():
                if not wait:
                    return
                ev[2].synchronize()
            queued.pop(0)
            self._restore_ms["copy"] += ev[0].elapsed_time(ev[1])
            self._restore_ms["scatter"] += ev[1].elapsed_time(ev[2])

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
            name: torch.empty((shape[0], n, *shape[2:]), dtype=dtype, pin_memory=pinned)
            for name, (shape, dtype) in self.cache_shapes.items()
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
        scatter-kernel launch a cache leaf, then register the blocks.  On a
        card the copy and the scatters are queued behind the window in
        flight, never waited for: the staging buffers are kept until a CUDA
        event after the scatters has completed (``_reap_queued``), and the
        blocks are matchable at once, since every later step is queued on
        the same stream behind the scatters."""
        t0 = time.perf_counter()
        ids, staged = self._stage_restore(plan)
        t1 = time.perf_counter()
        if self._shards is not None:
            # each rank's slice leaves rank 0 from the host staging
            self._mesh_leader.scatter(self.cache, self._shards, ids, staged)
            self._restore_ms["stage"] += (t1 - t0) * 1e3
            self._restore_ms["scatter"] += (time.perf_counter() - t1) * 1e3
            self.allocator.register_restored(plan)
            return
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
        self._restore_ms["stage"] += (t1 - t0) * 1e3
        if not cuda:
            self._restore_ms["copy"] += (t2 - t1) * 1e3
            self._restore_ms["scatter"] += (time.perf_counter() - t2) * 1e3
        else:
            ev[2].record(stream)
            self._queued_restores.append((ev, (staged, on_dev)))
        # the content is on the device, or queued ahead of every later step
        # on its stream: the landing blocks become matchable
        self.allocator.register_restored(plan)

    # -- predictive prefetch execution (device thread) ---------------------
    def _run_prefetch(self, idle: bool) -> bool:
        """Drain the pager within this iteration's block budget.  Returns
        True when any block actually moved (the idle loop uses it to keep
        paging without sleeping; headroom-deferred work must not spin)."""
        pager = self.prefetch_pager
        budget = pager.effective_blocks_per_step() * (pager.idle_boost if idle else 1)
        progress = False
        moved = 0
        wall0 = time.time()
        t0 = time.perf_counter()
        while budget > 0:
            job = pager.next_job()
            if job is None:
                break
            touched, leftover = self._execute_prefetch(job.hashes, budget)
            budget -= max(touched, 1)  # an all-resident job still costs a walk
            moved += touched
            progress = progress or touched > 0
            if leftover:
                # device headroom exhausted or the block budget cut the
                # chain: retry the rest next round (with the original
                # enqueue time, so a hint that keeps deferring still goes
                # stale), and stop this round
                pager.requeue(leftover, enqueued=job.enqueued)
                break
        # hot-prefix pinning rides the prefetch loop (never the demand path)
        pinned = self.host_tier.pin_hot()
        if self._phase_timing:
            self._phase("prefetch.page", t0)
        if moved:
            # prefetch work is tied to no request: its spans hang off the
            # engine's own prefetch trace
            get_recorder().record(
                "engine.prefetch", self._prefetch_trace, wall0, time.time(),
                component="engine", attrs={"blocks": moved, "idle": idle, "pinned": pinned},
            )
        return progress or pinned > 0

    def _execute_prefetch(self, hashes: list[int], budget: int) -> tuple[int, list[int]]:
        """Page one hinted prefix toward the device: walk the hash chain,
        promote disk/remote-resident blocks into the host tier, then
        pre-restore host-resident blocks into device landing blocks under
        the headroom reservation.  Returns (blocks touched, leftover hashes
        the caller requeues: headroom-deferred plus any chain tail the
        block budget cut off, or a block whose offload is still on its way).
        Nothing here waits for the device."""
        pager = self.prefetch_pager
        touched = 0
        restore: list[int] = []
        promote: list[int] = []
        overflow: list[int] = []
        for i, h in enumerate(hashes):
            if len(restore) >= budget:
                overflow = [x for x in hashes[i:] if not self.allocator.is_registered(x)]
                break
            if self.allocator.is_registered(h):
                continue  # already on the device
            if h in self.host_tier.pending:
                # its offload is still on its way: page it, and the rest of
                # the chain, next round rather than wait for the copy
                overflow = [x for x in hashes[i:] if not self.allocator.is_registered(x)]
                break
            tier = self.host_tier.locate(h)
            if tier is None:
                break  # chain broken: content gone, deeper blocks useless
            if tier > 0:
                promote.append(h)
            restore.append(h)
        if promote:
            moved = self.host_tier.promote_to_host(promote)
            pager.record_onboarded(moved)
            touched += moved
        if not restore:
            return touched, overflow
        plan, deferred = self.allocator.prefetch_reserve(restore, self._prefetch_headroom_blocks)
        if plan:
            t0 = time.perf_counter()
            try:
                self._restore_blocks(plan)
            except kernel_build.KernelBuildError:
                # a kernel that does not build is no speculative miss
                self.allocator.abort_prefetch(plan)
                raise
            except Exception:  # noqa: BLE001 — prefetch is best-effort: a
                # failed speculative restore must not poison serving
                logger.exception("prefetch restore failed")
                self._prefetch_failures += 1
                self.allocator.abort_prefetch(plan)
                return touched, []
            cost = (time.perf_counter() - t0) / len(plan)
            self.allocator.finish_prefetch(plan)
            for h, _bid in plan:
                pager.record_restored(h, cost)
            touched += len(plan)
        return touched, deferred + overflow

    def _process_token(
        self, seq: Sequence, token: int, logprob: float | None = None, top=None,
    ) -> None:
        seq.output_ids.append(token)
        self._tokens_emitted += 1
        if seq.guided is not None:
            was_complete = seq.guided.complete
            seq.guided.advance(token)
            if seq.guided.complete and not was_complete:
                # counted on the closing token's transition: a document that
                # closes on the max_tokens-th token (LENGTH below) still
                # completed
                self._guided_completions += 1
        finish = seq.hit_stop(token)
        if finish is None and seq.guided is not None and seq.guided.complete:
            # the document just closed: stop rather than sample trailing
            # whitespace until max_tokens
            finish = FinishReason.STOP
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
            self._record_decode_span(seq)
            self._finish_decoded(seq)
        elif seq.context_len % self.config.block_size == 0 and seq.mm_embeds is None:
            self.allocator.publish_stored(seq.seq_id, seq.all_token_ids)


def _to_device(tree, device):
    """A parameter tree on ``device`` (tensors and ``QuantizedMatrix``
    leaves)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
