"""The decode window, and the unified window of each token bucket, as CUDA
graphs.

The reference runs each decode window as one compiled program: ``jax.jit``
of its single step, or of ``multi`` (a ``lax.scan`` of ``decode_steps``
iterations) for a fused window (dynamo_tpu/engine/engine.py
``_build_decode``), warmed by ``aot_precompile``.  The port's counterpart
is a CUDA graph of the same window: the forward, penalties, logit bias,
the sampling tail with its threefry noise, logprobs and the generated-count
update, for ``decode_steps`` iterations (a Python loop is the ``scan``),
each iteration's cache slot derived on the device from the pre-extended
block table and its token fed back on the device.

``DecodeGraph`` owns a persistent device buffer for every input of the
window, each written in place from the host through pinned staging in one
non-blocking copy a group (``Staged``), so a replay reads this window's
values and no upload waits for the stream.  On a CUDA device the window is
captured with ``torch.cuda.graph`` at first use (one graph with the noise
draw, one without: a window whose lanes are all greedy skips the draw) and
replayed after; a capture that fails raises.  On the CPU the same step runs
eagerly.

The kernel wrappers count launches in Python, so inside a graph they count
once, at capture.  The capture records how many launches of each counter
the graph holds and adds them on every replay.

``UnifiedGraph`` does the same for the unified (mixed prefill + decode)
window: one graph per (token bucket, noise), every input at its bucket's
fixed shape (see its docstring).  ``PrefillGraph`` holds the split prefill
step, one graph per prefill key, as the reference compiles one
program per key; ``VerifyGraph`` the speculative verify step, one graph per
noise.  ``TorchLlmEngine.warmup`` captures every reachable bucket's graphs,
the decode graphs, and the split step's graphs where the split step is the
engine's prefill path, before serving.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch.ops.kernels.work_plan import DeviceWork
from dynamo_tpu_torch.ops.random import fold_in, gumbel
from dynamo_tpu_torch.ops.sampling import (
    apply_logit_bias,
    apply_penalties,
    sample_tokens,
    token_logprobs,
    topk_logprobs,
)

_ALIGN = 16  # byte offset of every field (the widest view dtype divides it)
_TORCH_DTYPES = {
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.bool_): torch.bool,
}
_NUMPY_DTYPES = {t: n for n, t in _TORCH_DTYPES.items()}


class Staged:
    """Named arrays in one device buffer, written from host arrays in one
    non-blocking copy through pinned staging.  The staging is a ring of two
    host buffers: a slot is rewritten only after its last copy landed (its
    event), so the host may fill the next window while the last one's copy
    is still queued.

    ``variants`` (key -> fields) lays several sets of fields over the same
    buffer, each from offset 0 (the buffer is the largest's size): the
    unified step's inputs at each token bucket, so a bucket's window copies
    its own bytes and no more, and each bucket's graph reads its own views
    at fixed addresses.  ``fields`` alone is the one variant ``None``."""

    def __init__(self, device: torch.device, fields: dict[str, tuple[tuple, Any]] | None = None,
                 *, variants: dict[Any, dict[str, tuple[tuple, Any]]] | None = None):
        self.device = device
        variants = {None: fields} if variants is None else variants
        self._layouts = {key: self._layout(f) for key, f in variants.items()}
        self.nbytes = max(nbytes for _, nbytes in self._layouts.values())
        self.buffer = torch.zeros(self.nbytes, dtype=torch.uint8, device=device)
        cuda = device.type == "cuda"
        self._host = [torch.zeros(self.nbytes, dtype=torch.uint8, pin_memory=cuda)
                      for _ in range(2)]
        self._events: list = [None, None]
        self._slot = 0
        self._views = {
            key: {name: self.buffer[o: o + n].view(_TORCH_DTYPES[dt]).view(shape)
                  for name, (o, n, shape, dt) in layout.items()}
            for key, (layout, _) in self._layouts.items()
        }
        self.views = self._views.get(None, {})

    @staticmethod
    def _layout(fields: dict[str, tuple[tuple, Any]]) -> tuple[dict, int]:
        layout, off = {}, 0
        for name, (shape, dtype) in fields.items():
            dtype = np.dtype(dtype)
            nbytes = int(np.prod(shape)) * dtype.itemsize
            layout[name] = (off, nbytes, tuple(shape), dtype)
            off += -(-nbytes // _ALIGN) * _ALIGN
        return layout, off

    def upload(self, arrays: dict[str, np.ndarray], variant: Any = None) -> None:
        """Write every field of ``variant`` from ``arrays`` (all of them,
        host values): one copy of that variant's bytes."""
        layout, nbytes = self._layouts[variant]
        if arrays.keys() != layout.keys():
            raise ValueError(f"staged upload needs {sorted(layout)}, got {sorted(arrays)}")
        slot = self._slot
        self._slot ^= 1
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        host = self._host[slot].numpy()
        for name, (o, n, shape, dt) in layout.items():
            a = np.asarray(arrays[name])
            if a.shape != shape:
                raise ValueError(f"staged upload: {name} is {a.shape}, the buffer {shape}")
            host[o: o + n] = np.ascontiguousarray(a, dtype=dt).reshape(-1).view(np.uint8)
        self.buffer[:nbytes].copy_(self._host[slot][:nbytes], non_blocking=True)
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._events[slot] = ev

    def view(self, variant: Any = None) -> dict[str, torch.Tensor]:
        return self._views[variant]

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.views[name]


def guided_mask(logits: torch.Tensor, table: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """Guided decoding's mask, as the reference's sampling tails apply it
    after penalties and logit bias: row ``i``'s inadmissible tokens go to
    -inf, the admissible ones being ``table[modes[i]]`` (``[modes, vocab]``
    bool) and mode -1 allowing every token.  Rows are gathered on the
    device (nothing read back)."""
    rows = table.index_select(0, modes.clamp(0, table.shape[0] - 1).long())
    allowed = rows | (modes < 0)[:, None]
    return torch.where(allowed, logits, float("-inf"))


def launch_counters() -> dict[tuple[Any, str], int]:
    """Every kernel wrapper's launch and plain-call counter, by (module,
    name)."""
    from dynamo_tpu_torch.ops.kernels import (
        block_copy,
        mla_attention,
        paged_attention,
        ragged_attention,
    )

    return {
        (mod, name): value
        for mod in (ragged_attention, paged_attention, mla_attention, block_copy)
        for name, value in vars(mod).items()
        if type(value) is int and (name.endswith("launches") or name.endswith("plain_calls"))
    }


def _add_counts(counts: dict, sign: int = 1) -> None:
    for (mod, name), n in counts.items():
        setattr(mod, name, getattr(mod, name) + sign * n)


class StepGraphs:
    """One step's CUDA graphs by key, over the graphs' shared memory pool:
    each captured at first use or by its owner's ``warm`` (a capture after
    ``warm`` ran is counted apart, as the reference counts a program
    compiled at its first dispatch), each replay adding the launches its
    capture held.  ``stats()`` reports them under ``<name>_graph...``."""

    name = ""

    def __init__(self, device: torch.device, pool=None):
        self.device = device
        self.pool = pool
        # key -> (graph, launches a replay holds)
        self._graphs: dict[Any, tuple[torch.cuda.CUDAGraph, dict]] = {}
        self.replays = 0
        self.capture_ms = 0.0
        self.pool_mb = 0.0
        self.warmed = False      # warm() ran: a later capture is counted apart
        self.late_captures = 0
        # run the step eagerly, no graph: the CPU, and a mesh (its steps'
        # collectives cross processes, which no graph captures)
        self.eager = device.type != "cuda"

    def _capture(self, key, idle, live) -> None:
        """Capture ``live`` under ``key`` (``capture``: ``idle`` runs first)."""
        graph, launches, ms, mb = capture(self.device, self.pool, idle, live)
        self._graphs[key] = (graph, launches)
        self.capture_ms += ms
        self.pool_mb += mb

    def _launch(self, key) -> None:
        graph, launches = self._graphs[key]
        graph.replay()
        _add_counts(launches)

    def _replay(self, key, idle, live) -> None:
        """A serving replay of ``key``, captured first where it is new."""
        if key not in self._graphs:
            self._capture(key, idle, live)
            self.late_captures += self.warmed
        self._launch(key)
        self.replays += 1

    def stats(self) -> dict:
        return {
            f"{self.name}_graph_replays_total": self.replays,
            f"{self.name}_graphs_captured": len(self._graphs),
            f"{self.name}_graph_capture_ms": self.capture_ms,
            f"{self.name}_graph_pool_mb": self.pool_mb,
            f"{self.name}_graphs_captured_after_warmup": self.late_captures,
        }

    @staticmethod
    def zero_stats(name: str) -> dict:
        """The stats of a step an engine does not have."""
        return {f"{name}_graph_replays_total": 0, f"{name}_graphs_captured": 0,
                f"{name}_graph_capture_ms": 0.0, f"{name}_graph_pool_mb": 0.0,
                f"{name}_graphs_captured_after_warmup": 0}


class DecodeGraph(StepGraphs):
    """The persistent inputs of a decode window and the window itself:
    ``tokens`` / ``use_fb`` / ``lens`` (``window``), the block ``tables``
    and the sampling ``tail`` (lane keys, the sampled mask, temperature,
    top-k, top-p, greedy, the three penalties and the logit-bias rows),
    beside the engine's persistent cache, penalty counts and parameters;
    ``feedback`` holds each lane's last sampled token, written by every
    decode and unified window on the device and read by the next one where
    ``use_fb`` says so."""

    name = "decode"

    def __init__(self, engine, bias_width: int, pool=None):
        super().__init__(engine.device, pool)
        self.engine = engine
        cfg = engine.config
        dev = self.device
        lanes = cfg.max_batch_size
        self.steps = cfg.decode_steps
        self.block_size = cfg.block_size
        self.oob = cfg.num_blocks * cfg.block_size
        self.max_len = engine.max_len
        self.window = Staged(dev, {
            "tokens": ((lanes,), np.int32),
            "use_fb": ((lanes,), np.bool_),
            "lens": ((lanes,), np.int32),
        })
        self.tables = Staged(dev, {"tables": ((lanes, engine.max_blocks_per_seq), np.int32)})
        self.tail = Staged(dev, {
            "keys": ((lanes, 2), np.int64),
            "sampled": ((lanes,), np.float32),
            "temp": ((lanes,), np.float32),
            "top_k": ((lanes,), np.int32),
            "top_p": ((lanes,), np.float32),
            "greedy": ((lanes,), np.bool_),
            "pres": ((lanes,), np.float32),
            "freq": ((lanes,), np.float32),
            "rep": ((lanes,), np.float32),
            "bias_ids": ((lanes, bias_width), np.int32),
            "bias_vals": ((lanes, bias_width), np.float32),
            "gmodes": ((lanes,), np.int32),
        })
        self.feedback = torch.zeros((lanes,), dtype=torch.int32, device=dev)
        self.out_tokens = torch.zeros((self.steps, lanes), dtype=torch.int32, device=dev)
        self.out_lps = torch.zeros((self.steps, lanes), dtype=torch.float32, device=dev)
        self._idle_lens = torch.zeros((lanes,), dtype=torch.int32, device=dev)

    # -- the window --------------------------------------------------------
    def sample(self, logits, fold_lens, gate, noise: bool, top: int = 0):
        """The sampling tail of a decode or unified window, from the
        ``tail`` buffers: penalties, logit bias, the guided mask (each
        lane's row of the engine's table by its mode id, -1 none), Gumbel
        noise from each
        lane's key folded with ``fold_lens`` (the reference's
        ``fold_in(key, context_len)``; greedy lanes draw zeros through the
        sampled mask, and ``noise=False`` skips the draw for a window with
        no sampled lane), the sample, its logprob, the ``top`` best
        logprobs (0: none), and ``gate`` added to the sampled token's
        generated count.  Returns (tokens, logprobs, top or None)."""
        e = self.engine
        t = self.tail.views
        logits = apply_penalties(logits, e._gen_counts, e._prompt_counts,
                                 t["pres"], t["freq"], t["rep"])
        logits = apply_logit_bias(logits, t["bias_ids"], t["bias_vals"])
        logits = guided_mask(logits, e._guided_table, t["gmodes"])
        vocab = logits.shape[-1]
        if noise:
            draw = gumbel(fold_in(t["keys"], fold_lens.long()), vocab) * t["sampled"][:, None]
        else:
            draw = logits.new_zeros(())
        tokens = sample_tokens(logits, draw, t["temp"], t["top_k"], t["top_p"], t["greedy"])
        lps = token_logprobs(logits, tokens)
        best = topk_logprobs(logits, min(top, vocab)) if top else None
        e._gen_counts[e._lane_idx, tokens.long()] += gate
        return tokens, lps, best

    def step(self, noise: bool, top: int = 0, lens: torch.Tensor | None = None):
        """One decode window, eagerly: ``steps`` iterations of forward and
        sampling tail; iteration s writes ``out_tokens[s]`` /
        ``out_lps[s]``.  Idle lanes (``lens`` 0) write only the caches'
        dump row and count nothing.  Returns the ``top`` best logprobs
        ([steps, lanes, k] values and ids) or None."""
        e = self.engine
        lens = self.window["lens"] if lens is None else lens
        tables = self.tables["tables"]
        bs = self.block_size
        active = lens > 0
        gate = active.to(torch.int32)
        tokens = torch.where(self.window["use_fb"], self.feedback, self.window["tokens"])
        tops = []
        for s in range(self.steps):
            # the block table covers the window; a lane past the engine's
            # last position writes its last slot (the host finishes it
            # there and drops the tokens), and attends no further
            pos = (lens - 1).clamp(0, self.max_len - 1)
            blk = tables.gather(1, (pos // bs).long()[:, None])[:, 0]
            slots = torch.where(active, blk * bs + pos % bs, self.oob)
            logits, _ = e.family.forward_decode(
                e.params, e.config.model, tokens, e.cache, tables,
                lens.clamp(max=self.max_len), slots, e.cos, e.sin,
            )
            tokens, lps, best = self.sample(logits, lens, gate, noise, top)
            self.out_tokens[s].copy_(tokens)
            self.out_lps[s].copy_(lps)
            if best is not None:
                tops.append(best)
            lens = torch.where(active, lens + 1, lens)
        self.feedback.copy_(torch.where(active, tokens, self.feedback))
        if not tops:
            return None
        return torch.stack([v for v, _ in tops]), torch.stack([i for _, i in tops])

    def run(self, noise: bool) -> None:
        """The window on this window's inputs: a graph replay on a CUDA
        device (captured at first use), the eager step on the CPU.  The
        results are in ``out_tokens`` / ``out_lps``."""
        if self.eager:
            self.step(noise)
            return
        self._replay(noise, *self._steps(noise))

    def warm(self) -> None:
        """Capture both graphs (noise drawn and not) before serving, and
        replay each once with every lane idle: a graph's first launch
        uploads it to the card, which a serving window should not wait for
        (its launches are counted, as every replay's).  On the CPU run the
        step once each with every lane idle."""
        lanes = self._idle_lens.shape[0]
        for noise in (False, True):
            if self.eager:
                self.step(noise, lens=self._idle_lens)
                continue
            if noise not in self._graphs:
                self._capture(noise, *self._steps(noise))
            self.window.upload({"tokens": np.zeros((lanes,), np.int32),
                                "use_fb": np.zeros((lanes,), np.bool_),
                                "lens": np.zeros((lanes,), np.int32)})
            self._launch(noise)
        self.warmed = True

    def _steps(self, noise: bool):
        """The capture's warm-up (every lane idle: it changes no cache slot,
        count or feedback) and the step it captures."""
        return (lambda: self.step(noise, lens=self._idle_lens)), (lambda: self.step(noise))


_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def capture(dev: torch.device, pool, idle, live) -> tuple[torch.cuda.CUDAGraph, dict, float, float]:
    """Run ``idle`` (the step with nothing live: it changes no cache slot,
    count or feedback) once, then capture ``live`` into a graph over the
    memory ``pool`` (a ``torch.cuda.MemPool``).  Both run on the device's
    one capture stream and allocate from the pool, so the capture reuses
    the blocks the warm-up freed, and the pool holds the largest step's
    memory, not the sum of the steps' (one stream also keeps one cuBLAS
    workspace, where a stream a capture would add one each).  The capture
    launched nothing: the counters it moved are taken back and kept as what
    each replay launches.  Returns (graph, launches a replay holds, ms
    taken, MB the memory reserved grew by).  A capture that fails raises."""
    t0 = time.perf_counter()
    stream = _CAPTURE_STREAMS.get(dev)
    if stream is None:
        stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    # the capture empties the allocator's cache on entry: empty it first too,
    # so the reserved bytes it adds are the graphs' pool's
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream), torch.cuda.use_mem_pool(pool, dev):
        idle()
    torch.cuda.current_stream(dev).wait_stream(stream)
    before = launch_counters()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool.id, stream=stream, capture_error_mode="thread_local"):
        live()
    after = launch_counters()
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    _add_counts(launches, -1)
    return (graph, launches, (time.perf_counter() - t0) * 1e3,
            (torch.cuda.memory_reserved(dev) - reserved) / 2**20)


class UnifiedGraph(StepGraphs):
    """The unified (mixed prefill + decode) window as one CUDA graph per
    (token bucket, noise), as the reference compiles one program per token
    bucket (dynamo_tpu/engine/engine.py ``_build_unified``, warmed by
    ``aot_precompile``).

    Every input has one shape per bucket: the flat token axis (``token_ids``
    / ``use_fb`` / ``token_pos`` / ``token_slot`` / ``token_lane``), the
    lane arrays (``context_lens`` / ``sample_rows`` / ``sample_gate``), the
    ``seed_slots`` lanes whose penalty counts a newly admitted prefill
    re-seeds (out of range: none), the page worklist at the engine's fixed
    width ``page_slots`` (``page_phys`` / ``page_lane`` / ``page_ord`` /
    ``page_count``; ``tb x max_blocks_per_seq`` by default, a tuned width
    from the kernel-perf table where one resolved) and, where the family's
    kernel takes one, the work plan at its fixed capacity (``plan``).  They
    live in one ``Staged`` buffer laid out per bucket (a window copies its
    bucket's bytes), the seed rows in another (copied only in a window that
    seeds).  Below a tuned width a bucket also has a full-width layout
    (variant ``("full", bucket)``, worklist ``full_slots`` wide): a window
    whose worklist outgrows the tuned width is repacked at the full width
    and replays that layout's graph, captured at its first use (one graph
    a bucket: it always draws the noise, which greedy lanes ignore), as the
    reference compiles at most one extra program a bucket.
    The block tables, the sampling tail and the feedback are
    ``DecodeGraph``'s.  Tokens and logprobs go to persistent ``out_tokens``
    / ``out_lps``: the overlapped pipeline reads them back a window later.

    A window is replayed on a CUDA device (captured at first use, or by
    ``warm``), run eagerly at the same shapes on the CPU and, on the card,
    where it wants top logprobs.  The graphs share one memory pool with the
    decode graphs: every output a graph leaves is in a persistent buffer
    allocated outside any capture, what a replay allocates is dead when it
    ends, and windows replay one at a time on one stream, so no graph's
    live output sits in memory another reuses."""

    name = "unified"

    def __init__(self, engine, decode: DecodeGraph, buckets: list[int], seed_slots: int,
                 planner=None, pool=None):
        super().__init__(engine.device, pool)
        self.engine = engine
        self.decode = decode
        cfg = engine.config
        dev = self.device
        self.tb = tb = engine._unified_tb
        self.lanes = lanes = cfg.max_batch_size
        self.page_slots = engine._unified_ps
        self.full_slots = engine._unified_ps_full
        self.pps = engine._unified_pps
        self.seed_slots = seed_slots
        self.buckets = sorted(buckets)
        self.planner = planner
        vocab = cfg.model.vocab_size
        self.caps = {b: planner.caps(b // tb) for b in self.buckets} if planner else {}

        def fields(b: int, ps: int) -> dict:
            ntb = b // tb
            out = {
                "token_ids": ((b,), np.int32),
                "use_fb": ((b,), np.bool_),
                "token_pos": ((b,), np.int32),
                "token_slot": ((b,), np.int32),
                "token_lane": ((b,), np.int32),
                "context_lens": ((lanes,), np.int32),
                "sample_rows": ((lanes,), np.int32),
                "sample_gate": ((lanes,), np.int32),
                "seed_lanes": ((seed_slots,), np.int32),
                "page_count": ((ntb,), np.int32),
                "page_phys": ((ntb, ps), np.int32),
                "page_lane": ((ntb, ps), np.int32),
                "page_ord": ((ntb, ps), np.int32),
            }
            if planner:
                out["plan"] = ((self.caps[b].rows, 4), np.int32)
            return out

        variants = {b: fields(b, self.page_slots) for b in self.buckets}
        if self.full_slots > self.page_slots:
            variants.update({("full", b): fields(b, self.full_slots) for b in self.buckets})
        self.inputs = Staged(dev, variants=variants)
        self.full_captures = 0  # full-width graphs captured (at first use)
        self.seeds = Staged(dev, {"prompt": ((seed_slots, vocab), np.int32),
                                  "gen": ((seed_slots, vocab), np.int32)})
        self.out_tokens = torch.zeros((lanes,), dtype=torch.int32, device=dev)
        self.out_lps = torch.zeros((lanes,), dtype=torch.float32, device=dev)
        # the work plan as the kernels read it, a bucket, and the plan of a
        # window with nothing live (each token block one empty item) for the
        # capture's warm-up; one partials scratch at the largest capacity
        self.work: dict[int, Any] = {}
        self._idle_work: dict[int, Any] = {}
        self.scratch_mb = {}
        if planner:
            most = max(planner.scratch_floats(c) for c in self.caps.values())
            self.scratch = torch.empty((most,), dtype=torch.float32, device=dev)
            for b in self.buckets:
                ntb, caps = b // tb, self.caps[b]
                for key in (b, ("full", b)):
                    if key in variants:
                        self.work[key] = DeviceWork(ntb, caps, self.inputs.view(key)["plan"],
                                                    self.scratch)
                idle = planner.plan(np.zeros((ntb,), np.int32)).pack(caps)
                self._idle_work[b] = DeviceWork(ntb, caps, torch.from_numpy(idle).to(dev),
                                                self.scratch)
                self.scratch_mb[b] = planner.scratch_floats(caps) * 4 / 1e6
        # a window with nothing live at the largest bucket, on the device:
        # the capture's warm-up reads these instead of the buffers, which
        # may hold a live window (a capture after warmup)
        idle = self._idle_arrays(self.buckets[-1])
        self._idle = {k: torch.from_numpy(idle[k]).to(dev) for k in (
            "token_pos", "token_lane", "token_slot", "page_count", "sample_gate")}
        self._idle["seed_lanes"] = torch.full((seed_slots,), lanes, dtype=torch.int32,
                                              device=dev)
        self.bucket_capture_ms: dict[int, float] = {}

    # -- inputs ------------------------------------------------------------
    def upload(self, bucket: int, arrays: dict[str, np.ndarray], plan=None,
               seeds: list[tuple[int, np.ndarray, np.ndarray]] = (), full: bool = False) -> None:
        """Write a window's host arrays into ``bucket``'s buffers in place
        (``full``: its full-width layout): the token axis, lane and
        worklist arrays (``arrays``), ``plan`` packed at the bucket's
        capacity (it refuses one that does not fit), and each seed (lane,
        prompt counts, generated counts) into a seed slot (the rest out of
        range)."""
        if len(seeds) > self.seed_slots:
            raise ValueError(f"{len(seeds)} seeds for {self.seed_slots} seed slots")
        arrays = dict(arrays)
        lanes_of = np.full((self.seed_slots,), self.lanes, np.int32)
        for i, (lane, _, _) in enumerate(seeds):
            lanes_of[i] = lane
        arrays["seed_lanes"] = lanes_of
        if self.planner:
            arrays["plan"] = plan.pack(self.caps[bucket])
        elif plan is not None:
            raise ValueError("a work plan for a kernel that takes none")
        self.inputs.upload(arrays, ("full", bucket) if full else bucket)
        if seeds:
            vocab = self.seeds["prompt"].shape[1]
            prompt = np.zeros((self.seed_slots, vocab), np.int32)
            gen = np.zeros((self.seed_slots, vocab), np.int32)
            for i, (_, p, g) in enumerate(seeds):
                prompt[i], gen[i] = p, g
            self.seeds.upload({"prompt": prompt, "gen": gen})

    # -- the window --------------------------------------------------------
    def step(self, bucket: int, noise: bool, top: int = 0, idle: bool = False,
             full: bool = False):
        """One unified window of ``bucket`` tokens, eagerly, from the
        buffers: decode lanes marked ``use_fb`` take their input token from
        the feedback, the seeded lanes' penalty counts are rewritten before
        the penalties read them, intermediate-chunk samples are gated out
        of the generated counts, and the emitting lanes' tokens become the
        feedback.  ``idle``: every token a pad, no lane sampled or seeded
        (a capture's warm-up: it changes no cache slot, count or
        feedback).  ``full``: from the bucket's full-width layout.  Returns
        the ``top`` best logprobs ([lanes, k] values and ids) or None."""
        e, d = self.engine, self.decode
        key = ("full", bucket) if full else bucket
        v = self.inputs.view(key)
        work = self.work.get(key)
        if idle:
            ntb = bucket // self.tb
            v = dict(v, page_count=self._idle["page_count"][:ntb],
                     **{k: self._idle[k][:bucket]
                        for k in ("token_pos", "token_lane", "token_slot")},
                     **{k: self._idle[k] for k in ("sample_gate", "seed_lanes")})
            work = self._idle_work.get(bucket)
        token_lane = v["token_lane"]
        fed = d.feedback[token_lane.clamp(max=self.lanes - 1).long()]
        token_ids = torch.where(v["use_fb"], fed, v["token_ids"])
        kw = {} if work is None else {"plan": work}
        logits, _ = e.family.forward_unified(
            e.params, e.config.model, token_ids, e.cache, d.tables["tables"],
            v["context_lens"], v["token_pos"], v["token_slot"], token_lane,
            v["page_phys"], v["page_lane"], v["page_ord"], v["page_count"],
            v["sample_rows"], e.cos, e.sin, tb_tokens=self.tb, pages_per_step=self.pps, **kw,
        )  # [lanes, vocab]
        seeds = self.seeds.views
        for i in range(self.seed_slots):
            hit = (e._lane_idx == v["seed_lanes"][i])[:, None]
            e._prompt_counts.copy_(torch.where(hit, seeds["prompt"][i], e._prompt_counts))
            e._gen_counts.copy_(torch.where(hit, seeds["gen"][i], e._gen_counts))
        gate = v["sample_gate"]
        tokens, lps, best = d.sample(logits, v["context_lens"], gate, noise, top)
        d.feedback.copy_(torch.where(gate > 0, tokens, d.feedback))
        self.out_tokens.copy_(tokens)
        self.out_lps.copy_(lps)
        return best

    def run(self, bucket: int, noise: bool, full: bool = False) -> None:
        """The window on this window's inputs: a graph replay on a CUDA
        device (captured at first use), the eager step on the CPU.  The
        results are in ``out_tokens`` / ``out_lps``.  ``full``: the
        bucket's full-width layout, whose one graph draws the noise."""
        if self.eager:
            self.step(bucket, noise, full=full)
            return
        if full:
            key = ("full", bucket)
            if key not in self._graphs:
                self.full_captures += 1
                self._capture(key, lambda: self.step(bucket, True, idle=True, full=True),
                              lambda: self.step(bucket, True, full=True))
            self._launch(key)
            self.replays += 1
            return
        self._replay((bucket, noise), *self._steps(bucket, noise))

    def warm(self) -> None:
        """Capture every bucket's graphs (noise drawn and not) before
        serving, and replay each once on a window with nothing live: a
        graph's first launch uploads it to the card, which a serving window
        should not wait for (its launches are counted, as every replay's).
        On the CPU run each bucket's step once with nothing live."""
        for bucket in reversed(self.buckets):  # the largest first, as PrefillGraph.warm
            # the buffers hold the last bucket's window in its own layout:
            # this bucket's window with nothing live goes in first, so the
            # capture's warm-up and the replay read it in this one's
            self.upload(bucket, self._idle_arrays(bucket),
                        self.planner.plan(np.zeros((bucket // self.tb,), np.int32))
                        if self.planner else None)
            for noise in (False, True):
                if self.eager:
                    self.step(bucket, noise, idle=True)
                elif (bucket, noise) not in self._graphs:
                    self._capture((bucket, noise), *self._steps(bucket, noise))
            if self.eager:
                continue
            for noise in (False, True):
                self._launch((bucket, noise))
        self.warmed = True

    def _idle_arrays(self, bucket: int) -> dict[str, np.ndarray]:
        """A window of ``bucket`` pads: no lane sampled, no page listed."""
        ntb, lanes = bucket // self.tb, self.lanes
        oob = self.engine.config.num_blocks * self.engine.config.block_size
        return {
            "token_ids": np.zeros((bucket,), np.int32),
            "use_fb": np.zeros((bucket,), np.bool_),
            "token_pos": np.full((bucket,), -1, np.int32),
            "token_slot": np.full((bucket,), oob, np.int32),
            "token_lane": np.full((bucket,), lanes, np.int32),
            "context_lens": np.zeros((lanes,), np.int32),
            "sample_rows": np.zeros((lanes,), np.int32),
            "sample_gate": np.zeros((lanes,), np.int32),
            "page_count": np.zeros((ntb,), np.int32),
            "page_phys": np.zeros((ntb, self.page_slots), np.int32),
            "page_lane": np.full((ntb, self.page_slots), -1, np.int32),
            "page_ord": np.zeros((ntb, self.page_slots), np.int32),
        }

    def _steps(self, bucket: int, noise: bool):
        return (lambda: self.step(bucket, noise, idle=True)), (lambda: self.step(bucket, noise))

    def stats(self) -> dict:
        return {**super().stats(), "unified_full_width_graphs_captured": self.full_captures}

    def _capture(self, key, idle, live) -> None:
        before = self.capture_ms
        super()._capture(key, idle, live)
        bucket = key[1] if key[0] == "full" else key[0]
        self.bucket_capture_ms[bucket] = (self.bucket_capture_ms.get(bucket, 0.0)
                                          + self.capture_ms - before)


class PrefillGraph(StepGraphs):
    """The split prefill step as one CUDA graph per key, as the reference
    compiles one program per key (dynamo_tpu/engine/engine.py
    ``_build_prefill``, ``_build_prefill_prefix``, warmed by
    ``aot_precompile``): ``("prefill", b)``, a whole prompt padded to the
    bucket ``b`` over a block table ``max_blocks_per_seq`` wide,
    ``("prefix", b, table_len)``, a window of ``b`` tokens over a resident
    prefix, its full and tail block tables ``table_len`` wide, and
    ``("mm", b)``, a multimodal prompt as ``("prefill", b)`` with its patch
    embeddings (``_build_prefill_mm``): the ``embeds [b, hidden]`` float32
    rows and their count ``n_patch``, spliced before the text's token
    embeddings (``torch.where(pos < n_patch, embeds, embed(tokens))``) and
    run through the family's ``forward_prefill_embeds``.  The multimodal
    keys' inputs sit in a buffer of their own, made at the first multimodal
    prompt (a text-only engine holds none), and are captured at first use.

    A key's inputs sit in one ``Staged`` buffer laid out per key: the
    window's token ids, its block ids, the valid length, the prefix length,
    the key fold, the lane, the sample gate, the lane's prompt and generated
    count rows, its raw key, sampling parameters, logit-bias row and guided
    mode (-1: none; an intermediate chunk's discarded sample is never
    masked).  The step is the family's forward (lengths as 0-d tensors:
    nothing is read on the host) and the sampling tail: the lane's counts
    reseeded, the penalties, the bias, the guided mask, the sample with the
    key folded on the device, the gated count add.  The step always draws the lane's noise (one row: a
    greedy lane's sample ignores it), so a key has one graph, not one a
    noise variant as the many-lane windows do.  Token and logprob land in
    one persistent buffer, read back once.  Replayed on a CUDA device
    (captured at first use, or by ``warm``), run eagerly from the same
    buffers on the CPU and, on the card, where the lane wants top
    logprobs.  The graphs share the decode graphs' memory pool
    (``UnifiedGraph`` says why that is safe)."""

    name = "prefill"

    def __init__(self, engine, keys: list[tuple], pool=None):
        super().__init__(engine.device, pool)
        self.engine = engine
        cfg = engine.config
        dev = self.device
        self.lanes = cfg.max_batch_size
        self.keys = list(keys)
        self.inputs = Staged(dev, variants={key: self._fields(key) for key in self.keys})
        self._mm_inputs: Staged | None = None  # the ("mm", b) keys', made at first use
        # the sampled token and its logprob's bits: one readback
        self.out = torch.zeros((2,), dtype=torch.int32, device=dev)
        self.deferred: set[tuple] = set()  # keys warm() left to their first use
        # a window with nothing valid and no lane, for the capture's warm-up
        self._idle_len = torch.zeros((), dtype=torch.int32, device=dev)
        self._idle_lane = torch.full((), self.lanes, dtype=torch.int32, device=dev)

    def _fields(self, key: tuple) -> dict:
        e = self.engine
        cfg = e.config
        vocab, kb = cfg.model.vocab_size, cfg.logit_bias_k
        out = {"token_ids": ((key[1],), np.int32)}
        if key[0] == "prefix":
            out["full_ids"] = out["tail_ids"] = ((key[2],), np.int32)
        else:
            out["block_ids"] = ((e.max_blocks_per_seq,), np.int32)
        if key[0] == "mm":
            out["embeds"] = ((key[1], cfg.model.hidden_size), np.float32)
            out["n_patch"] = ((), np.int32)
        return {**out, "seq_len": ((), np.int32), "start_pos": ((), np.int32),
                "fold": ((), np.int32), "lane": ((), np.int32), "gate": ((), np.int32),
                "prompt": ((vocab,), np.int32), "gen": ((vocab,), np.int32),
                "key": ((1, 2), np.int64), "temp": ((1,), np.float32),
                "top_k": ((1,), np.int32), "top_p": ((1,), np.float32),
                "greedy": ((1,), np.bool_), "pres": ((1,), np.float32),
                "freq": ((1,), np.float32), "rep": ((1,), np.float32),
                "bias_ids": ((1, kb), np.int32), "bias_vals": ((1, kb), np.float32),
                "gmode": ((1,), np.int32)}

    def _staged(self, key: tuple) -> Staged:
        if key[0] != "mm":
            return self.inputs
        if self._mm_inputs is None:
            self._mm_inputs = Staged(self.device, variants={
                ("mm", b): self._fields(("mm", b)) for b in self.engine.buckets})
        return self._mm_inputs

    def upload(self, key: tuple, arrays: dict[str, np.ndarray]) -> None:
        self._staged(key).upload(arrays, key)

    def step(self, key: tuple, top: int = 0, idle: bool = False):
        """One split prefill of ``key``, eagerly, from the buffers; ``idle``:
        no valid token and no lane (the capture's warm-up: it changes no
        cache slot or count).  Returns the ``top`` best logprobs ([1, k]
        values and ids) or None."""
        e = self.engine
        v = self._staged(key).view(key)
        seq_len, lane, gate = v["seq_len"], v["lane"], v["gate"]
        if idle:
            seq_len, lane, gate = self._idle_len, self._idle_lane, self._idle_len
        if key[0] == "prefill":
            logits, _ = e.family.forward_prefill(
                e.params, e.config.model, v["token_ids"], e.cache, v["block_ids"], seq_len, 0,
                e.cos, e.sin)
        elif key[0] == "mm":
            logits, _ = e.family.forward_prefill_spliced(
                e.params, e.config.model, v["token_ids"], e.cache, v["embeds"], v["n_patch"],
                v["block_ids"], seq_len, 0, e.cos, e.sin)
        else:
            logits, _ = e.family.forward_prefill_with_prefix(
                e.params, e.config.model, v["token_ids"], e.cache, v["full_ids"],
                v["tail_ids"], seq_len, v["start_pos"], e.cos, e.sin)
        # reseed the lane's penalty counts, then sample its one row
        hit = (e._lane_idx == lane)[:, None]
        e._prompt_counts.copy_(torch.where(hit, v["prompt"], e._prompt_counts))
        e._gen_counts.copy_(torch.where(hit, v["gen"], e._gen_counts))
        logits = apply_penalties(logits[None], v["gen"][None], v["prompt"][None],
                                 v["pres"], v["freq"], v["rep"])
        logits = apply_logit_bias(logits, v["bias_ids"], v["bias_vals"])
        logits = guided_mask(logits, e._guided_table, v["gmode"])
        vocab = logits.shape[-1]
        draw = gumbel(fold_in(v["key"], v["fold"].long().reshape(1)), vocab)
        tokens = sample_tokens(logits, draw, v["temp"], v["top_k"], v["top_p"], v["greedy"])
        lps = token_logprobs(logits, tokens)
        best = topk_logprobs(logits, min(top, vocab)) if top else None
        # a 0-d index would be read on the host: the lane goes in as [1]
        e._gen_counts.index_put_((lane.clamp(max=self.lanes - 1).long().reshape(1), tokens.long()),
                                 gate.reshape(1), accumulate=True)
        self.out[0].copy_(tokens[0])
        self.out[1].copy_(lps.view(torch.int32)[0])
        return best

    def result(self) -> tuple[int, float]:
        """The last step's (token, logprob), read back."""
        out = self.out.cpu().numpy()
        return int(out[0]), float(out[1:].view(np.float32)[0])

    def run(self, key: tuple) -> None:
        """The step on this key's inputs: a graph replay on a CUDA device
        (captured at first use), the eager step on the CPU."""
        if self.eager:
            self.step(key)
            return
        self._replay(key, *self._steps(key))

    def warm(self, keys: list[tuple], budget: int | None = None) -> None:
        """Capture each of ``keys``' graphs and replay each once on a window
        with nothing valid, so a serving step neither captures nor uploads
        one; on the CPU run each key's step once with nothing valid.  The
        largest windows go first: the pool then holds the largest step's
        memory and every later capture reuses it.  A key whose activations
        (``key_bytes``) exceed ``budget`` bytes is left to its first use
        (``deferred``); a later capture is counted apart."""
        for key in sorted(keys, key=self.key_bytes, reverse=True):
            if budget is not None and self.key_bytes(key) > budget:
                self.deferred.add(key)
                continue
            # as UnifiedGraph.warm: the key's own idle window first
            self.upload(key, self._idle_arrays(key))
            if self.eager:
                self.step(key, idle=True)
                continue
            if key not in self._graphs:
                self._capture(key, *self._steps(key))
            self._launch(key)
        self.warmed = True

    def key_bytes(self, key: tuple) -> int:
        """An upper bound of what capturing ``key`` adds to the pool, by
        the step's largest activation: four times the window's float32
        attention scores (``heads x b x (b + prefix positions)``).  On the
        card (``chip_smoke.py`` phases ``spec`` and ``longctx``) an eager
        Llama-3-8B step peaks at 2.1 of them, a capture's pool holds 2.1
        at 4096 positions and 3.1 at 8192 (blocks split off the first
        step's segments), DeepSeek-V2-Lite's 3.6 (its scores are
        concatenated before the softmax)."""
        cfg = self.engine.config
        keys = key[1] + (key[2] * cfg.block_size if key[0] == "prefix" else 0)
        return 4 * cfg.model.num_heads * key[1] * keys * 4

    def stats(self) -> dict:
        return super().stats() | {"prefill_graph_keys_deferred": len(self.deferred)}

    def _idle_arrays(self, key: tuple) -> dict[str, np.ndarray]:
        """Every input of ``key`` zero, but the lane out of range."""
        arrays = {name: np.zeros(t.shape, np.dtype(_NUMPY_DTYPES[t.dtype]))
                  for name, t in self._staged(key).view(key).items()}
        arrays["lane"] = np.asarray(self.lanes, np.int32)
        arrays["gmode"] = np.full((1,), -1, np.int32)
        return arrays

    def _steps(self, key: tuple):
        return (lambda: self.step(key, idle=True)), (lambda: self.step(key))


class VerifyGraph(StepGraphs):
    """The speculative verify step as one CUDA graph per noise, as the
    reference compiles one verify program (``_build_verify``): the
    ``[lanes, w]`` window token and cache slot matrices, the context and
    base lengths and ``spec_ok`` in one ``Staged`` buffer; the block tables
    and the sampling tail are ``DecodeGraph``'s.  The step is the family's
    verify forward (its cache write sync-free: ``last_writer_rows``) and the
    verify sampling tail: window position 0 through the full sampling
    machinery with the noise of a plain decode step at the same context,
    later positions greedy after penalties and bias, the leading-match
    acceptance count, the accepted tokens' generated counts.  Tokens, the
    acceptance counts and logprobs land in one persistent buffer, read
    back once: the drafts and the emission need them, so the step stays
    synchronous.  Replayed on a CUDA device, run eagerly on the CPU and,
    on the card, where a lane wants top logprobs."""

    name = "verify"

    def __init__(self, engine, decode: DecodeGraph, pool=None):
        super().__init__(engine.device, pool)
        self.engine = engine
        self.decode = decode
        cfg = engine.config
        dev = self.device
        self.lanes = lanes = cfg.max_batch_size
        self.w = w = cfg.spec_tokens + 1
        self.inputs = Staged(dev, {
            "tokens": ((lanes, w), np.int32),
            "slots": ((lanes, w), np.int32),
            "context_lens": ((lanes,), np.int32),
            "base_lens": ((lanes,), np.int32),
            "spec_ok": ((lanes,), np.bool_),
        })
        # per lane: w tokens, the acceptance count, w logprobs' bits
        self.out = torch.zeros((lanes, 2 * w + 1), dtype=torch.int32, device=dev)
        # every lane idle, every slot out of range: the capture's warm-up
        oob = cfg.num_blocks * cfg.block_size
        self._idle_lens = torch.zeros((lanes,), dtype=torch.int32, device=dev)
        self._idle_slots = torch.full((lanes, w), oob, dtype=torch.int32, device=dev)

    def step(self, noise: bool, top: int = 0, idle: bool = False):
        """One verify window, eagerly, from the buffers; ``idle``: every
        lane idle (it changes no cache slot or count).  Returns the ``top``
        best logprobs ([lanes, w, k] values and ids) or None."""
        e, d = self.engine, self.decode
        v = self.inputs.views
        ctx, slots = v["context_lens"], v["slots"]
        if idle:
            ctx, slots = self._idle_lens, self._idle_slots
        token_mat = v["tokens"]
        logits, _ = e.family.forward_verify(
            e.params, e.config.model, token_mat, e.cache, d.tables["tables"], ctx, slots,
            e.cos, e.sin)  # [lanes, w, vocab]
        lanes, w, vocab = logits.shape
        t = d.tail.views
        if noise:  # a plain decode step's draw at the same context
            draw = gumbel(fold_in(t["keys"], v["base_lens"].long()), vocab) * t["sampled"][:, None]
        else:
            draw = logits.new_zeros(())
        outs, lps, tops = [], [], []
        for i in range(w):
            li = apply_penalties(logits[:, i], e._gen_counts, e._prompt_counts,
                                 t["pres"], t["freq"], t["rep"])
            li = apply_logit_bias(li, t["bias_ids"], t["bias_vals"])
            if i == 0:
                ti = sample_tokens(li, draw, t["temp"], t["top_k"], t["top_p"], t["greedy"])
            else:
                ti = torch.argmax(li, dim=-1).to(torch.int32)
            outs.append(ti)
            lps.append(token_logprobs(li, ti))
            if top:
                tops.append(topk_logprobs(li, min(top, vocab)))
        tokens = torch.stack(outs, dim=1)
        # leading-match acceptance: window token i is kept iff every earlier
        # draft matched and it equals the model's output at position i - 1
        active = ctx > 0
        acc = v["spec_ok"] & active
        n_accept = active.to(torch.int32)
        for i in range(1, w):
            acc = acc & (token_mat[:, i] == tokens[:, i - 1])
            n_accept = n_accept + acc.to(torch.int32)
        # generated counts of the accepted tokens only (a row may repeat an id)
        take = (torch.arange(w, device=ctx.device)[None, :] < n_accept[:, None]) & active[:, None]
        e._gen_counts.index_put_(
            (e._lane_idx[:, None].expand(lanes, w), tokens.long()),
            take.to(torch.int32), accumulate=True,
        )
        self.out[:, :w].copy_(tokens)
        self.out[:, w].copy_(n_accept)
        self.out[:, w + 1:].copy_(torch.stack(lps, dim=1).view(torch.int32))
        if not tops:
            return None
        return (torch.stack([vals for vals, _ in tops], dim=1),
                torch.stack([ids for _, ids in tops], dim=1))

    def result(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The last window's (tokens [lanes, w], acceptance counts [lanes],
        logprobs [lanes, w]), read back."""
        out = self.out.cpu().numpy()
        w = self.w
        return out[:, :w], out[:, w], np.ascontiguousarray(out[:, w + 1:]).view(np.float32)

    def run(self, noise: bool) -> None:
        """The window on this window's inputs: a graph replay on a CUDA
        device (captured at first use), the eager step on the CPU."""
        if self.eager:
            self.step(noise)
            return
        self._replay(noise, *self._steps(noise))

    def warm(self) -> None:
        """Capture both graphs and replay each once with every lane idle;
        on the CPU run the step once each with every lane idle."""
        lanes, w = self.lanes, self.w
        self.inputs.upload({
            "tokens": np.zeros((lanes, w), np.int32),
            "slots": self._idle_slots.cpu().numpy(),
            "context_lens": np.zeros((lanes,), np.int32),
            "base_lens": np.zeros((lanes,), np.int32),
            "spec_ok": np.zeros((lanes,), np.bool_),
        })
        for noise in (False, True):
            if self.eager:
                self.step(noise, idle=True)
                continue
            if noise not in self._graphs:
                self._capture(noise, *self._steps(noise))
            self._launch(noise)
        self.warmed = True

    def _steps(self, noise: bool):
        return (lambda: self.step(noise, idle=True)), (lambda: self.step(noise))
