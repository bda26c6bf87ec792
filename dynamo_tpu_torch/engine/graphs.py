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
fixed shape (see its docstring).  ``TorchLlmEngine.warmup`` captures every
reachable bucket's graphs and the decode graphs before serving.
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


class DecodeGraph:
    """The persistent inputs of a decode window and the window itself:
    ``tokens`` / ``use_fb`` / ``lens`` (``window``), the block ``tables``
    and the sampling ``tail`` (lane keys, the sampled mask, temperature,
    top-k, top-p, greedy, the three penalties and the logit-bias rows),
    beside the engine's persistent cache, penalty counts and parameters;
    ``feedback`` holds each lane's last sampled token, written by every
    decode and unified window on the device and read by the next one where
    ``use_fb`` says so."""

    def __init__(self, engine, bias_width: int, pool=None):
        self.engine = engine
        cfg = engine.config
        self.device = dev = engine.device
        self.pool = pool  # the graphs' memory pool (shared with the unified graphs)
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
        })
        self.feedback = torch.zeros((lanes,), dtype=torch.int32, device=dev)
        self.out_tokens = torch.zeros((self.steps, lanes), dtype=torch.int32, device=dev)
        self.out_lps = torch.zeros((self.steps, lanes), dtype=torch.float32, device=dev)
        self._idle_lens = torch.zeros((lanes,), dtype=torch.int32, device=dev)
        # noise drawn? -> (graph, launches a replay holds)
        self._graphs: dict[bool, tuple[torch.cuda.CUDAGraph, dict]] = {}
        self.replays = 0
        self.capture_ms = 0.0
        self.pool_mb = 0.0
        self.warmed = False      # warm() ran: a later capture is counted apart
        self.late_captures = 0

    # -- the window --------------------------------------------------------
    def sample(self, logits, fold_lens, gate, noise: bool, top: int = 0):
        """The sampling tail of a decode or unified window, from the
        ``tail`` buffers: penalties, logit bias, Gumbel noise from each
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
        if self.device.type != "cuda":
            self.step(noise)
            return
        if noise not in self._graphs:
            self._graphs[noise] = self._capture(noise)
            self.late_captures += self.warmed
        graph, launches = self._graphs[noise]
        graph.replay()
        _add_counts(launches)
        self.replays += 1

    def warm(self) -> None:
        """Capture both graphs (noise drawn and not) before serving, and
        replay each once with every lane idle: a graph's first launch
        uploads it to the card, which a serving window should not wait for
        (its launches are counted, as every replay's).  On the CPU run the
        step once each with every lane idle."""
        lanes = self._idle_lens.shape[0]
        for noise in (False, True):
            if self.device.type != "cuda":
                self.step(noise, lens=self._idle_lens)
                continue
            if noise not in self._graphs:
                self._graphs[noise] = self._capture(noise)
            self.window.upload({"tokens": np.zeros((lanes,), np.int32),
                                "use_fb": np.zeros((lanes,), np.bool_),
                                "lens": np.zeros((lanes,), np.int32)})
            graph, launches = self._graphs[noise]
            graph.replay()
            _add_counts(launches)
        self.warmed = True

    def _capture(self, noise: bool) -> tuple[torch.cuda.CUDAGraph, dict]:
        """Warm the step once on a side stream with every lane idle (so it
        changes no cache slot, count or feedback), then capture it."""
        graph, launches, ms, mb = capture(self.device, self.pool,
                                          lambda: self.step(noise, lens=self._idle_lens),
                                          lambda: self.step(noise))
        self.capture_ms += ms
        self.pool_mb += mb
        return graph, launches

    def stats(self) -> dict:
        return {
            "decode_graph_replays_total": self.replays,
            "decode_graphs_captured": len(self._graphs),
            "decode_graph_capture_ms": self.capture_ms,
            "decode_graph_pool_mb": self.pool_mb,
            "decode_graphs_captured_after_warmup": self.late_captures,
        }


def capture(dev: torch.device, pool, idle, live) -> tuple[torch.cuda.CUDAGraph, dict, float, float]:
    """Run ``idle`` (the step with nothing live: it changes no cache slot,
    count or feedback) once on a side stream, then capture ``live`` into a
    graph over the memory ``pool``.  The capture launched nothing: the
    counters it moved are taken back and kept as what each replay
    launches.  Returns (graph, launches a replay holds, ms taken, MB the
    pool grew by).  A capture that fails raises."""
    t0 = time.perf_counter()
    # the capture empties the allocator's cache on entry: empty it first too,
    # so the reserved bytes it adds are the graphs' pool's
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        idle()
    torch.cuda.current_stream(dev).wait_stream(side)
    before = launch_counters()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        live()
    after = launch_counters()
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    _add_counts(launches, -1)
    return (graph, launches, (time.perf_counter() - t0) * 1e3,
            (torch.cuda.memory_reserved(dev) - reserved) / 2**20)


class UnifiedGraph:
    """The unified (mixed prefill + decode) window as one CUDA graph per
    (token bucket, noise), as the reference compiles one program per token
    bucket (dynamo_tpu/engine/engine.py ``_build_unified``, warmed by
    ``aot_precompile``).

    Every input has one shape per bucket: the flat token axis (``token_ids``
    / ``use_fb`` / ``token_pos`` / ``token_slot`` / ``token_lane``), the
    lane arrays (``context_lens`` / ``sample_rows`` / ``sample_gate``), the
    ``seed_slots`` lanes whose penalty counts a newly admitted prefill
    re-seeds (out of range: none), the page worklist at the fixed width
    ``page_slots = tb x max_blocks_per_seq`` (``page_phys`` / ``page_lane``
    / ``page_ord`` / ``page_count``) and, where the family's kernel takes
    one, the work plan at its fixed capacity (``plan``).  They live in one
    ``Staged`` buffer laid out per bucket (a window copies its bucket's
    bytes), the seed rows in another (copied only in a window that seeds).
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

    def __init__(self, engine, decode: DecodeGraph, buckets: list[int], seed_slots: int,
                 planner=None, pool=None):
        self.engine = engine
        self.decode = decode
        cfg = engine.config
        self.device = dev = engine.device
        self.pool = pool
        self.tb = tb = engine._unified_tb
        self.lanes = lanes = cfg.max_batch_size
        self.page_slots = ps = tb * engine.max_blocks_per_seq
        self.seed_slots = seed_slots
        self.buckets = sorted(buckets)
        self.planner = planner
        vocab = cfg.model.vocab_size
        self.caps = {b: planner.caps(b // tb) for b in self.buckets} if planner else {}

        def fields(b: int) -> dict:
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

        self.inputs = Staged(dev, variants={b: fields(b) for b in self.buckets})
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
                self.work[b] = DeviceWork(ntb, caps, self.inputs.view(b)["plan"], self.scratch)
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
        # (bucket, noise drawn?) -> (graph, launches a replay holds)
        self._graphs: dict[tuple[int, bool], tuple[torch.cuda.CUDAGraph, dict]] = {}
        self.replays = 0
        self.capture_ms: dict[int, float] = {}
        self.pool_mb = 0.0
        self.warmed = False
        self.late_captures = 0

    # -- inputs ------------------------------------------------------------
    def upload(self, bucket: int, arrays: dict[str, np.ndarray], plan=None,
               seeds: list[tuple[int, np.ndarray, np.ndarray]] = ()) -> None:
        """Write a window's host arrays into ``bucket``'s buffers in place:
        the token axis, lane and worklist arrays (``arrays``), ``plan``
        packed at the bucket's capacity (it refuses one that does not
        fit), and each seed (lane, prompt counts, generated counts) into a
        seed slot (the rest out of range)."""
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
        self.inputs.upload(arrays, bucket)
        if seeds:
            vocab = self.seeds["prompt"].shape[1]
            prompt = np.zeros((self.seed_slots, vocab), np.int32)
            gen = np.zeros((self.seed_slots, vocab), np.int32)
            for i, (_, p, g) in enumerate(seeds):
                prompt[i], gen[i] = p, g
            self.seeds.upload({"prompt": prompt, "gen": gen})

    # -- the window --------------------------------------------------------
    def step(self, bucket: int, noise: bool, top: int = 0, idle: bool = False):
        """One unified window of ``bucket`` tokens, eagerly, from the
        buffers: decode lanes marked ``use_fb`` take their input token from
        the feedback, the seeded lanes' penalty counts are rewritten before
        the penalties read them, intermediate-chunk samples are gated out
        of the generated counts, and the emitting lanes' tokens become the
        feedback.  ``idle``: every token a pad, no lane sampled or seeded
        (a capture's warm-up: it changes no cache slot, count or
        feedback).  Returns the ``top`` best logprobs ([lanes, k] values
        and ids) or None."""
        e, d = self.engine, self.decode
        v = self.inputs.view(bucket)
        work = self.work.get(bucket)
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
            v["sample_rows"], e.cos, e.sin, tb_tokens=self.tb, **kw,
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

    def run(self, bucket: int, noise: bool) -> None:
        """The window on this window's inputs: a graph replay on a CUDA
        device (captured at first use), the eager step on the CPU.  The
        results are in ``out_tokens`` / ``out_lps``."""
        if self.device.type != "cuda":
            self.step(bucket, noise)
            return
        key = (bucket, noise)
        if key not in self._graphs:
            self._graphs[key] = self._capture(bucket, noise)
            self.late_captures += self.warmed
        graph, launches = self._graphs[key]
        graph.replay()
        _add_counts(launches)
        self.replays += 1

    def warm(self) -> None:
        """Capture every bucket's graphs (noise drawn and not) before
        serving, and replay each once on a window with nothing live: a
        graph's first launch uploads it to the card, which a serving window
        should not wait for (its launches are counted, as every replay's).
        On the CPU run each bucket's step once with nothing live."""
        for bucket in self.buckets:
            for noise in (False, True):
                if self.device.type != "cuda":
                    self.step(bucket, noise, idle=True)
                elif (bucket, noise) not in self._graphs:
                    self._graphs[bucket, noise] = self._capture(bucket, noise)
            if self.device.type != "cuda":
                continue
            self.upload(bucket, self._idle_arrays(bucket),
                        self.planner.plan(np.zeros((bucket // self.tb,), np.int32))
                        if self.planner else None)
            for noise in (False, True):
                graph, launches = self._graphs[bucket, noise]
                graph.replay()
                _add_counts(launches)
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

    def _capture(self, bucket: int, noise: bool) -> tuple[torch.cuda.CUDAGraph, dict]:
        graph, launches, ms, mb = capture(
            self.device, self.pool, lambda: self.step(bucket, noise, idle=True),
            lambda: self.step(bucket, noise))
        self.capture_ms[bucket] = self.capture_ms.get(bucket, 0.0) + ms
        self.pool_mb += mb
        return graph, launches

    def stats(self) -> dict:
        return {
            "unified_graph_replays_total": self.replays,
            "unified_graphs_captured": len(self._graphs),
            "unified_graph_capture_ms": sum(self.capture_ms.values()),
            "unified_graph_pool_mb": self.pool_mb,
            "unified_graphs_captured_after_warmup": self.late_captures,
        }
