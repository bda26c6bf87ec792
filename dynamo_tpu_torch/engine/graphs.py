"""The decode window as one CUDA graph.

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
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

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
    is still queued."""

    def __init__(self, device: torch.device, fields: dict[str, tuple[tuple, Any]]):
        self.device = device
        self._layout = {}
        off = 0
        for name, (shape, dtype) in fields.items():
            dtype = np.dtype(dtype)
            nbytes = int(np.prod(shape)) * dtype.itemsize
            self._layout[name] = (off, nbytes, tuple(shape), dtype)
            off += -(-nbytes // _ALIGN) * _ALIGN
        self.nbytes = off
        self.buffer = torch.zeros(off, dtype=torch.uint8, device=device)
        cuda = device.type == "cuda"
        self._host = [torch.zeros(off, dtype=torch.uint8, pin_memory=cuda) for _ in range(2)]
        self._events: list = [None, None]
        self._slot = 0
        self.views = {
            name: self.buffer[o: o + n].view(_TORCH_DTYPES[dt]).view(shape)
            for name, (o, n, shape, dt) in self._layout.items()
        }

    def upload(self, arrays: dict[str, np.ndarray]) -> None:
        """Write every field from ``arrays`` (all of them, host values)."""
        if arrays.keys() != self._layout.keys():
            raise ValueError(f"staged upload needs {sorted(self._layout)}, got {sorted(arrays)}")
        slot = self._slot
        self._slot ^= 1
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        host = self._host[slot].numpy()
        for name, (o, n, shape, dt) in self._layout.items():
            host[o: o + n] = np.ascontiguousarray(arrays[name], dtype=dt).reshape(-1).view(np.uint8)
        self.buffer.copy_(self._host[slot], non_blocking=True)
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._events[slot] = ev

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

    def __init__(self, engine, bias_width: int):
        self.engine = engine
        cfg = engine.config
        self.device = dev = engine.device
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
        graph, launches = self._graphs[noise]
        graph.replay()
        _add_counts(launches)
        self.replays += 1

    def _capture(self, noise: bool) -> tuple[torch.cuda.CUDAGraph, dict]:
        """Warm the step once on a side stream with every lane idle (so it
        changes no cache slot, count or feedback), then capture it.  The
        capture launched nothing: the counters it moved are taken back and
        kept as what each replay launches."""
        dev = self.device
        t0 = time.perf_counter()
        # the capture empties the allocator's cache on entry: empty it first
        # too, so the reserved bytes it adds are the graph's private pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.step(noise, lens=self._idle_lens)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = launch_counters()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.step(noise)
        after = launch_counters()
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        _add_counts(launches, -1)
        self.capture_ms += (time.perf_counter() - t0) * 1e3
        self.pool_mb += (torch.cuda.memory_reserved(dev) - reserved) / 2**20
        return graph, launches

    def stats(self) -> dict:
        return {
            "decode_graph_replays_total": self.replays,
            "decode_graphs_captured": len(self._graphs),
            "decode_graph_capture_ms": self.capture_ms,
            "decode_graph_pool_mb": self.pool_mb,
        }
