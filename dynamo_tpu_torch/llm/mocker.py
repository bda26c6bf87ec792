"""Mocker: a simulated engine for infrastructure testing at scale.

Mirrors the reference's mocker (lib/llm/src/mocker/: watermark+budget
scheduler, KV manager with prefix bookkeeping, cost model "prefill quadratic,
decode ∝ active blocks", scheduler.rs:31-33) without any device work: it
reuses the real BlockAllocator + Scheduler host logic, sleeps according to
the cost model, emits deterministic tokens, and publishes the same KV/load
events as the real engine — so routers, disagg and planners can be exercised
with hundreds of simulated workers on one CPU.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from collections import deque
from dataclasses import dataclass
from typing import AsyncIterator, Callable

from dynamo_tpu_torch.engine.kv_manager import BlockAllocator, KvEvent
from dynamo_tpu_torch.engine.scheduler import Scheduler
from dynamo_tpu_torch.observability.flight import FlightRecorder
from dynamo_tpu_torch.engine.sequence import Sequence, SeqStatus
from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.engine import Context, ResponseStream
from dynamo_tpu_torch.runtime.resume import ack_item, apply_resume
from dynamo_tpu_torch.utils.tasks import spawn_logged


@dataclass
class MockerConfig:
    num_blocks: int = 512
    block_size: int = 16
    max_batch_size: int = 16
    speedup: float = 100.0               # simulation time compression
    # cost model (seconds at speedup=1)
    prefill_linear_s: float = 0.0002     # per prompt token
    prefill_quadratic_s: float = 2e-8    # per token^2 (attention)
    decode_base_s: float = 0.01          # per decode iteration
    decode_per_block_s: float = 0.00005  # per active KV block
    # disagg pool membership reported through stats()/ForwardPassMetrics
    # ("prefill"/"decode", "" = serves both)
    role: str = ""
    # emulated inbound KV-transfer latency (seconds at speedup=1) added per
    # prefill — how multi-slice soaks make a worker behind a DCN hop pay
    # for the prefix bytes shipped to it (scenarios/fleet.py sets it from
    # FleetSpec.link_delay_s by the worker's link class)
    transfer_delay_s: float = 0.0
    # rolling window (wall seconds) for the goodput/prefill-rate/MFU stats
    util_window_s: float = 2.0


class MockerEngine:
    """Wire-compatible with JaxLlmEngine (PreprocessedRequest dicts in,
    Annotated[LLMEngineOutput] wire dicts out) but fully simulated."""

    def __init__(
        self,
        config: MockerConfig | None = None,
        *,
        event_sink: Callable[[KvEvent], None] | None = None,
    ):
        self.config = config or MockerConfig()
        self._event_sink = event_sink
        self.allocator = BlockAllocator(
            self.config.num_blocks, self.config.block_size, event_sink=self._sink
        )
        self.scheduler = Scheduler(self.allocator, max_batch_size=self.config.max_batch_size)
        self._task: asyncio.Task | None = None
        self._wake = asyncio.Event()
        self._iterations = 0
        # utilization accounting: per-iteration samples of (wall_t, tokens
        # emitted, prefill tokens served, simulated busy seconds) feed the
        # rolling goodput/prefill-rate/MFU window; totals are cumulative
        self._util: deque = deque()
        self._t0: float | None = None
        self._tokens_emitted_total = 0
        self._prefill_tokens_total = 0
        self._decode_tokens_total = 0
        # perf flight recorder: same ring + dump triggers as the real engine
        # so soak fleets produce replayable load traces (DYN_FLIGHT=0 = off)
        self.flight = FlightRecorder(source="mocker")
        self._flight_preemptions = 0

    def _sink(self, event: KvEvent) -> None:
        if self._event_sink is not None:
            self._event_sink(event)

    def start(self) -> None:
        if self._task is None:
            self._t0 = time.monotonic()
            self._task = spawn_logged(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def _util_rates(self) -> tuple[float, float, float]:
        """(goodput tok/s, prefill tok/s, mfu fraction) over the rolling
        window — wall-clock rates, so at speedup=S they read S× the
        simulated-time rates (same compression as the cost model)."""
        cfg = self.config
        now = time.monotonic()
        horizon = now - cfg.util_window_s
        while self._util and self._util[0][0] < horizon:
            self._util.popleft()
        elapsed = cfg.util_window_s
        if self._t0 is not None:
            elapsed = min(elapsed, max(now - self._t0, 1e-3))
        tokens = sum(s[1] for s in self._util)
        prefill = sum(s[2] for s in self._util)
        busy_sim = sum(s[3] for s in self._util)
        # busy fraction in SIMULATED time: sim busy seconds / sim elapsed
        # seconds — the mocker's stand-in for model FLOPs utilization
        mfu = min(busy_sim / (elapsed * cfg.speedup), 1.0)
        return tokens / elapsed, prefill / elapsed, mfu

    def stats(self) -> dict:
        goodput, prefill_rate, mfu = self._util_rates()
        return {
            "role": self.config.role,
            "kv_active_blocks": self.allocator.used_blocks,
            "kv_total_blocks": self.allocator.num_blocks,
            "gpu_cache_usage_perc": self.allocator.usage,
            "num_requests_waiting": self.scheduler.num_waiting,
            "num_requests_running": self.scheduler.num_running,
            "request_total_slots": self.config.max_batch_size,
            "iterations_total": self._iterations,
            # same step-telemetry names as the real engine so mocker fleets
            # light up the dyn_worker occupancy/preemption gauges too
            "batch_occupancy_perc": (
                self.scheduler.num_running / max(self.config.max_batch_size, 1)
            ),
            "num_preemptions_total": self.scheduler.preemptions_total,
            # utilization accounting (same names as observability.perf) so
            # planner capacity sampling and the soak's MFU/goodput floors
            # work against mocker fleets
            "goodput_tokens_per_second": goodput,
            "prefill_tokens_per_second": prefill_rate,
            "mfu_perc": mfu,
            "tokens_emitted_total": self._tokens_emitted_total,
            "prefill_tokens_total": self._prefill_tokens_total,
            "decode_tokens_total": self._decode_tokens_total,
            **self.flight.stats(),
        }

    async def generate(self, request: Context[dict]) -> ResponseStream[dict]:
        # continuation-mode resume: a re-dispatched stream carries the
        # accepted tokens in ``resume_from`` — extend the prompt with them,
        # shrink the remaining budget, and ack as the FIRST item so the
        # dispatcher's dedupe cursor knows not to drop anything.  The
        # (last+1) mod 1000 "model" makes continuation exactly equal to a
        # replay's tail, which is what resume-aware real engines promise.
        wire, accepted = apply_resume(request.data)
        pre = PreprocessedRequest.from_wire(wire)
        ctx = request.ctx
        out_q: asyncio.Queue = asyncio.Queue()
        if accepted:
            out_q.put_nowait(ack_item(accepted))
        seq = Sequence(seq_id=ctx.id or uuid.uuid4().hex, request=pre)

        def emit(tokens: list[int], finish: FinishReason | None) -> None:
            wire = Annotated.from_data(
                LLMEngineOutput(token_ids=tokens, finish_reason=finish)
            ).to_wire(LLMEngineOutput.to_wire)
            out_q.put_nowait(wire)
            if finish is not None:
                out_q.put_nowait(None)

        seq.emit = emit
        self.scheduler.add(seq)
        self._wake.set()

        watcher = spawn_logged(self._watch_cancel(ctx, seq))

        async def gen() -> AsyncIterator[dict]:
            try:
                while True:
                    item = await out_q.get()
                    if item is None:
                        return
                    yield item
            finally:
                watcher.cancel()

        return ResponseStream(gen(), ctx)

    async def _watch_cancel(self, ctx, seq: Sequence) -> None:
        await ctx.stopped()
        if seq.status != SeqStatus.FINISHED:
            self.scheduler.abort(seq)
            seq.status = SeqStatus.FINISHED
            if seq.emit:
                seq.emit([], FinishReason.CANCELLED)

    async def _loop(self) -> None:
        cfg = self.config
        while True:
            if not self.scheduler.has_work():
                self._wake.clear()
                await self._wake.wait()
            decision = self.scheduler.schedule()
            cost = 0.0
            prefill_tokens = 0
            for seq in decision.prefills:
                # prefix-cache hits only pay for the NEW tokens, attending
                # over the full context (reference: mocker/scheduler.rs:31
                # "prefill compute = (cached_tokens + new_tokens) *
                # new_tokens") — this is the mechanism a KV-aware router
                # exploits, so the simulation must credit it
                cached = seq.cached_tokens
                new = max(seq.context_len - cached, 0)
                prefill_tokens += new
                cost += (
                    cfg.prefill_linear_s * new
                    + cfg.prefill_quadratic_s * (cached + new) * new
                    + cfg.transfer_delay_s
                )
            decodes = [s for s in self.scheduler.running if s.status == SeqStatus.RUNNING]
            if decodes:
                cost += cfg.decode_base_s + cfg.decode_per_block_s * self.allocator.used_blocks
            # simulate the compute FIRST, then emit: a request's first token
            # must arrive after its prefill cost (TTFT is the whole point of
            # the simulation — emitting before sleeping made every TTFT ~0
            # regardless of prompt length or cache state)
            self._iterations += 1
            await asyncio.sleep(cost / cfg.speedup)
            emitted_before = self._tokens_emitted_total
            for seq in decision.prefills:
                if seq.status == SeqStatus.FINISHED:  # cancelled mid-sleep
                    continue
                self.allocator.publish_stored(seq.seq_id, seq.all_token_ids)
                self._emit_next(seq)
            decode_before = self._tokens_emitted_total
            for seq in decodes:
                # FINISHED (cancelled mid-sleep) or PREEMPTED (victimized by
                # an EARLIER seq's ensure_slot in this very loop — its blocks
                # are gone, touching the allocator would KeyError): skip; a
                # preempted seq is already queued for recompute.
                if seq.status != SeqStatus.RUNNING:
                    continue
                slot = self.scheduler.ensure_slot(seq)
                if slot is None:
                    self.scheduler.preempt(seq)
                    continue
                self._emit_next(seq)
            self._prefill_tokens_total += prefill_tokens
            self._decode_tokens_total += self._tokens_emitted_total - decode_before
            self._util.append((
                time.monotonic(),
                self._tokens_emitted_total - emitted_before,
                prefill_tokens,
                cost,
            ))
            if self.flight.enabled:
                preempted = self.scheduler.preemptions_total
                if preempted > self._flight_preemptions:
                    self.flight.record_event(
                        "preemption",
                        count=preempted - self._flight_preemptions,
                        total=preempted,
                    )
                    self._flight_preemptions = preempted
                goodput, prefill_rate, mfu = self._util_rates()
                self.flight.record_step(
                    iteration=self._iterations,
                    num_running=self.scheduler.num_running,
                    num_waiting=self.scheduler.num_waiting,
                    kv_usage=self.allocator.usage,
                    prefill_tokens=prefill_tokens,
                    decode_tokens=self._tokens_emitted_total - decode_before,
                    emitted_tokens=self._tokens_emitted_total - emitted_before,
                    step_duration_s=cost / cfg.speedup,
                    mfu=mfu,
                    goodput_tok_s=goodput,
                )

    def _emit_next(self, seq: Sequence) -> None:
        # deterministic "generation": next token = (last + 1) mod 1000
        token = (seq.all_token_ids[-1] + 1) % 1000 if seq.all_token_ids else 0
        seq.output_ids.append(token)
        self._tokens_emitted_total += 1
        finish = seq.hit_stop(token)
        if seq.emit:
            seq.emit([token], finish)
        if finish is not None:
            self.scheduler.finish(seq)
        elif seq.context_len % self.config.block_size == 0:
            self.allocator.publish_stored(seq.seq_id, seq.all_token_ids)
