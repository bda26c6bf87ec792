"""Continuous-batching scheduler.

Policy (same family as the reference's mocker scheduler — watermark + budget
with preemption, lib/llm/src/mocker/scheduler.rs:16-205 — and vLLM's):

- admit waiting prefills FCFS while KV blocks (plus watermark) allow and a
  decode lane is free;
- every step, decode all running lanes in one batched call;
- if a running sequence can't grow (no free block), preempt the youngest
  running sequence (free its blocks, recompute later).

The scheduler is host-side bookkeeping only — device work happens in the
engine's jitted step functions.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from dynamo_tpu_torch.engine.kv_manager import BlockAllocator
from dynamo_tpu_torch.engine.sequence import Sequence, SeqStatus
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("engine.scheduler")


@dataclass
class ScheduleDecision:
    prefills: list[Sequence]
    decodes: list[Sequence]
    preempted: list[Sequence]


class Scheduler:
    def __init__(
        self,
        allocator: BlockAllocator,
        *,
        max_batch_size: int,
        max_prefills_per_step: int = 1,
        prefill_chunk_tokens: int | None = None,
        bucket_cost=None,
        unified_batch: bool = False,
    ):
        self.allocator = allocator
        self.max_batch_size = max_batch_size
        self.max_prefills_per_step = max_prefills_per_step
        # chunked prefill: prompts longer than this prefill in chunks
        # interleaved with decode steps (None = whole-prompt prefill)
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # unified-batch mode: decode tokens and chunked-prefill tokens ride
        # ONE ragged window, so the per-step token budget must charge the
        # decode lanes already in it before planning chunks (split mode
        # keeps the historical prefill-only budget — decode runs as its own
        # dispatch there, and its cost is not fungible with chunk tokens)
        self.unified_batch = unified_batch
        # budget accounting charges the PADDED compute of a window (the
        # engine's compile-bucket length), not raw tokens — otherwise a
        # split budget multiplies real per-step prefill work
        self.bucket_cost = bucket_cost or (lambda t: t)
        self.waiting: deque[Sequence] = deque()
        self.running: list[Sequence] = []
        self._free_lanes = list(range(max_batch_size - 1, -1, -1))
        # step telemetry: cumulative preemption count (KV-pressure evidence
        # exported as dyn_worker_preemptions via the metrics service)
        self.preemptions_total = 0
        # wasted-work accounting: every preempted sequence recomputes its
        # whole context, so those tokens were computed for nothing
        self.preempted_tokens_total = 0
        # optional hook fired on every preemption (the engine closes the
        # victim's tracing spans here; the scheduler itself stays
        # observability-agnostic)
        self.on_preempt = None

    # -- queue ops ---------------------------------------------------------
    def add(self, seq: Sequence) -> None:
        self.waiting.append(seq)

    def abort(self, seq: Sequence) -> None:
        if seq in self.running:
            self._release(seq)
        elif seq in self.waiting:
            self.waiting.remove(seq)

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- core policy -------------------------------------------------------
    def schedule(self) -> ScheduleDecision:
        preempted: list[Sequence] = []

        # 1) grow running sequences; preempt youngest on OOM
        survivors: list[Sequence] = []
        for seq in sorted(self.running, key=lambda s: s.arrival_time):
            survivors.append(seq)
        self.running = survivors
        # (growth happens in the engine when it asks for append slots; the
        # preemption hook is exposed via ensure_slot below)

        # 2) continue in-flight chunked prefills, oldest first, under a
        # SHARED per-step token budget (prefill_chunk_tokens): total prefill
        # work per iteration is bounded regardless of how many prefills are
        # in flight, so decode ITL stays bounded (vLLM-style budget)
        bs = self.allocator.block_size
        budget = self.prefill_chunk_tokens  # None = unlimited
        if budget is not None and self.unified_batch:
            # one decode token per running lane shares this step's window:
            # draw them from the same budget so a decode-saturated window
            # shrinks (or skips) its chunk share instead of overrunning
            n_decode = sum(
                1 for s in self.running if s.status == SeqStatus.RUNNING
            )
            budget = max(0, budget - n_decode)
        prefills: list[Sequence] = []
        continuing = sorted(
            (s for s in self.running if s.status == SeqStatus.PREFILLING),
            key=lambda s: s.arrival_time,
        )
        for seq in continuing:
            if budget is not None and budget < bs:
                break
            cost = self._plan_chunk(seq, seq.prefilled_tokens, budget)
            if cost is None:
                break
            if budget is not None:
                budget -= cost
            prefills.append(seq)

        # 3) admit new prefills with the leftover budget while blocks +
        # lanes allow
        admitted = 0
        while (
            self.waiting
            and admitted < self.max_prefills_per_step
            and len(self.running) < self.max_batch_size
            and self._free_lanes
            # enough budget for the smallest possible padded window — this
            # is what makes the post-allocation plan assert hold
            and (budget is None or budget >= self._chunk_cost(bs))
        ):
            candidate = self.waiting[0]
            if candidate.remote_prefilled:
                # KV was injected by a prefill worker into blocks this engine
                # reserved earlier (already adopted): no local prefill compute
                self.waiting.popleft()
                candidate.status = SeqStatus.RUNNING
                candidate.lane = self._free_lanes.pop()
                self.running.append(candidate)
                continue
            # context_len covers preempted sequences re-prefilling with their
            # generated tokens appended; +1 reserves the first decode slot
            if not self.allocator.can_allocate(candidate.context_len + 1):
                break
            self.waiting.popleft()
            # multimodal prompts: block hashes cover text tokens only, so
            # they neither match nor publish into the prefix registry, and
            # they prefill whole (embeds don't chunk)
            mm = candidate.mm_embeds is not None
            alloc = self.allocator.allocate_sequence(
                candidate.seq_id, candidate.context_len + 1,
                token_ids=None if mm else candidate.all_token_ids,
            )
            assert alloc is not None
            _, candidate.cached_tokens = alloc
            candidate.prefilled_tokens = candidate.cached_tokens
            if mm:
                candidate.chunk_target = candidate.context_len
            else:
                cost = self._plan_chunk(candidate, candidate.cached_tokens, budget)
                assert cost is not None  # budget >= bs guarantees a plan
                if budget is not None:
                    budget -= cost
            candidate.status = (
                SeqStatus.PREFILLING
                if candidate.chunk_target < candidate.context_len
                else SeqStatus.RUNNING
            )
            candidate.lane = self._free_lanes.pop()
            prefills.append(candidate)
            self.running.append(candidate)
            admitted += 1

        decodes = [s for s in self.running if s not in prefills]
        return ScheduleDecision(prefills=prefills, decodes=decodes, preempted=preempted)

    def _chunk_cost(self, take: int) -> int:
        """Budget cost of a ``take``-token chunk window.  Split mode charges
        the PADDED compute (each chunk runs as its own bucketed dispatch);
        unified mode charges raw tokens — decode lanes and every chunk share
        ONE window whose single bucket the engine picks, so padding the
        per-chunk cost there would double-count (and a post-decode-charge
        budget could never afford a full bucket, starving admission)."""
        return take if self.unified_batch else self.bucket_cost(take)

    def _plan_chunk(self, seq: Sequence, start: int, budget: int | None) -> int | None:
        """Set ``seq.chunk_target`` for this step's prefill window starting
        at ``start``; intermediate chunk ends stay block-aligned and the
        window's compute (_chunk_cost) must fit ``budget``.  Returns the
        budget cost charged, or None when nothing affordable fits."""
        remaining = seq.context_len - start
        if budget is None:
            seq.chunk_target = seq.context_len
            return 0
        bs = self.allocator.block_size
        take = min(remaining, budget)
        if take < remaining:  # intermediate end must be block-aligned
            take = (take // bs) * bs
        # shrink until the window's charged compute fits the budget
        while take > 0 and self._chunk_cost(take) > budget:
            take = ((take - 1) // bs) * bs
        if take <= 0:
            return None
        seq.chunk_target = start + take
        return self._chunk_cost(take)

    def ensure_slot(self, seq: Sequence) -> int | None:
        """Get the cache slot for this sequence's next token, preempting the
        youngest other running sequence if the pool is exhausted."""
        return self.ensure_slots(seq, 1)

    def ensure_slots(self, seq: Sequence, steps: int, max_pos: int | None = None) -> int | None:
        """Like ensure_slot but pre-extends the block table to cover a
        ``steps``-token decode window (positions capped at ``max_pos``)."""
        while True:
            slot = self.allocator.append_slots(seq.seq_id, seq.context_len, steps, max_pos)
            if slot is not None:
                return slot
            victim = self._youngest_other(seq)
            if victim is None:
                return None  # nothing to preempt; caller must handle
            self.preempt(victim)

    def try_slots_at(
        self, seq: Sequence, context_len: int, steps: int,
        max_pos: int | None = None,
    ) -> int | None:
        """``ensure_slots`` at an EXPLICIT context length (the overlapped
        decode pipeline allocates at the device-side context —
        ``seq.context_len + seq.inflight_tokens`` — because in-flight
        windows have already advanced past what the host retired), and
        WITHOUT preemption: while a window is in flight, freeing a victim's
        blocks would let the lagged device step garbage-write into storage
        the allocator may re-issue or prefix-match.  On None the engine
        drains the pipeline and retries through the preempting sync path."""
        return self.allocator.append_slots(seq.seq_id, context_len, steps, max_pos)

    def _youngest_other(self, seq: Sequence) -> Sequence | None:
        candidates = [s for s in self.running if s is not seq]
        if not candidates:
            return None
        return max(candidates, key=lambda s: s.arrival_time)

    def preempt(self, seq: Sequence) -> None:
        logger.warning("preempting sequence %s (recompute)", seq.seq_id)
        self.preemptions_total += 1
        self.preempted_tokens_total += max(seq.context_len, 0)
        if self.on_preempt is not None:
            self.on_preempt(seq)
        self._release(seq)
        seq.status = SeqStatus.PREEMPTED
        # remotely-prefilled KV is gone once blocks are freed: recompute locally
        seq.remote_prefilled = False
        seq.prefilled_tokens = 0
        # preemption only ever happens with the decode pipeline drained
        # (try_slots_at never preempts); zero the in-flight count anyway so
        # the recompute path starts from clean accounting
        seq.inflight_tokens = 0
        # re-queue at the front: preempted sequences restart first (their
        # prompt now includes generated tokens, so recompute is exact)
        self.waiting.appendleft(seq)

    def finish(self, seq: Sequence) -> None:
        self._release(seq)
        seq.status = SeqStatus.FINISHED

    def _release(self, seq: Sequence) -> None:
        if seq in self.running:
            self.running.remove(seq)
        if seq.lane >= 0:
            self._free_lanes.append(seq.lane)
            seq.lane = -1
        self.allocator.free_sequence(seq.seq_id)
