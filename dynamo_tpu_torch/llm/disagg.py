"""Disaggregated prefill/decode (a copy of dynamo_tpu/llm/disagg.py over
``TorchLlmEngine``: extraction on the prefill engine gathers with the
block-gather kernel, injection on the decode engine scatters with the
block-scatter kernel).

Decision + orchestration (reference: SURVEY.md §3.4; decision thresholds
lib/llm/src/disagg_router.rs:25-34 with etcd hot-reload :38-90; queue
examples/llm/utils/prefill_queue.py + NatsQueue):

- ``DisaggRouter``    — prefill locally vs remotely: remote iff prompt length
  exceeds ``max_local_prefill_length`` AND the prefill queue is not backed
  up; config hot-reloads from a control-plane KV key watch.
- ``PrefillQueue``    — durable work queue on the control-plane bus.
- ``DisaggDecodeEngine`` — decode-worker engine wrapper: on remote decision,
  reserves landing blocks, enqueues a RemotePrefillRequest, waits for the KV
  transfer, then decodes.  Local decision falls through to the inner engine.
- ``PrefillWorker``   — dequeues, prefills on its own engine/mesh, ships KV
  blocks to the decode worker's transfer server.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import time
import uuid
from dataclasses import dataclass, field

from dynamo_tpu_torch.engine.engine import TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.observability import get_recorder
from dynamo_tpu_torch.observability.trace import read_trace, stamp_trace
from dynamo_tpu_torch.parallel.kv_transfer import (
    LOCAL_SERVERS,
    KvTransferClient,
    KvTransferPayload,
    KvTransferServer,
    payload_nbytes,
)
from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.robustness.faults import FAULTS, PREFILL_DEQUEUE
from dynamo_tpu_torch.robustness.retry import Backoff
from dynamo_tpu_torch.runtime.component import ROOT_PATH
from dynamo_tpu_torch.runtime.controlplane.interface import WatchEventType
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context, ResponseStream
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged
from dynamo_tpu_torch.utils import knobs

logger = get_logger("llm.disagg")


def disagg_config_key(model: str) -> str:
    return f"{ROOT_PATH}public/components/disagg_router/models/chat/{model}"


def kv_stream_enabled() -> bool:
    """Streamed (multi-part, overlapped-with-prefill) KV transfer knob.
    Default ON; ``DYN_KV_STREAM=0`` falls back to the single-shot
    post-prefill transfer."""
    return knobs.get("DYN_KV_STREAM")


@dataclass
class DisaggConfig:
    max_local_prefill_length: int = 512
    max_prefill_queue_size: int = 16
    # link-cost guard: skip remote prefill when the estimated KV transfer
    # (prompt blocks / measured inbound bandwidth) would take longer than
    # this — behind a slow DCN hop, local prefill beats shipping the cache.
    # 0 = guard off; unmeasured links are never gated.
    max_transfer_seconds: float = 0.0


class DisaggRouter:
    """Local-vs-remote prefill decision with KV-watched hot reload."""

    def __init__(self, runtime: DistributedRuntime, model: str, config: DisaggConfig | None = None):
        self.runtime = runtime
        self.model = model
        self.config = config or DisaggConfig()
        self._watch = None
        self._task: asyncio.Task | None = None

    async def start(self) -> None:
        self._watch = self.runtime.plane.kv.watch_prefix(disagg_config_key(self.model))
        self._task = spawn_logged(self._loop())

    async def stop(self) -> None:
        if self._watch is not None:
            self._watch.cancel()
        if self._task is not None:
            self._task.cancel()

    async def _loop(self) -> None:
        """Run the config watch; on connection loss, resubscribe with
        backoff instead of exiting permanently (pre-fix, one dropped
        control-plane connection froze the disagg thresholds forever —
        the router kept serving on the last config, but could never see
        another hot-reload)."""
        backoff = Backoff(initial=0.1, max_delay=5.0)
        while True:
            started = asyncio.get_running_loop().time()
            try:
                await self._config_loop()
                return  # watch cancelled / closed cleanly (stop())
            except ConnectionError as exc:
                # a watch that survived a while before dying is a fresh,
                # independent outage — don't let attempts accumulate over a
                # long process lifetime until every blip pays the max delay
                if asyncio.get_running_loop().time() - started > 5.0:
                    backoff.reset()
                delay = backoff.next()
                logger.warning(
                    "disagg config watch lost (keeping last config; "
                    "resubscribing in %.1fs): %s", delay, exc,
                )
                await asyncio.sleep(delay)  # stop() cancels us here
                self._watch = self.runtime.plane.kv.watch_prefix(
                    disagg_config_key(self.model)
                )

    async def _config_loop(self) -> None:
        async for event in self._watch:
            if event.type != WatchEventType.PUT:
                continue
            try:
                d = json.loads(event.entry.value)
                self.config = DisaggConfig(
                    max_local_prefill_length=d.get(
                        "max_local_prefill_length", self.config.max_local_prefill_length
                    ),
                    max_prefill_queue_size=d.get(
                        "max_prefill_queue_size", self.config.max_prefill_queue_size
                    ),
                    max_transfer_seconds=d.get(
                        "max_transfer_seconds", self.config.max_transfer_seconds
                    ),
                )
                logger.info("disagg config reloaded: %s", self.config)
            except Exception:  # noqa: BLE001
                logger.exception("bad disagg config update")
                # a poison value that keeps getting re-emitted (e.g. a
                # config controller fighting the watch) must not spin this
                # loop hot
                await asyncio.sleep(0.1)

    def prefill_remote(
        self, prefill_length: int, queue_size: int, est_transfer_s: float = 0.0
    ) -> bool:
        return (
            prefill_length > self.config.max_local_prefill_length
            and queue_size < self.config.max_prefill_queue_size
            and (
                self.config.max_transfer_seconds <= 0
                or est_transfer_s <= self.config.max_transfer_seconds
            )
        )


class PrefillQueue:
    """Durable prefill work queue (JetStream-analog on the control-plane bus)."""

    def __init__(self, runtime: DistributedRuntime, namespace: str, component: str):
        self.runtime = runtime
        self.queue_name = f"{namespace}.{component}.prefill"

    async def enqueue(self, request: dict) -> None:
        await self.runtime.plane.bus.queue_publish(
            self.queue_name, json.dumps(request).encode()
        )

    async def dequeue(self, timeout: float | None = None) -> dict | None:
        raw = await self.runtime.plane.bus.queue_pop(self.queue_name, timeout)
        return json.loads(raw) if raw is not None else None

    async def dequeue_with_age(
        self, timeout: float | None = None
    ) -> tuple[dict, float | None] | None:
        """Dequeue plus the broker-measured queue age (None when the bus
        doesn't track enqueue times)."""
        item = await self.runtime.plane.bus.queue_pop_meta(self.queue_name, timeout)
        if item is None:
            return None
        raw, age = item
        return json.loads(raw), age

    async def size(self) -> int:
        return await self.runtime.plane.bus.queue_len(self.queue_name)


@dataclass
class _StreamAssembly:
    """Decode-side state for one in-flight multi-part KV stream.

    Parts may arrive out of order (a re-dialed client connection gets its
    own server task) and duplicated (an ack lost to a reset makes the
    client re-send over a fresh connection); ``received`` makes injection
    idempotent per part and completion order-free.  Timing splits into
    ``active_seconds`` (sum of per-part receive→inject work) and the
    exposure window after the closing part lands — their difference is the
    transfer time HIDDEN behind prefill compute, the quantity streaming
    exists to maximize."""

    received: set[int] = field(default_factory=set)   # arrival dedup
    injected: set[int] = field(default_factory=set)   # scatter completed
    # landing-block offsets whose KV has fully landed — the resume cursor
    # for re-enqueueing a stream whose prefill worker died mid-flight
    covered_blocks: set[int] = field(default_factory=set)
    last_index: int | None = None
    first_token: int | None = None
    first_token_logprob: float | None = None
    first_token_top_logprobs: list | None = None
    bytes: int = 0
    blocks_received: int = 0
    active_seconds: float = 0.0
    last_part_arrival: float | None = None  # monotonic; set when ``last`` lands
    inflight: int = 0                       # parts currently inside inject_blocks
    # set when the requester abandons the stream while a part is mid-inject:
    # the landing blocks stay reserved until the last in-flight inject
    # drains, then ITS handler releases them (never free under a writer)
    abandoned_blocks: list[int] | None = None
    span: object = None

    def contiguous_blocks(self) -> int:
        """Blocks 0..n-1 all fully injected — where a resumed prefill
        stream can safely skip to (anything past a gap must be re-shipped,
        so only the contiguous prefix counts)."""
        n = 0
        while n in self.covered_blocks:
            n += 1
        return n


class DisaggDecodeEngine:
    """Engine wrapper on the decode worker implementing the remote-prefill
    flow; wire-compatible AsyncEngine."""

    def __init__(
        self,
        runtime: DistributedRuntime,
        engine: TorchLlmEngine,
        router: DisaggRouter,
        queue: PrefillQueue,
        *,
        transfer_host: str = "127.0.0.1",
    ):
        self.runtime = runtime
        self.engine = engine
        self.router = router
        self.queue = queue
        # seq_id -> (future, reserved landing blocks, trace).  Ownership protocol
        # (all transitions are atomic dict pops on the one event loop):
        # whoever pops the entry owns the blocks' fate — the requester
        # releases on timeout, the transfer path injects and then releases
        # iff the requester's wait was already cancelled.  This is what
        # keeps a LATE transfer from scattering stale KV into blocks that
        # were released and re-allocated to a live sequence.
        self._pending: dict[str, tuple[asyncio.Future, list[int], object]] = {}
        # streamed transfers: seq_id -> partial assembly.  Intermediate
        # parts inject into their own landing-block subrange WITHOUT popping
        # _pending (the requester still owns the entry); only stream
        # completion — every part 0..last injected — claims it.
        self._assembly: dict[str, _StreamAssembly] = {}
        self.prefill_timeout_s = knobs.get("DYN_DISAGG_PREFILL_TIMEOUT_S")
        self.transfer_server = KvTransferServer(self._on_transfer, host=transfer_host)
        # link characterization for the router's transfer-cost model: hop
        # class this decode worker sits behind relative to the prefill pool
        # ("local"|"ici"|"dcn"; "" = unknown → the router keeps its prior).
        # DYN_TRANSFER_HOP is an explicit OVERRIDE; unset, the hop comes from
        # the discovered topology map (attach_topology) when one is wired.
        self._hop_override = knobs.get("DYN_TRANSFER_HOP")
        self._topology = None          # TopologyMap, when attached
        self._topo_self_id: int | None = None
        self._bytes_per_block: int | None = None  # lazy, for the transfer guard
        # observability
        self.remote_prefills = 0
        self.local_prefills = 0
        self.remote_prefill_timeouts = 0
        self.remote_prefill_requeues = 0
        # KV-transfer observability (cumulative; per-request latency/bytes
        # also land on each trace's kv.transfer span)
        self.kv_transfer_bytes_total = 0
        self.kv_transfer_seconds_total = 0.0
        # streamed-transfer accounting: parts injected, duplicate parts
        # dropped, and inject seconds HIDDEN behind prefill compute (a
        # single-shot transfer hides nothing — its whole inject is exposed)
        self.kv_transfer_parts_total = 0
        self.kv_transfer_duplicate_parts_total = 0
        self.kv_transfer_hidden_seconds_total = 0.0
        self.kv_transfer_streams_total = 0

    async def start(self) -> None:
        await self.transfer_server.start()

    async def stop(self) -> None:
        await self.transfer_server.stop()

    def attach_topology(self, topo_map, *, self_worker_id: int) -> None:
        """Derive this worker's inbound hop class from a discovered
        TopologyMap (consulted only while informative — a single-host
        all-local map leaves ``transfer_hop`` empty, exactly as before)."""
        self._topology = topo_map
        self._topo_self_id = self_worker_id

    @property
    def transfer_hop(self) -> str:
        if self._hop_override:
            return self._hop_override
        topo = self._topology
        if topo is not None and self._topo_self_id is not None and topo.informative():
            return topo.inbound_hop(self._topo_self_id)
        return ""

    def _release_landing(self, seq_id: str, block_ids: list[int]) -> None:
        """Release a sequence's landing blocks — DEFERRED while any streamed
        part is still inside inject_blocks (freeing under a writer would let
        the allocator hand the blocks to a live sequence mid-scatter).  The
        last in-flight part's handler performs the actual release."""
        asm = self._assembly.pop(seq_id, None)
        if asm is not None and asm.span is not None:
            asm.span.end(status="error", error="abandoned")
            asm.span = None
        if asm is not None and asm.inflight > 0:
            asm.abandoned_blocks = list(block_ids)
        else:
            self.engine.release_blocks(block_ids)

    async def _on_transfer(self, payload: KvTransferPayload) -> None:
        # legacy fast path: a one-part stream with no assembly in progress
        # is exactly the pre-streaming wire contract (atomic pop-claim)
        if payload.part_index == 0 and payload.last and payload.seq_id not in self._assembly:
            await self._on_transfer_single(payload)
            return
        await self._on_transfer_part(payload)

    async def _on_transfer_single(self, payload: KvTransferPayload) -> None:
        entry = self._pending.pop(payload.seq_id, None)
        if entry is None:
            # the requester already gave up AND released the landing blocks
            # (they may belong to another sequence by now) — never inject
            logger.warning(
                "dropping late KV transfer for %s (request abandoned)",
                payload.seq_id,
            )
            return
        fut, block_ids, trace = entry
        nbytes = payload_nbytes(payload.blocks)
        span = get_recorder().start(
            "kv.transfer", trace, component="decode_worker",
            attrs={"bytes": nbytes, "blocks": len(payload.block_ids)},
        )
        t0 = time.monotonic()
        try:
            await self.engine.inject_blocks(payload.block_ids, payload.blocks)
        except Exception as exc:  # noqa: BLE001
            if span is not None:
                span.end(status="error", error=repr(exc))
            if fut.cancelled():
                self.engine.release_blocks(block_ids)
            elif not fut.done():
                fut.set_exception(exc)  # requester releases (generate())
            return
        self.kv_transfer_bytes_total += nbytes
        self.kv_transfer_seconds_total += time.monotonic() - t0
        self.kv_transfer_parts_total += 1
        self.kv_transfer_streams_total += 1
        if span is not None:
            span.end()
        if fut.cancelled():
            # requester's wait timed out between our pop and the inject
            # finishing; the blocks were still reserved (we owned them), so
            # the inject was harmless — free them now
            self.engine.release_blocks(block_ids)
        elif not fut.done():
            fut.set_result(
                (
                    payload.first_token,
                    payload.first_token_logprob,
                    payload.first_token_top_logprobs,
                )
            )

    async def _on_transfer_part(self, payload: KvTransferPayload) -> None:
        """One part of a streamed transfer: inject its block subrange while
        the requester still owns the pending entry, complete the stream when
        every part 0..last has been injected."""
        seq_id = payload.seq_id
        entry = self._pending.get(seq_id)
        if entry is None:
            # requester gone (timeout → local fallback, or cancel): drop the
            # part and forget any partial assembly — the blocks are released
            # (or pending deferred release) elsewhere
            self._assembly.pop(seq_id, None)
            logger.warning(
                "dropping late KV transfer part %d for %s (request abandoned)",
                payload.part_index, seq_id,
            )
            return
        fut, block_ids, trace = entry
        asm = self._assembly.get(seq_id)
        if asm is None:
            asm = self._assembly[seq_id] = _StreamAssembly()
            asm.span = get_recorder().start(
                "kv.transfer", trace, component="decode_worker",
                attrs={"streamed": True},
            )
        if payload.part_index in asm.received:
            # duplicate delivery (client re-send over a re-dialed
            # connection): the blocks are already injected — drop
            self.kv_transfer_duplicate_parts_total += 1
            return
        asm.received.add(payload.part_index)
        if payload.last:
            asm.last_index = payload.part_index
            asm.first_token = payload.first_token
            asm.first_token_logprob = payload.first_token_logprob
            asm.first_token_top_logprobs = payload.first_token_top_logprobs
            asm.last_part_arrival = time.monotonic()
        nbytes = payload_nbytes(payload.blocks)
        part_span = get_recorder().start(
            "kv.transfer.part", trace, component="decode_worker",
            attrs={
                "part": payload.part_index, "bytes": nbytes,
                "blocks": len(payload.block_ids), "last": payload.last,
            },
        )
        t0 = time.monotonic()
        asm.inflight += 1
        try:
            if payload.block_ids:
                await self.engine.inject_blocks(payload.block_ids, payload.blocks)
        except Exception as exc:  # noqa: BLE001
            asm.inflight -= 1
            if part_span is not None:
                part_span.end(status="error", error=repr(exc))
            if asm.abandoned_blocks is not None:
                # requester abandoned mid-inject; we may be the last writer
                if asm.inflight == 0:
                    blocks_to_free, asm.abandoned_blocks = asm.abandoned_blocks, None
                    self.engine.release_blocks(blocks_to_free)
                return
            entry2 = self._pending.pop(seq_id, None)
            if entry2 is None:
                return  # abandonment raced us; its release path owns the blocks
            if fut.cancelled():
                # requester is gone and can't run its release path — do it
                # here through the deferral protocol (sibling parts may
                # still be scattering into these blocks)
                self._release_landing(seq_id, block_ids)
            elif not fut.done():
                # requester wakes with the exception and releases through
                # _release_landing (generate()); the assembly stays in the
                # dict until then so the deferral state survives
                fut.set_exception(exc)
            return
        asm.inflight -= 1
        asm.injected.add(payload.part_index)
        asm.covered_blocks.update(
            range(payload.block_start, payload.block_start + len(payload.block_ids))
        )
        asm.active_seconds += time.monotonic() - t0
        asm.bytes += nbytes
        asm.blocks_received += len(payload.block_ids)
        self.kv_transfer_parts_total += 1
        if part_span is not None:
            part_span.end()
        if asm.abandoned_blocks is not None:
            # requester abandoned while we were injecting: blocks stayed
            # reserved (deferred release), so the scatter was harmless —
            # the last writer out frees them
            if asm.inflight == 0:
                blocks_to_free, asm.abandoned_blocks = asm.abandoned_blocks, None
                self.engine.release_blocks(blocks_to_free)
            return
        # completion gates on INJECTED parts (a part that has merely arrived
        # may still be mid-scatter on a concurrent handler — admitting the
        # sequence then would race decode against its own KV landing)
        if asm.last_index is not None and len(asm.injected) == asm.last_index + 1:
            self._finish_stream(seq_id, asm)

    def _finish_stream(self, seq_id: str, asm: _StreamAssembly) -> None:
        """All parts injected: claim the pending entry and admit the
        sequence.  Exposure = time since the closing part arrived (the tail
        the requester actually waited on); everything before it was hidden
        behind prefill compute on the remote worker."""
        entry = self._pending.pop(seq_id, None)
        self._assembly.pop(seq_id, None)
        if entry is None:
            return  # raced an abandonment; release was handled there
        fut, block_ids, trace = entry
        now = time.monotonic()
        exposed = max(0.0, now - (asm.last_part_arrival or now))
        hidden = max(0.0, asm.active_seconds - exposed)
        self.kv_transfer_bytes_total += asm.bytes
        self.kv_transfer_seconds_total += asm.active_seconds
        self.kv_transfer_hidden_seconds_total += hidden
        self.kv_transfer_streams_total += 1
        if asm.span is not None:
            asm.span.end(
                bytes=asm.bytes, blocks=asm.blocks_received,
                parts=len(asm.received), hidden_s=round(hidden, 6),
            )
            asm.span = None
        if fut.cancelled():
            self.engine.release_blocks(block_ids)
        elif not fut.done():
            fut.set_result(
                (asm.first_token, asm.first_token_logprob, asm.first_token_top_logprobs)
            )

    def _est_transfer_seconds(self, n_tokens: int) -> float:
        """Estimated inbound KV transfer time for a prompt, from measured
        bandwidth.  Unmeasured, an informative topology map supplies the
        discovered link's bandwidth (prior or probed) so the transfer guard
        can act before the first real shipment; with neither, 0.0 — never
        gate on a guess."""
        secs = self.kv_transfer_seconds_total
        bps = self.kv_transfer_bytes_total / secs if secs > 0 else 0.0
        if bps <= 0:
            topo = self._topology
            if (
                topo is not None and self._topo_self_id is not None
                and topo.informative()
            ):
                sources = [
                    c.worker_id for c in topo.nodes.values()
                    if c.role == "prefill" and c.worker_id != self._topo_self_id
                ]
                if sources:
                    bps = max(
                        topo.pair_bandwidth(src, self._topo_self_id)
                        for src in sources
                    )
        if bps <= 0:
            return 0.0
        if self._bytes_per_block is None:
            # the whole blocks the wire carries (a mesh engine's rank 0
            # holds only its shard of them)
            self._bytes_per_block = sum(
                math.prod(shape) * dtype.itemsize // max(shape[1], 1)
                for shape, dtype in self.engine.cache_shapes.values()
            )
        blocks = self.engine.allocator.blocks_needed(n_tokens)
        return blocks * self._bytes_per_block / bps

    async def generate(self, request: Context[dict]) -> ResponseStream[dict]:
        pre = PreprocessedRequest.from_wire(request.data)
        queue_size = await self.queue.size()
        if not self.router.prefill_remote(
            len(pre.token_ids), queue_size,
            est_transfer_s=self._est_transfer_seconds(len(pre.token_ids)),
        ):
            self.local_prefills += 1
            return await self.engine.generate(request)

        # remote prefill: reserve the KV landing zone first
        block_ids = self.engine.reserve_blocks(len(pre.token_ids) + 1)
        if block_ids is None:
            logger.warning("no blocks free for remote prefill; falling back local")
            self.local_prefills += 1
            return await self.engine.generate(request)

        self.remote_prefills += 1
        seq_id = request.ctx.id or uuid.uuid4().hex
        trace = getattr(request.ctx, "trace", None)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[seq_id] = (fut, block_ids, trace)
        n_kv_blocks = self.engine.allocator.blocks_needed(len(pre.token_ids))
        # trace context rides the queue item (stamp_trace below) so the
        # prefill worker's span joins the same request tree
        await self.queue.enqueue(
            stamp_trace({
                "seq_id": seq_id,
                "request": request.data,
                "dst_block_ids": block_ids[:n_kv_blocks],
                "transfer_address": self.transfer_server.address,
                # staleness contract: a worker dequeuing after the requester
                # has timed out (and prefilled locally) must drop the item
                # rather than burn a prefill whose transfer would be
                # discarded.  ``ttl_s`` is a duration (skew-free); the
                # worker compares it against the queue broker's own
                # enqueue→pop age measurement.  ``deadline_ts`` is the
                # wall-clock fallback for buses without age metadata,
                # applied with a skew margin.
                "ttl_s": self.prefill_timeout_s,
                "deadline_ts": time.time() + self.prefill_timeout_s,
            }, trace)
        )
        requeued = False
        while True:
            try:
                first_token, first_lp, first_top = await asyncio.wait_for(
                    fut, timeout=self.prefill_timeout_s
                )
                break
            except (asyncio.TimeoutError, asyncio.CancelledError) as err:
                # resume cursor BEFORE abandoning the assembly: the
                # contiguous prefix of landing blocks already injected is
                # work a replacement prefill worker need not re-ship
                asm = self._assembly.get(seq_id)
                skip_blocks = asm.contiguous_blocks() if asm is not None else 0
                owned = self._pending.pop(seq_id, None) is not None
                if isinstance(err, asyncio.CancelledError):
                    if owned:
                        self._release_landing(seq_id, block_ids)
                    raise  # caller went away; nothing to serve
                # requeue only when a prefill worker demonstrably picked the
                # item up and started streaming (an assembly exists).  A dead
                # fleet leaves the original item queued — re-enqueueing would
                # duplicate it and still serve nobody; degrade to the local
                # prefill instead.
                if (
                    owned and not requeued and asm is not None
                    and knobs.get("DYN_RESUME")
                ):
                    # the prefill worker died (or stalled) mid-KV-stream:
                    # re-enqueue the REMAINING work for another prefill
                    # worker instead of burning a cold local prefill.  A
                    # fresh sub-stream id quarantines the dead stream (its
                    # late parts find no pending entry and drop); the
                    # landing blocks are KEPT — already-injected KV stays
                    # valid, and the replacement skips shipping it.  Old
                    # parts still mid-inject rewrite identical deterministic
                    # KV into the same blocks, which is harmless.
                    old = self._assembly.pop(seq_id, None)
                    if old is not None and old.span is not None:
                        old.span.end(status="error", error="requeued")
                        old.span = None
                    requeued = True
                    self.remote_prefill_requeues += 1
                    counters.incr("dyn_resume_prefill_requeues_total")
                    seq_id = f"{seq_id}#r1"
                    fut = asyncio.get_running_loop().create_future()
                    self._pending[seq_id] = (fut, block_ids, trace)
                    logger.warning(
                        "remote prefill stream stalled at %d contiguous "
                        "block(s); re-enqueueing remaining work as %s",
                        skip_blocks, seq_id,
                    )
                    try:
                        await self.queue.enqueue(
                            stamp_trace({
                                "seq_id": seq_id,
                                "request": request.data,
                                "dst_block_ids": block_ids[:n_kv_blocks],
                                "skip_blocks": skip_blocks,
                                "transfer_address": self.transfer_server.address,
                                "ttl_s": self.prefill_timeout_s,
                                "deadline_ts": time.time() + self.prefill_timeout_s,
                            }, trace)
                        )
                        continue
                    except Exception:  # noqa: BLE001 — queue down: go local
                        self._pending.pop(seq_id, None)
                        self._release_landing(seq_id, block_ids)
                elif owned:
                    # we still own the landing blocks — a transfer that
                    # arrives from here on finds no pending entry and is
                    # dropped.  (_release_landing defers the actual free
                    # while a streamed part is mid-inject into these blocks)
                    self._release_landing(seq_id, block_ids)
                # else: _on_transfer claimed the entry; it observes the
                # cancelled future and releases the blocks itself
                # the prefill fleet is slow/dead, but this worker still owns
                # the request and a whole engine: serve it locally (slower
                # TTFT beats a failed request — the reference's disagg also
                # degrades to aggregated serving when remote prefill is
                # unavailable)
                self.remote_prefill_timeouts += 1
                self.local_prefills += 1  # counted like the no-blocks fallback
                logger.warning(
                    "remote prefill for %s timed out after %.1fs; prefilling locally",
                    seq_id, self.prefill_timeout_s,
                )
                return await self.engine.generate(request)
            except Exception:
                # inject failed after the transfer claimed the entry; blocks
                # were never handed to a sequence — release here (deferred if
                # a sibling streamed part is still scattering into them)
                self._pending.pop(seq_id, None)
                self._release_landing(seq_id, block_ids)
                raise
        return await self.engine.generate_prefilled(
            request, block_ids, first_token, first_token_logprob=first_lp,
            first_token_top_logprobs=first_top,
        )

    def stats(self) -> dict:
        stats = self.engine.stats()
        stats["remote_prefills"] = self.remote_prefills
        stats["local_prefills"] = self.local_prefills
        stats["remote_prefill_timeouts"] = self.remote_prefill_timeouts
        stats["remote_prefill_requeues"] = self.remote_prefill_requeues
        stats["kv_transfer_bytes_total"] = self.kv_transfer_bytes_total
        stats["kv_transfer_seconds_total"] = self.kv_transfer_seconds_total
        # canonical dyn_disagg_* names (ForwardPassMetrics → metrics service)
        stats["disagg_remote_prefills_total"] = self.remote_prefills
        stats["disagg_local_prefills_total"] = self.local_prefills
        stats["disagg_prefill_timeouts_total"] = self.remote_prefill_timeouts
        stats["disagg_prefill_requeues_total"] = self.remote_prefill_requeues
        stats["disagg_kv_transfer_bytes_total"] = self.kv_transfer_bytes_total
        stats["disagg_kv_transfer_seconds_total"] = self.kv_transfer_seconds_total
        stats["disagg_kv_transfer_parts_total"] = self.kv_transfer_parts_total
        stats["disagg_kv_transfer_hidden_seconds_total"] = (
            self.kv_transfer_hidden_seconds_total
        )
        secs = self.kv_transfer_seconds_total
        stats["disagg_transfer_hidden_ratio"] = (
            self.kv_transfer_hidden_seconds_total / secs if secs > 0 else 0.0
        )
        # link characterization for the router's transfer-cost model:
        # measured inbound bandwidth (bytes over decode-side inject-active
        # seconds — a conservative floor for the link) + configured hop class
        stats["transfer_hop"] = self.transfer_hop
        stats["kv_transfer_bandwidth_bps"] = (
            self.kv_transfer_bytes_total / secs if secs > 0 else 0.0
        )
        return stats


class PrefillWorker:
    """Prefill-side pump: dequeue → prefill → ship KV → (decode worker
    continues).  One pump per prefill engine instance."""

    def __init__(
        self, runtime: DistributedRuntime, engine: TorchLlmEngine,
        queue: PrefillQueue, *, stream: bool | None = None,
    ):
        self.runtime = runtime
        self.engine = engine
        self.queue = queue
        self.client = KvTransferClient()
        self._task: asyncio.Task | None = None
        self._prober = None  # TopologyProber, when a map is attached
        self.prefills_done = 0
        self.stale_dropped = 0
        # streamed multi-part transfer: ship completed chunks while later
        # chunks compute.  None = DYN_KV_STREAM env gate; effective only
        # when the engine actually chunks prefill (otherwise there is one
        # chunk and the send degenerates to the single-part wire format).
        self.stream = kv_stream_enabled() if stream is None else stream
        self.kv_parts_sent_total = 0
        # tolerated cross-host clock disagreement: a dequeued item is only
        # dropped as stale once it is past its TTL by MORE than this margin,
        # so a skewed requester clock degrades to the occasional wasted
        # prefill instead of silently dropping all disagg traffic
        self.clock_skew_margin_s = knobs.get("DYN_DISAGG_CLOCK_SKEW_S")

    def attach_topology(self, topo_map, *, self_worker_id: int) -> None:
        """Run the bounded topology prober off this pump's own transfer
        client: active RTT/bandwidth probes of decode peers plus the
        client's passive per-destination send EWMAs (every real transfer
        is a measurement) fold into the attached TopologyMap."""
        from dynamo_tpu_torch.topology import TopologyProber

        self._prober = TopologyProber(
            topo_map, self_worker_id=self_worker_id, client=self.client
        )
        if self._task is not None:
            spawn_logged(self._prober.start(), name="topology-prober-start")

    def start(self) -> None:
        if self._task is None:
            self._task = spawn_logged(self._loop())
            if self._prober is not None:
                spawn_logged(self._prober.start(), name="topology-prober-start")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self._prober is not None:
            await self._prober.stop()
            self._prober = None
        await self.client.close()

    async def _loop(self) -> None:
        while True:
            try:
                # chaos seam: a failed dequeue exercises the sleep-and-retry
                # path below (the pump must survive broker churn)
                FAULTS.check(PREFILL_DEQUEUE)
                popped = await self.queue.dequeue_with_age(timeout=1.0)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                logger.exception("prefill queue pop failed")
                await asyncio.sleep(0.5)
                continue
            if popped is None:
                continue
            item, age = popped
            try:
                await self._handle(item, age)
            except Exception:  # noqa: BLE001
                logger.exception("remote prefill failed for %s", item.get("seq_id"))

    def _is_stale(self, item: dict, queue_age_s: float | None) -> bool:
        """True iff the requester has certainly timed out already.

        Preferred signal: the broker-measured queue age (enqueue→pop on the
        broker's own clock) against the item's relative TTL — two durations,
        no cross-host wall-clock comparison anywhere.  Buses without age
        metadata fall back to the absolute ``deadline_ts`` with a skew
        margin, which errs toward the wasted prefill (whose transfer the
        decode side drops harmlessly) rather than toward dropping live
        traffic when clocks disagree.
        """
        ttl = item.get("ttl_s")
        if queue_age_s is not None and ttl is not None:
            return queue_age_s > ttl
        deadline = item.get("deadline_ts")
        return deadline is not None and time.time() > deadline + self.clock_skew_margin_s

    def stats(self) -> dict:
        return {
            "prefills_done": self.prefills_done,
            "stale_dropped": self.stale_dropped,
            "kv_parts_sent_total": self.kv_parts_sent_total,
        }

    async def _handle(self, item: dict, queue_age_s: float | None = None) -> None:
        if self._is_stale(item, queue_age_s):
            # the requester already timed out and served itself locally; a
            # prefill now would be pure waste amplifying the overload that
            # caused the timeout (its transfer would be dropped anyway)
            self.stale_dropped += 1
            logger.warning(
                "dropping stale prefill request %s (stale_dropped=%d)",
                item.get("seq_id"), self.stale_dropped,
            )
            return
        pre = PreprocessedRequest.from_wire(item["request"])
        trace = read_trace(item)
        span = get_recorder().start(
            "prefill_worker.handle", trace, component="prefill_worker",
            attrs={"prompt_tokens": len(pre.token_ids)},
        )
        # strategy selection by destination locality (reference:
        # block/transfer/strategy.rs:345): same-process destinations keep
        # blocks on the device, remote ones stage to pinned host memory
        local = item["transfer_address"] in LOCAL_SERVERS
        address = item["transfer_address"]
        dst_ids = item["dst_block_ids"]
        # resumed stream (decode side re-enqueued after its first prefill
        # worker died mid-KV-stream): blocks below ``skip`` already landed —
        # compute everything (later chunks need the full KV context) but
        # don't re-ship chunks that land entirely inside the skipped prefix.
        # A chunk straddling the boundary ships whole: re-writing identical
        # deterministic KV is harmless, a hole is not.
        skip = int(item.get("skip_blocks", 0) or 0)
        # streamed transfer needs chunked prefill to have anything to
        # overlap; without it the single-part send below is the whole story
        streaming = self.stream and getattr(self.engine, "chunk_tokens", None) is not None
        loop = asyncio.get_running_loop()
        part_tasks: list[asyncio.Task] = []
        parts_sent = 0
        streamed_blocks = 0
        bytes_sent = 0

        def ship_part(payload: KvTransferPayload) -> None:
            part_tasks.append(asyncio.ensure_future(self.client.send(address, payload)))

        def on_chunk(start_b: int, leaves: dict, count: int) -> None:
            # DEVICE thread: build the part payload and hand the send to the
            # event loop.  call_soon_threadsafe is FIFO, so every part send
            # is scheduled before prefill_extract's own resolve callback —
            # the closing part below can never overtake an intermediate one
            # into the task list.
            nonlocal parts_sent, streamed_blocks, bytes_sent
            streamed_blocks = start_b + count
            if start_b + count <= skip:
                return  # decode side already holds these blocks (resume)
            payload = KvTransferPayload(
                seq_id=item["seq_id"],
                first_token=-1,  # only the closing part samples
                block_ids=list(dst_ids[start_b : start_b + count]),
                blocks=leaves,
                part_index=parts_sent,
                last=False,
                block_start=start_b,
            )
            parts_sent += 1
            bytes_sent += payload_nbytes(leaves)
            loop.call_soon_threadsafe(ship_part, payload)

        try:
            first_token, first_lp, first_top, blocks, n = await self.engine.prefill_extract(
                pre, device=local, on_chunk=on_chunk if streaming else None
            )
            # intermediate parts must have landed (or failed loudly) before
            # the closing part marks the stream complete — a lost part with
            # a delivered closing part would leave the decode side waiting
            # on an index that never comes
            if part_tasks:
                await asyncio.gather(*part_tasks)
            tail_start = min(streamed_blocks, n)
            bytes_sent += payload_nbytes(blocks)
            await self.client.send(
                address,
                KvTransferPayload(
                    seq_id=item["seq_id"],
                    first_token=first_token,
                    first_token_logprob=first_lp,
                    first_token_top_logprobs=first_top,
                    block_ids=list(dst_ids[tail_start:n]),
                    blocks=blocks,
                    part_index=parts_sent,
                    last=True,
                    block_start=tail_start,
                ),
            )
        except BaseException as exc:
            for t in part_tasks:
                t.cancel()
            if part_tasks:
                # retrieve outcomes so failed sends don't log as unawaited
                await asyncio.gather(*part_tasks, return_exceptions=True)
            if span is not None:
                span.end(status="error", error=repr(exc))
            raise
        self.kv_parts_sent_total += parts_sent + 1
        if span is not None:
            span.end(bytes=bytes_sent, blocks=n, parts=parts_sent + 1)
        self.prefills_done += 1  # actual prefills only, not dropped items
