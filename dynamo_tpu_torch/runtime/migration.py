"""Live session migration: zero-loss mid-decode handoff between workers.

A decode session pinned to one worker is a liability the moment that worker
becomes hot, drains, or sits on the wrong side of a link — but killing and
re-running it burns the decoded prefix and the client's patience.  This
module moves the session instead: the :class:`MigrationCoordinator` (one per
``PushRouter``) snapshots the request's :class:`GenerationJournal` at a
stream window boundary, pre-admits the session on the destination in
``resume_from`` continuation mode (the continuation rides the prefix cache;
fleets with a KV transfer plane can attach a ``kv_streamer`` hook that ships
the blocks layer-wise over the multi-part ``kv_transfer`` protocol first),
then asks the consumer loop to *flip* the live stream — atomically, between
two items — onto the destination with a replay-dedupe cursor so every token
is delivered exactly once.

The safety invariant: **the source keeps decoding until the flip commits.**
Nothing in the handoff stops, kills, or even slows the source stream; every
failure before the commit point (destination dead, KV stream failed,
pre-admit timeout, flip never reached inside ``DYN_MIGRATE_FLIP_TIMEOUT_S``)
aborts by simply discarding the destination — the client never notices.
Migration is therefore never less safe than not migrating.

State machine (counted in ``dyn_migration_*``):

    validate ──► snapshot ──► [kv stream] ──► pre-admit ──► flip ──► release
       │failed      │aborted       │aborted       │aborted    │aborted
       ▼            ▼              ▼              ▼           ▼
     (refused — no handoff started; the session never left the source)

Exactly-once arithmetic: the journal snapshot ships ``payload_accepted``
tokens to the destination, and the source decodes ``delta`` more tokens
between the snapshot and the flip commit (``delta = total_recorded −
snap_total``, fold-invariant).  The destination regenerates that window, so
the flip wraps its stream in ``dedupe_stream(dst, skip=payload_accepted +
delta, ack_skip=delta)``: a continuation-mode engine (acks) re-emits only
the delta window; a replay-mode engine re-emits the whole prefix.  Either
way the cursor drops exactly the tokens the client has already seen.

Exposed three ways: ``dynctl migrate <request_id> <dst>`` (the well-known
``_dyn.ctl.migrate`` bus subject — only the dispatcher that owns the request
replies), graceful-drain integration (a deregistered worker's survivors are
migrated, not cancelled, when a destination exists), and the planner's
defragmentation loop (the reference's ``planner/defrag.py``, not ported yet).
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Awaitable, Callable

from dynamo_tpu_torch.observability import get_recorder
from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.robustness.faults import FAULTS, MIGRATE_FLIP, MIGRATE_HANDOFF
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.resume import GenerationJournal
from dynamo_tpu_torch.utils import knobs
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("runtime.migration")

# Well-known control subject every dispatcher's coordinator subscribes to.
# A migrate request names a request_id; only the coordinator that OWNS that
# id replies, so one dynctl request finds the right dispatcher in a fleet
# of frontends without a directory.
MIGRATE_SUBJECT = "_dyn.ctl.migrate"

# Hop-class cost order for destination picking (mirrors topology/map.py):
# unknown hops price between ICI and DCN — informative maps should steer,
# not block, when a link simply has not been probed yet.
_HOP_COST = {"local": 0, "ici": 1, "": 2, "unknown": 2, "dcn": 3}


def _flight_event(status: str, **fields) -> None:
    """Mirror a migration state transition into every live flight recorder
    (best-effort — the handoff must never fail on observability)."""
    try:
        from dynamo_tpu_torch.observability import flight

        for rec in flight.recorders():
            rec.record_event("migration", status=status, **fields)
    except Exception:  # noqa: BLE001
        pass


class _PendingFlip:
    """A prepared destination stream waiting for the consumer loop to swap
    it in at the next item boundary.  ``outcome`` transitions exactly once
    (``committed`` / ``aborted`` / ``finished`` / ``timeout``) — both the
    consumer's commit and the coordinator's timeout run on the same event
    loop and check-then-set without awaiting, so the transition is a plain
    race-free compare."""

    __slots__ = ("dst_raw", "dst_inst_id", "snap_total", "payload_accepted",
                 "done", "outcome")

    def __init__(self, dst_raw, dst_inst_id: int, snap_total: int,
                 payload_accepted: int):
        self.dst_raw = dst_raw
        self.dst_inst_id = dst_inst_id
        self.snap_total = snap_total
        self.payload_accepted = payload_accepted
        self.done = asyncio.Event()
        self.outcome: str | None = None


class MigrationHandle:
    """One live, journaled stream the coordinator may migrate.  Registered
    by the dispatch loop for the lifetime of ``_stream_with_retry`` and
    updated in place as the stream retries/resumes/flips across workers."""

    __slots__ = ("request_id", "journal", "ctx", "inst_id", "flip", "busy")

    def __init__(self, request_id: str, journal: GenerationJournal, ctx,
                 inst_id: int):
        self.request_id = request_id
        self.journal = journal
        self.ctx = ctx
        self.inst_id = inst_id          # worker currently decoding
        self.flip: _PendingFlip | None = None
        self.busy = False               # a migrate() is mid-handoff

    def flip_pending(self) -> bool:
        return self.flip is not None and self.flip.outcome is None

    def abort_flip(self, outcome: str = "aborted") -> None:
        """Resolve a pending flip without committing (stream errored,
        finished, or the dispatch loop is tearing down).  The coordinator's
        waiter owns killing the discarded destination stream."""
        flip, self.flip = self.flip, None
        if flip is not None and flip.outcome is None:
            flip.outcome = outcome
            flip.done.set()


class MigrationCoordinator:
    """Owns the migrate state machine for one PushRouter's live sessions."""

    def __init__(self, router):
        self.router = router
        self._handles: dict[str, MigrationHandle] = {}
        # optional best-effort KV pre-stream: async (handle, src, dst, hop)
        # -> None; raising aborts the migration before pre-admission.  Set
        # by deployments whose engines expose KV block export (the transfer
        # itself rides parallel/kv_transfer's layer-wise multi-part frames);
        # continuation-mode pre-admission alone rides the prefix cache.
        self.kv_streamer: Callable[..., Awaitable[None]] | None = None
        self._topology: Any = None      # TopologyMap | callable -> map | None
        self._ctl_sub = None
        self._ctl_task: asyncio.Task | None = None

    # -- session registry (called by the dispatch loop) --------------------
    def register(self, request_id: str, journal: GenerationJournal, ctx,
                 inst_id: int) -> MigrationHandle:
        handle = MigrationHandle(request_id, journal, ctx, inst_id)
        self._handles[request_id] = handle
        return handle

    def unregister(self, handle: MigrationHandle) -> None:
        handle.abort_flip()
        if self._handles.get(handle.request_id) is handle:
            self._handles.pop(handle.request_id, None)

    def resolve(self, request_id: str) -> MigrationHandle | None:
        """Find a live session by id.  The dispatch loop registers handles
        under the internal context id, but operators know the *request/trace*
        id (the ``x-request-id`` header, echoed in logs and response
        headers) — accept either: exact session id first, unique trace-id
        match second."""
        handle = self._handles.get(request_id)
        if handle is not None:
            return handle
        matches = [
            h for h in self._handles.values()
            if getattr(getattr(h.ctx, "trace", None), "trace_id", None)
            == request_id
        ]
        return matches[0] if len(matches) == 1 else None

    def sessions_on(self, inst_id: int) -> list[str]:
        return [
            rid for rid, h in self._handles.items()
            if h.inst_id == inst_id and not h.journal.finished
        ]

    def sessions(self) -> dict[str, int]:
        """request_id -> current worker, for the planner's defrag view."""
        return {
            rid: h.inst_id for rid, h in self._handles.items()
            if not h.journal.finished
        }

    # -- topology pricing --------------------------------------------------
    def attach_topology(self, topology) -> None:
        """Accepts a TopologyMap or a zero-arg callable returning one (the
        discovery layer's watcher refreshes its map in place)."""
        self._topology = topology

    def _topo_map(self):
        topo = self._topology() if callable(self._topology) else self._topology
        if topo is None or not topo.informative():
            return None  # uninformative map: no pricing signal, don't block
        return topo

    def hop(self, src: int, dst: int) -> str:
        topo = self._topo_map()
        return topo.hop(src, dst) if topo is not None else ""

    def pick_destination(self, src: int, *, allow_dcn: bool = False) -> int | None:
        """Cheapest-hop healthy destination: local/ICI neighbors first,
        unprobed links next, DCN only when the caller priced it in
        (drain/defrag of a doomed worker beats losing the session)."""
        candidates = [
            w for w in self.router.healthy_ids({src}) if w != src
        ]
        topo = self._topo_map()
        if topo is not None:
            priced = [
                (w, _HOP_COST.get(topo.hop(src, w), 2)) for w in candidates
            ]
            if not allow_dcn:
                priced = [(w, c) for w, c in priced if c < _HOP_COST["dcn"]]
            candidates = [w for w, _ in sorted(priced, key=lambda p: (p[1], p[0]))]
        if not candidates:
            return None
        return candidates[0]

    # -- the handoff -------------------------------------------------------
    async def migrate(
        self, request_id: str, dst: int | None = None, *,
        reason: str = "manual",
    ) -> dict:
        """Move one live session to ``dst`` (or the cheapest-hop healthy
        worker).  Returns a result dict either way; the session is NEVER
        worse off for having tried."""
        handle = self.resolve(request_id)
        allow_dcn = reason not in ("", "manual")

        def _refuse(error: str) -> dict:
            counters.incr("dyn_migration_failed_total")
            logger.warning("migrate %s refused: %s", request_id, error)
            return {"op": "migrate", "ok": False, "request_id": request_id,
                    "error": error}

        if handle is None or handle.journal.finished:
            return _refuse("unknown or finished session")
        if handle.busy:
            return _refuse("a migration is already in flight for this session")
        src = handle.inst_id
        if dst is None:
            dst = self.pick_destination(src, allow_dcn=allow_dcn)
            if dst is None:
                return _refuse("no eligible destination")
        if dst == src:
            return _refuse("destination is the worker already decoding it")
        if dst not in set(self.router.client.instance_ids):
            return _refuse(f"destination {dst:x} is not a registered instance")
        hop = self.hop(src, dst)
        if hop == "dcn" and not allow_dcn:
            return _refuse(
                "destination is a DCN hop away; cross-slice migration needs "
                "an explicit reason (drain/defrag/--reason)"
            )

        handle.busy = True
        t0 = time.monotonic()
        counters.incr("dyn_migration_started_total")
        _flight_event("started", request=request_id, src=f"{src:x}", dst=f"{dst:x}",
                      reason=reason)
        span = get_recorder().start(
            "migrate", getattr(handle.ctx, "trace", None), component="frontend",
            attrs={"request": request_id, "src": f"{src:x}", "dst": f"{dst:x}",
                   "hop": hop or "?", "reason": reason},
        )
        dst_raw = None
        try:
            # chaos seam: everything up to (and including) pre-admission
            FAULTS.check(MIGRATE_HANDOFF, request=request_id, dst=f"{dst:x}")
            # snapshot at a window boundary: the journal only mutates between
            # consumer yields on this same loop, so reading it here (no await
            # since the consumer last ran) IS the boundary
            snap_total = handle.journal.total_recorded
            resume_wire = handle.journal.resume_request()
            payload_accepted = len(resume_wire["resume_from"]["accepted"])
            if self.kv_streamer is not None:
                await self.kv_streamer(handle, src, dst, hop)
            # pre-admit: pinned rendezvous on the destination; the engine
            # starts regenerating from the snapshot immediately — all of it
            # overlapped with the still-decoding source
            resumed = Context(resume_wire, handle.ctx)
            dst_raw, dst_id = await self.router._rendezvous(resumed, dst, set())
            # chaos seam: the flip itself
            FAULTS.check(MIGRATE_FLIP, request=request_id, dst=f"{dst:x}")
            if (handle.journal.finished
                    or self._handles.get(handle.request_id) is not handle):
                raise RuntimeError("session finished during the handoff")
            if handle.flip_pending():
                raise RuntimeError("another flip is already pending")
            flip = _PendingFlip(dst_raw, dst_id, snap_total, payload_accepted)
            handle.flip = flip
            try:
                await asyncio.wait_for(
                    flip.done.wait(), knobs.get("DYN_MIGRATE_FLIP_TIMEOUT_S")
                )
            except asyncio.TimeoutError:
                pass
            # the consumer commits synchronously between items; whatever
            # state we observe here is final for this flip
            if flip.outcome is None:
                flip.outcome = "timeout"
                if handle.flip is flip:
                    handle.flip = None
            if flip.outcome != "committed":
                raise RuntimeError(f"flip did not commit ({flip.outcome})")
        except BaseException as exc:
            if dst_raw is not None:
                # discard the pre-admitted destination stream: kills the
                # worker-side context for that hop only (data-plane control
                # frame), the client-visible source stream is untouched
                await dst_raw.send_control("kill")
            counters.incr("dyn_migration_aborted_total")
            _flight_event("aborted", request=request_id, error=repr(exc))
            if span is not None:
                span.end(status="error", error=repr(exc))
            logger.warning(
                "migrate %s %x->%x aborted (%s); session continues on source",
                request_id, src, dst, exc,
            )
            if isinstance(exc, asyncio.CancelledError):
                raise
            return {"op": "migrate", "ok": False, "aborted": True,
                    "request_id": request_id, "src": f"{src:x}",
                    "dst": f"{dst:x}", "error": repr(exc)}
        finally:
            handle.busy = False
        hidden = time.monotonic() - t0
        counters.incr("dyn_migration_committed_total")
        _flight_event("committed", request=request_id, hidden_s=round(hidden, 4))
        counters.incr("dyn_migration_hidden_seconds", hidden)
        if span is not None:
            span.end(hidden_s=round(hidden, 4))
        logger.info(
            "migrated %s %x->%x (%s, reason=%s) in %.3fs hidden",
            request_id, src, dst_id, hop or "unpriced", reason, hidden,
        )
        return {"op": "migrate", "ok": True, "request_id": request_id,
                "src": f"{src:x}", "dst": f"{dst_id:x}", "hop": hop,
                "reason": reason, "hidden_s": round(hidden, 4)}

    async def migrate_off(self, inst_id: int, *, reason: str = "drain") -> list[dict]:
        """Drain integration: move every live session off ``inst_id``.
        Each migration picks its own destination; failures degrade to the
        existing cancel-via-resume drain path, so this is strictly a
        latency win, never a safety risk."""
        results = []
        for rid in self.sessions_on(inst_id):
            results.append(await self.migrate(rid, None, reason=reason))
        return results

    # -- drain hook --------------------------------------------------------
    def attach_client(self, client) -> None:
        """Subscribe to instance-removal events so a draining worker's
        survivors are migrated during its natural-completion window (the
        drain deletes its instance key in phase 1, cancels in phase 2)."""
        client.on_instance_removed.append(self._on_instance_removed)

    def _on_instance_removed(self, inst_id: int) -> None:
        if self.sessions_on(inst_id):
            spawn_logged(self.migrate_off(inst_id, reason="drain"))

    # -- control-plane verb ------------------------------------------------
    async def serve_ctl(self, bus) -> None:
        if self._ctl_sub is not None:
            return
        self._ctl_sub = await bus.subscribe(MIGRATE_SUBJECT)
        self._ctl_task = spawn_logged(self._ctl_loop(bus))

    async def stop(self) -> None:
        sub, self._ctl_sub = self._ctl_sub, None
        if sub is not None:
            await sub.unsubscribe()
        task, self._ctl_task = self._ctl_task, None
        if task is not None and task is not asyncio.current_task():
            task.cancel()

    def _resolve_instance(self, needle: str) -> int | None:
        """Hex-prefix instance resolution (same UX as ``dynctl drain``);
        None on no/ambiguous match."""
        needle = needle.lower()
        if needle.startswith("0x"):
            needle = needle[2:]
        matches = []
        for iid in self.router.client.instance_ids:
            hex16 = f"{iid:016x}"
            if needle in (hex16, f"{iid:x}") or hex16.startswith(needle):
                matches.append(iid)
        return matches[0] if len(matches) == 1 else None

    async def _ctl_loop(self, bus) -> None:
        assert self._ctl_sub is not None
        async for msg in self._ctl_sub:
            try:
                op = json.loads(msg.payload.decode())
            except Exception:  # noqa: BLE001
                continue
            if op.get("op") != "migrate":
                continue
            rid = str(op.get("request_id") or "")
            if self.resolve(rid) is None:
                # a fleet runs many dispatchers on this subject; only the
                # owner answers, so an unknown id times out at the caller
                continue
            dst_arg = op.get("dst")
            dst: int | None = None
            result: dict | None = None
            if dst_arg:
                dst = self._resolve_instance(str(dst_arg))
                if dst is None:
                    counters.incr("dyn_migration_failed_total")
                    result = {"op": "migrate", "ok": False, "request_id": rid,
                              "error": f"no unique instance matches {dst_arg!r}"}
            if result is None:
                result = await self.migrate(
                    rid, dst, reason=str(op.get("reason") or "manual")
                )
            if msg.reply_to:
                await bus.publish(msg.reply_to, json.dumps(result).encode())
