"""Network egress: endpoint clients and the push router.

Mirrors the reference's client/egress stack (reference:
lib/runtime/src/component/client.rs, pipeline/network/egress/push_router.rs):
a ``Client`` tracks live instances (static list or dynamic KV watch); a
``PushRouter`` picks an instance per request (random / round-robin / direct),
registers a local TCP response stream, and pushes the request envelope to the
instance's bus subject.
"""

from __future__ import annotations

import asyncio
import os
import enum
import random
import time
import uuid

import msgpack

from dynamo_tpu_torch.observability import get_recorder
from dynamo_tpu_torch.observability.trace import stamp_trace
from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.runtime.component import Endpoint, Instance, instances_prefix
from dynamo_tpu_torch.runtime.dataplane import PendingStream
from dynamo_tpu_torch.runtime.controlplane.interface import WatchEventType
from dynamo_tpu_torch.runtime.engine import Context, EngineContext, ResponseStream
from dynamo_tpu_torch.runtime.migration import MigrationCoordinator
from dynamo_tpu_torch.runtime.resume import GenerationJournal, dedupe_stream
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged
from dynamo_tpu_torch.utils import knobs

logger = get_logger("runtime.client")


class RouterMode(enum.Enum):
    RANDOM = "random"
    ROUND_ROBIN = "round_robin"
    DIRECT = "direct"
    KV = "kv"  # KV-cache-aware; scheduling provided by dynamo_tpu_torch.llm.kv_router


class Client:
    """Tracks instances of one endpoint; generates requests against them."""

    def __init__(
        self,
        runtime,
        endpoint: Endpoint,
        *,
        static_instances: list[Instance] | None = None,
    ):
        self.runtime = runtime
        self.endpoint = endpoint
        self._static = static_instances is not None
        self._instances: dict[int, Instance] = {
            i.instance_id: i for i in (static_instances or [])
        }
        self._watch = None
        self._watch_task: asyncio.Task | None = None
        self._changed = asyncio.Event()
        # instance-removal hooks (sync callables, instance_id arg): the
        # migration coordinator uses the DELETE event — fired the moment a
        # drain deletes its instance key — to move survivors off the worker
        # while its natural-completion window is still open
        self.on_instance_removed: list = []

    async def start(self) -> None:
        if self._static:
            return
        prefix = instances_prefix(
            self.endpoint.component.namespace.name,
            self.endpoint.component.name,
            self.endpoint.name,
        )
        self._watch = self.runtime.plane.kv.watch_prefix(prefix)
        self._watch_task = spawn_logged(self._watch_loop())
        # Don't return until the watch's initial snapshot has been applied:
        # a request served before this sees an empty instance view even
        # though workers are registered (startup race).
        await self._watch.ready()

    async def _watch_loop(self) -> None:
        assert self._watch is not None
        try:
            async for event in self._watch:
                try:
                    inst = Instance.from_json(event.entry.value)
                except Exception:  # noqa: BLE001
                    continue
                if event.type == WatchEventType.PUT:
                    self._instances[inst.instance_id] = inst
                else:
                    self._instances.pop(inst.instance_id, None)
                    for hook in list(self.on_instance_removed):
                        try:
                            hook(inst.instance_id)
                        except Exception:  # noqa: BLE001
                            logger.exception("instance-removed hook failed")
                self._changed.set()
                self._changed = asyncio.Event()
        except ConnectionError as exc:
            # instance view is stale from here on; requests keep flowing to
            # the last-known instances rather than failing hard
            logger.warning("%s instance watch lost: %s", self.endpoint.path, exc)

    async def close(self) -> None:
        if self._watch is not None:
            self._watch.cancel()
        if self._watch_task is not None:
            self._watch_task.cancel()

    # -- instance views ----------------------------------------------------
    @property
    def instances(self) -> list[Instance]:
        return list(self._instances.values())

    @property
    def instance_ids(self) -> list[int]:
        return list(self._instances.keys())

    async def wait_for_instances(self, n: int = 1, timeout: float = 30.0) -> list[Instance]:
        deadline = asyncio.get_running_loop().time() + timeout
        while len(self._instances) < n:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                raise TimeoutError(
                    f"{self.endpoint.path}: {len(self._instances)}/{n} instances after {timeout}s"
                )
            changed = self._changed
            try:
                await asyncio.wait_for(changed.wait(), min(remaining, 0.5))
            except asyncio.TimeoutError:
                pass
        return self.instances


class InstanceNotFound(RuntimeError):
    """Directly-addressed instance is no longer registered (deregistered or
    lease-reaped between scheduling and dispatch)."""


# Remote engine errors arrive as RuntimeError("remote engine error: <repr>")
# (dataplane error frames) — the repr is all we have to distinguish a dead
# worker from a request its engine deterministically rejects.
_TRANSIENT_STREAM_MARKERS = (
    "connection lost",          # transport died mid-stream (no error frame)
    "worker shutting down",     # drain raced the dispatch
    "ConnectionError",          # worker-side transport/injected failures,
    "ConnectionResetError",     # surfaced through the error frame's repr
    "BrokenPipeError",
    "TimeoutError",
    "OSError",
)


def _is_transient_stream_error(exc: BaseException) -> bool:
    """True for stream failures where re-dispatching can help (worker died,
    transport broke).  A deterministic application error (bad prompt,
    guided-decoding rejection) would fail identically on every peer —
    retrying it burns duplicate work and, worse, quarantines healthy
    workers over a poison request."""
    if isinstance(exc, (ConnectionError, OSError, asyncio.TimeoutError)):
        return True
    message = str(exc)
    return any(marker in message for marker in _TRANSIENT_STREAM_MARKERS)


class PushRouter:
    """Routes requests to instances and returns the response stream."""

    def __init__(self, client: Client, mode: RouterMode = RouterMode.RANDOM):
        self.client = client
        self.mode = mode
        self._rr = 0
        # quarantine shared by ALL routing modes: a worker that failed a
        # rendezvous is skipped until its deadline passes (a dead worker
        # stays in the instance view until its lease is reaped — or forever
        # if the watch was lost — and per-request exclusion alone would
        # re-pay the connect timeout on every other request)
        self.dark_ttl_s = knobs.get("DYN_DARK_WORKER_TTL_S")
        self._dark: dict[int, float] = {}  # instance_id -> retry-after monotonic
        # live-session migration (dynctl migrate / drain handoff / planner
        # defrag): journaled streams register with the coordinator so their
        # decode can be flipped to another worker mid-stream, exactly-once
        self.migrations: MigrationCoordinator | None = (
            MigrationCoordinator(self) if knobs.get("DYN_MIGRATE") else None
        )
        if self.migrations is not None:
            self.migrations.attach_client(client)

    @classmethod
    async def from_endpoint(
        cls, endpoint: Endpoint, mode: RouterMode = RouterMode.RANDOM
    ) -> "PushRouter":
        client = await endpoint.client()
        return cls(client, mode)

    def quarantine(self, instance_id: int) -> None:
        self._dark[instance_id] = time.monotonic() + self.dark_ttl_s

    def dark_instances(self) -> set[int]:
        """Currently-quarantined instance ids (expired entries dropped)."""
        now = time.monotonic()
        self._dark = {w: t for w, t in self._dark.items() if t > now}
        return set(self._dark)

    def healthy_ids(self, exclude: set[int] | None = None) -> list[int]:
        """Candidate instance ids under the shared routing policy:
        exclusion (failed THIS request) is hard; quarantine is soft —
        when every remaining candidate is quarantined, retry them rather
        than hard-failing a servable request."""
        ids = [
            w for w in self.client.instance_ids if w not in (exclude or set())
        ]
        if not ids:
            return []
        dark = self.dark_instances()
        healthy = [w for w in ids if w not in dark]
        return healthy or ids

    def _pick(
        self, instance_id: int | None, exclude: set[int] | None = None
    ) -> Instance | None:
        instances = self.client.instances
        if instance_id is not None:
            inst = self.client._instances.get(instance_id)
            if inst is None:
                raise InstanceNotFound(f"instance {instance_id:x} not found")
            return inst
        if not instances:
            raise RuntimeError(f"no instances available for {self.client.endpoint.path}")
        ids = set(self.healthy_ids(exclude))
        if not ids:
            return None  # every live instance already failed this request
        instances = [i for i in instances if i.instance_id in ids]
        if self.mode == RouterMode.ROUND_ROBIN:
            inst = instances[self._rr % len(instances)]
            self._rr += 1
            return inst
        return random.choice(instances)

    async def generate(
        self, request: Context[dict], *, instance_id: int | None = None
    ) -> ResponseStream[dict]:
        """Push ``request`` (a wire-dict) to an instance, return its stream.

        A rendezvous timeout fails over to another instance (reference:
        router modes re-pick per request, push_router.rs:111-155): a
        worker that died with its lease not yet reaped would otherwise
        surface a timeout to the caller while healthy peers sit idle.
        Safe because nothing has streamed before the rendezvous completes.
        Direct routing (explicit ``instance_id``) never fails over.

        After the rendezvous, a stream that fails BEFORE its first item is
        re-dispatched to another healthy instance (up to ``DYN_RETRY_MAX``
        times, counted in ``dyn_retries_total`` and visible as a
        ``dispatch.retry`` span): with zero items delivered the request
        provably had no observable effect on the client, so re-running it
        cannot duplicate output.

        A stream that fails AFTER its first item is *resumed* when the
        request is deterministic-replayable (greedy or seeded — see
        runtime/resume.py) and ``DYN_RESUME`` is on: the generation journal
        re-dispatches the original request plus a ``resume_from`` cursor,
        and a dedupe cursor over the new stream guarantees exactly-once
        token delivery.  Non-deterministic requests keep the honest
        truncation error.  Direct (pinned) dispatch never fails over
        pre-first-token — the KV router owns that reschedule — but DOES
        resume mid-stream, un-pinned: the affinity bet is already burned
        once the pinned worker died with the stream half-delivered.
        """
        tried: set[int] = set()
        pending, inst_id = await self._rendezvous(request, instance_id, tried)
        retry_max = knobs.get("DYN_RETRY_MAX")
        journal: GenerationJournal | None = None
        if retry_max > 0 and knobs.get("DYN_RESUME") and isinstance(request.data, dict):
            journal = GenerationJournal(request.data)
            if not journal.resumable:
                journal = None
        if instance_id is not None or retry_max <= 0:
            # direct routing keeps affinity decisions with the scheduler
            # (KV router does its own reschedule-excluding-failed failover),
            # so pre-first-token retries stay off here (retry_max=0 below)
            if journal is None:
                return ResponseStream(pending, request.ctx)
            return ResponseStream(
                self._stream_with_retry(
                    request, pending, inst_id, tried, 0,
                    journal=journal, resume_max=retry_max,
                ),
                request.ctx,
            )
        return ResponseStream(
            self._stream_with_retry(
                request, pending, inst_id, tried, retry_max,
                journal=journal, resume_max=retry_max if journal else 0,
            ),
            request.ctx,
        )

    async def _stream_with_retry(
        self, request: Context[dict], pending, inst_id: int, tried: set[int],
        retry_max: int, journal: GenerationJournal | None = None,
        resume_max: int = 0,
    ):
        retries = 0
        resumes = 0
        resume_counted = False
        # ``pending`` is what we iterate (possibly a dedupe wrapper);
        # ``raw`` is the underlying transport stream of the active hop —
        # the thing a migration flip must kill to release the source
        raw = pending
        handle = None
        if journal is not None and self.migrations is not None:
            handle = self.migrations.register(
                request.ctx.id, journal, request.ctx, inst_id
            )
        try:
            while True:
                streamed_any = False
                it = pending.__aiter__()
                try:
                    while True:
                        if handle is not None and handle.flip_pending():
                            if journal.finished:
                                # the finish item already reached the client;
                                # there is nothing left to move
                                handle.abort_flip("finished")
                            else:
                                # COMMIT — synchronous (no await between the
                                # pending check and ``done.set()``), so the
                                # coordinator's flip timeout can never observe
                                # a half-applied swap.  An item boundary IS a
                                # journal window boundary: the source decoded
                                # ``delta`` tokens past the snapshot, all
                                # delivered, and the destination regenerates
                                # exactly that window for the cursor to drop.
                                flip = handle.flip
                                delta = journal.total_recorded - flip.snap_total
                                old_raw, raw = raw, flip.dst_raw
                                inst_id = flip.dst_inst_id
                                handle.inst_id = inst_id
                                pending = dedupe_stream(
                                    raw, flip.payload_accepted + delta,
                                    ack_skip=delta,
                                )
                                it = pending.__aiter__()
                                handle.flip = None
                                flip.outcome = "committed"
                                flip.done.set()
                                # release the source: a data-plane control
                                # frame killing the worker-side context of
                                # the OLD hop only — the request context
                                # (and this stream) are untouched
                                spawn_logged(old_raw.send_control("kill"))
                        try:
                            item = await it.__anext__()
                        except StopAsyncIteration:
                            break
                        streamed_any = True
                        if journal is not None:
                            journal.record(item)
                        if (
                            isinstance(item, dict)
                            and isinstance(item.get("data"), dict)
                            and item["data"].get("finish_reason")
                        ):
                            # success is counted at the FINISH item, not at
                            # generator exhaustion: consumers stop pulling
                            # once they see the finish, so a post-loop
                            # increment may never run.  The journal releases
                            # its retained tokens here for the same reason.
                            if journal is not None:
                                journal.finish()
                            if resumes and not resume_counted:
                                resume_counted = True
                                counters.incr("dyn_resume_success_total")
                        yield item
                    if resumes and not resume_counted:
                        resume_counted = True
                        counters.incr("dyn_resume_success_total")
                    return
                except Exception as exc:  # noqa: BLE001 — retry decision below
                    if handle is not None:
                        # a flip prepared against the now-broken hop is void;
                        # the coordinator kills its pre-admitted destination
                        # and the ordinary resume machinery takes over —
                        # migration is never less safe than not migrating
                        handle.abort_flip()
                    if request.ctx.is_killed or not _is_transient_stream_error(exc):
                        raise
                    accepted = journal.accepted if journal is not None else []
                    if not streamed_any and not accepted:
                        # pre-first-token: safe plain re-dispatch
                        if retries >= retry_max:
                            raise
                        retries += 1
                        counters.incr("dyn_retries_total")
                        tried.add(inst_id)
                        self.quarantine(inst_id)
                        logger.warning(
                            "stream from instance %x failed pre-first-token (%s); "
                            "re-dispatching (retry %d/%d)",
                            inst_id, exc, retries, retry_max,
                        )
                        span = get_recorder().start(
                            "dispatch.retry", getattr(request.ctx, "trace", None),
                            component="frontend",
                            attrs={
                                "failed_instance": f"{inst_id:x}",
                                "attempt": retries,
                                "error": repr(exc),
                            },
                        )
                        try:
                            pending, inst_id = await self._rendezvous(request, None, tried)
                        except BaseException as redispatch_exc:
                            if span is not None:
                                span.end(status="error", error=repr(redispatch_exc))
                            # surface the original stream failure; the re-dispatch
                            # failure (usually "no instances left") rides as cause
                            raise exc from redispatch_exc
                        if span is not None:
                            span.end(instance=f"{inst_id:x}")
                        raw = pending
                        if handle is not None:
                            handle.inst_id = inst_id
                        continue
                    # mid-stream: resume from the journal (or truncate honestly)
                    if journal is None or resumes >= resume_max:
                        raise
                    resumes += 1
                    journal.resumes = resumes
                    counters.incr("dyn_resume_attempts_total")
                    tried.add(inst_id)
                    self.quarantine(inst_id)
                    logger.warning(
                        "stream from instance %x failed after %d accepted "
                        "token(s) (%s); resuming (resume %d/%d)",
                        inst_id, len(accepted), exc, resumes, resume_max,
                    )
                    span = get_recorder().start(
                        "dispatch.resume", getattr(request.ctx, "trace", None),
                        component="frontend",
                        attrs={
                            "failed_instance": f"{inst_id:x}",
                            "accepted_tokens": len(accepted),
                            "attempt": resumes,
                            "error": repr(exc),
                        },
                    )
                    # un-pinned re-dispatch of the ORIGINAL request + cursor; a
                    # resume-aware engine continues (and acks), everything else
                    # replays — riding the prefix cache — and the dedupe cursor
                    # drops the replayed prefix
                    resumed = Context(journal.resume_request(), request.ctx)
                    try:
                        raw, inst_id = await self._rendezvous(resumed, None, tried)
                    except BaseException as redispatch_exc:
                        if span is not None:
                            span.end(status="error", error=repr(redispatch_exc))
                        raise exc from redispatch_exc
                    if span is not None:
                        span.end(instance=f"{inst_id:x}")
                    if handle is not None:
                        handle.inst_id = inst_id
                    pending = dedupe_stream(raw, len(accepted))
        finally:
            if handle is not None:
                self.migrations.unregister(handle)

    async def _rendezvous(
        self, request: Context[dict], instance_id: int | None, tried: set[int]
    ) -> "tuple[PendingStream, int]":
        """One dispatch: pick an instance, publish the envelope, await the
        worker's connect-back.  Fails over across instances (``tried`` is
        shared with the caller's retry policy so a retry never lands on an
        instance this request already burned)."""
        runtime = self.client.runtime
        server = await runtime.data_server()
        ctx = request.ctx
        connect_timeout = knobs.get("DYN_CONNECT_TIMEOUT_S")
        # quarantined instances get a short probe window instead of the
        # full connect timeout: during a full-fleet outage healthy_ids
        # returns the dark set rather than hard-failing, and without this a
        # request would serially re-pay 30s per dark instance — a latency
        # storm instead of a fast, diagnosable failure
        dark_probe_timeout = min(
            connect_timeout, knobs.get("DYN_DARK_PROBE_TIMEOUT_S")
        )
        # hard cap on TOTAL rendezvous time across failovers; generation
        # time is unbounded as ever — this only bounds how long a request
        # can hunt for a worker that will talk to it.  The default scales
        # with the connect timeout so raising DYN_CONNECT_TIMEOUT_S (e.g.
        # for first-compile rendezvous on a loaded CI box) is never
        # silently undone by a smaller fixed budget.
        budget = knobs.get("DYN_RENDEZVOUS_BUDGET_S") or 3.0 * connect_timeout
        t_start = time.monotonic()
        last_err: Exception | None = None
        dark_started: dict[int, float] = {}  # instance -> first dark publish
        dark_count = 0
        empty_since: float | None = None  # first empty-instance-view pick
        while True:
            remaining = budget - (time.monotonic() - t_start)
            if remaining <= 0 and last_err is not None:
                logger.warning(
                    "rendezvous budget %.0fs exhausted after %d instance(s)",
                    budget, len(tried),
                )
                break
            # bounded by exclusion, not a count: every live instance gets
            # one shot (3 dark + 2 healthy must reach the healthy ones)
            try:
                inst = self._pick(instance_id, exclude=tried)
                empty_since = None
            except InstanceNotFound:
                raise  # pinned dispatch: let KV routing reschedule at once
            except RuntimeError as exc:
                # EMPTY instance view — can be transient: a control-plane
                # resync replays synthetic deletes before the workers'
                # re-registrations land (observed driving a real 3-process
                # dynctl restart).  Wait it out briefly before giving up.
                now = time.monotonic()
                empty_since = empty_since if empty_since is not None else now
                if now - empty_since >= dark_probe_timeout or remaining <= 0:
                    raise last_err or exc
                await asyncio.sleep(0.2)
                continue
            if inst is None:
                break
            # expiry-aware: an EXPIRED quarantine entry must not demote a
            # recovered worker to the probe window (direct dispatch skips
            # healthy_ids, so nothing else prunes on this path)
            attempt_timeout = (
                dark_probe_timeout
                if self._dark.get(inst.instance_id, 0.0) > time.monotonic()
                else connect_timeout
            )
            # every attempt (including the first) honors the budget: an
            # operator setting a budget below the connect timeout chose
            # fail-fast semantics deliberately
            attempt_timeout = min(attempt_timeout, max(remaining, 0.1))
            # stream ids are per-hop AND per-attempt (a pipeline stage
            # reuses the request ctx, so ctx.id alone would collide on the
            # shared server; a late connect-back from a failed-over attempt
            # must find nothing and get killed)
            stream_id = uuid.uuid4().hex
            pending = server.register(stream_id, ctx)
            # per-attempt dispatch span: the worker's spans parent to it, so
            # a failed-over request shows every rendezvous it paid for
            dispatch = get_recorder().start(
                "dispatch", getattr(ctx, "trace", None), component="frontend",
                attrs={"instance": f"{inst.instance_id:x}", "subject": inst.subject},
            )
            control = stamp_trace(
                {"id": ctx.id, "ci": server.connection_info(stream_id).to_dict()},
                dispatch.ctx if dispatch is not None else None,
            )
            envelope = msgpack.packb(
                {"c": control, "p": request.data}, use_bin_type=True
            )
            try:
                # the trace also stamps the control-plane transport frame
                # (remote planes), so dynctl can attribute publish failures
                delivered = await runtime.plane.bus.publish(
                    inst.subject, envelope,
                    trace=dispatch.ctx if dispatch is not None else None,
                )
                if delivered == 0:
                    # nobody received the envelope: the worker is dead (its
                    # lease will reap shortly and the watch prunes it) or
                    # mid-resubscribe after a control-plane reconnect.
                    # Re-publish soon instead of burning the full rendezvous
                    # timeout waiting for a connect-back that cannot come —
                    # found by driving a real multi-process dynctl restart.
                    server.unregister(stream_id)
                    if dispatch is not None:
                        dispatch.end(status="error", error="subject dark (no subscriber)")
                    last_err = TimeoutError(
                        f"no subscriber on {inst.subject} — worker dead, or "
                        "mid-resubscribe after a control-plane reconnect"
                    )
                    now = time.monotonic()
                    already_quarantined = self._dark.get(inst.instance_id, 0.0) > now
                    first_dark = dark_started.setdefault(inst.instance_id, now)
                    if already_quarantined or now - first_dark >= dark_probe_timeout:
                        # confirmed-dead subject (it was already suspect, or
                        # stayed dark past the probe window): same remedy as
                        # a rendezvous timeout — quarantine and fail over;
                        # pinned dispatch raises so KV routing reschedules
                        tried.add(inst.instance_id)
                        self.quarantine(inst.instance_id)
                        if instance_id is not None:
                            raise last_err from None
                        logger.warning("%s; failing over", last_err)
                        continue
                    # freshly dark: likely a resubscribe gap, not a death —
                    # re-publish within the probe window
                    dark_count += 1
                    if dark_count in (1, 2) or dark_count % 8 == 0:
                        logger.warning("%s; re-publishing", last_err)
                    await asyncio.sleep(0.25)
                    continue
                # rendezvous: wait for the worker to connect back before
                # returning the stream (the reference awaits the prologue)
                await asyncio.wait_for(pending.connected.wait(), timeout=attempt_timeout)
            except asyncio.TimeoutError:
                if pending.connected.is_set():
                    # the connect-back won the race with wait_for's timer
                    # (both fire in the same loop pass): the stream is
                    # live — failing over here would run the request twice
                    self._dark.pop(inst.instance_id, None)
                    self._end_dispatch(dispatch, pending)
                    return pending, inst.instance_id
                server.unregister(stream_id)
                if dispatch is not None:
                    dispatch.end(status="error", error="rendezvous timeout")
                tried.add(inst.instance_id)
                self.quarantine(inst.instance_id)
                # a bare TimeoutError is undiagnosable from the frontend;
                # name the instance and the usual causes (observed: a
                # request envelope the worker's codec rejected)
                last_err = TimeoutError(
                    f"no data-plane connect-back from instance "
                    f"{inst.instance_id:x} ({inst.subject}) within "
                    f"{attempt_timeout:.0f}s — worker dead/overloaded, or it "
                    "rejected the request envelope (check worker logs for "
                    "'malformed request')"
                )
                if instance_id is not None:
                    raise last_err from None
                logger.warning("%s; failing over", last_err)
                continue
            except ConnectionError as exc:
                # control-plane blip mid-publish: not the instance's fault.
                # Don't burn it from this request's candidate set — back off
                # briefly (the plane client is reconnecting underneath) and
                # re-dispatch; the rendezvous budget bounds the healing wait
                server.unregister(stream_id)
                if dispatch is not None:
                    dispatch.end(status="error", error=repr(exc))
                last_err = exc
                if instance_id is not None:
                    raise
                logger.warning("publish to %s failed (%s); retrying dispatch", inst.subject, exc)
                await asyncio.sleep(0.1)
                continue
            except BaseException as exc:
                # includes caller cancellation mid-rendezvous: the pending
                # registration must not leak (a later connect-back to an
                # unknown stream gets killed instead of streaming into an
                # orphaned queue)
                server.unregister(stream_id)
                if dispatch is not None:
                    dispatch.end(status="error", error=repr(exc))
                raise
            # successful rendezvous clears any quarantine: one transient
            # overload blip must not idle a recovered worker for the TTL
            self._dark.pop(inst.instance_id, None)
            self._end_dispatch(dispatch, pending)
            return pending, inst.instance_id
        if last_err is None:
            # every live instance is already in ``tried`` (the pre-first-
            # token retry path re-enters with the failed set pre-populated)
            raise RuntimeError(
                f"no instances left to dispatch {self.client.endpoint.path} "
                f"({len(tried)} already failed this request)"
            )
        raise last_err

    @staticmethod
    def _end_dispatch(dispatch, pending) -> None:
        """Close a rendezvous span, cross-linking the worker-side span id
        the connect-back prologue carried — the explicit edge between the
        frontend's dispatch attempt and the worker.handle span that served
        it (robust even if either side's buffer later drops a span)."""
        if dispatch is None:
            return
        if pending.trace is not None:
            dispatch.end(worker_span=pending.trace.span_id)
        else:
            dispatch.end()

    async def generate_direct(self, request: Context[dict], instance_id: int) -> ResponseStream[dict]:
        return await self.generate(request, instance_id=instance_id)


class RemoteEngine:
    """AsyncEngine facade over a PushRouter (so pipelines can ``.link`` a
    remote endpoint transparently)."""

    def __init__(self, router: PushRouter, *, instance_id: int | None = None):
        self.router = router
        self.instance_id = instance_id

    async def generate(self, request: Context[dict]) -> ResponseStream[dict]:
        return await self.router.generate(request, instance_id=self.instance_id)
