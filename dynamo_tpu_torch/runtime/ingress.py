"""Network ingress: serving an endpoint instance.

The worker-side push endpoint (reference:
lib/runtime/src/pipeline/network/ingress/push_endpoint.rs:39-101): subscribes
the instance's bus subject, spawns a handler task per request, connects back
over TCP to stream responses, and tracks in-flight requests for graceful
drain on shutdown.
"""

from __future__ import annotations

import asyncio
import json
import time

import msgpack

from dynamo_tpu_torch.observability import get_recorder
from dynamo_tpu_torch.observability import flight as flight_obs
from dynamo_tpu_torch.observability.trace import read_trace
from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.robustness.faults import FAULTS, WORKER_GENERATE
from dynamo_tpu_torch.runtime.component import (
    Instance,
    ctl_subject,
    instance_key,
    stats_subject,
)
from dynamo_tpu_torch.runtime.dataplane import ConnectionInfo, ResponseStreamSender
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context, EngineContext
from dynamo_tpu_torch.utils import knobs
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("runtime.ingress")


class EndpointService:
    """A live, registered instance serving one engine."""

    def __init__(
        self,
        runtime,
        instance: Instance,
        engine: AsyncEngine,
        *,
        stats_handler=None,
        topo_role: str = "",
        topo_transfer_address: str = "",
        topo_slice: str | None = None,
    ):
        self.runtime = runtime
        self.instance = instance
        self.engine = engine
        self.stats_handler = stats_handler
        # topology plane: placement facts for this instance's TopologyCard
        # (published lease-scoped in start() when DYN_TOPO is on)
        self.topo_role = topo_role
        self.topo_transfer_address = topo_transfer_address
        self.topo_slice = topo_slice
        self._lease = None
        self._sub = None
        self._stats_sub = None
        self._ctl_sub = None
        self._tasks: set[asyncio.Task] = set()
        self._loop_task: asyncio.Task | None = None
        self._stats_task: asyncio.Task | None = None
        self._ctl_task: asyncio.Task | None = None
        self._draining = False
        self._drain_task: asyncio.Task | None = None
        self._stopped = False
        self._in_flight = 0
        self._arrived_total = 0
        self._last_arrival = 0.0  # event-loop time of the newest request
        self._handled_total = 0
        self._errors_total = 0
        self._drained = asyncio.Event()
        self._drained.set()
        self._started_at = time.time()

    # -- lifecycle ---------------------------------------------------------
    async def start(self, lease_ttl: float = 3.0) -> None:
        plane = self.runtime.plane
        self._lease = await plane.kv.grant_lease(lease_ttl)
        self._sub = await plane.bus.subscribe(self.instance.subject)
        self._stats_sub = await plane.bus.subscribe(stats_subject(self.instance.subject))
        self._ctl_sub = await plane.bus.subscribe(ctl_subject(self.instance.subject))
        self._loop_task = spawn_logged(self._serve_loop())
        self._stats_task = spawn_logged(self._stats_loop())
        self._ctl_task = spawn_logged(self._ctl_loop())
        self.runtime.register_keepalive(self._lease)
        # register *after* subscribing so no request can race the subscription
        await plane.kv.put(instance_key(self.instance), self.instance.to_json(), self._lease.id)
        if knobs.get("DYN_TOPO"):
            from dynamo_tpu_torch.topology import local_card, publish_card

            await publish_card(self, local_card(
                self.instance.instance_id,
                transfer_address=self.topo_transfer_address,
                role=self.topo_role,
                slice_label=self.topo_slice,
            ))
        logger.info("serving %s (instance %x)", self.instance.subject, self.instance.instance_id)

    async def shutdown(self, *, drain_timeout: float | None = None) -> None:
        """Deregister, drain in-flight requests, stop accepting.

        Ordering matters: deregistering stops NEW routing decisions, but
        clients with a stale instance view keep publishing to this subject
        until their watch catches up — the subscription must stay open
        through the drain window or those requests are silently dropped
        and their callers wait out the rendezvous timeout (found by the
        runtime soak test's churn wave)."""
        if self._stopped:
            # a graceful drain already tore everything down (it leaves the
            # control loop alive just long enough to publish its reply)
            await self._close_ctl()
            return
        plane = self.runtime.plane
        await plane.kv.delete(instance_key(self.instance))
        if self._stats_sub is not None:
            await self._stats_sub.unsubscribe()
        if drain_timeout is None:
            drain_timeout = self.runtime.config.graceful_shutdown_timeout
        loop = asyncio.get_running_loop()
        deadline = loop.time() + drain_timeout
        while True:
            remaining = deadline - loop.time()
            if remaining <= 0:
                logger.warning(
                    "drain timeout: %d requests still in flight on %s",
                    self._in_flight,
                    self.instance.subject,
                )
                break
            try:
                await asyncio.wait_for(self._drained.wait(), remaining)
            except asyncio.TimeoutError:
                continue
            # an envelope may already sit in the subscription queue with no
            # handler task yet (invisible to in_flight/arrival counters):
            # yield so _serve_loop can spawn it, then require no live tasks
            await asyncio.sleep(0)
            if self._tasks or self._in_flight:
                continue
            # quiet period: in_flight hitting zero mid-burst is not done —
            # stale-view clients may still be publishing; only close the
            # subject once no new request ARRIVED for a beat (arrivals, not
            # completions: a request that arrives and fails connect-back
            # inside the window must still count as activity).  A service
            # whose last arrival is already older than the beat — including
            # one that never served — skips the sleep entirely.
            if loop.time() - self._last_arrival > 0.25:
                break
            before = self._arrived_total
            await asyncio.sleep(min(0.25, max(deadline - loop.time(), 0.0)))
            if (
                self._in_flight == 0
                and self._arrived_total == before
                and not self._tasks
            ):
                break
        if self._sub is not None:
            await self._sub.unsubscribe()
        await self._close_ctl()
        for task in (self._loop_task, self._stats_task):
            if task is not None:
                task.cancel()
        for task in list(self._tasks):
            task.cancel()
        if self._lease is not None:
            await plane.kv.revoke_lease(self._lease)
        self._stopped = True

    async def abort(self) -> None:
        """Crash-style teardown (chaos/worker-kill seam): no drain, no
        grace — the lease is revoked and every handler task is cancelled
        mid-stream, exactly like a process dying under a supervisor.  The
        cancelled handlers' error frames give the dispatcher its mid-stream
        failure to resume from."""
        plane = self.runtime.plane
        await plane.kv.delete(instance_key(self.instance))
        if self._sub is not None:
            await self._sub.unsubscribe()
        if self._stats_sub is not None:
            await self._stats_sub.unsubscribe()
        await self._close_ctl()
        for task in (self._loop_task, self._stats_task):
            if task is not None:
                task.cancel()
        tasks = [t for t in list(self._tasks) if not t.done()]
        for task in tasks:
            task.cancel()
        if tasks:
            await asyncio.wait(tasks, timeout=5)
        if self._lease is not None:
            await plane.kv.revoke_lease(self._lease)
        self._stopped = True

    async def _close_ctl(self) -> None:
        if self._ctl_sub is not None:
            await self._ctl_sub.unsubscribe()
            self._ctl_sub = None
        task, self._ctl_task = self._ctl_task, None
        if task is not None and task is not asyncio.current_task():
            task.cancel()

    # -- graceful drain ----------------------------------------------------
    async def drain(self, timeout_s: float | None = None) -> dict:
        """Empty this worker without killing any request.

        State machine: (1) admissions stop instantly — the instance key is
        deleted so routers stop picking us, and any stale-view envelope
        that still lands gets an immediate ``worker shutting down`` error
        frame the dispatcher treats as a safe pre-first-token retry;
        (2) in-flight requests get ~half the budget to finish naturally;
        (3) survivors are handed off — their handler tasks are cancelled,
        whose error frames the dispatcher resumes from its generation
        journal on a healthy peer; (4) the lease is revoked, so the
        instance is gone from every view BEFORE the process exits.

        Idempotent and concurrency-safe: every caller (dynctl, SIGTERM,
        planner scale-down, a racing shutdown) awaits the same underlying
        drain and gets the same result dict.
        """
        if self._drain_task is None:
            self._drain_task = asyncio.ensure_future(self._drain(timeout_s))
        return await asyncio.shield(self._drain_task)

    async def _drain(self, timeout_s: float | None) -> dict:
        if timeout_s is None or timeout_s <= 0:
            timeout_s = knobs.get("DYN_DRAIN_TIMEOUT_S")
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        deadline = t0 + timeout_s
        self._draining = True
        counters.incr("dyn_drain_started_total")
        # flight recorder: record the drain and snapshot the ring NOW —
        # the worker is about to empty and the pre-drain window is the
        # evidence an operator wants
        flight_obs.dump_all_on_drain(
            instance=f"{self.instance.instance_id:x}", in_flight=self._in_flight
        )
        span = get_recorder().start(
            "engine.drain", None, component="worker",
            attrs={"subject": self.instance.subject,
                   "instance": f"{self.instance.instance_id:x}",
                   "in_flight": self._in_flight,
                   "timeout_s": timeout_s},
        )
        plane = self.runtime.plane
        await plane.kv.delete(instance_key(self.instance))
        # phase 1 — natural completion: short sequences just finish
        natural_deadline = t0 + timeout_s * 0.5
        while (self._tasks or self._in_flight) and loop.time() < natural_deadline:
            try:
                await asyncio.wait_for(
                    self._drained.wait(),
                    max(min(0.1, natural_deadline - loop.time()), 0.01),
                )
            except asyncio.TimeoutError:
                pass
            await asyncio.sleep(0)  # let _serve_loop spawn queued envelopes
        # phase 2 — handoff: cancel survivors; their CancelledError path
        # sends "worker shutting down", which the dispatcher's journal
        # resumes on another worker with exactly-once delivery
        me = asyncio.current_task()
        handoff = [t for t in list(self._tasks) if t is not me and not t.done()]
        for task in handoff:
            task.cancel()
        if handoff:
            counters.incr("dyn_drain_handoff_total", len(handoff))
            await asyncio.wait(handoff, timeout=max(deadline - loop.time(), 0.5))
        emptied = not self._tasks and self._in_flight == 0
        # phase 3 — teardown: revoke the lease before anyone can exit us
        if self._sub is not None:
            await self._sub.unsubscribe()
        if self._stats_sub is not None:
            await self._stats_sub.unsubscribe()
        for task in (self._loop_task, self._stats_task):
            if task is not None and task is not me:
                task.cancel()
        if self._lease is not None:
            await plane.kv.revoke_lease(self._lease)
        self._stopped = True
        if emptied:
            counters.incr("dyn_drain_completed_total")
        result = {
            "op": "drain",
            "ok": emptied,
            "instance_id": f"{self.instance.instance_id:x}",
            "subject": self.instance.subject,
            "handed_off": len(handoff),
            "duration_s": round(loop.time() - t0, 3),
        }
        if span is not None:
            span.end(**{k: v for k, v in result.items() if k != "op"})
        logger.info(
            "drained %s: ok=%s handed_off=%d in %.2fs",
            self.instance.subject, emptied, len(handoff), result["duration_s"],
        )
        return result

    async def _ctl_loop(self) -> None:
        """Request/reply control verbs on ``_ctl.<subject>`` (dynctl drain)."""
        assert self._ctl_sub is not None
        async for msg in self._ctl_sub:
            try:
                op = json.loads(msg.payload.decode())
            except Exception:  # noqa: BLE001
                logger.warning("malformed ctl message on %s", self.instance.subject)
                continue
            if op.get("op") == "flight_dump":
                # on-demand flight dump (dynctl flight dump): write every
                # live recorder's ring and reply with the paths
                paths = flight_obs.dump_all("manual")
                if msg.reply_to:
                    await self.runtime.plane.bus.publish(
                        msg.reply_to,
                        json.dumps({
                            "op": "flight_dump",
                            "ok": True,
                            "instance_id": f"{self.instance.instance_id:x}",
                            "enabled": flight_obs.flight_enabled(),
                            "paths": [str(p) for p in paths],
                        }).encode(),
                    )
                continue
            if op.get("op") != "drain":
                if msg.reply_to:
                    await self.runtime.plane.bus.publish(
                        msg.reply_to,
                        json.dumps({"ok": False, "error": f"unknown op {op.get('op')!r}"}).encode(),
                    )
                continue
            result = await self.drain(op.get("timeout_s"))
            if msg.reply_to:
                await self.runtime.plane.bus.publish(
                    msg.reply_to, json.dumps(result).encode()
                )
            # the drain tore the instance down; close our own subscription
            # and exit (we cannot be cancelled mid-reply this way)
            await self._close_ctl()
            return

    # -- serving -----------------------------------------------------------
    async def _serve_loop(self) -> None:
        assert self._sub is not None
        async for msg in self._sub:
            try:
                envelope = msgpack.unpackb(msg.payload, raw=False)
            except Exception:  # noqa: BLE001
                logger.warning("malformed request envelope on %s", self.instance.subject)
                continue
            task = asyncio.ensure_future(self._handle(envelope))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    async def _handle(self, envelope: dict) -> None:
        control = envelope["c"]
        request = envelope["p"]
        ctx = EngineContext(control["id"])
        # propagated trace context: engine-side spans (queue/prefill/decode)
        # nest under this worker's handle span so one trace_id reassembles
        # the whole frontend → router → engine path
        wire_trace = read_trace(control)
        span = get_recorder().start(
            "worker.handle", wire_trace, component="worker",
            attrs={"subject": self.instance.subject,
                   "instance": f"{self.instance.instance_id:x}"},
        )
        ctx.trace = span.ctx if span is not None else None
        sender = ResponseStreamSender(ConnectionInfo.from_dict(control["ci"]), ctx)
        if self._draining or self._stopped:
            # admission stop: a stale-view client published to a draining
            # worker — connect back only to deliver the error frame, which
            # the dispatcher treats as a safe pre-first-token retry
            try:
                await sender.connect()
                await sender.error("worker shutting down")
            except (ConnectionError, OSError, asyncio.TimeoutError):
                pass
            if span is not None:
                span.end(status="error", error="draining: admission stopped")
            return
        self._in_flight += 1
        self._arrived_total += 1
        self._last_arrival = asyncio.get_running_loop().time()
        self._drained.clear()
        try:
            await sender.connect()
        # asyncio.TimeoutError: on py3.10 it is NOT an OSError subclass, and
        # connect()'s retry loop re-raises it after exhausting attempts — it
        # must not leak _in_flight
        except (ConnectionError, OSError, asyncio.TimeoutError) as exc:
            logger.warning("connect-back failed for %s: %r", control["id"], exc)
            if span is not None:
                span.end(status="error", error=f"connect-back failed: {exc!r}")
            self._request_done()
            return
        try:
            # chaos seam: a worker failing before its engine produced
            # anything — the error frame reaches the frontend pre-first-
            # token, which re-dispatches to a healthy peer
            FAULTS.check(WORKER_GENERATE, request=control["id"])
            stream = await self.engine.generate(Context(request, ctx))
            items = 0
            async for item in stream:
                if ctx.is_killed:
                    break
                items += 1
                await sender.send(item)
            await sender.complete()
            self._handled_total += 1
            if span is not None:
                span.end(items=items, killed=ctx.is_killed)
        except asyncio.CancelledError:
            await sender.error("worker shutting down")
            if span is not None:
                span.end(status="error", error="worker shutting down")
            raise
        except Exception as exc:  # noqa: BLE001
            logger.exception("engine error on %s", self.instance.subject)
            self._errors_total += 1
            await sender.error(repr(exc))
            if span is not None:
                span.end(status="error", error=repr(exc))
        finally:
            self._request_done()

    def _request_done(self) -> None:
        self._in_flight -= 1
        if self._in_flight == 0:
            self._drained.set()

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        data = {
            "subject": self.instance.subject,
            "instance_id": self.instance.instance_id,
            "draining": self._draining,
            "in_flight": self._in_flight,
            "handled_total": self._handled_total,
            "errors_total": self._errors_total,
            "uptime_s": time.time() - self._started_at,
        }
        if self.stats_handler is not None:
            try:
                data["custom"] = self.stats_handler()
            except Exception:  # noqa: BLE001
                logger.exception("stats handler failed")
        return data

    async def _stats_loop(self) -> None:
        assert self._stats_sub is not None
        async for msg in self._stats_sub:
            if msg.reply_to:
                await self.runtime.plane.bus.publish(
                    msg.reply_to, json.dumps(self.stats()).encode()
                )
