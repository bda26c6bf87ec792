"""The port's distributed runtime against the reference's: the control
plane (memory and TCP), endpoints and the TCP data plane, the typed
pipeline and the barrier.

Cases that hold the same for both packages are one test parametrised over
the package (``dynamo_tpu`` and ``dynamo_tpu_torch``): the same inputs give
the same observed sequence.  The wire cases cross the packages: a port
client on the reference's control-plane server and the reference's client
on the port's, a port worker behind the reference's router and the other
way round, and the data plane's frames decoded by the other codec.  Every
wait is on an event with a timeout well above need, never a fixed sleep.
"""

import asyncio
import importlib
import itertools
import time
from types import SimpleNamespace

import pytest

PKGS = ["dynamo_tpu", "dynamo_tpu_torch"]
PLANES = ["memory", "tcp"]
_names = itertools.count()


def pkg_modules(pkg: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        memory=mod("runtime.controlplane.memory"),
        client=mod("runtime.controlplane.client"),
        server=mod("runtime.controlplane.server"),
        iface=mod("runtime.controlplane.interface"),
        runtime=mod("runtime"),
        rclient=mod("runtime.client"),
        component=mod("runtime.component"),
        codec=mod("runtime.codec"),
        pipeline=mod("runtime.pipeline"),
        engine=mod("runtime.engine"),
        barrier=mod("runtime.barrier"),
        config=mod("utils.config"),
    )


async def make_plane(pkg: str, kind: str):
    m = pkg_modules(pkg)
    if kind == "memory":
        return m.memory.MemoryControlPlane(), None
    server = m.server.ControlPlaneServer(port=0)
    await server.start()
    plane = m.client.RemoteControlPlane("127.0.0.1", server.port)
    await plane.connect()
    return plane, server


async def teardown(plane, server):
    await plane.close()
    if server is not None:
        await server.stop()


async def until(predicate, timeout: float = 10.0):
    """Poll ``predicate`` until it holds; fail after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise TimeoutError("condition never held")
        await asyncio.sleep(0.01)


def echo_engine(m, tag):
    class EchoEngine:
        async def generate(self, request):
            async def gen():
                for tok in request.data["tokens"]:
                    yield {"token": tok, "worker": tag}

            return m.engine.ResponseStream(gen(), request.ctx)

    return EchoEngine()


def endless_engine(m, stopped: asyncio.Event):
    """Emits until its context stops; sets ``stopped`` when it sees that."""

    class Endless:
        async def generate(self, request):
            ctx = request.ctx

            async def gen():
                i = 0
                try:
                    while not ctx.is_stopped:
                        yield {"i": i}
                        i += 1
                        await asyncio.sleep(0.005)
                finally:
                    stopped.set()

            return m.engine.ResponseStream(gen(), ctx)

    return Endless()


async def named_runtime(m, tag: str):
    name = f"torch-runtime-{tag}-{next(_names)}"
    return await m.runtime.DistributedRuntime.create(
        m.config.RuntimeConfig(control_plane=f"memory://{name}")
    )


# ---------------------------------------------------------------------------
# the control plane, both packages, memory and TCP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", PLANES)
@pytest.mark.parametrize("pkg", PKGS)
async def test_kv_put_get_prefix_delete_and_create(pkg, kind):
    plane, server = await make_plane(pkg, kind)
    try:
        rev1 = await plane.kv.put("a/b", b"1")
        rev2 = await plane.kv.put("a/c", b"2")
        seen = [
            rev2 > rev1,
            (await plane.kv.get("a/b")).value,
            await plane.kv.get("missing"),
            [e.key for e in await plane.kv.get_prefix("a/")],
            await plane.kv.delete("a/b"),
            await plane.kv.delete("a/b"),
            await plane.kv.delete_prefix("a/"),
            await plane.kv.create("x", b"first"),
            await plane.kv.create("x", b"second"),
            (await plane.kv.get("x")).value,
        ]
        assert seen == [True, b"1", None, ["a/b", "a/c"], True, False, 1, True, False,
                        b"first"]
    finally:
        await teardown(plane, server)


@pytest.mark.parametrize("kind", PLANES)
@pytest.mark.parametrize("pkg", PKGS)
async def test_prefix_watch_snapshot_sync_marker_then_live(pkg, kind):
    """The snapshot comes first and ``ready()`` resolves once it has been
    consumed (the sync marker); live puts and deletes follow in order."""
    m = pkg_modules(pkg)
    plane, server = await make_plane(pkg, kind)
    try:
        await plane.kv.put("w/a", b"1")
        await plane.kv.put("w/b", b"2")
        watch = plane.kv.watch_prefix("w/")
        events = []

        async def consume():
            async for ev in watch:
                events.append((ev.type, ev.entry.key))
                if len(events) == 5:
                    return

        task = asyncio.ensure_future(consume())
        await asyncio.wait_for(watch.ready(), 10)
        at_sync = list(events)
        await plane.kv.put("w/c", b"3")
        await plane.kv.delete("w/a")
        await plane.kv.put("other/x", b"-")
        await plane.kv.put("w/b", b"22")
        await asyncio.wait_for(task, 10)
        watch.cancel()
        put, delete = m.iface.WatchEventType.PUT, m.iface.WatchEventType.DELETE
        assert at_sync == [(put, "w/a"), (put, "w/b")]
        assert events == [(put, "w/a"), (put, "w/b"), (put, "w/c"), (delete, "w/a"),
                          (put, "w/b")]
    finally:
        await teardown(plane, server)


@pytest.mark.parametrize("kind", PLANES)
@pytest.mark.parametrize("pkg", PKGS)
async def test_lease_revoke_deletes_attached_keys_and_notifies(pkg, kind):
    m = pkg_modules(pkg)
    plane, server = await make_plane(pkg, kind)
    try:
        lease = await plane.kv.grant_lease(5.0)
        await plane.kv.put("inst/1", b"alive", lease_id=lease.id)
        await plane.kv.put("inst/2", b"kept")
        watch = plane.kv.watch_prefix("inst/")
        first = [await asyncio.wait_for(watch.__anext__(), 10) for _ in range(2)]
        await plane.kv.revoke_lease(lease)
        ev = await asyncio.wait_for(watch.__anext__(), 10)
        watch.cancel()
        assert [(e.type, e.entry.key) for e in first] == [
            (m.iface.WatchEventType.PUT, "inst/1"), (m.iface.WatchEventType.PUT, "inst/2")]
        assert (ev.type, ev.entry.key) == (m.iface.WatchEventType.DELETE, "inst/1")
        assert await plane.kv.get("inst/1") is None
        assert (await plane.kv.get("inst/2")).value == b"kept"
    finally:
        await teardown(plane, server)


@pytest.mark.parametrize("pkg", PKGS)
async def test_lease_ttl_expiry_without_keepalive(pkg):
    """A lease nobody keeps alive lapses: its keys go, with a delete event."""
    m = pkg_modules(pkg)
    plane = m.memory.MemoryControlPlane()
    lease = await plane.kv.grant_lease(0.3)
    await plane.kv.put("inst/2", b"alive", lease_id=lease.id)
    watch = plane.kv.watch_prefix("inst/")
    snap = await asyncio.wait_for(watch.__anext__(), 10)
    ev = await asyncio.wait_for(watch.__anext__(), 10)
    watch.cancel()
    assert (snap.type, ev.type, ev.entry.key) == (
        m.iface.WatchEventType.PUT, m.iface.WatchEventType.DELETE, "inst/2")
    assert await plane.kv.get("inst/2") is None
    assert lease.revoked


@pytest.mark.parametrize("kind", PLANES)
@pytest.mark.parametrize("pkg", PKGS)
async def test_bus_subscribe_queue_groups_and_request_reply(pkg, kind):
    plane, server = await make_plane(pkg, kind)
    try:
        nobody = await plane.bus.publish("nobody.home", b"x")
        plain = await plane.bus.subscribe("evt.>")
        g1 = await plane.bus.subscribe("work.q", queue_group="g")
        g2 = await plane.bus.subscribe("work.q", queue_group="g")
        delivered = await plane.bus.publish("evt.kv.stored", b"e1")
        msg = await asyncio.wait_for(plain.__anext__(), 10)
        for i in range(4):
            await plane.bus.publish("work.q", f"m{i}".encode())
        await until(lambda: g1.pending() + g2.pending() == 4)

        svc = await plane.bus.subscribe("svc.stats")

        async def responder():
            req = await svc.__anext__()
            await plane.bus.publish(req.reply_to, b"stats:" + req.payload)

        task = asyncio.ensure_future(responder())
        reply = await plane.bus.request("svc.stats", b"hello", timeout=10)
        await task
        seen = [nobody, delivered, msg.subject, msg.payload, g1.pending(), g2.pending(),
                reply]
        assert seen == [0, 1, "evt.kv.stored", b"e1", 2, 2, b"stats:hello"]
        for sub in (plain, g1, g2, svc):
            await sub.unsubscribe()
    finally:
        await teardown(plane, server)


@pytest.mark.parametrize("kind", PLANES)
@pytest.mark.parametrize("pkg", PKGS)
async def test_work_queue_and_object_store(pkg, kind):
    plane, server = await make_plane(pkg, kind)
    try:
        await plane.bus.queue_publish("prefill", b"req1")
        await plane.bus.queue_publish("prefill", b"req2")
        await plane.bus.object_put("mdc-artifacts", "sum/config.json", b"{}")
        seen = [
            await plane.bus.queue_len("prefill"),
            await plane.bus.queue_pop("prefill", timeout=5),
            await plane.bus.queue_pop("prefill", timeout=5),
            await plane.bus.queue_pop("prefill", timeout=0.05),
            await plane.bus.object_get("mdc-artifacts", "sum/config.json"),
            await plane.bus.object_get("mdc-artifacts", "sum/missing"),
        ]
        assert seen == [2, b"req1", b"req2", None, b"{}", None]
    finally:
        await teardown(plane, server)


@pytest.mark.parametrize("pkg", PKGS)
async def test_named_memory_planes_are_shared_and_reset(pkg):
    m = pkg_modules(pkg)
    name = f"shared-{next(_names)}"
    a = m.memory.MemoryControlPlane.named(name)
    b = m.memory.MemoryControlPlane.named(name)
    await a.kv.put("k", b"v")
    assert a is b and (await b.kv.get("k")).value == b"v"
    m.memory.MemoryControlPlane.reset_named()
    assert m.memory.MemoryControlPlane.named(name) is not a


# ---------------------------------------------------------------------------
# endpoints, the client and the TCP data plane, both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
async def test_round_robin_random_and_direct_routing(pkg):
    m = pkg_modules(pkg)
    rt = await named_runtime(m, "route")
    try:
        ep = rt.namespace("ns").component("backend").endpoint("generate")
        s1 = await ep.serve(echo_engine(m, "w1"), instance_id=111)
        s2 = await ep.serve(echo_engine(m, "w2"), instance_id=222)
        seen = {}
        for mode in (m.rclient.RouterMode.ROUND_ROBIN, m.rclient.RouterMode.RANDOM):
            router = await m.rclient.PushRouter.from_endpoint(ep, mode)
            await router.client.wait_for_instances(2, timeout=10)
            workers = []
            for i in range(12):
                out = await (await router.generate(m.engine.Context({"tokens": [i, i + 1]}))).collect()
                assert [o["token"] for o in out] == [i, i + 1]
                workers.append(out[0]["worker"])
            seen[mode.value] = workers
        direct = await m.rclient.PushRouter.from_endpoint(ep, m.rclient.RouterMode.DIRECT)
        await direct.client.wait_for_instances(2, timeout=10)
        picks = [
            (await (await direct.generate_direct(m.engine.Context({"tokens": [0]}), iid)).collect())[0]["worker"]
            for iid in (222, 111, 222)
        ]
        rr = seen["round_robin"]
        assert set(rr) == {"w1", "w2"} and all(a != b for a, b in zip(rr, rr[1:]))
        assert set(seen["random"]) <= {"w1", "w2"}
        assert picks == ["w2", "w1", "w2"]
        await s1.shutdown(drain_timeout=1)
        await s2.shutdown(drain_timeout=1)
    finally:
        await rt.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_cancellation_reaches_the_engine_across_the_data_plane(pkg):
    m = pkg_modules(pkg)
    rt = await named_runtime(m, "cancel")
    try:
        ep = rt.namespace("ns").component("backend").endpoint("generate")
        stopped = asyncio.Event()
        service = await ep.serve(endless_engine(m, stopped))
        router = await m.rclient.PushRouter.from_endpoint(ep)
        await router.client.wait_for_instances(1, timeout=10)
        req = m.engine.Context({"tokens": []})
        got = 0
        async for _ in await router.generate(req):
            got += 1
            if got == 3:
                req.ctx.stop_generating()
        await asyncio.wait_for(stopped.wait(), 10)
        await until(lambda: service._in_flight == 0)
        assert got >= 3
        await service.shutdown(drain_timeout=1)
    finally:
        await rt.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_dead_instance_lease_removes_it_from_the_client(pkg):
    m = pkg_modules(pkg)
    rt = await named_runtime(m, "dead")
    try:
        ep = rt.namespace("ns").component("backend").endpoint("generate")
        s1 = await ep.serve(echo_engine(m, "w1"))
        s2 = await ep.serve(echo_engine(m, "w2"))
        router = await m.rclient.PushRouter.from_endpoint(ep)
        await router.client.wait_for_instances(2, timeout=10)
        # the worker vanishes without a shutdown: its lease is revoked, as a
        # lapsed lease would be
        await s2._sub.unsubscribe()
        await rt.plane.kv.revoke_lease(s2._lease)
        await until(lambda: [i.instance_id for i in router.client.instances]
                    == [s1.instance.instance_id])
        for _ in range(3):
            out = await (await router.generate(m.engine.Context({"tokens": [5]}))).collect()
            assert out == [{"token": 5, "worker": "w1"}]
        await s1.shutdown(drain_timeout=1)
        await until(lambda: router.client.instances == [])
        with pytest.raises(RuntimeError, match="no instances"):
            await router.generate(m.engine.Context({"tokens": [1]}))
    finally:
        await rt.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_engine_error_and_stats_scrape(pkg):
    import json

    m = pkg_modules(pkg)
    rt = await named_runtime(m, "stats")
    try:

        class Failing:
            async def generate(self, request):
                raise ValueError("model exploded")

        ep = rt.namespace("ns").component("backend").endpoint("generate")
        bad = rt.namespace("ns").component("backend").endpoint("bad")
        service = await ep.serve(echo_engine(m, "w"), stats_handler=lambda: {"kv_usage": 0.5})
        failing = await bad.serve(Failing())
        router = await m.rclient.PushRouter.from_endpoint(ep)
        bad_router = await m.rclient.PushRouter.from_endpoint(bad)
        await router.client.wait_for_instances(1, timeout=10)
        await bad_router.client.wait_for_instances(1, timeout=10)
        out = await (await m.rclient.RemoteEngine(router).generate(
            m.engine.Context({"tokens": [7]}))).collect()
        with pytest.raises(RuntimeError, match="model exploded"):
            await (await bad_router.generate(m.engine.Context({"tokens": [1]}))).collect()
        raw = await rt.plane.bus.request(
            m.component.stats_subject(service.instance.subject), b"", timeout=10
        )
        stats = json.loads(raw)
        assert out == [{"token": 7, "worker": "w"}]
        assert (stats["handled_total"], stats["custom"]) == (1, {"kv_usage": 0.5})
        await service.shutdown(drain_timeout=1)
        await failing.shutdown(drain_timeout=1)
    finally:
        await rt.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_pipeline_segment_cut_over_the_bus(pkg):
    m = pkg_modules(pkg)

    class Doubler(m.engine.Operator):
        async def preprocess(self, request):
            return request.transfer({"tokens": [t * 2 for t in request.data["tokens"]]})

        async def postprocess(self, stream, request):
            return stream.map(lambda item: {**item, "doubled": True})

    class PlusOne(m.engine.Operator):
        async def preprocess(self, request):
            return request.transfer({"tokens": [t + 1 for t in request.data["tokens"]]})

        async def postprocess(self, stream, request):
            return stream

    local = m.pipeline.source().link(Doubler()).link(PlusOne()).link(echo_engine(m, "sink"))
    in_process = await (await local.generate(m.engine.Context({"tokens": [1, 2]}))).collect()
    with pytest.raises(ValueError, match="not terminated"):
        await m.pipeline.source().link(Doubler()).generate(m.engine.Context({"tokens": [1]}))
    rt = await named_runtime(m, "pipe")
    sink = None
    try:
        ep = rt.namespace("test").component("pipe").endpoint("gen")
        sink = m.pipeline.SegmentSink(
            ep, m.pipeline.source().link(PlusOne()).link(echo_engine(m, "remote")))
        await sink.start()
        remote = await m.pipeline.segment_source(ep)
        pipe = m.pipeline.source().link(Doubler()).link(remote)
        cut = await (await pipe.generate(m.engine.Context({"tokens": [1, 2]}))).collect()
    finally:
        if sink is not None:
            await sink.stop()
        await rt.close()
    assert [o["token"] for o in in_process] == [o["token"] for o in cut] == [3, 5]
    assert [o["worker"] for o in cut] == ["remote", "remote"]
    assert all(o["doubled"] for o in in_process + cut)


@pytest.mark.parametrize("pkg", PKGS)
async def test_barrier_rendezvous_and_timeout(pkg):
    m = pkg_modules(pkg)
    plane = m.memory.MemoryControlPlane()
    leader = m.barrier.LeaderBarrier(plane.kv, "b1", num_workers=3)
    workers = [m.barrier.WorkerBarrier(plane.kv, "b1", worker_id=str(i)) for i in range(3)]
    leader_task = asyncio.ensure_future(leader.sync({"coordinator": "10.0.0.1:8476"}, timeout=10))
    results = await asyncio.gather(*[w.sync(timeout=10) for w in workers])
    joined = await leader_task
    assert [r["coordinator"] for r in results] == ["10.0.0.1:8476"] * 3
    assert joined == ["0", "1", "2"]
    lonely = m.barrier.LeaderBarrier(plane.kv, "b3", num_workers=2)
    with pytest.raises(TimeoutError, match="0/2 workers"):
        await lonely.sync({}, timeout=0.3)


# ---------------------------------------------------------------------------
# wire compatibility across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("server_pkg,client_pkg", [("dynamo_tpu", "dynamo_tpu_torch"),
                                                   ("dynamo_tpu_torch", "dynamo_tpu")])
async def test_control_plane_client_and_server_interoperate(server_pkg, client_pkg):
    """A client of one package on the other's server: KV, watch, leases,
    bus, request/reply, work queue and object store."""
    s, c = pkg_modules(server_pkg), pkg_modules(client_pkg)
    server = s.server.ControlPlaneServer(port=0)
    await server.start()
    plane = c.client.RemoteControlPlane("127.0.0.1", server.port)
    await plane.connect()
    try:
        await plane.kv.put("x/a", b"1")
        watch = plane.kv.watch_prefix("x/")
        snap = await asyncio.wait_for(watch.__anext__(), 10)
        lease = await plane.kv.grant_lease(5.0)
        await plane.kv.put("x/b", b"2", lease_id=lease.id)
        live = await asyncio.wait_for(watch.__anext__(), 10)
        await plane.kv.revoke_lease(lease)
        gone = await asyncio.wait_for(watch.__anext__(), 10)
        watch.cancel()
        sub = await plane.bus.subscribe("evt.>")
        assert await plane.bus.publish("evt.one", b"p") == 1
        msg = await asyncio.wait_for(sub.__anext__(), 10)
        svc = await plane.bus.subscribe("svc")

        async def responder():
            req = await svc.__anext__()
            await plane.bus.publish(req.reply_to, req.payload[::-1])

        task = asyncio.ensure_future(responder())
        reply = await plane.bus.request("svc", b"abc", timeout=10)
        await task
        await plane.bus.queue_publish("q", b"job")
        await plane.bus.object_put("bkt", "k", b"obj")
        put, delete = c.iface.WatchEventType.PUT, c.iface.WatchEventType.DELETE
        assert (snap.type, snap.entry.key, snap.entry.value) == (put, "x/a", b"1")
        assert (live.type, live.entry.key) == (put, "x/b")
        assert (gone.type, gone.entry.key) == (delete, "x/b")
        assert (msg.subject, msg.payload, reply) == ("evt.one", b"p", b"cba")
        assert await plane.bus.queue_pop("q", timeout=5) == b"job"
        assert await plane.bus.object_get("bkt", "k") == b"obj"
        # the server's own view: the key and the queue live there
        assert (await server.state.kv.get("x/a")).value == b"1"
        for sub_ in (sub, svc):
            await sub_.unsubscribe()
    finally:
        await plane.close()
        await server.stop()


@pytest.mark.parametrize("worker_pkg,router_pkg", [("dynamo_tpu", "dynamo_tpu_torch"),
                                                   ("dynamo_tpu_torch", "dynamo_tpu")])
async def test_worker_and_router_of_other_packages_serve_over_tcp(worker_pkg, router_pkg):
    """One package's endpoint behind the other's router, over a TCP control
    plane: the request envelope crosses the bus and the response stream
    the data plane, both ways; a stop from the caller reaches the worker."""
    w, r = pkg_modules(worker_pkg), pkg_modules(router_pkg)
    server = w.server.ControlPlaneServer(port=0)
    await server.start()
    address = f"127.0.0.1:{server.port}"
    w_rt = await w.runtime.DistributedRuntime.create(w.config.RuntimeConfig(control_plane=address))
    r_rt = await r.runtime.DistributedRuntime.create(r.config.RuntimeConfig(control_plane=address))
    try:
        ep = w_rt.namespace("x").component("backend").endpoint("generate")
        service = await ep.serve(echo_engine(w, "remote"), stats_handler=lambda: {"k": 1})
        stopped = asyncio.Event()
        slow = await w_rt.namespace("x").component("backend").endpoint("slow").serve(
            endless_engine(w, stopped))
        router = await r.rclient.PushRouter.from_endpoint(
            r_rt.namespace("x").component("backend").endpoint("generate"))
        slow_router = await r.rclient.PushRouter.from_endpoint(
            r_rt.namespace("x").component("backend").endpoint("slow"))
        await router.client.wait_for_instances(1, timeout=10)
        await slow_router.client.wait_for_instances(1, timeout=10)
        out = await (await router.generate(r.engine.Context({"tokens": [4, 5, 6]}))).collect()
        req = r.engine.Context({"tokens": []})
        got = 0
        async for _ in await slow_router.generate(req):
            got += 1
            if got == 2:
                req.ctx.stop_generating()
        await asyncio.wait_for(stopped.wait(), 10)
        assert out == [{"token": t, "worker": "remote"} for t in (4, 5, 6)]
        assert [i.instance_id for i in router.client.instances] == [service.instance.instance_id]
        await service.shutdown(drain_timeout=1)
        await slow.shutdown(drain_timeout=1)
    finally:
        await r_rt.close()
        await w_rt.close()
        await server.stop()


@pytest.mark.parametrize("writer_pkg,reader_pkg", [("dynamo_tpu", "dynamo_tpu_torch"),
                                                   ("dynamo_tpu_torch", "dynamo_tpu")])
async def test_data_plane_frames_decode_with_the_other_codec(writer_pkg, reader_pkg):
    """Two-part frames (with a trace context in the header) written by one
    package's codec read back with the other's, byte for byte."""
    w, r = pkg_modules(writer_pkg), pkg_modules(reader_pkg)
    trace = importlib.import_module(f"{writer_pkg}.observability.trace")
    ctx = trace.TraceContext(trace_id=trace.new_trace_id(), span_id=trace.new_span_id())
    frames = [
        w.codec.TwoPartMessage(header=w.codec.attach_trace({"t": "prologue", "id": "s1"}, ctx)),
        w.codec.TwoPartMessage(header={"t": "data"}, payload=b"\x00\x01payload"),
        w.codec.TwoPartMessage(header={"t": "complete"}),
    ]
    wire = b"".join(w.codec.encode_frame(f) for f in frames)
    reader = asyncio.StreamReader()
    reader.feed_data(wire)
    reader.feed_eof()
    dataplane = importlib.import_module(f"{reader_pkg}.runtime.dataplane")
    got = [f async for f in dataplane.iter_frames(reader)]
    assert [(f.header, f.payload) for f in got] == [(f.header, f.payload) for f in frames]
    read_back = r.codec.extract_trace(got[0].header)
    assert (read_back.trace_id, read_back.span_id) == (ctx.trace_id, ctx.span_id)
    assert r.codec.encode_frame(r.codec.TwoPartMessage(got[1].header, got[1].payload)) \
        == w.codec.encode_frame(frames[1])
