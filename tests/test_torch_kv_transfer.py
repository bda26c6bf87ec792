"""The port's KV transfer plane (dynamo_tpu_torch/parallel/kv_transfer.py)
over real TCP, and against the reference's (dynamo_tpu/parallel/
kv_transfer.py) on the same wire:
- payload framing: concurrent sends intact, multi-part and layer-wise
  fields through the codec, ``split_layerwise`` / ``assemble_layers``;
- the wire both ways between the stacks: a port client to a JAX server
  and a JAX client to a port server, with float32, bfloat16, float8 e4m3fn
  and e5m2 leaves, bit for bit;
- probe payloads acked and never delivered (both servers), a refused ack
  not retried, a dropped pooled connection re-dialed once, the bandwidth
  EWMA, a dial that times out, the same-process short cut;
- ``StagedBlocks``: a send waits for its staging's event first."""

import asyncio
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.parallel import kv_transfer as jax_xfer
from dynamo_tpu_torch.parallel import kv_transfer as xfer
from dynamo_tpu_torch.parallel.kv_transfer import (
    PROBE_SEQ_PREFIX,
    KvTransferClient,
    KvTransferPayload,
    KvTransferServer,
    StagedBlocks,
    assemble_layers,
    split_layerwise,
)
from dynamo_tpu_torch.runtime.codec import TwoPartMessage, encode_frame, read_two_part

# torch dtype -> the numpy dtype the reference stages it as
WIRE_DTYPES = {
    torch.float32: np.dtype(np.float32),
    torch.bfloat16: np.dtype(ml_dtypes.bfloat16),
    torch.float8_e4m3fn: np.dtype(ml_dtypes.float8_e4m3fn),
    torch.float8_e5m2: np.dtype(ml_dtypes.float8_e5m2),
}


def payload(i: int) -> KvTransferPayload:
    g = torch.Generator().manual_seed(i)
    return KvTransferPayload(
        seq_id=f"seq-{i}",
        first_token=100 + i,
        block_ids=[i, i + 1],
        # a non-contiguous slice: staging must normalize the layout
        blocks={
            "k": torch.randn((2, 2, 4, 2, 8), generator=g)[:, :, ::2],
            "v": torch.randn((2, 2, 2, 2, 8), generator=g),
        },
        first_token_logprob=-0.5 * i,
    )


def leaves(seed: int) -> dict[str, torch.Tensor]:
    """One leaf of each wire dtype (an MLA-like pair of widths)."""
    g = torch.Generator().manual_seed(seed)
    return {
        name: (torch.randn((2, 3, 4, 8 if i % 2 else 6), generator=g) * 4).to(dtype)
        for i, (name, dtype) in enumerate(zip(("f32", "bf16", "e4m3", "e5m2"), WIRE_DTYPES))
    }


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A torch leaf as the reference holds it (ml_dtypes for bf16 / fp8)."""
    raw = t.contiguous().view(torch.uint8).numpy()
    return raw.view(WIRE_DTYPES[t.dtype]).reshape(t.shape)


def same_bits(a: torch.Tensor, b) -> bool:
    a_raw = a.contiguous().view(torch.uint8).numpy().tobytes()
    b_raw = np.ascontiguousarray(b).tobytes() if isinstance(b, np.ndarray) else (
        b.contiguous().view(torch.uint8).numpy().tobytes())
    return a_raw == b_raw


async def tcp_server(mod, sink):
    """A started server of ``mod`` reachable only over TCP."""
    server = mod.KvTransferServer(sink)
    await server.start()
    mod.LOCAL_SERVERS.pop(server.address, None)
    return server


async def test_concurrent_sends_over_tcp_arrive_intact():
    received: dict[str, KvTransferPayload] = {}

    async def sink(p: KvTransferPayload) -> None:
        await asyncio.sleep(0.01)  # a slow consumer: only write→ack serializes
        received[p.seq_id] = p

    server = await tcp_server(xfer, sink)
    client = KvTransferClient()
    try:
        sent = [payload(i) for i in range(6)]
        await asyncio.gather(*[client.send(server.address, p) for p in sent])
        assert set(received) == {p.seq_id for p in sent}
        for p in sent:
            got = received[p.seq_id]
            assert (got.first_token, got.block_ids, got.first_token_logprob) == (
                p.first_token, p.block_ids, p.first_token_logprob)
            for name, t in p.blocks.items():
                assert torch.equal(got.blocks[name], t.contiguous())
    finally:
        await client.close()
        await server.stop()


async def test_multipart_fields_roundtrip_over_tcp():
    received: list[KvTransferPayload] = []

    async def sink(p):
        received.append(p)

    server = await tcp_server(xfer, sink)
    client = KvTransferClient()
    try:
        for idx, last in ((0, False), (1, False), (2, True)):
            await client.send(server.address, KvTransferPayload(
                seq_id="stream-1", first_token=42 if last else -1,
                block_ids=[idx * 2, idx * 2 + 1], blocks={"k": torch.randn((2, 2, 4))},
                part_index=idx, last=last, block_start=idx * 2,
            ))
        assert [p.part_index for p in received] == [0, 1, 2]
        assert [p.last for p in received] == [False, False, True]
        assert [p.block_start for p in received] == [0, 2, 4]
        assert [p.first_token for p in received] == [-1, -1, 42]
    finally:
        await client.close()
        await server.stop()


def test_split_layerwise_roundtrips_through_assemble():
    p = payload(3)
    n_layers = min(a.shape[0] for a in p.blocks.values())
    parts = split_layerwise(p, 1)
    assert [q.layer_start for q in parts] == list(range(n_layers))
    assert all(q.layer_count == 1 for q in parts)
    assert [q.first_token for q in parts] == [-1] * (n_layers - 1) + [p.first_token]
    assert [q.last for q in parts] == [False] * (n_layers - 1) + [True]
    assert [q.part_index for q in parts] == list(range(n_layers))
    got = assemble_layers([parts[-1], parts[0], parts[0]] + parts[1:])
    assert (got.first_token, got.block_ids, got.first_token_logprob) == (
        p.first_token, p.block_ids, p.first_token_logprob)
    for name, t in p.blocks.items():
        assert torch.equal(got.blocks[name], t)
    # the reference's split of the same arrays: the same parts
    ref = jax_xfer.KvTransferPayload(
        seq_id=p.seq_id, first_token=p.first_token, block_ids=p.block_ids,
        blocks={n: t.numpy() for n, t in p.blocks.items()},
        first_token_logprob=p.first_token_logprob)
    for ours, theirs in zip(parts, jax_xfer.split_layerwise(ref, 1)):
        assert (ours.layer_start, ours.layer_count, ours.part_index, ours.last) == (
            theirs.layer_start, theirs.layer_count, theirs.part_index, theirs.last)


def test_split_layerwise_degenerate_cases_pass_through():
    p = payload(4)
    assert split_layerwise(p, 0) == [p]
    assert split_layerwise(p, 99)[0] is p
    assert assemble_layers([p]) is p


async def test_layerwise_parts_roundtrip_over_tcp():
    received: list[KvTransferPayload] = []

    async def sink(p):
        received.append(p)

    server = await tcp_server(xfer, sink)
    client = KvTransferClient()
    try:
        original = payload(5)
        for part in split_layerwise(original, 1):
            await client.send(server.address, part)
        assert [p.layer_start for p in received] == [0, 1]
        got = assemble_layers(received)
        for name, t in original.blocks.items():
            assert torch.equal(got.blocks[name], t.contiguous())
        received.clear()
        await client.send(server.address, payload(6))
        assert (received[0].layer_start, received[0].layer_count) == (0, -1)
    finally:
        await client.close()
        await server.stop()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
async def test_wire_interoperates_with_the_reference(direction):
    """Float32, bfloat16 and both fp8 leaves, bit for bit, with every
    header field, between the two stacks in both directions."""
    blocks = leaves(7)
    received: list = []

    async def sink(p):
        received.append(p)

    fields = dict(seq_id="x-1", first_token=17, block_ids=[4, 5, 6],
                  first_token_logprob=-1.25, first_token_top_logprobs=[[17, -1.25], [3, -2.0]],
                  part_index=2, last=False, block_start=4, layer_start=0, layer_count=2)
    if direction == "port_to_jax":
        server = await tcp_server(jax_xfer, sink)
        client = KvTransferClient()
        sent = KvTransferPayload(blocks=blocks, **fields)
    else:
        server = await tcp_server(xfer, sink)
        client = jax_xfer.KvTransferClient()
        sent = jax_xfer.KvTransferPayload(
            blocks={n: to_numpy(t) for n, t in blocks.items()}, **fields)
    try:
        await client.send(server.address, sent)
        (got,) = received
        for name, value in fields.items():
            assert getattr(got, name) == value, name
        assert sorted(got.blocks) == sorted(blocks)
        for name, t in blocks.items():
            if direction == "port_to_jax":
                assert got.blocks[name].dtype == WIRE_DTYPES[t.dtype]
            else:
                assert got.blocks[name].dtype == t.dtype
            assert tuple(got.blocks[name].shape) == tuple(t.shape)
            assert same_bits(t, got.blocks[name]), name
    finally:
        await client.close()
        await server.stop()


@pytest.mark.parametrize("mod", [xfer, jax_xfer], ids=["port_server", "jax_server"])
async def test_probe_payloads_are_acked_and_never_delivered(mod):
    received: list = []

    async def sink(p):
        received.append(p)

    server = await tcp_server(mod, sink)
    client = KvTransferClient()
    try:
        probe = KvTransferPayload(seq_id=f"{PROBE_SEQ_PREFIX}abc", first_token=-1,
                                  block_ids=[], blocks={"probe": torch.zeros(4096, dtype=torch.uint8)})
        await client.send(server.address, probe)  # acked: no error
        assert received == []
        assert client.bandwidth_bps[server.address] > 0
        # the local short cut drops a probe too
        mod.LOCAL_SERVERS[server.address] = server
        await server.deliver_local(probe)
        assert received == []
    finally:
        await client.close()
        await server.stop()


async def test_send_redials_after_peer_drops_first_connection():
    received: list[KvTransferPayload] = []

    async def sink(p):
        received.append(p)

    inner = KvTransferServer(sink)  # only its protocol loop is used
    state = {"dropped": 0}

    async def handler(reader, writer):
        if state["dropped"] == 0:
            state["dropped"] += 1
            writer.close()
            return
        await inner._handle(reader, writer)

    server = await asyncio.start_server(handler, "127.0.0.1", 0)
    address = f"127.0.0.1:{server.sockets[0].getsockname()[1]}"
    client = KvTransferClient()
    try:
        await client.send(address, payload(1))
        assert state["dropped"] == 1 and client.evictions_total == 1
        assert [p.seq_id for p in received] == ["seq-1"]
        await client.send(address, payload(2))
        assert client.evictions_total == 1 and len(received) == 2
    finally:
        await client.close()
        server.close()
        await server.wait_closed()


async def test_refused_ack_is_not_retried():
    """A server that SAW the frame and refused it gets no re-send."""
    conns = {"n": 0}
    refused = asyncio.Event()

    async def handler(reader, writer):
        conns["n"] += 1
        await read_two_part(reader)
        writer.write(encode_frame(TwoPartMessage(header={"ok": False})))
        await writer.drain()
        refused.set()
        # a handler that returns with its transport open keeps the
        # server's wait_closed() waiting
        writer.close()

    server = await asyncio.start_server(handler, "127.0.0.1", 0)
    address = f"127.0.0.1:{server.sockets[0].getsockname()[1]}"
    client = KvTransferClient()
    try:
        with pytest.raises(ConnectionError, match="failed"):
            await client.send(address, payload(3))
        await asyncio.wait_for(refused.wait(), 10)
        assert conns["n"] == 1
        assert client.evictions_total == 0
    finally:
        await client.close()
        server.close()
        await server.wait_closed()


async def test_bandwidth_ewma():
    client = KvTransferClient(ewma_alpha=0.25)
    client._observe("w:1", 100, 1.0)
    assert client.bandwidth_bps["w:1"] == 100.0
    client._observe("w:1", 200, 1.0)
    assert client.bandwidth_bps["w:1"] == pytest.approx(125.0)
    client._observe("w:1", 0, 1.0)
    client._observe("w:1", 100, 0.0)
    assert client.bandwidth_bps["w:1"] == pytest.approx(125.0)

    async def sink(p):
        pass

    server = await tcp_server(xfer, sink)
    try:
        await client.send(server.address, payload(0))
        assert client.bandwidth_bps[server.address] > 0
    finally:
        await client.close()
        await server.stop()


async def test_dial_timeout_bounds_a_blackholed_peer(monkeypatch):
    monkeypatch.setenv("DYN_KV_DIAL_TIMEOUT_S", "0.2")

    async def blackhole(host, port):
        await asyncio.sleep(3600)

    monkeypatch.setattr(asyncio, "open_connection", blackhole)
    client = KvTransferClient()
    try:
        t0 = time.monotonic()
        with pytest.raises(ConnectionError, match="timed out after 0.2s"):
            await client.send("10.255.255.1:9", payload(0))
        assert time.monotonic() - t0 < 1.5
    finally:
        await client.close()


async def test_local_shortcut_skips_codec():
    received: list[KvTransferPayload] = []

    async def sink(p):
        received.append(p)

    server = KvTransferServer(sink)
    await server.start()
    client = KvTransferClient()
    try:
        p = payload(0)
        await client.send(server.address, p)
        assert received and received[0] is p  # the very object, no codec
    finally:
        await client.close()
        await server.stop()


async def test_staged_blocks_wait_for_their_event():
    """The send's staging waits for a StagedBlocks' event before it reads
    the bytes (off the event loop), and the wire carries the blocks."""
    waited = []

    class Event:
        def synchronize(self):
            waited.append(True)

    received: list = []

    async def sink(p):
        received.append(p)

    server = await tcp_server(xfer, sink)
    client = KvTransferClient()
    staged = StagedBlocks(k=torch.arange(24, dtype=torch.float32).reshape(2, 3, 4))
    staged.ready = Event()
    try:
        await client.send(server.address, KvTransferPayload(
            seq_id="s", first_token=1, block_ids=[0, 1, 2], blocks=staged))
        assert waited == [True]
        assert torch.equal(received[0].blocks["k"], staged["k"])
        assert xfer.payload_nbytes(staged) == 96
    finally:
        await client.close()
        await server.stop()
