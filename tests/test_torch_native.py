"""The port's native host codecs against the Python twins and the
reference's native ones: two-part frames split from byte streams cut at
random offsets, radix-index scores after random event streams, the
``DYN_DISABLE_NATIVE`` gate, the data plane's route by decoder, and two
processes building the same library at once.

Everything is seeded from numpy; the libraries build with ``g++`` into the
port's own ``_build/`` (the reference's into its ``csrc/build/``)."""

import asyncio
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.llm.kv_router import protocols as ref_protocols
from dynamo_tpu.native import dataplane as ref_dataplane
from dynamo_tpu.native import radix as ref_radix
from dynamo_tpu_torch import native
from dynamo_tpu_torch.llm.kv_router import protocols
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, RadixTree
from dynamo_tpu_torch.native.dataplane import NativeFrameDecoder
from dynamo_tpu_torch.native.radix import NativeRadixTree
from dynamo_tpu_torch.runtime import dataplane
from dynamo_tpu_torch.runtime.codec import TwoPartMessage, encode_frame, read_two_part

ROOT = Path(__file__).resolve().parent.parent


def test_this_host_builds_the_native_libraries():
    assert shutil.which("g++") is not None
    for name in ("dataplane", "radix_index"):
        assert native.load_native(name) is not None
        path = native.library_path(name)
        assert path.parent == ROOT / "dynamo_tpu_torch" / "_build"
        assert path.exists()
    assert native.stats()["libraries"] == {"dataplane": True, "radix_index": True}
    # the sources are the reference's, byte for byte
    for name in ("dataplane.cpp", "radix_index.cpp"):
        assert (ROOT / "dynamo_tpu_torch" / "csrc" / name).read_bytes() == \
            (ROOT / "csrc" / name).read_bytes()


# -- frames ---------------------------------------------------------------------


def random_frames(rng: np.random.Generator, n: int) -> list[TwoPartMessage]:
    frames = []
    for i in range(n):
        header = {"t": str(rng.choice(["data", "complete", "stop", "prologue"])), "i": i}
        if rng.random() < 0.3:
            header["stream_id"] = "s" * int(rng.integers(1, 40))
        size = int(rng.choice([0, 1, int(rng.integers(2, 300)), int(rng.integers(300, 70_000))]))
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        frames.append(TwoPartMessage(header=header, payload=payload))
    return frames


def cut(rng: np.random.Generator, stream: bytes) -> list[bytes]:
    offsets = sorted(set(rng.integers(0, len(stream), int(rng.integers(1, 40))).tolist()))
    bounds = [0, *offsets, len(stream)]
    return [stream[a:b] for a, b in zip(bounds, bounds[1:]) if b > a]


def decode_all(decoder, chunks: list[bytes]) -> list[tuple]:
    out = []
    for chunk in chunks:
        decoder.feed(chunk)
        out.extend(decoder.drain())
    assert decoder.pending == 0
    return [(m.header, m.payload) for m in out]


async def decode_python(chunks: list[bytes]) -> list[tuple]:
    reader = asyncio.StreamReader()
    for chunk in chunks:
        reader.feed_data(chunk)
    reader.feed_eof()
    out = []
    while (frame := await read_two_part(reader)) is not None:
        out.append((frame.header, frame.payload))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_frames_equal_the_python_codec_and_the_reference(seed):
    rng = np.random.default_rng(seed)
    frames = random_frames(rng, int(rng.integers(1, 60)))
    stream = b"".join(encode_frame(f) for f in frames)
    chunks = cut(rng, stream)
    want = [(f.header, f.payload) for f in frames]
    assert decode_all(NativeFrameDecoder(), chunks) == want
    assert decode_all(ref_dataplane.NativeFrameDecoder(), chunks) == want
    assert asyncio.run(decode_python(chunks)) == want


def test_frame_by_frame_and_partial_frames():
    rng = np.random.default_rng(11)
    frames = random_frames(rng, 5)
    stream = b"".join(encode_frame(f) for f in frames)
    ours, ref = NativeFrameDecoder(), ref_dataplane.NativeFrameDecoder()
    got = []
    for i in range(len(stream)):  # one byte at a time: next() sees every partial state
        ours.feed(stream[i:i + 1])
        ref.feed(stream[i:i + 1])
        a, b = ours.next(), ref.next()
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.header, a.payload) == (b.header, b.payload)
            got.append(a)
    assert [(m.header, m.payload) for m in got] == [(f.header, f.payload) for f in frames]
    assert ours.next() is None and ours.pending == 0


def test_oversized_frame_is_refused_as_the_reference_refuses_it():
    bad = (2 ** 31).to_bytes(4, "big") + (0).to_bytes(4, "big")
    for decoder in (NativeFrameDecoder(), ref_dataplane.NativeFrameDecoder()):
        with pytest.raises(ValueError, match="oversized"):
            decoder.feed(bad)
            decoder.drain()


@pytest.mark.parametrize("disabled", [False, True])
def test_iter_frames_takes_the_native_decoder_unless_disabled(monkeypatch, disabled):
    if disabled:
        monkeypatch.setenv("DYN_DISABLE_NATIVE", "1")
    rng = np.random.default_rng(3)
    frames = random_frames(rng, 30)
    chunks = cut(rng, b"".join(encode_frame(f) for f in frames))
    before = dict(native.counters)

    async def run():
        reader = asyncio.StreamReader()
        for chunk in chunks:
            reader.feed_data(chunk)
        reader.feed_eof()
        return [(m.header, m.payload) async for m in dataplane.iter_frames(reader)]

    assert asyncio.run(run()) == [(f.header, f.payload) for f in frames]
    route = "python" if disabled else "native"
    other = "native" if disabled else "python"
    assert native.counters[f"{route}_streams"] - before[f"{route}_streams"] == 1
    assert native.counters[f"{route}_frames"] - before[f"{route}_frames"] == 30
    assert native.counters[f"{other}_streams"] == before[f"{other}_streams"]


# -- radix index ----------------------------------------------------------------

WORKERS = (1, 2, 3, 2 ** 40 + 7)


def random_events(rng: np.random.Generator, n: int):
    """Stored chains (from the root and continued from a known parent),
    removals of known hashes, clears and worker deaths."""
    known: list[int] = []
    events = []
    for _ in range(n):
        r = rng.random()
        worker = int(rng.choice(WORKERS))
        if r < 0.55 or not known:
            parent = int(rng.choice(known)) if known and rng.random() < 0.5 else None
            chain = [int(h) for h in rng.integers(1, 2 ** 63, int(rng.integers(1, 8)),
                                                   dtype=np.uint64)]
            if known and rng.random() < 0.3:  # re-store a known hash (another worker)
                chain[0] = int(rng.choice(known))
            known.extend(chain)
            events.append(("stored", worker, chain, parent))
        elif r < 0.85:
            picks = rng.choice(known, int(rng.integers(1, 4)))
            events.append(("removed", worker, [int(h) for h in picks], None))
        elif r < 0.93:
            events.append(("cleared", worker, [], None))
        else:
            events.append(("remove_worker", worker, [], None))
    return events, known


def apply(tree, proto, event) -> None:
    kind, worker, hashes, parent = event
    if kind == "remove_worker":
        tree.remove_worker(worker)
        return
    tree.apply(proto.RouterEvent(worker_id=worker, event=proto.KvCacheEvent(
        kind=kind, block_hashes=list(hashes), parent_hash=parent)))


def queries(rng: np.random.Generator, known: list[int]) -> list[list[int]]:
    qs = [[], [1]]
    for _ in range(6):
        if known:
            start = int(rng.integers(0, len(known)))
            qs.append(known[start:start + int(rng.integers(1, 10))])
    return qs


def check_equal(trees: list, qs) -> None:
    ours, py, ref = trees
    for q in qs:
        a, b, c = ours.find_matches(q), py.find_matches(q), ref.find_matches(q)
        assert (a.scores, a.total_blocks) == (b.scores, b.total_blocks) == \
            (c.scores, c.total_blocks), q
    assert ours.size() == py.size() == ref.size()
    for w in WORKERS:
        assert ours.worker_block_count(w) == py.worker_block_count(w) == \
            ref.worker_block_count(w)


@pytest.mark.parametrize("seed", range(4))
def test_radix_scores_equal_after_every_event(seed):
    rng = np.random.default_rng(100 + seed)
    events, known = random_events(rng, 120)
    trees = [NativeRadixTree(), RadixTree(), ref_radix.NativeRadixTree()]
    qs = queries(rng, known)
    for event in events:
        for tree, proto in zip(trees, (protocols, protocols, ref_protocols)):
            apply(tree, proto, event)
        check_equal(trees, qs)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 32 - 1), st.integers(1, 60))
def test_radix_property_native_equals_python(seed, n):
    rng = np.random.default_rng(seed)
    events, known = random_events(rng, n)
    trees = [NativeRadixTree(), RadixTree(), ref_radix.NativeRadixTree()]
    for event in events:
        for tree, proto in zip(trees, (protocols, protocols, ref_protocols)):
            apply(tree, proto, event)
    check_equal(trees, queries(rng, known))


def test_indexer_native_argument(monkeypatch):
    """None tries native, True insists on it, False runs Python; under
    DYN_DISABLE_NATIVE=1, True raises and None falls back."""
    assert isinstance(KvIndexer().tree, NativeRadixTree)
    assert isinstance(KvIndexer(native=True).tree, NativeRadixTree)
    assert isinstance(KvIndexer(native=False).tree, RadixTree)
    monkeypatch.setenv("DYN_DISABLE_NATIVE", "1")
    assert native.load_native("radix_index") is None
    with pytest.raises(RuntimeError, match="native radix index unavailable"):
        KvIndexer(native=True)
    assert isinstance(KvIndexer().tree, RadixTree)


# -- concurrent builds ----------------------------------------------------------

BUILDER = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    from dynamo_tpu_torch import native
    from dynamo_tpu_torch.native.dataplane import NativeFrameDecoder
    from dynamo_tpu_torch.runtime.codec import TwoPartMessage, encode_frame
    native.BUILD = Path(sys.argv[1])
    go = Path(sys.argv[2])
    while not go.exists():
        time.sleep(0.005)
    assert native.load_native("dataplane") is not None
    d = NativeFrameDecoder()
    d.feed(encode_frame(TwoPartMessage(header={"t": "data"}, payload=b"xyz")))
    (m,) = d.drain()
    assert (m.header, m.payload) == ({"t": "data"}, b"xyz")
    print(native.library_path("dataplane").name)
""")


def test_two_processes_building_at_once_both_load_a_whole_library(tmp_path):
    build, go = tmp_path / "build", tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER, str(build), str(go)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    go.touch()
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    names = {out.strip().splitlines()[-1] for out, _ in outs}
    assert len(names) == 1
    assert [p.name for p in build.iterdir()] == list(names)  # no temp dir left behind
    # the reference's build directory is not the port's
    assert not any(p.name.startswith(tuple(names)) for p in (ROOT / "csrc").glob("build/*"))


def test_msgpack_header_roundtrip_matches_the_python_codec():
    header = {"t": "data", "nested": {"a": [1, 2, 3]}, "u": "ünï"}
    frame = encode_frame(TwoPartMessage(header=header, payload=b"\x00" * 5))
    d = NativeFrameDecoder()
    d.feed(frame)
    (m,) = d.drain()
    assert m.header == msgpack.unpackb(msgpack.packb(header, use_bin_type=True), raw=False)
