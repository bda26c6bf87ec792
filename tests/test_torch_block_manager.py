"""The port's KV block manager (dynamo_tpu_torch.llm.block_manager) against
the JAX package's, on the CPU: the scenarios of
tests/llm/test_block_manager.py run as one operation sequence on each
manager (the port's G1 DeviceStorage on the CPU device, through the block
copy wrappers' plain versions), with data from one numpy seed.  The two
must agree on block ids, ``stats()`` and read-back bytes, exactly."""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

import dynamo_tpu.llm.block_manager as jax_kvbm
import dynamo_tpu_torch.llm.block_manager as kvbm
from dynamo_tpu.llm.block_manager import remote as jax_remote
from dynamo_tpu_torch.llm.block_manager import remote
from dynamo_tpu_torch.ops.kernels import block_copy

SHAPE = (2, 2, 4, 2, 8)  # layers, kv, block, heads, dim
GEOM = dict(num_layers=2, block_size=4, kv_heads=2, head_dim=8)


@dataclasses.dataclass
class Side:
    """One package's KVBM with how data goes in and comes out."""

    mod: object
    remote: object
    dtype: object
    extra: dict

    def config(self, **kw):
        return self.mod.KvbmConfig(**GEOM, dtype=self.dtype, **kw, **self.extra)

    def data(self, arr: np.ndarray):
        return arr if self.mod is jax_kvbm else torch.from_numpy(arr)

    def host_storage(self, n):
        return self.mod.HostStorage(n, SHAPE, self.dtype)


JAX = Side(jax_kvbm, jax_remote, np.float32, {})
PORT = Side(kvbm, remote, torch.float32, {"device": "cpu"})


def as_np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def randn(seed, n):
    return np.random.default_rng(seed).standard_normal((n, *SHAPE)).astype(np.float32)


def run_both(scenario, *args):
    """The scenario's record on each side; they must be equal."""
    records = []
    for side in (JAX, PORT):
        out = scenario(side, *args)
        if asyncio.iscoroutine(out):
            out = asyncio.run(out)
        records.append(out)
    ref, ours = records
    assert_equal_records(ours, ref)
    return ours


def assert_equal_records(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        if isinstance(b, (np.ndarray, torch.Tensor)) or isinstance(a, (np.ndarray, torch.Tensor)):
            np.testing.assert_array_equal(as_np(a), as_np(b))
        else:
            assert a == b


async def settle(pool, hashes, rounds=300):
    for _ in range(rounds):
        if all(pool.has_hash(h) for h in hashes):
            return
        await asyncio.sleep(0.02)
    raise AssertionError("background offload did not land")


# ---------------------------------------------------------------------------
# pool logic (Null storage)
# ---------------------------------------------------------------------------


def pool_of(side, n=8):
    return side.mod.BlockPool(side.mod.NullStorage(n, SHAPE, side.dtype))


def lifecycle(side):
    pool = pool_of(side)
    bid = pool.allocate()
    rec = [bid, pool.blocks[bid].state.value]
    pool.complete(bid, 4)
    rec.append(pool.blocks[bid].state.value)
    pool.register(bid, seq_hash=111)
    rec += [pool.blocks[bid].state.value, pool.has_hash(111)]
    pool.release(bid)
    rec += [pool.inactive_count, pool.match_hash(111), pool.inactive_count, pool.reuse_hits]
    return rec


def dedupe(side):
    pool = pool_of(side)
    a = pool.allocate()
    pool.complete(a, 4)
    pool.register(a, 42)
    b = pool.allocate()
    pool.complete(b, 4)
    pool.register(b, 42)  # duplicate hash: stays COMPLETE
    return [a, b, pool.blocks[b].state.value, pool.match_hash(42)]


def lru(side):
    pool = pool_of(side, 2)
    ids = []
    for h in (1, 2):
        bid = pool.allocate()
        pool.complete(bid, 4)
        pool.register(bid, h)
        pool.release(bid)
        ids.append(bid)
    pool.match_hash(1)  # touch 1: 2 becomes LRU
    pool.release(ids[0])
    c = pool.allocate()
    return [*ids, c, pool.has_hash(1), pool.has_hash(2), pool.evictions]


def active_never_evicted(side):
    pool = pool_of(side, 2)
    a = pool.allocate()
    b = pool.allocate()
    rec = [a, b, pool.allocate()]
    pool.release(a)
    return rec + [pool.allocate()]


@pytest.mark.parametrize("scenario", [lifecycle, dedupe, lru, active_never_evicted],
                         ids=lambda f: f.__name__)
def test_pool_logic_matches_reference(scenario):
    rec = run_both(scenario)
    assert None not in rec[:2]


# ---------------------------------------------------------------------------
# tiers
# ---------------------------------------------------------------------------


async def g1_g2_roundtrip(side, tmp_path):
    mgr = side.mod.KvBlockManager(side.config(host_blocks=8, device_blocks=4))
    mgr.start()
    try:
        hashes = [101, 102, 103]
        data = randn(0, 3)
        ids = mgr.store_sequence(hashes, side.data(data))
        await settle(mgr.pools[side.mod.Tier.G2_HOST], hashes)
        mgr.release_sequence(ids)
        for h in hashes:
            mgr.primary.drop_hash(h)
        hit, tier = await mgr.match_and_onboard(hashes)
        got = mgr.primary.read(hit)
        np.testing.assert_array_equal(as_np(got), data)
        return [ids, hit, tier.value, got, mgr.stats()]
    finally:
        await mgr.stop()


async def three_tier_spill(side, tmp_path):
    mgr = side.mod.KvBlockManager(side.config(
        device_blocks=2, host_blocks=4, disk_blocks=8, disk_path=str(tmp_path / "kv.bin")))
    mgr.start()
    try:
        tier = side.mod.Tier
        data = randn(1, 1)
        ids = mgr.store_sequence([7], side.data(data))
        await settle(mgr.pools[tier.G2_HOST], [7])
        bid = mgr.pools[tier.G2_HOST].match_hash(7)
        mgr.offload.request_offload(tier.G2_HOST, tier.G3_DISK, bid, 7)
        await settle(mgr.pools[tier.G3_DISK], [7])
        disk = mgr.pools[tier.G3_DISK]
        got = disk.read([disk.peek_hash(7)])
        np.testing.assert_array_equal(as_np(got), data)
        return [ids, bid, disk.peek_hash(7), got]
    finally:
        await mgr.stop()


async def partial_prefix(side, tmp_path):
    mgr = side.mod.KvBlockManager(side.config(host_blocks=8))
    mgr.start()
    try:
        mgr.store_sequence([1, 2], side.data(np.zeros((2, *SHAPE), np.float32)), offload=False)
        hit, tier = await mgr.match_and_onboard([1, 2, 3, 4])
        return [hit, tier.value, mgr.stats()]
    finally:
        await mgr.stop()


async def with_server(side, fn, n):
    server = side.remote.BlockStoreServer(side.host_storage(n))
    await server.start()
    try:
        return await fn(server)
    finally:
        await server.stop()


async def remote_roundtrip(side, tmp_path):
    async def body(server):
        store = await asyncio.to_thread(side.remote.RemoteStorage, server.address)
        data = randn(3, 4)
        await asyncio.to_thread(store.write_batch, [3, 5, 7, 9], side.data(data))
        got = await asyncio.to_thread(store.read_batch, [3, 5, 7, 9])
        got2 = await asyncio.to_thread(store.read_batch, [9, 3])
        np.testing.assert_array_equal(as_np(got), data)
        np.testing.assert_array_equal(as_np(got2), data[[3, 0]])
        store.close()
        return [store.num_blocks, tuple(store.shape), got, got2]

    return await with_server(side, body, 16)


async def remote_tier(side, tmp_path):
    async def body(server):
        mgr = await asyncio.to_thread(side.mod.KvBlockManager, side.config(
            host_blocks=8, remote_address=server.address))
        mgr.start()
        try:
            hashes = [201, 202, 203]
            data = randn(4, 3)
            ids = mgr.store_sequence(hashes, side.data(data))
            await settle(mgr.pools[side.mod.Tier.G4_REMOTE], hashes)
            mgr.release_sequence(ids)
            for h in hashes:
                mgr.primary.drop_hash(h)
            hit, tier = await mgr.match_and_onboard(hashes)
            got = mgr.primary.read(hit)
            np.testing.assert_array_equal(as_np(got), data)
            return [ids, hit, tier.value, got, mgr.stats()]
        finally:
            await mgr.stop()

    return await with_server(side, body, 32)


async def cascade_all_tiers(side, tmp_path):
    async def body(server):
        mgr = await asyncio.to_thread(side.mod.KvBlockManager, side.config(
            device_blocks=4, host_blocks=8, disk_blocks=8,
            disk_path=str(tmp_path / f"kv.{id(side)}.bin"), remote_address=server.address))
        mgr.start()
        try:
            data = randn(5, 1)
            rec = [mgr.store_sequence([77], side.data(data))]
            await settle(mgr.pools[side.mod.Tier.G4_REMOTE], [77])
            for t in ("G2_HOST", "G3_DISK", "G4_REMOTE"):
                pool = mgr.pools[getattr(side.mod.Tier, t)]
                got = await asyncio.to_thread(pool.read, [pool.peek_hash(77)])
                np.testing.assert_array_equal(as_np(got), data)
                rec += [pool.peek_hash(77), got]
            return rec + [mgr.stats()]
        finally:
            await mgr.stop()

    return await with_server(side, body, 16)


def host_disk(side, tmp_path, host_blocks=8, disk_blocks=8):
    return side.mod.KvBlockManager(side.config(
        device_blocks=0, host_blocks=host_blocks, disk_blocks=disk_blocks,
        disk_path=str(tmp_path / f"kv.{id(side)}.bin")))


def park_on_disk(side, mgr, hashes, seed):
    data = {}
    rng = np.random.default_rng(seed)
    for h in hashes:
        payload = rng.standard_normal((1, *SHAPE)).astype(np.float32)
        assert mgr.offload.insert_sync(side.mod.Tier.G3_DISK, side.data(payload), h)
        data[h] = payload
    return data


async def concurrent_onboards(side, tmp_path):
    mgr = host_disk(side, tmp_path)
    tier = side.mod.Tier
    data = park_on_disk(side, mgr, [11, 12, 13], 0)
    host = mgr.pools[tier.G2_HOST]
    a, b = await asyncio.gather(
        mgr.offload.onboard([11, 12, 13], tier.G2_HOST, tier.G3_DISK),
        mgr.offload.onboard([11, 12, 13], tier.G2_HOST, tier.G3_DISK),
    )
    rec = [a, b, mgr.offload.skipped, host.free_count]
    for h in (11, 12, 13):
        bid = host.match_hash(h)
        got = host.read([bid])
        np.testing.assert_array_equal(as_np(got), data[h])
        rec += [bid, got, mgr.pools[tier.G3_DISK].ref_count(h)]
        host.release(bid)
    return rec


async def overlapping_onboards(side, tmp_path):
    mgr = host_disk(side, tmp_path)
    tier = side.mod.Tier
    park_on_disk(side, mgr, [1, 2, 3], 1)
    out = await asyncio.gather(
        mgr.offload.onboard([1, 2], tier.G2_HOST, tier.G3_DISK),
        mgr.offload.onboard([2, 3], tier.G2_HOST, tier.G3_DISK),
    )
    host = mgr.pools[tier.G2_HOST]
    return [out, host.free_count, [host.ref_count(h) for h in (1, 2, 3)], mgr.stats()]


async def missing_source(side, tmp_path):
    mgr = host_disk(side, tmp_path)
    tier = side.mod.Tier
    park_on_disk(side, mgr, [1], 2)
    host = mgr.pools[tier.G2_HOST]
    first = await mgr.offload.onboard([1, 999], tier.G2_HOST, tier.G3_DISK)
    rec = [first, host.free_count, mgr.pools[tier.G3_DISK].ref_count(1)]
    second = await mgr.offload.onboard([1], tier.G2_HOST, tier.G3_DISK)
    return rec + [second, host.has_hash(1), mgr.stats()]


async def onboard_eviction_cascades(side, tmp_path):
    mgr = host_disk(side, tmp_path, host_blocks=2)
    tier = side.mod.Tier
    rng = np.random.default_rng(3)
    a = rng.standard_normal((1, *SHAPE)).astype(np.float32)
    assert mgr.offload.insert_sync(tier.G2_HOST, side.data(a), 100)
    assert mgr.offload.insert_sync(
        tier.G2_HOST, side.data(rng.standard_normal((1, *SHAPE)).astype(np.float32)), 101)
    park_on_disk(side, mgr, [102], 4)
    gone = []
    out = await mgr.offload.onboard([102], tier.G2_HOST, tier.G3_DISK,
                                    on_fully_evicted=gone.append)
    disk = mgr.pools[tier.G3_DISK]
    bid = disk.match_hash(100)
    got = disk.read([bid])
    np.testing.assert_array_equal(as_np(got), a)
    return [out, gone, bid, got, mgr.stats()]


@pytest.mark.parametrize("scenario", [
    g1_g2_roundtrip, three_tier_spill, partial_prefix, remote_roundtrip, remote_tier,
    cascade_all_tiers, concurrent_onboards, overlapping_onboards, missing_source,
    onboard_eviction_cascades,
], ids=lambda f: f.__name__)
def test_tiers_match_reference(scenario, tmp_path):
    run_both(scenario, tmp_path)


def test_device_tier_moves_blocks_through_the_copy_wrappers(tmp_path):
    """The G1 pool reads and writes through the block copy wrappers (their
    plain versions on the CPU; the kernels on the card), bf16 included."""
    before = block_copy.plain_calls
    storage = kvbm.DeviceStorage(8, SHAPE, torch.bfloat16, device="cpu")
    data = torch.from_numpy(randn(6, 3)).to(torch.bfloat16)
    storage.write_batch([5, 0, 2], data)
    got = storage.read_batch([2, 5])
    assert torch.equal(got.view(torch.int16), data[[2, 0]].view(torch.int16))
    assert block_copy.plain_calls == before + 2
    with pytest.raises(ValueError, match="duplicate"):
        storage.write_batch([1, 1], data[:2])


def test_host_and_disk_storage_hold_bf16(tmp_path):
    data = torch.from_numpy(randn(7, 2)).to(torch.bfloat16)
    for storage in (kvbm.HostStorage(4, SHAPE, torch.bfloat16),
                    kvbm.DiskStorage(4, SHAPE, torch.bfloat16, path=tmp_path / "g3.bin")):
        storage.write_batch([3, 1], data)
        assert torch.equal(storage.read_batch([1, 3]).view(torch.int16),
                           data[[1, 0]].view(torch.int16))
        storage.close()


def test_host_and_disk_storage_hold_fp8(tmp_path):
    """One-byte float pools: G2 host memory and the G3 uint8 memmap keep
    fp8 e4m3fn blocks byte for byte."""
    data = torch.from_numpy(randn(9, 2)).to(torch.float8_e4m3fn)
    for storage in (kvbm.HostStorage(4, SHAPE, torch.float8_e4m3fn),
                    kvbm.DiskStorage(4, SHAPE, torch.float8_e4m3fn, path=tmp_path / "g3.bin")):
        storage.write_batch([3, 1], data)
        got = storage.read_batch([1, 3])
        assert got.dtype == torch.float8_e4m3fn
        assert torch.equal(got.view(torch.uint8), data[[1, 0]].view(torch.uint8))
        storage.close()


@pytest.mark.parametrize("server_side,client_side", [(JAX, PORT), (PORT, JAX)],
                         ids=["port-client-jax-store", "jax-client-port-store"])
def test_g4_wire_carries_fp8_blocks_both_ways(server_side, client_side):
    """An fp8 e4m3fn pool over the G4 wire between the two packages: the
    dtype by its name (numpy's through ml_dtypes, torch's), the bytes
    equal both ways."""
    import ml_dtypes

    dtypes = {id(JAX): ml_dtypes.float8_e4m3fn, id(PORT): torch.float8_e4m3fn}
    server_side = dataclasses.replace(server_side, dtype=dtypes[id(server_side)])
    data = randn(10, 3).astype(ml_dtypes.float8_e4m3fn)
    payload = data if client_side is JAX else torch.from_numpy(
        data.view(np.uint8)).view(torch.float8_e4m3fn)

    async def body(server):
        store = await asyncio.to_thread(client_side.remote.RemoteStorage, server.address)
        await asyncio.to_thread(store.write_batch, [4, 1, 6], payload)
        got = await asyncio.to_thread(store.read_batch, [6, 4])
        store.close()
        return str(store.dtype).removeprefix("torch."), got

    name, got = asyncio.run(with_server(server_side, body, 8))
    assert name == "float8_e4m3fn"
    got = got.view(torch.uint8).numpy() if isinstance(got, torch.Tensor) else got.view(np.uint8)
    np.testing.assert_array_equal(got, data[[2, 0]].view(np.uint8))


@pytest.mark.parametrize("server_side,client_side", [(JAX, PORT), (PORT, JAX)],
                         ids=["port-client-jax-store", "jax-client-port-store"])
def test_g4_wire_interoperates_with_the_reference(server_side, client_side):
    """The two packages' block stores speak one wire: msgpack headers,
    dtypes by name, raw bytes."""

    async def body(server):
        store = await asyncio.to_thread(client_side.remote.RemoteStorage, server.address)
        data = randn(8, 3)
        await asyncio.to_thread(store.write_batch, [4, 1, 6], client_side.data(data))
        got = await asyncio.to_thread(store.read_batch, [6, 4])
        store.close()
        return store.num_blocks, tuple(store.shape), as_np(got)

    n, shape, got = asyncio.run(with_server(server_side, body, 8))
    assert (n, shape) == (8, SHAPE)
    np.testing.assert_array_equal(got, randn(8, 3)[[2, 0]])
