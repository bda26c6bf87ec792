"""The port's KV offload tiers (dynamo_tpu_torch.engine.offload and the
engine's offload/restore) against the JAX reference, on the CPU:
- HostOffloadTier unit cases of tests/engine/test_host_offload.py, each run
  on both tiers: same hashes held, same payload bytes, same stats;
- TorchLlmEngine against JaxLlmEngine(prefetch=False) on the same traffic
  (prompt A, churn that evicts it, A again), through the host tier, the
  disk tier (a small host pool) and the remote tier (a BlockStoreServer of
  each package), with the unified step on and off, for the tiny llama and
  tiny_mla (asymmetric cache leaves): identical greedy streams, identical
  offload/restore/prefix-hit counters, and G2 payloads equal within 1e-5;
- config rules: no tier without config, disk without host refused,
  prefetch=True not served yet."""

import asyncio
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.engine.offload import HostOffloadTier as JaxTier
from dynamo_tpu.llm.block_manager.remote import BlockStoreServer as JaxStoreServer
from dynamo_tpu.llm.block_manager.storage import HostStorage as JaxHostStorage
from dynamo_tpu.models import deepseek as jax_ds
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.engine.offload import HostOffloadTier
from dynamo_tpu_torch.llm.block_manager.remote import BlockStoreServer
from dynamo_tpu_torch.llm.block_manager.storage import HostStorage
from dynamo_tpu_torch.models import deepseek, llama
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.ops.kernels import block_copy
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import collect, request
from tests.test_torch_llama import tree_to_numpy

PAYLOAD_ATOL = 1e-5  # KV values of two frameworks' float32 forwards

# ---------------------------------------------------------------------------
# HostOffloadTier unit cases, on both tiers
# ---------------------------------------------------------------------------


def _leaves(i=0):
    return {
        "k": np.full((2, 4, 2, 8), i + 1, np.float32),
        "v": np.full((2, 4, 3), i + 2, np.float16),  # asymmetric leaf
    }


def _torch_leaves(i=0):
    return {k: torch.from_numpy(v) for k, v in _leaves(i).items()}


def make_tiers(n=4, tmp_path=None, disk_n=0, **kw):
    sample = _leaves()
    shapes = {k: v.shape for k, v in sample.items()}

    def disk(name):
        return dict(disk_blocks=disk_n, disk_path=tmp_path / name) if disk_n else {}

    ref = JaxTier(n, shapes, {k: v.dtype for k, v in sample.items()}, **disk("jax.blocks"))
    ours = HostOffloadTier(n, shapes, {k: torch.from_numpy(v).dtype for k, v in sample.items()},
                           **disk("ours.blocks"), **kw)
    return ours, ref


def put_both(ours, ref, h, i):
    assert ours.put(h, _torch_leaves(i)) == ref.put(h, _leaves(i))


def assert_tiers_agree(ours, ref):
    """Same hashes in every tier, same payload bytes, same stats."""
    assert ours.tier_names == ref.tier_names
    for p_ours, p_ref in zip(ours.tiers, ref.tiers):
        hashes = sorted(p_ref.registered_hashes())
        assert sorted(p_ours.registered_hashes()) == hashes
        for h in hashes:
            got = p_ours.read([p_ours.peek_hash(h)])[0].numpy()
            want = np.asarray(p_ref.read([p_ref.peek_hash(h)])[0])
            np.testing.assert_array_equal(got, want)
    assert ours.stats() == without_pins(ref.stats())
    assert ours.tiers_snapshot() == snapshot_without_pins(ref.tiers_snapshot())


def without_pins(ref_stats: dict) -> dict:
    """The reference's stats less its hot-prefix pin count, which only its
    prefetch pager raises (the port pages on demand and has no such pins)."""
    out = dict(ref_stats)
    assert out.pop("host_blocks_pinned") == 0
    return out


def snapshot_without_pins(ref_snapshot: dict) -> dict:
    out = {name: dict(row) for name, row in ref_snapshot.items()}
    assert out["g2"].pop("pinned") == 0
    return out


def read_one(tier, h):
    return tier.read_pinned_many([h])[h]


def assert_read_equal(out, i):
    for name, want in _leaves(i).items():
        assert out[name].dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(out[name].numpy(), want)


def test_tier_roundtrip_asymmetric_leaves():
    ours, ref = make_tiers()
    put_both(ours, ref, 111, 7)
    assert ours.has(111) and ours.pin(111) and ref.pin(111)
    assert_read_equal(read_one(ours, 111), 7)
    ref.read_pinned(111)
    assert_tiers_agree(ours, ref)


def test_tier_lru_eviction():
    ours, ref = make_tiers(n=2)
    for h in (1, 2, 3):  # 3 evicts hash 1 (LRU)
        put_both(ours, ref, h, h)
    assert not ours.has(1) and ours.has(2) and ours.has(3)
    assert_tiers_agree(ours, ref)


def test_tier_pin_blocks_eviction():
    ours, ref = make_tiers(n=2)
    put_both(ours, ref, 1, 1)
    put_both(ours, ref, 2, 2)
    assert ours.pin(1) and ref.pin(1)
    put_both(ours, ref, 3, 3)  # must evict 2, not pinned 1
    assert ours.has(1) and not ours.has(2)
    assert_read_equal(read_one(ours, 1), 1)
    ref.read_pinned(1)
    assert_tiers_agree(ours, ref)


def test_tier_put_fails_when_every_host_block_is_pinned():
    ours, ref = make_tiers(n=2)
    put_both(ours, ref, 1, 1)
    put_both(ours, ref, 2, 2)
    assert ours.pin(1) and ref.pin(1) and ours.pin(2) and ref.pin(2)
    assert not ours.put(3, _torch_leaves(3)) and not ref.put(3, _leaves(3))
    assert ours.has(1) and ours.has(2) and not ours.has(3)
    for h in (1, 2):
        assert_read_equal(read_one(ours, h), h)
        ref.read_pinned(h)
    assert_tiers_agree(ours, ref)


def test_host_eviction_spills_to_disk_and_restores(tmp_path):
    ours, ref = make_tiers(2, tmp_path, disk_n=4)
    for i in range(4):  # 4 puts into 2 host blocks → 2 cascade to disk
        put_both(ours, ref, 100 + i, i)
    assert ours.stats()["disk_spills_total"] == 2
    assert_tiers_agree(ours, ref)
    assert ours.pin(100) and ref.pin(100)
    assert_read_equal(read_one(ours, 100), 0)
    ref.read_pinned(100)
    assert ours.stats()["disk_restores_total"] == 1
    assert_tiers_agree(ours, ref)
    ours.close()
    ref.close()


def test_disk_eviction_notifies_observer(tmp_path):
    ours, ref = make_tiers(1, tmp_path, disk_n=1)
    gone, gone_ref = [], []
    ours.evict_observer, ref.evict_observer = gone.append, gone_ref.append
    for h in (1, 2, 3):  # 3: 2 spills, the disk evicts 1 → notify(1)
        put_both(ours, ref, h, h)
    assert gone == gone_ref == [1]
    assert_tiers_agree(ours, ref)


def test_hot_prefix_repromotes_to_host(tmp_path):
    ours, ref = make_tiers(2, tmp_path, disk_n=4)
    for h in (1, 2, 3):  # 1 spills to disk
        put_both(ours, ref, h, h)
    assert ours.disk.has_hash(1) and not ours.pool.has_hash(1)
    put_both(ours, ref, 1, 1)  # back from the device: a fresh host copy
    assert ours.pool.has_hash(1)
    assert ours.pin(1) and ref.pin(1)
    assert_read_equal(read_one(ours, 1), 1)
    ref.read_pinned(1)
    assert ours.stats()["host_restores_total"] == 1
    assert ours.stats()["disk_restores_total"] == 0
    assert_tiers_agree(ours, ref)


# ---------------------------------------------------------------------------
# engine parity through each tier
# ---------------------------------------------------------------------------

LLAMA_DIR = Path(__file__).parent / "data" / "tiny-chat-model"
GEOMETRY = dict(num_blocks=6, block_size=4, max_batch_size=2, max_model_len=24,
                prefill_buckets=(16,))
PROMPT_A = list(range(3, 15))  # 3 full blocks
CHURN = [list(range(base, base + 16)) for base in (40, 60, 80, 100)]
# tier settings, and the counter of the tier A restores from
TIERS = {
    "host": (dict(host_offload_blocks=16), "host_restores_total"),
    "disk": (dict(host_offload_blocks=2, disk_offload_blocks=16), "disk_restores_total"),
    "remote": (dict(host_offload_blocks=2, disk_offload_blocks=2), "remote_restores_total"),
}
COUNTERS = ("host_offloads_total", "host_restores_total", "disk_restores_total",
            "remote_restores_total", "disk_spills_total", "remote_spills_total",
            "prefix_hits_total")


@functools.cache
def family_models(family: str):
    if family == "llama":
        cfg = dataclasses.replace(llama.LlamaConfig.from_hf_config(LLAMA_DIR / "config.json"),
                                  dtype=torch.float32)
        jcfg = dataclasses.replace(
            jax_llama.LlamaConfig.from_hf_config(LLAMA_DIR / "config.json"), dtype=jnp.float32)
        jparams = jax_llama.load_hf_weights(jcfg, LLAMA_DIR)
        return "llama", cfg, jcfg, params_from_jax(tree_to_numpy(jparams), device="cpu"), jparams
    cfg = deepseek.DeepseekConfig.tiny_mla(vocab_size=481)
    jcfg = jax_ds.DeepseekConfig.tiny_mla(vocab_size=481)
    jparams = jax_ds.init_params(jcfg, jax.random.PRNGKey(5))
    return "deepseek_v2", cfg, jcfg, params_from_jax(tree_to_numpy(jparams), device="cpu"), jparams


def g2_payloads(tier) -> dict:
    """hash -> {leaf: float64 array} of every block the host tier holds."""
    pool = tier.tiers[0]
    out = {}
    for h in pool.registered_hashes():
        buf = pool.read([pool.peek_hash(h)])[0]
        leaves = tier._deserialize(buf)
        out[h] = {k: v.double().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v, np.float64) for k, v in leaves.items()}
    return out


async def drive(engine, ctx_cls):
    """A, churn that pushes A's blocks down the tiers, A again — one request
    at a time."""
    engine.start()
    try:
        out = []
        for prompt in [PROMPT_A, *CHURN, PROMPT_A]:
            out.append(await collect(engine, request(prompt, max_tokens=2, ignore_eos=True),
                                     ctx_cls))
        return out, engine.stats(), g2_payloads(engine.host_tier)
    finally:
        engine.stop()


async def remote_store(server_cls, storage_cls, nbytes: int, dtype):
    server = server_cls(storage_cls(32, (nbytes,), dtype))
    await server.start()
    return server


async def offload_pair(family, tier, unified, tmp_path, **engine_kw):
    """Both engines through ``drive`` on one tier configuration: (ours,
    our stats, our G2 payloads), then the reference's."""
    name, cfg, jcfg, params, jparams = family_models(family)
    tier_kw, _ = TIERS[tier]
    kw = {**GEOMETRY, **tier_kw, "model_family": name, "unified_batch": unified, **engine_kw}
    servers = []
    if tier == "remote":
        probe = TorchLlmEngine(EngineConfig(model=cfg, **GEOMETRY, model_family=name,
                                            host_offload_blocks=1, **engine_kw),
                               params=params, device="cpu")
        nbytes = probe.host_tier.block_nbytes
        probe.stop()
        servers = [await remote_store(JaxStoreServer, JaxHostStorage, nbytes, np.uint8),
                   await remote_store(BlockStoreServer, HostStorage, nbytes, torch.uint8)]
    try:
        results = []
        for i, build in enumerate((
            lambda extra: JaxLlmEngine(
                JaxEngineConfig(model=jcfg, decode_overlap=False, prefetch=False, **kw, **extra),
                params=jparams),
            lambda extra: TorchLlmEngine(EngineConfig(model=cfg, **kw, **extra),
                                         params=params, device="cpu"),
        )):
            extra = {}
            if "disk_offload_blocks" in kw:
                extra["disk_offload_path"] = str(tmp_path / f"g3.{i}.blocks")
            if servers:
                extra["remote_store_addr"] = servers[i].address
            # mounting a remote store does blocking IO: build off the loop
            engine = await asyncio.to_thread(build, extra)
            results.append(await drive(engine, (JaxContext, Context)[i]))
        (ref, ref_stats, ref_g2), (ours, stats, g2) = results
    finally:
        for server in servers:
            await server.stop()
    return ours, stats, g2, ref, ref_stats, ref_g2


@pytest.mark.parametrize("unified", [True, False], ids=["unified", "split"])
@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("family", ["llama", "tiny_mla"])
async def test_engine_offload_and_restore_match_reference(family, tier, unified, tmp_path):
    restore_counter = TIERS[tier][1]
    ours, stats, g2, ref, ref_stats, ref_g2 = await offload_pair(family, tier, unified, tmp_path)
    assert ours == ref
    assert ours[-1] == ours[0]  # the restored prefix gives A's tokens again
    for key in COUNTERS:
        assert stats.get(key) == ref_stats.get(key), key
    assert stats[restore_counter] > 0, stats
    assert stats["offload_tiers"] == snapshot_without_pins(ref_stats["offload_tiers"])
    assert sorted(g2) == sorted(ref_g2) and g2
    for h, leaves in g2.items():
        for leaf, arr in leaves.items():
            np.testing.assert_allclose(arr, ref_g2[h][leaf], rtol=0, atol=PAYLOAD_ATOL)


@pytest.mark.parametrize("tier", sorted(TIERS))
async def test_engine_offload_and_restore_of_an_fp8_cache(tier, tmp_path):
    """An fp8 e4m3fn cache through G2 pinned host memory, the G3 uint8
    memmap and the G4 wire (a store of the reference's and one of the
    port's): the same greedy streams as the reference, the restored prefix
    gives the tokens A gave with no eviction, and the blocks the host tier
    holds are the reference's bytes."""
    restore_counter = TIERS[tier][1]
    ours, stats, g2, ref, ref_stats, ref_g2 = await offload_pair(
        "llama", tier, True, tmp_path, kv_cache_dtype="fp8")
    assert ours == ref
    assert ours[-1] == ours[0]
    assert stats[restore_counter] > 0, stats
    assert stats["kv_cache_dtype"] == "float8_e4m3fn"
    assert sorted(g2) == sorted(ref_g2) and g2
    for h, leaves in g2.items():
        for leaf, arr in leaves.items():
            np.testing.assert_array_equal(arr, ref_g2[h][leaf])


async def test_engine_offload_runs_the_block_copy_wrappers():
    """On the CPU the engine's offload and restore go through the kernel
    wrappers' plain versions (on the card, the kernels)."""
    _, cfg, _, params, _ = family_models("llama")
    before = block_copy.plain_calls
    engine = TorchLlmEngine(EngineConfig(model=cfg, **GEOMETRY, host_offload_blocks=16),
                            params=params, device="cpu")
    _, stats, _ = await drive(engine, Context)
    assert stats["host_restores_total"] > 0
    # one gather a leaf an offload batch, one scatter a leaf a restore
    assert block_copy.plain_calls - before >= 2 * 2
    assert block_copy.gather_launches == block_copy.scatter_launches == 0


async def test_engine_stats_split_restore_time():
    """stats() adds up where restores spend their time: the tier reads into
    staging, the copies to the device and the scatters."""
    _, cfg, _, params, _ = family_models("llama")
    engine = TorchLlmEngine(EngineConfig(model=cfg, **GEOMETRY, host_offload_blocks=16),
                            params=params, device="cpu")
    assert {engine.stats()[f"restore_{k}_ms_total"] for k in ("stage", "copy", "scatter")} == {0.0}
    _, stats, _ = await drive(engine, Context)
    assert stats["host_restores_total"] > 0
    assert stats["restore_stage_ms_total"] > 0 and stats["restore_scatter_ms_total"] > 0
    assert stats["restore_copy_ms_total"] >= 0


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def test_offload_disabled_without_config():
    _, cfg, _, params, _ = family_models("llama")
    engine = TorchLlmEngine(EngineConfig(model=cfg, **GEOMETRY), params=params, device="cpu")
    assert engine.host_tier is None
    assert "host_offloads_total" not in engine.stats()


@pytest.mark.parametrize("tiers", [dict(disk_offload_blocks=4),
                                   dict(remote_store_addr="127.0.0.1:1")])
def test_lower_tiers_without_a_host_tier_are_refused(tiers):
    _, cfg, _, params, _ = family_models("llama")
    with pytest.raises(ValueError, match="need host_offload_blocks"):
        TorchLlmEngine(EngineConfig(model=cfg, **GEOMETRY, **tiers), params=params,
                       device="cpu")


def test_prefetch_is_not_served_yet():
    _, cfg, _, params, _ = family_models("llama")
    with pytest.raises(NotImplementedError, match="prefetch"):
        TorchLlmEngine(EngineConfig(model=cfg, **GEOMETRY, host_offload_blocks=8,
                                    prefetch=True), params=params, device="cpu")
    engine = TorchLlmEngine(EngineConfig(model=cfg, **GEOMETRY, host_offload_blocks=8,
                                         prefetch=False), params=params, device="cpu")
    assert engine.host_tier is not None
