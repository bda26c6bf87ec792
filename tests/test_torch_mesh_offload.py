"""The KV offload tiers on an engine mesh, against the reference's.

The port's tp = 2 and pp = 2 engines (rank 0 here, the shard worker a child
process) with a G2 host tier, and with a small G2 over a G3 disk tier,
against ``JaxLlmEngine`` on the same mesh over the same traffic (prompt A,
churn that evicts it, A again): every offload gathers whole blocks
``[L, n, bs, KVH, D]`` from every rank's shard (row 6 on each rank), every
restore scatters each rank's slice (row 7 on each rank).  Held: the greedy
streams and the tier counters equal the reference's, the blocks the host
tier holds equal the reference's whole blocks within 1e-5, and each rank
launched its copies.  The prefetch pager's restores on a tp = 2 mesh: its
hint pages A's evicted blocks back as the reference's does, with the same
counts and streams.  The tiny chat model's trained weights, its vocabulary
padded to 482 rows so tp divides it."""

import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_engine import collect, request
from tests.test_torch_mesh_spec import chat_model
from tests.test_torch_offload import CHURN, COUNTERS, GEOMETRY, PAYLOAD_ATOL, PROMPT_A, TIERS
from tests.test_torch_offload import g2_payloads
from tests.test_torch_prefetch import COUNTS, scenario_hint

CFG, JCFG, TREE = chat_model()
PARAMS = params_from_jax(TREE, "cpu")


def build(kind: str, sizes: dict, tmp_path, **kw):
    """(engine, context class) of ``kind`` "ref" (the reference's mesh
    engine) or "port" (the port's) on a mesh of ``sizes``."""
    kw = {**GEOMETRY, "decode_overlap": False, **kw}
    if "disk_offload_blocks" in kw:
        kw["disk_offload_path"] = str(tmp_path / f"g3.{kind}.blocks")
    if kind == "ref":
        return JaxLlmEngine(JaxEngineConfig(model=JCFG, mesh=jmesh.MeshConfig(**sizes), **kw),
                            params=TREE), JaxContext
    return TorchLlmEngine(EngineConfig(model=CFG, mesh=MeshConfig(**sizes), **kw),
                          params=PARAMS, device="cpu"), Context


async def drive(engine, ctx_cls):
    """A, churn that pushes A's blocks down the tiers, A again, one request
    at a time; the streams, stats, the host tier's blocks and (the port's)
    every rank's block copies."""
    engine.start()
    try:
        out = []
        for prompt in [PROMPT_A, *CHURN, PROMPT_A]:
            out.append(await collect(engine, request(prompt, max_tokens=2, ignore_eos=True),
                                     ctx_cls))
        copies = None
        if hasattr(engine, "mesh_counts"):
            copies = [c["block_copy.plain_calls"] for c in engine.mesh_counts()]
        return out, engine.stats(), g2_payloads(engine.host_tier), copies
    finally:
        engine.stop()


@pytest.mark.parametrize("tier", ["host", "disk"])
@pytest.mark.parametrize("sizes", [dict(tp=2), dict(pp=2)], ids=["tp2", "pp2"])
async def test_mesh_offload_and_restore_match_the_reference(sizes, tier, tmp_path):
    restore_counter = TIERS[tier][1]
    (ref, ref_stats, ref_g2, _), (ours, stats, g2, copies) = [
        await drive(*build(kind, sizes, tmp_path, prefetch=False, **TIERS[tier][0]))
        for kind in ("ref", "port")]
    assert ours == ref
    assert ours[-1] == ours[0]  # the restored prefix gives A's tokens again
    for key in COUNTERS:
        assert stats.get(key) == ref_stats.get(key), key
    assert stats[restore_counter] > 0, stats
    assert stats["offload_tiers"] == ref_stats["offload_tiers"]
    # whole blocks in the reference's layout, each rank's shard in its place
    assert sorted(g2) == sorted(ref_g2) and g2
    for h, leaves in g2.items():
        for leaf, arr in leaves.items():
            assert arr.shape == ref_g2[h][leaf].shape == (CFG.num_layers, GEOMETRY["block_size"],
                                                          CFG.num_kv_heads, CFG.head_dim)
            np.testing.assert_allclose(arr, ref_g2[h][leaf], rtol=0, atol=PAYLOAD_ATOL)
    # rows 6-7 on every rank: a gather a leaf an offload, a scatter a leaf a
    # restore
    assert len(copies) == 2 and all(n >= 4 for n in copies), copies
    assert stats["mesh_step_time"]["gather"]["transfer_s"] > 0
    assert stats["mesh_step_time"]["scatter"]["steps"] > 0


async def test_mesh_prefetch_pager_restores_match_the_reference(tmp_path):
    """The pager's hint restores A's evicted blocks onto both ranks before
    A returns, as the reference's pager does on its mesh: equal streams,
    residency and counts."""
    out = {}
    for kind in ("ref", "port"):
        engine, ctx = build(kind, dict(tp=2), tmp_path, prefetch=True, host_offload_blocks=16)
        engine.start()
        try:
            out[kind] = await scenario_hint(engine, ctx)
        finally:
            engine.stop()
    ref, port = out["ref"], out["port"]
    assert port["streams"] == ref["streams"]
    assert port["streams"][-2] == port["streams"][0]
    for key in ("resident", "offloaded", "queued", "dup_free", "counts"):
        assert port[key] == ref[key], key
    assert port["counts"]["prefetch_blocks_restored_total"] >= 1
    assert set(COUNTS) <= set(port["counts"])
