"""Disaggregated prefill and decode with a mesh engine on either side.

A tp = 2 engine's ``prefill_extract`` gathers whole blocks ``[L, n, bs,
KVH, D]`` from both ranks' shards (row 6 on each), equal within 1e-5 to
``JaxLlmEngine(mesh=tp 2)``'s for the same prompt; a tp = 2 decode engine's
inject scatters each rank's slice (row 7 on each).  Streams over every
route equal the one-card engine's aggregated stream and the reference mesh
engine's: tp 2 -> one card and one card -> tp 2, single-shot and streamed
(chunks of 8 shipped while later ones compute), over the same-process route
(device tensors) and TCP; and DeepSeek's latent cache (two leaf widths,
whole on every rank) both ways.  The engines are shared by the module."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxPreprocessed
from dynamo_tpu.models import deepseek as jds
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.disagg import (
    DisaggConfig,
    DisaggDecodeEngine,
    DisaggRouter,
    PrefillQueue,
    PrefillWorker,
)
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.models import deepseek
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.parallel.kv_transfer import LOCAL_SERVERS
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from dynamo_tpu_torch.runtime import Context, DistributedRuntime
from dynamo_tpu_torch.utils.config import RuntimeConfig
from tests.test_torch_disagg import collect, request
from tests.test_torch_mesh import MLA
from tests.test_torch_mesh_spec import chat_model

ATOL = 1e-5  # KV values of two frameworks' float32 forwards
BASE = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32),
            max_model_len=64, decode_overlap=False, prefill_chunk_tokens=8)
PROMPTS = [list(range(3, 27)), list(range(40, 53))]
_names = itertools.count()


def models(family: str):
    """(registry key, port cfg, reference cfg, reference tree)."""
    if family == "llama":
        cfg, jcfg, tree = chat_model()
        return "llama", cfg, jcfg, tree
    over = dict(MLA, num_layers=2)
    jcfg = jds.DeepseekConfig(**over, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jds.init_params(jcfg, jax.random.PRNGKey(3)))
    return "deepseek_v2", deepseek.DeepseekConfig(**over, dtype=torch.float32), jcfg, tree


class Side:
    """A family's shared engines: the port's tp = 2 and one-card engines,
    started, and the one-card engine's aggregated streams of ``PROMPTS``."""

    def __init__(self, family: str):
        self.name, cfg, self.jcfg, self.tree = models(family)
        params = params_from_jax(self.tree, "cpu")
        kw = dict(model_family=self.name, **BASE)
        self.mesh = TorchLlmEngine(EngineConfig(model=cfg, mesh=MeshConfig(tp=2), **kw),
                                   params=params, device="cpu")
        self.one = TorchLlmEngine(EngineConfig(model=cfg, **kw), params=params, device="cpu")
        self.mesh.start()
        self.one.start()
        self._want = None

    async def want(self) -> list:
        """The one-card engine's aggregated streams (computed once)."""
        if self._want is None:
            self._want = [await collect(await self.one.generate(Context(request(p))))
                          for p in PROMPTS]
        return self._want

    def stop(self):
        self.mesh.stop()
        self.one.stop()


@pytest.fixture(scope="module")
def sides():
    """``sides(family)``: that family's engines, the other family's stopped
    first (a process is rank 0 of one mesh at a time: one process group)."""
    live: dict[str, Side] = {}

    def get(family: str) -> Side:
        for other in [f for f in live if f != family]:
            live.pop(other).stop()
        if family not in live:
            live[family] = Side(family)
        return live[family]

    yield get
    for side in live.values():
        side.stop()


async def reference_mesh_streams(side: Side) -> list:
    """The reference mesh engine's aggregated streams of ``PROMPTS``."""
    engine = JaxLlmEngine(JaxEngineConfig(model=side.jcfg, model_family=side.name,
                                          mesh=jmesh.MeshConfig(tp=2), **BASE), params=side.tree)
    engine.start()
    try:
        return [await collect(await engine.generate(JaxContext(request(p)))) for p in PROMPTS]
    finally:
        engine.stop()


async def disagg(prefill, decode, *, tcp: bool, stream: bool) -> tuple[list, dict]:
    """``PROMPTS`` through a decode engine behind ``DisaggDecodeEngine`` and
    a prefill engine behind a ``PrefillWorker``, over a fresh memory plane;
    the streams and the decode side's transfer counters.  Both engines'
    prefix caches are flushed first: every prompt prefills whole."""
    for engine in (prefill, decode):
        await engine.clear_kv_blocks()
    rt = await DistributedRuntime.create(RuntimeConfig(
        control_plane=f"memory://tmeshdisagg-{next(_names)}"))
    router = DisaggRouter(rt, "tiny", DisaggConfig(max_local_prefill_length=4))
    queue = PrefillQueue(rt, "ns", "backend")
    front = DisaggDecodeEngine(rt, decode, router, queue)
    await front.start()
    if tcp:
        LOCAL_SERVERS.pop(front.transfer_server.address, None)
    worker = PrefillWorker(rt, prefill, queue, stream=stream)
    worker.start()
    try:
        got = [await collect(await front.generate(Context(request(p)))) for p in PROMPTS]
        return got, dict(remote=front.remote_prefills, parts=front.kv_transfer_parts_total)
    finally:
        await worker.stop()
        await front.stop()
        await rt.close()


@pytest.mark.parametrize("stream", [False, True], ids=["single", "streamed"])
@pytest.mark.parametrize("tcp", [False, True], ids=["same_process", "tcp"])
@pytest.mark.parametrize("direction", ["tp2_to_one", "one_to_tp2"])
async def test_llama_routes_match_the_aggregated_streams(sides, direction, tcp, stream):
    side = sides("llama")
    prefill, decode = ((side.mesh, side.one) if direction == "tp2_to_one"
                       else (side.one, side.mesh))
    counts0 = [c["block_copy.plain_calls"] for c in side.mesh.mesh_counts()]
    got, info = await disagg(prefill, decode, tcp=tcp, stream=stream)
    assert got == await side.want()
    assert info["remote"] == len(PROMPTS)
    if stream:  # the 24-token prompt ships two parts mid-prefill, then its tail
        assert info["parts"] > len(PROMPTS)
    counts = [c["block_copy.plain_calls"] for c in side.mesh.mesh_counts()]
    assert all(b > a for a, b in zip(counts0, counts)), (counts0, counts)


@pytest.mark.parametrize("direction", ["tp2_to_one", "one_to_tp2"])
async def test_deepseek_routes_match_the_aggregated_streams(sides, direction):
    """The latent cache is whole on every rank: the gather takes rank 0's,
    the scatter writes every rank's copy."""
    side = sides("deepseek")
    prefill, decode = ((side.mesh, side.one) if direction == "tp2_to_one"
                       else (side.one, side.mesh))
    got, info = await disagg(prefill, decode, tcp=True, stream=True)
    assert got == await side.want() and info["remote"] == len(PROMPTS)
    assert len({leaf.shape[-1] for leaf in side.mesh.cache.values()}) == 2


@pytest.mark.parametrize("family", ["llama", "deepseek"])
async def test_mesh_streams_equal_the_reference_mesh_engine(sides, family):
    side = sides(family)
    assert await reference_mesh_streams(side) == await side.want()


@pytest.mark.parametrize("device", [False, True])
async def test_prefill_extract_whole_blocks_match_the_reference(sides, device):
    """The tp = 2 engine's extracted blocks are whole blocks in the
    reference's layout, equal to ``JaxLlmEngine(mesh=tp 2)``'s; with
    ``device=True`` they sit on rank 0's device."""
    side = sides("llama")
    prompt = PROMPTS[1]
    token, _, _, blocks, n = await side.mesh.prefill_extract(
        PreprocessedRequest.from_wire(request(prompt)), device=device)
    ref_engine = JaxLlmEngine(JaxEngineConfig(model=side.jcfg, mesh=jmesh.MeshConfig(tp=2),
                                              **BASE), params=side.tree)
    ref_engine.start()
    try:
        ref_token, _, _, ref_blocks, ref_n = await ref_engine.prefill_extract(
            JaxPreprocessed.from_wire(request(prompt)))
    finally:
        ref_engine.stop()
    assert (token, n) == (ref_token, ref_n)
    cfg = side.mesh.config.model
    for name in ("k", "v"):
        ours = blocks[name]
        assert ours.shape == (cfg.num_layers, n, BASE["block_size"], cfg.num_kv_heads,
                              cfg.head_dim)
        assert ours.device == side.mesh.device
        ref = np.asarray(ref_blocks[name])[:, :n]
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL)
