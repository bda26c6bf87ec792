"""Guided JSON decoding and multimodal requests on an engine mesh.

The port's tp = 2 engines (rank 0 here, the shard worker a child process)
against ``JaxLlmEngine`` on the same mesh: guided streams, greedy and
seeded, with guided and unguided lanes in one batch (the mask in rank 0's
sampling tail), byte-identical with equal guided counters; multimodal
streams (patch embeddings spliced before the text on every rank, the
``embeds`` program) of the llama family and Gemma-3, greedy and seeded,
ids identical and logprobs within 1e-4.  ``build_torch_engine(mesh=tp 2)``
installs the guided table and serves ``json_object``;
``MultimodalEngine`` serves image requests over a tp = 2 engine, the ViT on
rank 0's device, with the token streams of the one-card engine on the same
seed (bf16 weights: logprobs within bf16's precision)."""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import gemma3 as jg3
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import gemma3
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_guided import BASE as GUIDED_BASE
from tests.test_torch_guided import CFG as GUIDED_CFG
from tests.test_torch_guided import JCFG as GUIDED_JCFG
from tests.test_torch_guided import JPARAMS as GUIDED_JPARAMS
from tests.test_torch_guided import collect as guided_collect
from tests.test_torch_guided import guided_parts, guided_request, replay, tokenizer  # noqa: F401
from tests.test_torch_mesh_spec import chat_model
from tests.test_torch_multimodal import drain, mm, request
from tests.test_torch_tp_cli import model_dir

TP2 = dict(tp=2)


@pytest.mark.parametrize("sampling", ["greedy", "temp"])
async def test_guided_streams_equal_the_reference_mesh_engine(guided_parts, tokenizer,
                                                              sampling):
    kwargs = {"temperature": 0.9, "seed": 11} if sampling == "temp" else {}
    reqs = [guided_request(max_tokens=20, tokens=range(3 + i, 9 + 2 * i),
                           output_format="json" if i % 2 == 0 else None, **kwargs)
            for i in range(4)]
    masks, strings = guided_parts
    kw = dict(decode_overlap=False, **GUIDED_BASE)
    out = {}
    for stack, engine, ctx in (
        ("jax", JaxLlmEngine(JaxEngineConfig(model=GUIDED_JCFG, mesh=jmesh.MeshConfig(**TP2),
                                             **kw), params=GUIDED_JPARAMS), JaxContext),
        ("torch", TorchLlmEngine(EngineConfig(model=GUIDED_CFG, mesh=MeshConfig(**TP2), **kw),
                                 params=params_from_jax(jax.tree.map(np.asarray, GUIDED_JPARAMS),
                                                        "cpu"), device="cpu"), Context),
    ):
        engine.set_guided(masks, strings, tokenizer.eos_token_ids)
        engine.start()
        try:
            out[stack] = await asyncio.gather(*(guided_collect(engine, ctx, r) for r in reqs))
            out[stack + "_stats"] = {k: engine.stats()[k] for k in (
                "guided_requests_total", "guided_completions_total")}
        finally:
            engine.stop()
    assert out["torch"] == out["jax"]
    assert out["torch_stats"] == out["jax_stats"]
    assert out["torch_stats"]["guided_requests_total"] == 2
    for tokens, _ in out["torch"][::2]:
        replay(tokens, guided_parts, tokenizer)


def test_build_torch_engine_guides_on_a_mesh(tmp_path, tokenizer):
    """Every launch path guides on a mesh: the table is installed and a
    ``json_object`` request's completion is admissible JSON."""
    from dynamo_tpu_torch.serve import build_torch_engine

    path = model_dir(tmp_path, vocab_size=512)
    engine = build_torch_engine(path, ModelDeploymentCard.from_local_path(path), device="cpu",
                                mesh=MeshConfig(**TP2), max_model_len=64)
    try:
        assert engine.mesh is not None and engine.guided_masks is not None
        engine.start()
        tokens, _ = asyncio.run(guided_collect(engine, Context, guided_request(
            max_tokens=16, output_format="json_object")))
        cursor = replay(tokens, (engine.guided_masks, engine._guided_strings), tokenizer)
        if cursor.complete:
            json.loads(tokenizer.decode(tokens, skip_special_tokens=True))
        assert engine.stats()["guided_requests_total"] == 1
    finally:
        engine.stop()


MM = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32, 64),
          max_model_len=128, decode_overlap=False)


def mm_model(name: str):
    """(registry key, port cfg, reference cfg, reference tree)."""
    if name == "llama":
        cfg, jcfg, tree = chat_model()
        return "llama", cfg, jcfg, tree
    over = dict(num_layers=6, global_layers=())
    jcfg = dataclasses.replace(jg3.Gemma3Config.tiny(), dtype=jnp.float32, **over)
    tree = jax.tree.map(np.asarray, jg3.init_params(jcfg, jax.random.PRNGKey(4)))
    return ("gemma3", dataclasses.replace(gemma3.Gemma3Config.tiny(), dtype=torch.float32,
                                          **over), jcfg, tree)


@pytest.mark.parametrize("name", ["llama", "gemma3"])
async def test_multimodal_streams_equal_the_reference_mesh_engine(name):
    family, cfg, jcfg, tree = mm_model(name)
    rng = np.random.default_rng(3)
    image = rng.normal(size=(12, cfg.hidden_size)).astype(np.float32)
    video = rng.normal(size=(20, cfg.hidden_size)).astype(np.float32)
    seeded = SamplingOptions(temperature=0.9, top_k=40, top_p=0.9, seed=17)
    jobs = [(request(range(3, 10), 6), image), (request(range(20, 30), 6, seeded), video),
            (request(range(40, 48), 5), None)]
    kw = dict(model_family=family, **MM)
    out = {}
    for stack, engine, ctx in (
        ("jax", JaxLlmEngine(JaxEngineConfig(model=jcfg, mesh=jmesh.MeshConfig(**TP2), **kw),
                             params=tree), JaxContext),
        ("torch", TorchLlmEngine(EngineConfig(model=cfg, mesh=MeshConfig(**TP2), **kw),
                                 params=params_from_jax(tree, "cpu"), device="cpu"), Context),
    ):
        engine.start()
        try:
            out[stack] = await asyncio.gather(*[mm(engine, r, e, ctx) for r, e in jobs])
            if stack == "torch":
                stats = engine.stats()
        finally:
            engine.stop()
    for (t, lp), (rt, rlp) in zip(out["torch"], out["jax"], strict=True):
        assert t == rt
        np.testing.assert_allclose(lp, rlp, atol=1e-4, rtol=0)
    assert stats["mesh_step_time"]["embeds"]["steps"] == 2


async def test_multimodal_engine_serves_over_a_mesh(tmp_path):
    """``MultimodalEngine`` over a tp = 2 engine (the tiny ViT on rank 0's
    device): image and text requests give the one-card service's streams
    (both draw their weights from the same seed)."""
    from dynamo_tpu_torch.examples.multimodal.pipeline import start_engine

    path = model_dir(tmp_path, vocab_size=512)
    image = np.random.default_rng(5).random((20, 13, 3), np.float32).tolist()
    reqs = [{**request(range(3, 10), 5), "image": image}, request(range(3, 10), 5)]
    got = {}
    for name, over in (("mesh", dict(mesh=MeshConfig(**TP2))), ("one", {})):
        handle = await start_engine(str(path), device="cpu", **over)
        try:
            assert handle.encoder.device == handle.llm.device
            got[name] = [await drain(await handle.engine.generate(Context(r))) for r in reqs]
        finally:
            await handle.shutdown()
    # bf16 weights (the model directory's): the row-parallel sums round
    # once more than one card's, so the logprobs agree to bf16's precision
    for (tokens, lps), (one_tokens, one_lps) in zip(got["mesh"], got["one"], strict=True):
        assert tokens == one_tokens
        np.testing.assert_allclose(lps, one_lps, atol=5e-2, rtol=0)
    assert got["mesh"][0][0] != got["mesh"][1][0]  # the image conditions the stream
