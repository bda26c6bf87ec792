"""The port's embedding engine (dynamo_tpu_torch/engine/embedding.py,
device="cpu") against ``JaxEmbeddingEngine`` on the same weights: the
trunk against ``llama_forward_trunk``, unit vectors within 1e-5 in float32
over the four input shapes, base64 the same bytes' floats, the
reference's refusal of another encoding in its words, and
``/v1/embeddings`` answering JSON of the reference's structure and usage
through both packages' HTTP services."""

import base64
import dataclasses
from pathlib import Path

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.embedding import EmbeddingEngineConfig as JaxEmbeddingConfig
from dynamo_tpu.engine.embedding import JaxEmbeddingEngine
from dynamo_tpu.llm.protocols.openai import EmbeddingRequest as JaxEmbeddingRequest
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu_torch.engine.embedding import EmbeddingEngineConfig, TorchEmbeddingEngine
from dynamo_tpu_torch.llm.protocols.openai import EmbeddingRequest
from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
from dynamo_tpu_torch.models import llama

MODEL_DIR = Path(__file__).parent / "data" / "tiny-chat-model"
TOKENIZER = HfTokenizer.from_file(MODEL_DIR / "tokenizer.json")
JCFG = jax_llama.LlamaConfig.tiny()
CFG = llama.LlamaConfig.tiny()
JPARAMS = jax_llama.init_params(JCFG, jax.random.PRNGKey(5))
PARAMS = llama.params_from_jax(jax.tree.map(np.asarray, JPARAMS), "cpu")
MAX_LEN = 32

INPUTS = [
    "hello world",                                  # one string
    ["hello world", "the quick brown fox", ""],     # a batch of strings
    [5, 6, 7, 8, 9],                                # one pre-tokenized sequence
    [[1, 2, 3], [4, 5], list(range(3, 60))],        # a batch of them, one past max_length
]


def engines():
    from dynamo_tpu.llm.tokenizer import HfTokenizer as JaxTokenizer

    ref = JaxEmbeddingEngine(JaxEmbeddingConfig(model=JCFG, max_length=MAX_LEN),
                             JaxTokenizer.from_file(MODEL_DIR / "tokenizer.json"),
                             params=JPARAMS)
    ours = TorchEmbeddingEngine(EmbeddingEngineConfig(model=CFG, max_length=MAX_LEN), TOKENIZER,
                                params=PARAMS, device="cpu")
    return ours, ref


def test_trunk_matches_reference():
    tokens = np.random.default_rng(0).integers(3, CFG.vocab_size, 24).astype(np.int32)
    jcos, jsin = jax_llama.make_rope_tables(JCFG)
    want = jax_llama.llama_forward_trunk(JPARAMS, JCFG, jnp.asarray(tokens), jnp.int32(17),
                                         jcos[:24], jsin[:24])
    cos, sin = llama.make_rope_tables(CFG, "cpu", 24)
    got = llama.llama_forward_trunk(PARAMS, CFG, torch.from_numpy(tokens), 17, cos, sin)
    np.testing.assert_allclose(got.numpy()[:17], np.asarray(want)[:17], atol=1e-5, rtol=0)


@pytest.mark.parametrize("inp", INPUTS, ids=["str", "strs", "ids", "id_lists"])
@pytest.mark.parametrize("fmt", ["float", "base64"])
async def test_vectors_match_reference(inp, fmt):
    ours, ref = engines()
    mine = await ours.embed(EmbeddingRequest(model="m", input=inp, encoding_format=fmt))
    theirs = await ref.embed(JaxEmbeddingRequest(model="m", input=inp, encoding_format=fmt))
    assert mine.usage.model_dump() == theirs.usage.model_dump()
    assert [d.index for d in mine.data] == [d.index for d in theirs.data]
    for a, b in zip(mine.data, theirs.data, strict=True):
        if fmt == "base64":
            a = np.frombuffer(base64.b64decode(a.embedding), np.float32)
            b = np.frombuffer(base64.b64decode(b.embedding), np.float32)
        else:
            a, b = np.asarray(a.embedding), np.asarray(b.embedding)
        assert a.shape == b.shape == (CFG.hidden_size,)
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        if np.linalg.norm(b) > 0:
            assert abs(np.linalg.norm(a) - 1.0) < 1e-5


async def test_same_text_same_bits_and_refusal():
    ours, ref = engines()
    a = ours.embed_ids(TOKENIZER.encode("hello world"))
    b = ours.embed_ids(TOKENIZER.encode("the quick brown fox"))
    assert np.array_equal(ours.embed_ids(TOKENIZER.encode("hello world")), a)
    assert not np.allclose(a, b)
    # past the protocol's validation (model_construct), the engine refuses itself
    with pytest.raises(ValueError) as mine:
        await ours.embed(EmbeddingRequest.model_construct(model="m", input="x",
                                                          encoding_format="int8"))
    with pytest.raises(ValueError) as theirs:
        await ref.embed(JaxEmbeddingRequest.model_construct(model="m", input="x",
                                                            encoding_format="int8"))
    assert str(mine.value) == str(theirs.value)


async def test_http_embeddings_match_reference_service():
    from dynamo_tpu.llm.http import HttpService as JaxHttpService
    from dynamo_tpu.llm.http import ModelManager as JaxModelManager
    from dynamo_tpu_torch.llm.http import HttpService, ModelManager

    ours, ref = engines()
    bodies = [{"model": "tiny-embed", "input": ["hello world", "the quick brown fox"]},
              {"model": "tiny-embed", "input": [[1, 2, 3], [4, 5]]},
              {"model": "tiny-embed", "input": "hello world", "encoding_format": "base64"},
              {"model": "nope", "input": "x"}]
    answers = {}
    for side, (service_cls, manager_cls, engine) in {
            "ours": (HttpService, ModelManager, ours),
            "ref": (JaxHttpService, JaxModelManager, ref)}.items():
        manager = manager_cls()
        manager.add_embedding_model("tiny-embed", engine)
        service = service_cls(manager, host="127.0.0.1", port=0)
        await service.start()
        try:
            async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{service.port}",
                                         timeout=60) as client:
                answers[side] = [await client.post("/v1/embeddings", json=b) for b in bodies]
        finally:
            await service.stop()
    for mine, theirs in zip(answers["ours"], answers["ref"], strict=True):
        assert mine.status_code == theirs.status_code
        m, t = mine.json(), theirs.json()
        if mine.status_code != 200:
            assert m == t
            continue
        assert m.keys() == t.keys() and m["usage"] == t["usage"] and m["model"] == t["model"]
        assert [d.keys() for d in m["data"]] == [d.keys() for d in t["data"]]
        for a, b in zip(m["data"], t["data"]):
            if isinstance(a["embedding"], str):
                a = np.frombuffer(base64.b64decode(a["embedding"]), np.float32)
                b = np.frombuffer(base64.b64decode(b["embedding"]), np.float32)
            else:
                a, b = np.asarray(a["embedding"]), np.asarray(b["embedding"])
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_bfloat16_trunk_pools_in_float32():
    """At the model's bfloat16 the trunk runs in bfloat16 and the pool and
    the norm in float32: a unit vector to float32's precision (the
    reference's bfloat16 norm rounds its length by up to 2^-9)."""
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    params = llama.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), JPARAMS), "cpu")
    engine = TorchEmbeddingEngine(EmbeddingEngineConfig(model=cfg, max_length=MAX_LEN),
                                  TOKENIZER, params=params, device="cpu")
    vec = engine.embed_ids([5, 6, 7])
    assert vec.dtype == np.float32 and abs(np.linalg.norm(vec) - 1.0) < 1e-5


BF16_ATOL = 2e-2  # a bfloat16 trunk in each package, and the reference's 2^-9 norm


@pytest.mark.parametrize("inp", INPUTS, ids=["str", "strs", "ids", "id_lists"])
async def test_bfloat16_vectors_match_reference(inp):
    """At the served bfloat16 the port's vectors (trunk in bfloat16, pool
    and norm in float32) against ``JaxEmbeddingEngine``'s (all in
    bfloat16) on the same bfloat16 weights, element by element."""
    from dynamo_tpu.llm.tokenizer import HfTokenizer as JaxTokenizer

    jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), JPARAMS)
    ref = JaxEmbeddingEngine(JaxEmbeddingConfig(model=jcfg, max_length=MAX_LEN),
                             JaxTokenizer.from_file(MODEL_DIR / "tokenizer.json"), params=jparams)
    ours = TorchEmbeddingEngine(
        EmbeddingEngineConfig(model=dataclasses.replace(CFG, dtype=torch.bfloat16),
                              max_length=MAX_LEN), TOKENIZER,
        params=llama.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"), device="cpu")
    mine = await ours.embed(EmbeddingRequest(model="m", input=inp))
    theirs = await ref.embed(JaxEmbeddingRequest(model="m", input=inp))
    assert mine.usage.model_dump() == theirs.usage.model_dump()
    for a, b in zip(mine.data, theirs.data, strict=True):
        a, b = np.asarray(a.embedding), np.asarray(b.embedding, np.float32)
        assert a.shape == b.shape == (CFG.hidden_size,)
        np.testing.assert_allclose(a, b, atol=BF16_ATOL, rtol=0)
