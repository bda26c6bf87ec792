"""Multimodal serving in the port against the JAX package's: the same
patch embeddings (the JAX tiny ViT's) through ``TorchLlmEngine.
generate_multimodal`` (device="cpu") and ``JaxLlmEngine.
generate_multimodal`` on tests/data/tiny-chat-model in float32, token ids
byte-identical greedy and seeded, logprobs within 1e-4; decode after a
multimodal prefill equal to a recompute; no prefix publish of multimodal
blocks; the shape and overflow refusals in the reference's words; Gemma-3's
embeddings prefill; ``MultimodalEngine`` over a ``RemoteEncoder`` on the
memory plane bitwise the in-process encoder; the HTTP ``image_url`` chat
completion end to end against the JAX stack; a text-only deployment
refusing an image."""

import asyncio
import base64
import dataclasses
import io
from pathlib import Path

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import gemma3 as jax_gemma3
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.models import vision as jax_vision
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.examples.multimodal.pipeline import MultimodalEngine, TorchVisionEncoder
from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import gemma3, llama, vision
from dynamo_tpu_torch.runtime.engine import Context

MODEL_DIR = Path(__file__).parent / "data" / "tiny-chat-model"
CFG = dataclasses.replace(
    llama.LlamaConfig.from_hf_config(MODEL_DIR / "config.json"), dtype=torch.float32)
JCFG = dataclasses.replace(
    jax_llama.LlamaConfig.from_hf_config(MODEL_DIR / "config.json"), dtype=jnp.float32)
PARAMS = llama.load_hf_weights(CFG, MODEL_DIR, device="cpu")
JPARAMS = jax_llama.load_hf_weights(JCFG, MODEL_DIR)
BASE = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32, 64),
            max_model_len=128)

JVCFG = jax_vision.VisionConfig(**{**jax_vision.VisionConfig.tiny().__dict__,
                                   "projector_dim": CFG.hidden_size})
VCFG = vision.VisionConfig(**{**vision.VisionConfig.tiny().__dict__,
                              "projector_dim": CFG.hidden_size})
JVPARAMS = jax_vision.init_vit_params(JVCFG, jax.random.PRNGKey(1))
VPARAMS = vision.params_from_jax(jax.tree.map(np.asarray, JVPARAMS), "cpu")


def embeds_for(seed: int, frames: int = 0) -> np.ndarray:
    """The JAX encoder's patch embeddings of a random image (or video)."""
    rng = np.random.default_rng(seed)
    shape = (frames or 1, VCFG.image_size, VCFG.image_size, 3)
    img = jnp.asarray(rng.random(shape, np.float32))
    if frames:
        return np.asarray(jax_vision.vit_encode_video(JVPARAMS, JVCFG, img, temporal_pool=2))
    return np.asarray(jax_vision.vit_encode(JVPARAMS, JVCFG, img)[0])


def request(tokens, max_tokens=6, sampling=None, **stop) -> dict:
    return PreprocessedRequest(
        token_ids=list(tokens),
        sampling=sampling or SamplingOptions(use_greedy=True),
        stop=StopConditions(max_tokens=max_tokens, **stop),
        eos_token_ids=[1],
    ).to_wire()


async def drain(stream) -> tuple[list, list]:
    tokens, lps = [], []
    async for item in stream:
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is None:
            continue
        tokens.extend(ann.data.token_ids)
        lps.extend(ann.data.logprobs or [])
    return tokens, lps


async def mm(engine, req, embeds, ctx_cls=Context):
    if embeds is None:
        return await drain(await engine.generate(ctx_cls(req)))
    return await drain(await engine.generate_multimodal(ctx_cls(req), embeds))


def engines(**overrides):
    cfg = {**BASE, **overrides}
    ref = JaxLlmEngine(JaxEngineConfig(model=JCFG, decode_overlap=False, **cfg), params=JPARAMS)
    ours = TorchLlmEngine(EngineConfig(model=CFG, decode_overlap=False, **cfg), params=PARAMS,
                          device="cpu")
    return ours, ref


async def run_both(jobs, **overrides):
    """``jobs`` ((request, embeds or None), ...) through both engines, all
    admitted together; returns (ours, ref, our engine)."""
    ours, ref = engines(**overrides)
    out = []
    for engine, ctx_cls in ((ref, JaxContext), (ours, Context)):
        engine.start()
        try:
            out.append(await asyncio.gather(*[mm(engine, r, e, ctx_cls) for r, e in jobs]))
        finally:
            engine.stop()
    return out[1], out[0], ours


def assert_streams_equal(ours, ref):
    for (t, lp), (rt, rlp) in zip(ours, ref, strict=True):
        assert t == rt
        np.testing.assert_allclose(lp, rlp, atol=1e-4, rtol=0)


SEEDED = SamplingOptions(temperature=0.9, top_k=40, top_p=0.9, seed=17)
PENALIZED = SamplingOptions(temperature=0.7, seed=5, presence_penalty=0.4,
                            frequency_penalty=0.3, repetition_penalty=1.2)


@pytest.mark.parametrize("unified", [True, False])
async def test_streams_match_reference(unified):
    """Image and video prompts, greedy and seeded, beside text-only lanes:
    ids identical to JaxLlmEngine's, logprobs within 1e-4.  The unified
    engine serves the multimodal prefills on the split step (counted under
    ``disagg_or_mm``) and their decode tokens in the unified windows."""
    jobs = [
        (request(range(3, 9), 6), embeds_for(0)),
        (request(range(10, 14), 6, SEEDED), embeds_for(1)),
        (request(range(20, 31), 5, PENALIZED), embeds_for(2)),
        (request(range(5, 9), 4), embeds_for(3, frames=3)),
        (request(range(40, 52), 6), None),
        (request(range(60, 63), 6, SEEDED), None),
    ]
    ours, ref, engine = await run_both(jobs, unified_batch=unified)
    assert_streams_equal(ours, ref)
    stats = engine.stats()
    if unified:
        assert stats["unified_fallbacks"].get("disagg_or_mm", 0) > 0
    assert stats["prefill_graphs_captured"] == 0  # the CPU runs every step eagerly


async def test_top_logprobs_and_stop_tokens_match_reference():
    jobs = [(request(range(3, 9), 5, SamplingOptions(use_greedy=True, top_logprobs=3)),
             embeds_for(4)),
            (request(range(3, 9), 8, stop_token_ids=[12]), embeds_for(5))]
    ours, ref, _ = await run_both(jobs)
    assert_streams_equal(ours, ref)


async def test_decode_after_mm_prefill_matches_recompute():
    """Paged decode after a multimodal prefill equals a recompute with the
    sampled token appended as text."""
    engine = TorchLlmEngine(EngineConfig(model=CFG, **BASE), params=PARAMS, device="cpu")
    engine.start()
    try:
        prompt, embeds = list(range(3, 9)), embeds_for(6)
        two, _ = await mm(engine, request(prompt, 2, ignore_eos=True), embeds)
        one, _ = await mm(engine, request(prompt, 1, ignore_eos=True), embeds)
        extended, _ = await mm(engine, request(prompt + one, 1, ignore_eos=True), embeds)
        assert two == one + extended
    finally:
        engine.stop()


async def test_mm_blocks_never_publish():
    """A multimodal prompt's blocks neither match nor enter the prefix
    registry (no stored event, nothing cached), and a text prompt after it
    still matches the reference."""
    events = []
    engine = TorchLlmEngine(EngineConfig(model=CFG, **BASE), params=PARAMS, device="cpu",
                            event_sink=events.append)
    engine.start()
    try:
        prompt = list(range(3, 27))
        first, _ = await mm(engine, request(prompt, 9, ignore_eos=True), embeds_for(0))
        again, _ = await mm(engine, request(prompt, 9, ignore_eos=True), embeds_for(0))
        assert first == again
        assert engine.allocator.cached_blocks == 0
        assert not [e for e in events if e.kind == "stored"]
        assert engine.stats()["prefix_hits_total"] == 0
    finally:
        engine.stop()


async def test_refusals_match_reference():
    ours, ref = engines(max_model_len=32)
    bad = [(request([3, 4], 2), np.zeros((4, 7), np.float32)),
           (request(list(range(3, 30)), 2), np.zeros((16, CFG.hidden_size), np.float32))]
    try:
        for req, embeds in bad:
            with pytest.raises(ValueError) as mine:
                await ours.generate_multimodal(Context(req), embeds)
            with pytest.raises(ValueError) as theirs:
                await ref.generate_multimodal(JaxContext(req), embeds)
            assert str(mine.value) == str(theirs.value)
        # guided on an engine with no guided table: refused as the reference refuses
        guided = dict(request([3, 4], 2), output_format="json")
        embeds = np.zeros((4, CFG.hidden_size), np.float32)
        with pytest.raises(ValueError) as mine:
            await ours.generate_multimodal(Context(guided), embeds)
        with pytest.raises(ValueError) as theirs:
            await ref.generate_multimodal(JaxContext(guided), embeds)
        assert str(mine.value) == str(theirs.value)
        # an image reaching the text engine itself is refused too
        with pytest.raises(ValueError, match="does not accept image/video input"):
            await ours.generate(Context(dict(request([3], 2), image=[[0.0]])))
    finally:
        ours.stop()
        ref.stop()


async def test_family_without_embeds_prefill_is_refused():
    from dynamo_tpu_torch.models import gemma2

    cfg = gemma2.Gemma2Config.tiny()
    engine = TorchLlmEngine(EngineConfig(model=cfg, model_family="gemma2", **BASE),
                            device="cpu")
    with pytest.raises(ValueError, match="has no multimodal prefill"):
        await engine.generate_multimodal(Context(request([3], 2)),
                                         np.zeros((4, cfg.hidden_size), np.float32))


def test_gemma3_prefill_embeds_matches_reference():
    """``gemma3_forward_prefill_embeds`` on the same spliced embeddings (the
    family's scaled text embeddings after random patch rows) against the
    JAX forward; the token prefill is the embeddings prefill of ``embed``."""
    jcfg = dataclasses.replace(jax_gemma3.Gemma3Config.tiny(), dtype=jnp.float32)
    cfg = dataclasses.replace(gemma3.Gemma3Config.tiny(), dtype=torch.float32)
    jparams = jax_gemma3.init_params(jcfg, jax.random.PRNGKey(2))
    params = gemma3.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    n, s, bs = 5, 24, 4
    tokens = np.random.default_rng(0).integers(3, cfg.vocab_size, s).astype(np.int32)
    patches = np.random.default_rng(1).normal(size=(n, cfg.hidden_size)).astype(np.float32)
    jx = jnp.concatenate([jnp.asarray(patches),
                          jax_gemma3._embed(jparams, jcfg, jnp.asarray(tokens[n:]))])
    jcos, jsin = jax_gemma3.make_rope_tables(jcfg)
    jcache = jax_llama.init_kv_cache(jcfg, s // bs + 1, bs)
    block_ids = np.arange(s // bs + 1, dtype=np.int32)
    want, _ = jax_gemma3.gemma3_forward_prefill_embeds(
        jparams, jcfg, jx, jcache, jnp.asarray(block_ids), jnp.int32(s - 2), jnp.int32(0),
        jcos, jsin)
    from dynamo_tpu_torch.models.registry import get_family

    family = get_family("gemma3")
    x = torch.cat([torch.from_numpy(patches),
                   family.embed(params, cfg, torch.from_numpy(tokens[n:]).long())])
    cos, sin = gemma3.make_rope_tables(cfg, "cpu")
    cache = llama.init_kv_cache(cfg, s // bs + 1, bs, device="cpu")
    got, _ = family.forward_prefill_embeds(params, cfg, x, cache, torch.from_numpy(block_ids),
                                           s - 2, 0, cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


async def test_gemma3_engine_streams_match_reference():
    jcfg = dataclasses.replace(jax_gemma3.Gemma3Config.tiny(), dtype=jnp.float32)
    cfg = dataclasses.replace(gemma3.Gemma3Config.tiny(), dtype=torch.float32)
    jparams = jax_gemma3.init_params(jcfg, jax.random.PRNGKey(4))
    params = gemma3.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    kw = dict(BASE, model_family="gemma3", decode_overlap=False)
    ref = JaxLlmEngine(JaxEngineConfig(model=jcfg, **kw), params=jparams)
    ours = TorchLlmEngine(EngineConfig(model=cfg, **kw), params=params, device="cpu")
    rng = np.random.default_rng(3)
    jobs = [(request(range(3, 12), 5), rng.normal(size=(6, cfg.hidden_size)).astype(np.float32)),
            (request(range(7, 10), 5, SEEDED),
             rng.normal(size=(9, cfg.hidden_size)).astype(np.float32))]
    out = []
    for engine, ctx_cls in ((ref, JaxContext), (ours, Context)):
        engine.start()
        try:
            out.append(await asyncio.gather(*[mm(engine, r, e, ctx_cls) for r, e in jobs]))
        finally:
            engine.stop()
    assert_streams_equal(out[1], out[0])


async def test_remote_encoder_is_bitwise_the_local_one():
    """``MultimodalEngine`` over a ``RemoteEncoder`` (an encode-worker
    component on the memory plane, raw bytes in the two-part frames):
    embeddings and streams bitwise the in-process encoder's, image and
    video."""
    from dynamo_tpu_torch.examples.multimodal.components import (
        RemoteEncoder,
        serve_encode_worker,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    encoder = TorchVisionEncoder(VCFG, params=VPARAMS, device="cpu")
    llm = TorchLlmEngine(EngineConfig(model=CFG, **BASE), params=PARAMS, device="cpu")
    llm.start()
    runtime = await DistributedRuntime.create(RuntimeConfig(control_plane="memory://mm-test"))
    service = await serve_encode_worker(runtime, encoder)
    remote = await RemoteEncoder.connect(runtime)
    try:
        rng = np.random.default_rng(9)
        image = rng.random((20, 13, 3), np.float32)
        video = rng.random((3, 16, 16, 3), np.float32)
        np.testing.assert_array_equal(await remote.aencode(image), encoder.encode(image))
        np.testing.assert_array_equal(await remote.aencode_video(video, temporal_pool=2),
                                      encoder.encode_video(video, temporal_pool=2))
        got = {}
        for name, enc in (("local", encoder), ("remote", remote)):
            engine = MultimodalEngine(llm, enc)
            streams = []
            for extra in ({"image": image.tolist()},
                          {"video": video.tolist(), "video_temporal_pool": 3},
                          {}):
                req = {**request(range(3, 10), 5), **extra}
                streams.append(await drain(await engine.generate(Context(req))))
            got[name] = streams
        assert got["remote"] == got["local"]
        with pytest.raises(ValueError, match="one modality per request"):
            await MultimodalEngine(llm, encoder).generate(
                Context({**request([3], 2), "image": image.tolist(), "video": video.tolist()}))
        with pytest.raises(ValueError, match="video_temporal_pool must be in"):
            await MultimodalEngine(llm, encoder).generate(
                Context({**request([3], 2), "video": video.tolist(), "video_temporal_pool": 9}))
    finally:
        await remote.close()
        await service.shutdown(drain_timeout=2)
        await runtime.close()
        llm.stop()


# ---------------------------------------------------------------------------
# the HTTP front door
# ---------------------------------------------------------------------------


def _png(color=None, size: int = 20) -> str:
    from PIL import Image

    if color is None:
        arr = np.random.default_rng(11).integers(0, 256, size=(size, size, 3), dtype=np.uint8)
        img = Image.fromarray(arr)
    else:
        img = Image.new("RGB", (size, size), color)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


async def _stack(port_side: bool, engine_core=None):
    """The reference test's multimodal service (random tiny weights, so the
    image moves the logprobs), on either package; the same weights."""
    if port_side:
        from dynamo_tpu_torch.llm.backend import Backend
        from dynamo_tpu_torch.llm.http import HttpService, ModelManager
        from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
        from dynamo_tpu_torch.llm.preprocessor import ChatPreprocessor
        from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
    else:
        from dynamo_tpu.llm.backend import Backend
        from dynamo_tpu.llm.http import HttpService, ModelManager
        from dynamo_tpu.llm.model_card import ModelDeploymentCard
        from dynamo_tpu.llm.preprocessor import ChatPreprocessor
        from dynamo_tpu.llm.tokenizer import HfTokenizer
    mdc = ModelDeploymentCard.from_local_path(MODEL_DIR, name="tiny")
    tokenizer = HfTokenizer.from_file(MODEL_DIR / "tokenizer.json")
    llm = None
    if engine_core is None:
        jcfg = jax_llama.LlamaConfig.tiny(vocab_size=481)
        jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(3))
        kw = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(32, 64),
                  max_model_len=128, decode_overlap=False)
        if port_side:
            cfg = llama.LlamaConfig.tiny(vocab_size=481)
            llm = TorchLlmEngine(EngineConfig(model=cfg, **kw), device="cpu",
                                 params=llama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                                              "cpu"))
            encoder = TorchVisionEncoder(VCFG, params=VPARAMS, device="cpu")
            engine_core = MultimodalEngine(llm, encoder)
        else:
            from examples.multimodal.pipeline import JaxVisionEncoder
            from examples.multimodal.pipeline import MultimodalEngine as JaxMultimodalEngine

            llm = JaxLlmEngine(JaxEngineConfig(model=jcfg, **kw), params=jparams)
            engine_core = JaxMultimodalEngine(llm, JaxVisionEncoder(JVCFG, params=JVPARAMS))
        llm.start()
    manager = ModelManager()
    manager.add_chat_model(
        "tiny", ChatPreprocessor(mdc, tokenizer).wrap(Backend(tokenizer).wrap(engine_core)))
    service = HttpService(manager, host="127.0.0.1", port=0)
    await service.start()
    return service, llm


async def _chat(port: int, content) -> httpx.Response:
    async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{port}", timeout=120) as client:
        return await client.post("/v1/chat/completions", json={
            "model": "tiny", "max_tokens": 6, "logprobs": True,
            "messages": [{"role": "user", "content": content}]})


async def test_image_chat_completion_matches_the_jax_stack():
    """An ``image_url`` (data: PNG) chat completion through the port's
    preprocessor, backend, ``MultimodalEngine`` and engine: the same tokens
    as the JAX stack's, logprobs within 1e-4; an undecodable image is a
    400."""
    contents = {
        "text": "describe the image",
        "red": [{"type": "text", "text": "describe the image"},
                {"type": "image_url", "image_url": {"url": _png((255, 0, 0))}}],
        "noise": [{"type": "text", "text": "describe the image"},
                  {"type": "image_url", "image_url": {"url": _png()}}],
    }
    got = {}
    for side in ("ref", "ours"):
        service, llm = await _stack(side == "ours")
        try:
            for name, content in contents.items():
                r = await _chat(service.port, content)
                assert r.status_code == 200, r.text
                got[side, name] = [(e["token"], e["logprob"])
                                   for e in r.json()["choices"][0]["logprobs"]["content"]]
            if side == "ours":
                mm_prefills = llm.stats()["unified_fallbacks"]["disagg_or_mm"]
                bad = await _chat(service.port, [{"type": "image_url", "image_url": {
                    "url": "data:image/png;base64,aGk="}}])
                assert bad.status_code == 400
                assert "decodable" in bad.json()["error"]["message"]
        finally:
            await service.stop()
            llm.stop()
    for name in contents:
        ours, ref = got["ours", name], got["ref", name]
        assert [t for t, _ in ours] == [t for t, _ in ref]
        np.testing.assert_allclose([lp for _, lp in ours], [lp for _, lp in ref], atol=1e-4)
    # both image requests took the multimodal prefill (the split step)
    assert mm_prefills == 2


async def test_text_only_deployment_rejects_image_requests():
    """As the reference's test of the same name: a deployment without a
    multimodal engine answers an image-bearing request with a 400."""
    from dynamo_tpu_torch.llm.engines import EchoEngineCore

    service, _ = await _stack(True, engine_core=EchoEngineCore())
    try:
        r = await _chat(service.port, [{"type": "text", "text": "hi"},
                                       {"type": "image_url", "image_url": {"url": _png((1, 2, 3))}}])
        assert r.status_code == 400
        assert "does not accept image" in r.json()["error"]["message"]
    finally:
        await service.stop()


async def test_image_url_resolution_and_wire_form():
    """The port's copy of llm/multimodal.py: schemes, the SSRF guard and the
    wire codec, as the reference's unit tests hold them."""
    from dynamo_tpu_torch.llm.multimodal import (
        decode_image_wire,
        encode_image_wire,
        resolve_image,
    )

    arr = await resolve_image(_png((0, 128, 255)))
    assert arr.shape == (20, 20, 3) and arr.dtype == np.float32
    np.testing.assert_allclose(arr[0, 0], [0, 128 / 255, 1], atol=1e-7)
    with pytest.raises(ValueError, match="scheme"):
        await resolve_image("file:///etc/passwd")
    with pytest.raises(ValueError, match="non-global"):
        await resolve_image("http://127.0.0.1:1/img.png")
    np.testing.assert_array_equal(decode_image_wire(encode_image_wire(arr)), arr)
