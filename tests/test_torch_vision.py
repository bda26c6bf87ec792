"""The port's vision encoder against the JAX package's on the same numpy
weights (dynamo_tpu_torch/models/vision.py against dynamo_tpu/models/
vision.py): patchify, ``vit_encode`` and ``vit_encode_video`` at the tiny
geometry in float32 (1e-5) and bfloat16 (2e-2), the encoder's resize
against ``jax.image.resize(method="bilinear")`` downsampling and
upsampling (1e-5), the tanh GELU and the biased-variance LayerNorm, and
``VisionConfig.from_hf_config`` on a LLaVA config and a bare CLIP one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import vision as jvision
from dynamo_tpu.ops.norms import layer_norm as jax_layer_norm
from dynamo_tpu_torch.examples.multimodal.pipeline import (
    MAX_TEMPORAL_POOL,
    TorchVisionEncoder,
    resize_bilinear,
)
from dynamo_tpu_torch.models import vision
from dynamo_tpu_torch.ops.norms import layer_norm

JCFG = jvision.VisionConfig.tiny()
CFG = vision.VisionConfig.tiny()
JPARAMS = jvision.init_vit_params(JCFG, jax.random.PRNGKey(1))
PARAMS = vision.params_from_jax(jax.tree.map(np.asarray, JPARAMS), "cpu")

LLAVA = {
    "model_type": "llava",
    "vision_config": {"hidden_size": 1024, "image_size": 336, "intermediate_size": 4096,
                      "model_type": "clip_vision_model", "num_attention_heads": 16,
                      "num_hidden_layers": 24, "patch_size": 14, "projection_dim": 768},
    "text_config": {"model_type": "llama", "hidden_size": 4096, "vocab_size": 32064},
}


def images(n: int, seed: int = 0, size: int = 16) -> np.ndarray:
    return np.random.default_rng(seed).random((n, size, size, 3), np.float32)


def test_patchify_is_the_reference_reshape():
    x = images(2)
    want = np.asarray(jvision.patchify(jnp.asarray(x), 8))
    got = vision.patchify(torch.from_numpy(x), 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_vit_encode_matches_reference_float32():
    x = images(3, seed=1)
    want = np.asarray(jvision.vit_encode(JPARAMS, JCFG, jnp.asarray(x)))
    got = vision.vit_encode(PARAMS, CFG, torch.from_numpy(x)).numpy()
    assert got.shape == (3, CFG.num_patches, CFG.projector_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_vit_encode_matches_reference_bfloat16():
    jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), JPARAMS)
    params = vision.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    x = images(2, seed=2)
    want = np.asarray(jvision.vit_encode(jparams, jcfg, jnp.asarray(x)))
    got = vision.vit_encode(params, cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("frames,pool", [(4, 2), (5, 2), (3, 1), (7, 3)])
def test_vit_encode_video_matches_reference(frames, pool):
    x = images(frames, seed=3)
    want = np.asarray(jvision.vit_encode_video(JPARAMS, JCFG, jnp.asarray(x),
                                               temporal_pool=pool))
    got = vision.vit_encode_video(PARAMS, CFG, torch.from_numpy(x), temporal_pool=pool).numpy()
    assert got.shape == (-(-frames // pool) * CFG.num_patches, CFG.projector_dim)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="temporal_pool"):
        vision.vit_encode_video(PARAMS, CFG, torch.from_numpy(x), temporal_pool=0)


@pytest.mark.parametrize("shape,out", [
    ((37, 23, 3), (16, 16)),      # downsampling both axes (antialiased)
    ((7, 9, 3), (16, 16)),        # upsampling both axes
    ((48, 10, 3), (16, 16)),      # one of each
    ((2, 40, 16, 3), (16, 16)),   # frames: the leading axis kept, one axis resized
    ((500, 336, 3), (336, 336)),  # a photo to the LLaVA input
])
def test_resize_matches_jax_image_resize(shape, out):
    x = np.random.default_rng(4).random(shape, np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape[:-3] + out + (3,),
                                       method="bilinear"))
    got = resize_bilinear(torch.from_numpy(x), *out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_encoder_resizes_and_encodes_as_the_reference_encoder():
    from examples.multimodal.pipeline import JaxVisionEncoder

    ref = JaxVisionEncoder(JCFG, params=JPARAMS)
    ours = TorchVisionEncoder(CFG, params=PARAMS, device="cpu")
    image = np.random.default_rng(5).random((30, 21, 3), np.float32)
    np.testing.assert_allclose(ours.encode(image), ref.encode(image), atol=1e-5, rtol=0)
    frames = np.random.default_rng(6).random((3, 12, 20, 3), np.float32)
    np.testing.assert_allclose(ours.encode_video(frames, temporal_pool=2),
                               ref.encode_video(frames, temporal_pool=2), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="temporal_pool must be in"):
        ours.encode_video(frames, temporal_pool=MAX_TEMPORAL_POOL + 1)


def test_gelu_is_the_tanh_form_and_layer_norm_the_biased_variance():
    x = np.random.default_rng(7).normal(size=(5, 33)).astype(np.float32) * 3
    np.testing.assert_allclose(vision._gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6, rtol=0)
    w = np.random.default_rng(8).normal(size=(33,)).astype(np.float32)
    b = np.random.default_rng(9).normal(size=(33,)).astype(np.float32)
    got = layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-6).numpy()
    want = np.asarray(jax_layer_norm(*map(jnp.asarray, (x, w, b)), 1e-6))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # torch.var's default (unbiased) variance would miss the tolerance
    t = torch.from_numpy(x)
    unbiased = ((t - t.mean(-1, keepdim=True)) / torch.sqrt(t.var(-1, keepdim=True) + 1e-6)
                * torch.from_numpy(w) + torch.from_numpy(b)).numpy()
    assert np.abs(unbiased - want).max() > 1e-3


@pytest.mark.parametrize("config,kw", [
    (LLAVA, {}),
    (LLAVA["vision_config"], {"llm_hidden_size": 2048}),   # a bare CLIP config
    ({**LLAVA["vision_config"], "hidden_size": 768}, {}),  # bare, no LLM width given
    ({"vision_config": LLAVA["vision_config"], "hidden_size": 5120}, {}),  # older LLaVA
])
def test_from_hf_config_matches_reference(config, kw):
    ours = vision.VisionConfig.from_hf_config(config, **kw)
    ref = jvision.VisionConfig.from_hf_config(config, **kw)
    fields = [f.name for f in dataclasses.fields(ours) if f.name != "dtype"]
    assert {f: getattr(ours, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    assert ours.num_patches == ref.num_patches and ours.head_dim == ref.head_dim


def test_init_params_layout_matches_reference():
    gen = torch.Generator().manual_seed(0)
    ours = vision.init_vit_params(CFG, gen, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(JPARAMS)[0]
    assert len(flat) == sum(1 for _ in _leaves(ours))
    for path, leaf in flat:
        node = ours
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
