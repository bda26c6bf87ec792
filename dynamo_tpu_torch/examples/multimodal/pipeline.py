"""Multimodal serving pipeline: encode → prefill → decode (counterpart of
examples/multimodal/pipeline.py; reference: examples/multimodal —
encode_worker.py:61 produces image embeddings that the LLM worker
consumes).

Components:
- ``TorchVisionEncoder``: the ViT and its LLaVA-style projector
  (``models/vision.py``) on the device; an image of any size is first
  resized to the ViT's square input as ``jax.image.resize(method=
  "bilinear")`` resizes it (``resize_bilinear``).
- ``MultimodalEngine``: wraps a ``TorchLlmEngine``; a request carrying an
  ``image`` (the frontend's wire form, or an [H, W, 3] float array) or a
  ``video`` ([T, H, W, 3] frames) has its patch embeddings spliced before
  the text tokens through ``generate_multimodal``.

Run in process (the tiny model on the CPU; drop ``--device cpu`` on a card):
    python -m dynamo_tpu_torch.examples.multimodal.pipeline \\
        --model tests/data/tiny-chat-model --device cpu [--remote-encode] [--video]
Serve the OpenAI frontend (``image_url`` chat completions end to end):
    ... --serve PORT [--remote-encode]
An encode worker of its own on a control plane (``RemoteEncoder`` calls it):
    ... --encode-worker --control-plane HOST:PORT [--vision-config config.json]
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.engine import _to_device
from dynamo_tpu_torch.models.vision import (
    VisionConfig,
    init_vit_params,
    vit_encode,
    vit_encode_video,
)
from dynamo_tpu_torch.runtime.engine import Context, ResponseStream
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

logger = get_logger("examples.multimodal")

# the wire-facing bound of the temporal pool (the reference's: there each
# value compiles a program of its own; here it bounds the frames a request
# can make the encoder pool)
MAX_TEMPORAL_POOL = 8


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """The [in_size, out_size] float32 weights of one axis of
    ``jax.image.resize(method="bilinear")`` (antialias on, its default):
    a triangle kernel at half-pixel centres, widened by the ratio when
    downsampling (a low-pass filter), each output's weights renormalised
    to sum to 1, outputs whose sample falls outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[..., H, W, C] float32 -> [..., height, width, C], each axis whose
    size changes resized by its ``resize_weights`` matrix (two products,
    on ``x``'s device)."""
    if x.shape[-3] != height:
        wh = torch.from_numpy(resize_weights(x.shape[-3], height)).to(x.device)
        x = torch.einsum("...hwc,hH->...Hwc", x, wh)
    if x.shape[-2] != width:
        ww = torch.from_numpy(resize_weights(x.shape[-2], width)).to(x.device)
        x = torch.einsum("...hwc,wW->...hWc", x, ww)
    return x


class TorchVisionEncoder:
    """The encode worker's engine: images and video frames -> projected
    embeddings, on ``device`` (the card unless ``device="cpu"``).  Runs
    eagerly."""

    def __init__(self, cfg: VisionConfig, params=None, seed: int = 0, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_vit_params(cfg, gen, self.device)
        self.params = _to_device(params, self.device)

    def _fit(self, x: np.ndarray) -> torch.Tensor:
        """Images or frames ([..., H, W, 3]) on the device at the ViT's
        square input size."""
        size = self.cfg.image_size
        t = torch.as_tensor(np.array(x, np.float32), device=self.device)
        return resize_bilinear(t, size, size)

    def encode(self, image: np.ndarray) -> np.ndarray:
        """[H, W, 3] float image -> [num_patches, projector_dim] float32.
        The frontend ships decoded images unresized: the geometry belongs
        next to the encoder that knows its ``image_size``."""
        x = self._fit(image)[None].to(self.cfg.dtype)
        with torch.inference_mode():
            return vit_encode(self.params, self.cfg, x)[0].cpu().numpy()

    def encode_video(self, frames: np.ndarray, *, temporal_pool: int = 2) -> np.ndarray:
        """[T, H, W, 3] frames -> [ceil(T / pool) * num_patches, dim] float32."""
        if not 1 <= temporal_pool <= MAX_TEMPORAL_POOL:
            raise ValueError(
                f"temporal_pool must be in [1, {MAX_TEMPORAL_POOL}], got {temporal_pool}"
            )
        x = self._fit(frames).to(self.cfg.dtype)
        with torch.inference_mode():
            return vit_encode_video(self.params, self.cfg, x,
                                    temporal_pool=temporal_pool).cpu().numpy()

    # the async surface shared with components.RemoteEncoder (the LLM side
    # awaits the same methods whether encoding is in process or remote)
    async def aencode(self, image: np.ndarray) -> np.ndarray:
        return await asyncio.to_thread(self.encode, np.asarray(image, np.float32))

    async def aencode_video(self, frames: np.ndarray, *, temporal_pool: int = 2) -> np.ndarray:
        return await asyncio.to_thread(
            lambda: self.encode_video(np.asarray(frames, np.float32),
                                      temporal_pool=temporal_pool))

    async def generate(self, request: Context[dict]) -> ResponseStream[dict]:
        embeds = await self.aencode(np.asarray(request.data["image"], np.float32))

        async def gen():
            yield {"embeds": embeds.tolist()}

        return ResponseStream(gen(), request.ctx)


class MultimodalEngine:
    """AsyncEngine wrapper: image- and video-carrying requests go through
    the encoder (an in-process TorchVisionEncoder or a RemoteEncoder
    component), text-only requests straight to the LLM engine."""

    def __init__(self, llm_engine, encoder):
        self.llm = llm_engine
        self.encoder = encoder

    async def generate(self, request: Context[dict]) -> ResponseStream[dict]:
        from dynamo_tpu_torch.llm.multimodal import decode_image_wire

        data = dict(request.data)
        image = data.pop("image", None)
        if image is not None:
            # the frontend ships the compact b64 wire form; direct API
            # callers may still attach raw arrays or lists
            image = decode_image_wire(image)
        video = data.pop("video", None)
        temporal_pool = int(data.pop("video_temporal_pool", 2))
        if image is not None and video is not None:
            raise ValueError(
                "request carries both 'image' and 'video'; attach one "
                "modality per request"
            )
        if not 1 <= temporal_pool <= MAX_TEMPORAL_POOL:
            raise ValueError(
                f"video_temporal_pool must be in [1, {MAX_TEMPORAL_POOL}], "
                f"got {temporal_pool}"
            )
        inner = Context(data, request.ctx)
        if image is None and video is None:
            return await self.llm.generate(inner)
        if video is not None:
            embeds = await self.encoder.aencode_video(
                np.asarray(video, np.float32), temporal_pool=temporal_pool)
        else:
            embeds = await self.encoder.aencode(np.asarray(image, np.float32))
        return await self.llm.generate_multimodal(inner, embeds)

    def stats(self) -> dict:
        return self.llm.stats()


def _tiny_vision(llm_hidden: int) -> VisionConfig:
    """The demo encoder: the tiny ViT, its projector into the LLM's width."""
    return VisionConfig(**{**VisionConfig.tiny().__dict__, "projector_dim": llm_hidden})


@dataclass
class MultimodalService:
    """A running multimodal engine: the LLM engine, the wrapper, the local
    encoder, with ``remote_encode`` the in-process runtime that serves it
    as an encode-worker component, and the HTTP service once one is
    started over it."""

    llm: Any
    engine: MultimodalEngine | None = None
    encoder: TorchVisionEncoder | None = None
    runtime: Any = None
    encode_service: Any = None
    remote: Any = None
    service: Any = None

    async def shutdown(self) -> None:
        if self.service is not None:
            await self.service.stop()
        if self.remote is not None:
            await self.remote.close()
        if self.encode_service is not None:
            await self.encode_service.shutdown(drain_timeout=2)
        if self.runtime is not None:
            await self.runtime.close()
        self.llm.stop()


async def start_engine(model_dir: str, *, remote_encode: bool = False, device=None,
                       name: str = "mm-demo", vision: VisionConfig | None = None,
                       vision_seed: int = 0, **engine_kw) -> MultimodalService:
    """The multimodal engine, started: the LLM engine (``engine_kw`` go to
    ``build_torch_engine``, the demo's small pool by default) behind a
    ``MultimodalEngine`` over the ViT of ``vision`` (default the tiny ViT
    into the LLM's width).  With ``remote_encode`` the encoder serves its
    own runtime component (an in-process memory plane, the reference's
    separate-encode-worker shape) and the LLM side calls it."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.serve import build_torch_engine

    mdc = ModelDeploymentCard.from_local_path(model_dir, name=name)
    engine_kw = {**dict(num_blocks=64, max_batch_size=4, max_model_len=256,
                        prefill_buckets=(64, 128)), **engine_kw}
    llm = build_torch_engine(model_dir, mdc, device=device, **engine_kw)
    llm.start()
    handle = MultimodalService(llm)
    try:
        handle.encoder = TorchVisionEncoder(
            vision or _tiny_vision(llm.config.model.hidden_size), seed=vision_seed,
            device=llm.device)
        if remote_encode:
            from dynamo_tpu_torch.examples.multimodal.components import (
                RemoteEncoder,
                serve_encode_worker,
            )
            from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
            from dynamo_tpu_torch.utils.config import RuntimeConfig

            handle.runtime = await DistributedRuntime.create(
                RuntimeConfig(control_plane=f"memory://{name}-encode"))
            handle.encode_service = await serve_encode_worker(handle.runtime, handle.encoder)
            handle.remote = await RemoteEncoder.connect(handle.runtime)
        handle.engine = MultimodalEngine(
            llm, handle.encoder if handle.remote is None else handle.remote)
    except BaseException:
        await handle.shutdown()
        raise
    return handle


async def start_http(model_dir: str, port: int = 0, *, remote_encode: bool = False,
                     device=None, name: str = "mm-demo", vision: VisionConfig | None = None,
                     vision_seed: int = 0, host: str = "127.0.0.1",
                     **engine_kw) -> MultimodalService:
    """The OpenAI frontend over ``start_engine``'s multimodal engine,
    started: an ``image_url`` chat completion (``data:`` or http(s)) is
    decoded at the frontend (llm/multimodal.py), encoded by the ViT and
    spliced ahead of the text."""
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.http import HttpService, ModelManager
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import ChatPreprocessor
    from dynamo_tpu_torch.llm.tokenizer import HfTokenizer

    handle = await start_engine(model_dir, remote_encode=remote_encode, device=device,
                                name=name, vision=vision, vision_seed=vision_seed, **engine_kw)
    try:
        mdc = ModelDeploymentCard.from_local_path(model_dir, name=name)
        tokenizer = HfTokenizer.from_model_dir(model_dir)
        manager = ModelManager()
        manager.add_chat_model(
            name, ChatPreprocessor(mdc, tokenizer).wrap(Backend(tokenizer).wrap(handle.engine)))
        handle.service = HttpService(manager, host=host, port=port)
        await handle.service.start()
    except BaseException:
        await handle.shutdown()
        raise
    return handle


async def _until_signal() -> None:
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()


async def serve_http(model_dir: str, port: int, *, remote_encode: bool = False,
                     device=None) -> int:
    """``start_http``, serving until SIGINT or SIGTERM."""
    handle = await start_http(model_dir, port, remote_encode=remote_encode, device=device)
    try:
        print(
            f"\nmultimodal frontend on http://127.0.0.1:{handle.service.port} — try:\n"
            "  curl -s http://127.0.0.1:%d/v1/chat/completions \\\n"
            "    -H 'Content-Type: application/json' -d '{\"model\": \"mm-demo\", "
            '"max_tokens": 16, "messages": [{"role": "user", "content": ['
            '{"type": "text", "text": "describe"}, {"type": "image_url", '
            '"image_url": {"url": "data:image/png;base64,<...>"}}]}]}\'\n'
            % handle.service.port,
            flush=True,
        )
        await _until_signal()
    finally:
        await handle.shutdown()
    return 0


async def amain(model_dir: str, *, remote_encode: bool = False, video: bool = False,
                device=None) -> int:
    """One demo request, image- or video-conditioned, in process."""
    from dynamo_tpu_torch.llm.protocols.common import (
        Annotated,
        LLMEngineOutput,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    handle = await start_engine(model_dir, remote_encode=remote_encode, device=device,
                                max_model_len=128, prefill_buckets=(32, 64))
    try:
        rng = np.random.default_rng(0)
        request = PreprocessedRequest(
            token_ids=[5, 6, 7],
            sampling=SamplingOptions(use_greedy=True),
            stop=StopConditions(max_tokens=8),
            eos_token_ids=[],
        ).to_wire()
        size = handle.encoder.cfg.image_size
        if video:
            request["video"] = rng.random((4, size, size, 3), np.float32).tolist()
        else:
            request["image"] = rng.random((size, size, 3), np.float32).tolist()
        stream = await handle.engine.generate(Context(request))
        tokens = []
        async for item in stream:
            ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
            if ann.data is not None:
                tokens.extend(ann.data.token_ids)
        kind = "video" if video else "image"
        via = "remote encode worker" if remote_encode else "in-process encoder"
        print(f"generated ({kind}-conditioned, {via}):", tokens)
    finally:
        await handle.shutdown()
    return 0


async def run_encode_worker(control_plane: str, *, vision_config: str | None = None,
                            llm_hidden_size: int | None = None, seed: int = 0,
                            device=None) -> int:
    """An encode worker of its own: a ``TorchVisionEncoder`` (the ViT of
    ``vision_config``, an HF config.json, else the tiny one) from ``seed``,
    served as the ``dynamo/encoder/encode`` component on the control plane
    at ``control_plane`` until SIGINT or SIGTERM.  Prints ``ENCODE_READY``
    on stdout once it serves."""
    from dynamo_tpu_torch.examples.multimodal.components import serve_encode_worker
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    if vision_config is not None:
        cfg = VisionConfig.from_hf_config(vision_config, llm_hidden_size=llm_hidden_size)
    else:
        cfg = _tiny_vision(llm_hidden_size or VisionConfig.tiny().projector_dim)
    encoder = TorchVisionEncoder(cfg, seed=seed, device=device)
    runtime = await DistributedRuntime.create(RuntimeConfig(control_plane=control_plane))
    service = await serve_encode_worker(runtime, encoder)
    print("ENCODE_READY", flush=True)
    try:
        await _until_signal()
    finally:
        await service.shutdown(drain_timeout=2)
        await runtime.close()
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", default="tests/data/tiny-chat-model")
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the CUDA card)")
    parser.add_argument("--remote-encode", action="store_true",
                        help="serve the encoder as its own runtime component")
    parser.add_argument("--video", action="store_true",
                        help="condition on 4 video frames instead of one image")
    parser.add_argument("--serve", type=int, metavar="PORT", default=None,
                        help="serve the OpenAI frontend instead of the demo "
                        "request: image_url chat completions end to end")
    parser.add_argument("--encode-worker", action="store_true",
                        help="run an encode worker on --control-plane instead")
    parser.add_argument("--control-plane", default=None, help="HOST:PORT of a dynctl server")
    parser.add_argument("--vision-config", default=None,
                        help="an HF config.json with a vision_config (LLaVA) or a bare "
                        "CLIP vision config; default the tiny ViT")
    parser.add_argument("--llm-hidden-size", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    configure_logging()
    if args.encode_worker:
        if not args.control_plane:
            parser.error("--encode-worker needs --control-plane")
        return asyncio.run(run_encode_worker(
            args.control_plane, vision_config=args.vision_config,
            llm_hidden_size=args.llm_hidden_size, seed=args.seed, device=args.device))
    if args.serve is not None:
        return asyncio.run(serve_http(args.model, args.serve,
                                      remote_encode=args.remote_encode, device=args.device))
    return asyncio.run(amain(args.model, remote_encode=args.remote_encode, video=args.video,
                             device=args.device))


if __name__ == "__main__":
    sys.exit(main())
