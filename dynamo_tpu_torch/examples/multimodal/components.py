"""Multimodal encode worker as a SEPARATE runtime component (counterpart of
examples/multimodal/components.py).

The reference runs encoding in its own worker process and ships embeddings
to the LLM worker by descriptor (reference:
examples/multimodal/components/encode_worker.py:61 — NIXL RDMA descriptors
over NATS).  Here, as in the JAX package, the runtime's own data plane
carries them: the encode worker serves a control-plane endpoint; images/frames arrive as raw bytes in the request envelope, and
the embeddings return as raw bytes through the TCP call-home stream (the
two-part codec carries binary without base64/JSON overhead — the
descriptor's job, done by the plane that already exists).

- :class:`EncodeWorkerEngine` — wire AsyncEngine over a TorchVisionEncoder:
  ``{"image_b": bytes, "shape": [H,W,3]}`` or
  ``{"frames_b": bytes, "shape": [T,H,W,3], "temporal_pool": n}`` →
  one reply ``{"embeds_b": bytes, "shape": [...], "dtype": "float32"}``.
- :func:`serve_encode_worker` — mount it on a runtime component.
- :class:`RemoteEncoder` — client used by the LLM worker's
  MultimodalEngine; same ``aencode``/``aencode_video`` surface as the
  local encoder.
"""

from __future__ import annotations

import numpy as np

from dynamo_tpu_torch.runtime.client import PushRouter, RouterMode
from dynamo_tpu_torch.runtime.engine import Context, ResponseStream
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("examples.multimodal.components")


def _pack(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {
        "embeds_b": arr.tobytes(),
        "shape": list(arr.shape),
        "dtype": str(arr.dtype),
    }


def _unpack(d: dict, key: str = "embeds_b") -> np.ndarray:
    return np.frombuffer(d[key], dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()


class EncodeWorkerEngine:
    """Wire engine for the encode worker process."""

    def __init__(self, encoder):
        self.encoder = encoder  # pipeline.TorchVisionEncoder
        self.encodes = 0

    async def generate(self, request: Context[dict]) -> ResponseStream[dict]:
        data = request.data
        if "frames_b" in data:
            frames = np.frombuffer(data["frames_b"], np.float32).reshape(data["shape"])
            embeds = await self.encoder.aencode_video(
                frames, temporal_pool=int(data.get("temporal_pool", 2))
            )
        else:
            image = np.frombuffer(data["image_b"], np.float32).reshape(data["shape"])
            embeds = await self.encoder.aencode(image)
        self.encodes += 1
        reply = _pack(embeds)

        async def gen():
            yield reply

        return ResponseStream(gen(), request.ctx)

    def stats(self) -> dict:
        return {"encodes_total": self.encodes}


async def serve_encode_worker(
    runtime,
    encoder,
    *,
    namespace: str = "dynamo",
    component: str = "encoder",
    endpoint: str = "encode",
):
    """Mount the encoder on the control plane; returns the EndpointService."""
    ep = runtime.namespace(namespace).component(component).endpoint(endpoint)
    engine = EncodeWorkerEngine(encoder)
    service = await ep.serve(engine, stats_handler=engine.stats)
    logger.info("encode worker serving %s", ep.path)
    return service


class RemoteEncoder:
    """Encoder facade over the encode-worker component (the LLM worker's
    view): numpy in, numpy out, bytes on the wire."""

    def __init__(self, router: PushRouter):
        self.router = router

    @classmethod
    async def connect(
        cls,
        runtime,
        *,
        namespace: str = "dynamo",
        component: str = "encoder",
        endpoint: str = "encode",
        min_instances: int = 1,
        timeout: float = 30.0,
    ) -> "RemoteEncoder":
        ep = runtime.namespace(namespace).component(component).endpoint(endpoint)
        router = await PushRouter.from_endpoint(ep, mode=RouterMode.ROUND_ROBIN)
        await router.client.wait_for_instances(min_instances, timeout=timeout)
        return cls(router)

    async def _call(self, payload: dict) -> np.ndarray:
        stream = await self.router.generate(Context(payload))
        async for item in stream:
            return _unpack(item)
        raise RuntimeError("encode worker returned no embeddings")

    async def aencode(self, image: np.ndarray) -> np.ndarray:
        image = np.ascontiguousarray(np.asarray(image, np.float32))
        return await self._call(
            {"image_b": image.tobytes(), "shape": list(image.shape)}
        )

    async def aencode_video(
        self, frames: np.ndarray, *, temporal_pool: int = 2
    ) -> np.ndarray:
        frames = np.ascontiguousarray(np.asarray(frames, np.float32))
        return await self._call(
            {
                "frames_b": frames.tobytes(),
                "shape": list(frames.shape),
                "temporal_pool": temporal_pool,
            }
        )

    async def close(self) -> None:
        await self.router.client.close()
