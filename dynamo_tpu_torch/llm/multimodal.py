"""Multimodal front door: ``image_url`` content parts → encoder input.

The reference's multimodal processor pulls ``image_url`` out of the chat
request and drives encode→prefill→decode (reference:
examples/multimodal/components/processor.py:107-217,
encode_worker.py:61).  Here the OpenAI frontend does the I/O half —
extract the URL, fetch/decode the bytes, normalize to a float RGB array —
and attaches it to the preprocessed request; the engine half
(examples/multimodal/pipeline.py ``MultimodalEngine``) encodes it with
the ViT (in-process or on a separate encode-worker component) and splices
the patch embeddings ahead of the text tokens.

Split rationale (TPU-first): image I/O and PNG/JPEG decode are host work
that belongs at the frontend; geometry (resize to the ViT's square input)
belongs next to the encoder that knows its ``image_size`` — so the wire
carries decoded [H, W, 3] float32 in [0, 1], unresized.

Supported URL forms:
- ``data:image/...;base64,<payload>`` — decoded inline (no network);
- ``http://`` / ``https://`` — fetched with a size cap and timeout.
Anything else (``file://``, relative paths) is rejected: a frontend that
dereferences arbitrary schemes is an SSRF/file-exfiltration hole.
"""

from __future__ import annotations

import base64
import binascii
import io

import numpy as np

from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils import knobs

logger = get_logger("llm.multimodal")

MAX_IMAGE_BYTES = 16 * 1024 * 1024
# decompressed-size guard: a 16MB PNG can decode to ~90M pixels (~1GB as
# float32) — cap pixels independently of the compressed byte cap
MAX_IMAGE_PIXELS = 4096 * 4096
FETCH_TIMEOUT_S = 30.0
# http(s) image fetch resolves to private/loopback/link-local addresses
# only when explicitly allowed (SSRF guard); data: URLs need no opt-in
ALLOW_PRIVATE_ENV = "DYN_ALLOW_PRIVATE_IMAGE_URLS"


def extract_image_url(request) -> str | None:
    """The request's single image URL, or None for text-only requests.

    One image per request in v1 (the LLM engine splices one patch-embedding
    block ahead of the text); two or more is a loud error, not a silent
    drop of all but one."""
    urls: list[str] = []
    for message in request.messages:
        content = message.content
        if not isinstance(content, list):
            continue
        for part in content:
            if part.type != "image_url":
                continue
            url = (part.image_url or {}).get("url")
            if not url:
                raise ValueError("image_url content part carries no url")
            urls.append(url)
    if len(urls) > 1:
        raise ValueError(
            f"request carries {len(urls)} images; one image per request is "
            "supported"
        )
    return urls[0] if urls else None


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Image bytes → RGB float32 [H, W, 3] in [0, 1]."""
    from PIL import Image, UnidentifiedImageError

    try:
        with Image.open(io.BytesIO(data)) as img:
            # size is known from the header BEFORE pixel decode: reject
            # decompression bombs without paying for the decode
            w, h = img.size
            if w * h > MAX_IMAGE_PIXELS:
                raise ValueError(
                    f"image is {w}x{h} = {w * h} pixels; limit is "
                    f"{MAX_IMAGE_PIXELS}"
                )
            rgb = img.convert("RGB")
            arr = np.asarray(rgb, np.float32) / 255.0
    except UnidentifiedImageError:
        raise ValueError("image bytes are not a decodable image") from None
    if arr.ndim != 3:  # pragma: no cover — convert("RGB") guarantees 3 channels
        raise ValueError(f"decoded image has shape {arr.shape}, want [H, W, 3]")
    return arr


def encode_image_wire(arr: np.ndarray) -> dict:
    """Compact wire form for a decoded image: raw bytes + shape, base64.

    ``ndarray.tolist()`` turns a 2MP photo into ~200MB of Python float
    objects; this stays within ~4/3 of the raw buffer size."""
    arr = np.ascontiguousarray(arr, np.float32)
    return {
        "shape": list(arr.shape),
        "dtype": "float32",
        "b64": base64.b64encode(arr.tobytes()).decode("ascii"),
    }


def decode_image_wire(obj) -> np.ndarray:
    """Inverse of :func:`encode_image_wire`; also accepts a plain nested
    list / array (direct API callers attaching ``image`` themselves)."""
    if isinstance(obj, dict):
        data = base64.b64decode(obj["b64"])
        arr = np.frombuffer(data, dtype=obj.get("dtype", "float32"))
        return arr.reshape(obj["shape"]).astype(np.float32, copy=False)
    return np.asarray(obj, np.float32)


def _decode_data_url(url: str) -> bytes:
    header, _, payload = url.partition(",")
    if not payload:
        raise ValueError("data: URL has no payload")
    if ";base64" not in header:
        raise ValueError("data: image URLs must be base64-encoded")
    try:
        data = base64.b64decode(payload, validate=True)
    except (binascii.Error, ValueError):
        raise ValueError("data: URL payload is not valid base64") from None
    if len(data) > MAX_IMAGE_BYTES:
        raise ValueError(
            f"image exceeds {MAX_IMAGE_BYTES // (1024 * 1024)}MB limit"
        )
    return data


def _reject_private_host(url: str) -> None:
    """SSRF guard: refuse http(s) URLs that resolve to loopback, private,
    link-local, or otherwise non-global addresses (169.254.169.254 metadata
    endpoints, the deployment's own control plane, ...) unless the operator
    opted in via DYN_ALLOW_PRIVATE_IMAGE_URLS=1.

    Depth note: the check resolves once here and aiohttp resolves again at
    connect time (a DNS-rebinding TOCTOU); closing that fully needs a
    pinned-IP connector, which the opt-in env documents as the boundary."""
    import os
    import socket
    import urllib.parse
    from ipaddress import ip_address

    if knobs.get(ALLOW_PRIVATE_ENV):
        return
    host = urllib.parse.urlsplit(url).hostname
    if not host:
        raise ValueError(f"image URL {url!r} has no host")
    try:
        infos = socket.getaddrinfo(host, None)
    except socket.gaierror:
        raise ValueError(f"image host {host!r} does not resolve") from None
    for info in infos:
        addr = ip_address(info[4][0])
        if not addr.is_global:
            raise ValueError(
                f"image host {host!r} resolves to non-global address "
                f"{addr} (set {ALLOW_PRIVATE_ENV}=1 to allow internal "
                "fetches)"
            )


async def _fetch_http(url: str) -> bytes:
    import aiohttp

    _reject_private_host(url)
    timeout = aiohttp.ClientTimeout(total=FETCH_TIMEOUT_S)
    async with aiohttp.ClientSession(timeout=timeout) as session:
        async with session.get(url) as resp:
            if resp.status != 200:
                raise ValueError(f"image fetch failed: HTTP {resp.status} for {url}")
            data = await resp.content.read(MAX_IMAGE_BYTES + 1)
            if len(data) > MAX_IMAGE_BYTES:
                raise ValueError(
                    f"image exceeds {MAX_IMAGE_BYTES // (1024 * 1024)}MB limit"
                )
            return data


async def resolve_image(url: str) -> np.ndarray:
    """URL (data:/http:/https:) → decoded RGB float32 [H, W, 3] in [0, 1]."""
    if url.startswith("data:"):
        data = _decode_data_url(url)
    elif url.startswith(("http://", "https://")):
        data = await _fetch_http(url)
    else:
        scheme = url.split(":", 1)[0] if ":" in url else "<none>"
        raise ValueError(
            f"unsupported image URL scheme {scheme!r}: use data: (base64) "
            "or http(s)"
        )
    return decode_image_bytes(data)
