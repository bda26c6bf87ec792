"""Cross-worker KV block transfer (the port of
dynamo_tpu/parallel/kv_transfer.py, on the same wire).

Prefill and decode engines live in separate processes or share one, so
prefilled KV blocks are shipped prefill→decode.  Paths, selected per
destination:

- **same process**: the destination server is found in the process-local
  registry; the blocks stay CUDA tensors end to end and the receiving
  engine's block-scatter kernel copies them device to device.  No
  serialization, no host staging.
- **TCP**: the prefill engine stages the gathered blocks into pinned host
  memory behind a CUDA event (``StagedBlocks.ready``), the send waits for
  that event off the engine thread, and the raw bytes travel in the two-part
  codec's frame; the receiver's engine copies them back to the device and
  scatters.  Works across hosts and processes.

Wire (the reference's, byte for byte): header {seq_id, first_token,
block_ids, parts, part_index, last, block_start, layer_start, layer_count}
+ the leaves' raw bytes in name order.  A part names its dtype as numpy
does (``bfloat16``, ``float8_e4m3fn``, ``float32``, ...), so a port client
talks to a JAX ``KvTransferServer`` and a JAX client to this server.  The
reference decodes accelerator dtypes through ``ml_dtypes``; the port reads
the raw bytes with ``torch.frombuffer`` and views them as the named dtype.
Streamed transfers ship one frame per completed prefill chunk; the final
frame alone holds the sampled first token.
"""

from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass
from typing import Any, Awaitable, Callable

import torch

from dynamo_tpu_torch.robustness.faults import FAULTS, KV_TRANSFER
from dynamo_tpu_torch.runtime.codec import TwoPartMessage, encode_frame, read_two_part
from dynamo_tpu_torch.utils import knobs
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("parallel.kv_transfer")


def resolve_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire dtype name (numpy's names: ``bfloat16``,
    ``float8_e4m3fn``, ``float8_e5m2``, ``float32``, ``uint8``, ...)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown KV transfer dtype {name!r}")
    return dtype


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a torch dtype (numpy's name for it)."""
    return str(dtype).removeprefix("torch.")


class StagedBlocks(dict):
    """A cache pytree of host tensors whose device-to-host copies may still
    be queued: ``ready`` is the CUDA event after them (None: ready now).
    A reader waits for it first (``wait_ready``); the staging stays alive
    as long as the dict does."""

    ready: Any = None

    def wait_ready(self) -> None:
        if self.ready is not None:
            self.ready.synchronize()


def payload_nbytes(blocks) -> int:
    """Total bytes of a payload's leaves (host or device tensors)."""
    return int(sum(t.numel() * t.element_size() for t in blocks.values()))


# process-local transfer servers by address: same-process sends short-cut
# TCP entirely and hand device tensors straight to the sink
LOCAL_SERVERS: dict[str, "KvTransferServer"] = {}

# topology-prober payloads carry this seq-id prefix: servers ack them (so the
# sender times a real staging+frame+ack exchange) but never deliver them to
# the engine sink — probing must be invisible to decode state
PROBE_SEQ_PREFIX = "__dyn_topo_probe__/"


@dataclass
class KvTransferPayload:
    seq_id: str
    first_token: int
    block_ids: list[int]          # destination (decode-side) block ids
    # cache pytree restricted to the sequence's blocks, one named tensor per
    # cache leaf — llama: {"k": [L, n, bs, kvh, d], "v": ...}; DeepSeek MLA:
    # latent + rope-key leaves with different trailing shapes
    blocks: dict[str, torch.Tensor]
    # logprob of first_token under the prefill worker's distribution
    first_token_logprob: float | None = None
    # [[token_id, logprob], ...] alternatives for first_token (when asked)
    first_token_top_logprobs: list | None = None
    # streamed multi-part protocol: ``part_index`` orders the parts of one
    # sequence's transfer, ``last`` marks the stream-closing part (the only
    # one whose first_token* fields are meaningful — intermediates carry
    # first_token=-1), ``block_start`` is the part's offset into the
    # sequence's landing zone.  The defaults make a single-shot payload a
    # well-formed one-part stream.
    part_index: int = 0
    last: bool = True
    block_start: int = 0
    # layer-wise granularity: a part may carry only layers
    # [layer_start, layer_start + layer_count) of its blocks' leading (layer)
    # axis.  layer_count == -1 means "all layers".
    layer_start: int = 0
    layer_count: int = -1


def split_layerwise(
    payload: KvTransferPayload, layers_per_part: int
) -> list[KvTransferPayload]:
    """Slice one payload into layer-range parts along the blocks' leading
    (layer) axis.  The final part inherits ``last`` and the first_token*
    fields; intermediates are ordinary non-final stream parts.  A payload
    whose tensors have fewer layers than ``layers_per_part`` round-trips as
    a single part."""
    if layers_per_part <= 0 or not payload.blocks:
        return [payload]
    n_layers = min(a.shape[0] for a in payload.blocks.values())
    if n_layers <= layers_per_part:
        return [payload]
    parts: list[KvTransferPayload] = []
    for start in range(0, n_layers, layers_per_part):
        count = min(layers_per_part, n_layers - start)
        final = start + count >= n_layers
        parts.append(KvTransferPayload(
            seq_id=payload.seq_id,
            first_token=payload.first_token if final else -1,
            block_ids=list(payload.block_ids),
            blocks={n: a[start:start + count] for n, a in payload.blocks.items()},
            first_token_logprob=payload.first_token_logprob if final else None,
            first_token_top_logprobs=(
                payload.first_token_top_logprobs if final else None
            ),
            part_index=payload.part_index + len(parts),
            last=payload.last and final,
            block_start=payload.block_start,
            layer_start=start,
            layer_count=count,
        ))
    return parts


def assemble_layers(parts: list[KvTransferPayload]) -> KvTransferPayload:
    """Stitch layer-range parts of one block range back into a full-depth
    payload (receiver-side twin of :func:`split_layerwise`; tolerates
    duplicates and arbitrary arrival order)."""
    if len(parts) == 1 and parts[0].layer_count < 0:
        return parts[0]
    by_start = {p.layer_start: p for p in parts}
    ordered = [by_start[k] for k in sorted(by_start)]
    final = max(parts, key=lambda p: p.layer_start)
    blocks = {
        name: torch.cat([p.blocks[name] for p in ordered], dim=0)
        for name in ordered[0].blocks
    }
    return KvTransferPayload(
        seq_id=final.seq_id,
        first_token=final.first_token,
        block_ids=list(final.block_ids),
        blocks=blocks,
        first_token_logprob=final.first_token_logprob,
        first_token_top_logprobs=final.first_token_top_logprobs,
        part_index=final.part_index,
        last=final.last,
        block_start=final.block_start,
    )


def encode_payload(payload: KvTransferPayload) -> tuple[dict, bytes]:
    """(header, body) of a payload's frame: the leaves in name order, each
    copied to host memory once (after the staging's event, where it has
    one)."""
    wait = getattr(payload.blocks, "wait_ready", None)
    if wait is not None:
        wait()
    names = sorted(payload.blocks)
    tensors = [payload.blocks[n].detach().to("cpu").contiguous() for n in names]
    header = {
        "seq_id": payload.seq_id,
        "first_token": payload.first_token,
        "first_token_logprob": payload.first_token_logprob,
        "first_token_top_logprobs": payload.first_token_top_logprobs,
        "block_ids": payload.block_ids,
        "part_index": payload.part_index,
        "last": payload.last,
        "block_start": payload.block_start,
        "layer_start": payload.layer_start,
        "layer_count": payload.layer_count,
        "parts": [
            {"name": n, "dtype": dtype_name(t.dtype), "shape": list(t.shape)}
            for n, t in zip(names, tensors)
        ],
    }
    body = b"".join(t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
                    for t in tensors)
    return header, body


def decode_blocks(header: dict, body: bytes) -> dict[str, torch.Tensor]:
    """The leaves of a frame: CPU tensors over one writable copy of the
    body."""
    buf = bytearray(body)
    blocks: dict[str, torch.Tensor] = {}
    offset = 0
    for part in header["parts"]:
        dtype = resolve_dtype(part["dtype"])
        shape = tuple(part["shape"])
        size = math.prod(shape) * dtype.itemsize
        if size:
            flat = torch.frombuffer(buf, dtype=torch.uint8, count=size, offset=offset)
        else:
            flat = torch.empty((0,), dtype=torch.uint8)
        blocks[part["name"]] = flat.view(dtype).reshape(shape)
        offset += size
    return blocks


class KvTransferServer:
    """Decode-worker side: receives KV payloads and hands them to a sink
    (typically ``engine.inject_blocks`` + completion notification)."""

    def __init__(
        self,
        sink: Callable[[KvTransferPayload], Awaitable[None]],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.sink = sink
        self.host = host
        self.port = port
        self._server: asyncio.Server | None = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        LOCAL_SERVERS[self.address] = self

    async def stop(self) -> None:
        LOCAL_SERVERS.pop(self.address, None)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def deliver_local(self, payload: KvTransferPayload) -> None:
        """Same-process fast path: blocks arrive as device tensors and skip
        the codec entirely."""
        if payload.seq_id.startswith(PROBE_SEQ_PREFIX):
            return
        await self.sink(payload)

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                frame = await read_two_part(reader)
                if frame is None:
                    return
                h = frame.header
                payload = KvTransferPayload(
                    seq_id=h["seq_id"],
                    first_token=h["first_token"],
                    first_token_logprob=h.get("first_token_logprob"),
                    first_token_top_logprobs=h.get("first_token_top_logprobs"),
                    block_ids=list(h["block_ids"]),
                    blocks=decode_blocks(h, frame.payload),
                    # a pre-streaming sender omits the part fields (a
                    # one-part stream), a pre-layerwise one the layer fields
                    part_index=int(h.get("part_index", 0)),
                    last=bool(h.get("last", True)),
                    block_start=int(h.get("block_start", 0)),
                    layer_start=int(h.get("layer_start", 0)),
                    layer_count=int(h.get("layer_count", -1)),
                )
                if not payload.seq_id.startswith(PROBE_SEQ_PREFIX):
                    await self.sink(payload)
                writer.write(encode_frame(TwoPartMessage(header={"ok": True, "seq_id": h["seq_id"]})))
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()


# socket-class failures a pooled connection can hit mid-exchange: the
# cached connection is garbage (peer restarted, idle reset by a middlebox)
# but the payload is intact — evict and re-dial instead of failing the send
_RETRYABLE = (ConnectionError, asyncio.IncompleteReadError, BrokenPipeError, OSError)


class KvTransferClient:
    """Prefill-worker side: pooled connections to decode workers.

    Beyond pooling, the client measures each TCP exchange and keeps a
    per-destination bandwidth EWMA — the measured half of the router's
    transfer-cost model (hop class supplies the prior until a destination
    has been observed)."""

    def __init__(self, *, ewma_alpha: float = 0.25) -> None:
        self._conns: dict[str, tuple[asyncio.StreamReader, asyncio.StreamWriter, asyncio.Lock]] = {}
        self._ewma_alpha = ewma_alpha
        # address -> measured bytes/second EWMA over write→ack exchanges
        self.bandwidth_bps: dict[str, float] = {}
        self.evictions_total = 0

    async def _conn(self, address: str):
        entry = self._conns.get(address)
        if entry is not None and not entry[1].is_closing():
            return entry
        host, _, port = address.rpartition(":")
        # bound the dial: a black-holed peer would otherwise park the send —
        # and the prefill pump behind it — on the kernel's connect timeout
        dial_timeout = knobs.get("DYN_KV_DIAL_TIMEOUT_S")
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, int(port)), timeout=dial_timeout
            )
        except asyncio.TimeoutError:
            raise ConnectionError(
                f"KV transfer dial to {address} timed out after {dial_timeout:.1f}s"
            ) from None
        entry = (reader, writer, asyncio.Lock())
        self._conns[address] = entry
        return entry

    def _evict(self, address: str, writer: asyncio.StreamWriter) -> None:
        """Drop a broken pooled connection — only if the pool still holds
        THIS writer (a concurrent sender may have re-dialed already)."""
        writer.close()
        entry = self._conns.get(address)
        if entry is not None and entry[1] is writer:
            del self._conns[address]
            self.evictions_total += 1

    def _observe(self, address: str, nbytes: int, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 0:
            return
        bps = nbytes / seconds
        prev = self.bandwidth_bps.get(address)
        self.bandwidth_bps[address] = (
            bps if prev is None else prev + self._ewma_alpha * (bps - prev)
        )

    async def send(self, address: str, payload: KvTransferPayload) -> None:
        # chaos seam: a failed KV shipment (the decode side's prefill wait
        # times out and degrades to a local prefill)
        FAULTS.check(KV_TRANSFER, seq_id=payload.seq_id)
        local = LOCAL_SERVERS.get(address)
        if local is not None:
            await local.deliver_local(payload)
            return

        # host staging (the wait for the device-to-host copies, byte
        # serialization of multi-MB KV slices) runs OUTSIDE the
        # per-connection lock and OFF the event loop: concurrent shipments
        # to one decode worker overlap their staging with each other and
        # with the socket round-trip below
        loop = asyncio.get_running_loop()
        header, body = await loop.run_in_executor(None, encode_payload, payload)
        frame = encode_frame(TwoPartMessage(header=header, payload=body))
        last_err: Exception | None = None
        for _attempt in range(2):
            reader, writer, lock = await self._conn(address)
            try:
                # only the write→ack round-trip holds the lock (frame
                # interleaving on one socket is the one thing that must
                # serialize)
                async with lock:
                    t0 = time.perf_counter()
                    writer.write(frame)
                    await writer.drain()
                    ack = await read_two_part(reader)
                    elapsed = time.perf_counter() - t0
            except _RETRYABLE as exc:
                # pooled connection died under us (peer restart / reset):
                # the payload never landed — evict and re-dial once
                self._evict(address, writer)
                last_err = exc
                continue
            if ack is None:
                # clean EOF before the ack: same remedy as a reset
                self._evict(address, writer)
                last_err = ConnectionError(
                    f"kv transfer to {address}: connection closed before ack"
                )
                continue
            if not ack.header.get("ok"):
                # the server SAW the frame and refused it — re-sending the
                # same bytes cannot help; fail loudly
                raise ConnectionError(f"kv transfer to {address} failed")
            self._observe(address, len(body), elapsed)
            return
        raise ConnectionError(
            f"kv transfer to {address} failed after re-dial: {last_err}"
        )

    async def close(self) -> None:
        for _, writer, _ in self._conns.values():
            writer.close()
        self._conns.clear()
