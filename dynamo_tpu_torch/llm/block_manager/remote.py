"""G4 remote KV block tier: a block store served over TCP (a copy of
dynamo_tpu/llm/block_manager/remote.py on torch tensors).

The reference's fourth tier is remote memory reached via NIXL RDMA
descriptors (lib/llm/src/block_manager.rs:68-81 G4, storage/nixl.rs:98-231
remote descriptors).  Here it is host-staged TCP, as in the
JAX package: a ``BlockStoreServer`` process owns a
big block pool (host DRAM or SSD) and serves batched read/write by block id
over TCP with the two-part codec; decode/prefill hosts mount it as a
``RemoteStorage`` backend — the same uniform ``Storage`` interface every
other tier uses, so pools/offload/onboard logic is tier-agnostic.

Wire protocol (one two-part frame per request/response):
    → {op: "write", ids: [...], dtype, shape}  payload = raw block bytes
    ← {ok: true}
    → {op: "read", ids: [...]}
    ← {ok: true, dtype, shape}                 payload = raw block bytes
    → {op: "info"}
    ← {ok: true, num_blocks, dtype, shape}

Dtypes travel by their torch names (``float32``, ``bfloat16``, ``uint8``).

Run standalone:  python -m dynamo_tpu_torch.llm.block_manager.remote --port 7051 \
    --num-blocks 4096 --shape 2,2,16,2,16 --dtype float32
"""

from __future__ import annotations

import argparse
import asyncio
import queue
import socket
import threading

import torch

from dynamo_tpu_torch.llm.block_manager.storage import Storage
from dynamo_tpu_torch.runtime.codec import (
    TwoPartMessage,
    encode_frame,
    read_two_part,
    read_two_part_sync,
)
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("llm.block_manager.remote")


def _resolve_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_bytes(data: torch.Tensor) -> bytes:
    return data.detach().to("cpu").contiguous().view(torch.uint8).numpy().tobytes()


def _from_bytes(payload: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    flat = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    return flat.view(dtype).reshape(shape)


class BlockStoreServer:
    """Owns a local Storage backend and serves it to remote mounters."""

    def __init__(self, backing: Storage, *, host: str = "127.0.0.1", port: int = 0):
        self.backing = backing
        self.host = host
        self.port = port
        self._server: asyncio.Server | None = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("block store serving %d blocks on %s", self.backing.num_blocks, self.address)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.backing.close()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                msg = await read_two_part(reader)
                if msg is None:
                    return
                try:
                    reply = await self._dispatch(msg)
                except Exception as exc:  # noqa: BLE001
                    logger.exception("block store request failed")
                    reply = TwoPartMessage({"ok": False, "error": str(exc)})
                writer.write(encode_frame(reply))
                await writer.drain()
        finally:
            writer.close()

    async def _dispatch(self, msg: TwoPartMessage) -> TwoPartMessage:
        op = msg.header.get("op")
        if op == "info":
            probe = self.backing.read_batch([0])
            return TwoPartMessage(
                {
                    "ok": True,
                    "num_blocks": self.backing.num_blocks,
                    "dtype": _dtype_name(probe.dtype),
                    "shape": list(probe.shape[1:]),
                }
            )
        ids = list(msg.header.get("ids", []))
        if op == "read":
            data = await asyncio.to_thread(self.backing.read_batch, ids)
            return TwoPartMessage(
                {"ok": True, "dtype": _dtype_name(data.dtype), "shape": list(data.shape)},
                _to_bytes(data),
            )
        if op == "write":
            dtype = _resolve_dtype(msg.header["dtype"])
            data = _from_bytes(msg.payload, dtype, msg.header["shape"])
            await asyncio.to_thread(self.backing.write_batch, ids, data)
            return TwoPartMessage({"ok": True})
        return TwoPartMessage({"ok": False, "error": f"unknown op {op!r}"})


class RemoteStorage(Storage):
    """Client-side Storage backend mounted on a BlockStoreServer.

    Synchronous (the offload manager drives Storage through
    ``asyncio.to_thread``); a small blocking-socket pool makes concurrent
    batch transfers from multiple offload workers safe.
    """

    def __init__(self, address: str, *, pool_size: int = 4, timeout: float = 30.0):
        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout
        self._pool: queue.Queue[socket.socket] = queue.Queue()
        self._pool_size = pool_size
        self._created = 0
        self._lock = threading.Lock()
        info = self._request({"op": "info"})
        self.num_blocks = info.header["num_blocks"]
        self.shape = tuple(info.header["shape"])
        self.dtype = _resolve_dtype(info.header["dtype"])

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _acquire(self) -> socket.socket:
        try:
            return self._pool.get_nowait()
        except queue.Empty:
            pass
        with self._lock:
            may_create = self._created < self._pool_size
            if may_create:
                self._created += 1
        if may_create:
            try:
                return self._connect()
            except Exception:
                with self._lock:
                    self._created -= 1  # failed connect must not leak the slot
                raise
        try:
            return self._pool.get(timeout=self._timeout)
        except queue.Empty:
            raise TimeoutError(
                f"no free connection to block store {self._addr} after {self._timeout}s"
            ) from None

    def _request(self, header: dict, payload: bytes = b"") -> TwoPartMessage:
        sock = self._acquire()
        try:
            sock.sendall(encode_frame(TwoPartMessage(header, payload)))
            reply = read_two_part_sync(sock)
        except Exception:
            with self._lock:
                self._created -= 1
            sock.close()
            raise
        if reply is None:
            with self._lock:
                self._created -= 1
            sock.close()
            raise ConnectionError(f"block store {self._addr} closed the connection")
        self._pool.put(sock)
        if not reply.header.get("ok"):
            raise RuntimeError(f"block store error: {reply.header.get('error')}")
        return reply

    def read_batch(self, block_ids: list[int]) -> torch.Tensor:
        reply = self._request({"op": "read", "ids": [int(b) for b in block_ids]})
        dtype = _resolve_dtype(reply.header["dtype"])
        return _from_bytes(reply.payload, dtype, reply.header["shape"])

    def write_batch(self, block_ids: list[int], data: torch.Tensor) -> None:
        self._request(
            {
                "op": "write",
                "ids": [int(b) for b in block_ids],
                "dtype": _dtype_name(data.dtype),
                "shape": list(data.shape),
            },
            _to_bytes(data),
        )

    def close(self) -> None:
        while True:
            try:
                self._pool.get_nowait().close()
            except queue.Empty:
                return


def main() -> int:
    from dynamo_tpu_torch.llm.block_manager.storage import DiskStorage, HostStorage
    from dynamo_tpu_torch.utils.logging import configure_logging

    parser = argparse.ArgumentParser(description="standalone G4 block store server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7051)
    parser.add_argument("--num-blocks", type=int, default=4096)
    parser.add_argument("--shape", default="2,2,16,2,16",
                        help="block shape layers,kv,block_size,kv_heads,head_dim")
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--nbytes", type=int, default=None,
                        help="serve RAW uint8 payload blocks of this size "
                             "instead of structured --shape/--dtype blocks "
                             "(what a serving engine's G4 tier mounts; the "
                             "engine logs its block_nbytes at startup and "
                             "errors with both sizes on mismatch)")
    parser.add_argument("--disk-path", default=None,
                        help="back the store with an SSD memmap instead of DRAM")
    args = parser.parse_args()

    configure_logging()
    if args.nbytes:
        shape, dtype = (args.nbytes,), torch.uint8
    else:
        shape = tuple(int(x) for x in args.shape.split(","))
        dtype = _resolve_dtype(args.dtype)
    if args.disk_path:
        backing: Storage = DiskStorage(args.num_blocks, shape, dtype, path=args.disk_path)
    else:
        backing = HostStorage(args.num_blocks, shape, dtype)

    async def run() -> None:
        server = BlockStoreServer(backing, host=args.host, port=args.port)
        await server.start()
        try:
            await asyncio.Event().wait()
        finally:
            await server.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
