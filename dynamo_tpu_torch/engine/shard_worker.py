"""Shard workers: ranks 1..N-1 of an engine mesh, and rank 0's side of their
step protocol.

The reference runs one controller for every device of its mesh: one jitted
program, which XLA partitions.  A PyTorch process drives its own device
only, so the port runs one process a rank.  Rank 0 is the engine
(``TorchLlmEngine``: scheduler, block manager, sampling, HTTP, KV events);
every other rank runs this module's loop: it receives each step's header
(the program and its input shapes) and inputs by broadcast from rank 0,
runs the same family forward on its shard with ``mesh=``, and takes part in
the forward's collectives.  The step broadcast is the port's counterpart of
XLA's single program, not a feature of its own.

Programs: ``prefill`` / ``prefix`` / ``decode`` / ``verify`` (the family's
split prefill, continued prefill, decode and speculative verify forwards),
``embeds`` (the multimodal prefill: patch embeddings spliced before the
text's token embeddings), ``gather`` (row 6 over every rank's cache shard,
the shards to rank 0, which assembles whole blocks in the reference's
layout), ``scatter`` (whole blocks from rank 0, each rank's slice, row 7
into its shard), ``ping`` (an idle engine's keep-alive), ``zero_counts`` /
``counts`` (every rank's kernel launch counters, zeroed or gathered to rank
0) and ``stop``.  Inputs are integer tensors (token ids, block tables,
lengths, slots), float32 tensors (patch embeddings, bit for bit) and Python
ints; they travel as one int64 payload behind a fixed-size int64 header.

Lifetime: ``MeshLeader.launch`` starts the workers as child processes
(``python -m dynamo_tpu_torch.engine.shard_worker``) over a ``FileStore``
in a fresh temp directory, unless a process group is already initialised
(``parallel/multihost.py``: the workers were started on their own hosts
with ``--control-plane``).  A worker exits when rank 0 sends ``stop``, when
a collective raises (rank 0 died: its sockets closed; or hung past
``DYN_MESH_TIMEOUT_S``), or when its parent process is gone.  Rank 0 marks
the mesh broken at the first failed collective: every later step raises
``MeshError`` at once.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    COMM_KINDS,
    broadcast,
    comm_counters,
    gather_to_root,
    leaf_sharder,
    make_mesh,
    mesh_size,
    rank_coords,
    resolve_backend,
    scatter_from_root,
    shard_config,
    shard_index,
    zero_comm_counters,
)
from dynamo_tpu_torch.utils import knobs
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("engine.shard_worker")

PROGRAMS = ("stop", "ping", "decode", "prefill", "prefix", "zero_counts", "counts", "verify",
            "embeds", "gather", "scatter")
# the step forwards by program: the family attribute each runs (inputs
# broadcast after the cache argument, cos and sin excepted)
FORWARDS = {"decode": "forward_decode", "prefill": "forward_prefill",
            "prefix": "forward_prefill_with_prefix", "verify": "forward_verify",
            "embeds": "forward_prefill_spliced"}
HEADER_LEN = 64
MAX_DIMS = 2
# wire codes of an input: 0 a Python int, else a tensor dtype; a float32
# tensor travels as its bits (int32 widened to int64)
_DTYPES = (None, torch.int32, torch.int64, torch.bool, torch.float32)


class MeshError(RuntimeError):
    """A mesh collective failed: a rank died, hung, or fell out of step."""


@dataclass
class ShardSpec:
    """What a rank needs to build its shard, broadcast once by rank 0."""
    mesh: MeshConfig
    model_family: str
    model: Any               # the family's config
    num_blocks: int
    block_size: int
    kv_cache_dtype: Any      # torch dtype of the cache
    max_len: int             # positions the rope tables cover
    seed: int
    quantize: str | None
    attention_impl: str      # "kernel" | "plain"
    # None: every rank draws the weights from ``seed`` (the family's
    # init_params) and keeps its slice; else [(path, shape, dtype)] of the
    # full leaves rank 0 broadcasts in this order (a quantized leaf as its
    # "#q" and "#s" parts)
    leaves: list | None = None


def _flat_leaves(tree, path=()):
    from dynamo_tpu_torch.ops.quant import QuantizedMatrix

    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, path + (k,))
    elif isinstance(tree, QuantizedMatrix):
        yield path + ("#q",), tree.q
        yield path + ("#s",), tree.s
    else:
        yield path, tree


def forward_of(family, program: str, mesh: Mesh | None):
    """The forward a mesh step of ``program`` runs on every rank: the
    family's split-step forward, or on a pp mesh its pipelined decode where
    it has one (the reference's ``_build_decode``, engine.py:1325)."""
    if program == "decode" and mesh_size(mesh, "pp") > 1 and family.forward_decode_pp is not None:
        return family.forward_decode_pp
    return getattr(family, FORWARDS[program])


def shard_cache(family, cfg, mesh: Mesh, num_blocks: int, block_size: int, dtype, device):
    """This rank's cache: its tp heads, and its stage's layers where the
    family's cache spec puts the layer axis on pp (the llama family's;
    DeepSeek's latent cache is whole on every rank)."""
    kw = {}
    pp = mesh_size(mesh, "pp")
    if pp > 1 and family.cache_specs(cfg)["k"][0] == "pp":
        kw["num_layers"] = cfg.num_layers // pp
    return family.init_kv_cache(shard_config(cfg, mesh), num_blocks, block_size, dtype, device,
                                **kw)


class CacheShards:
    """Where each rank's cache shard sits in the whole cache: the whole
    leaves' shapes (``[L, N, bs, KVH, D]``, the reference's layout), the
    slice of a whole block range each rank holds, and the ranks whose shard
    a gather takes (the lowest rank holding each distinct slice: a leaf
    whole on every rank comes from rank 0 alone).  The axes a leaf is split
    over are the family's ``cache_specs``, as ``shard_cache`` holds them:
    the kv-head axis over tp and the layer axis over pp for the llama
    family's cache; none for DeepSeek's latent cache.  No leaf is split over
    sp or ep: their ranks hold copies."""

    def __init__(self, family, cfg, mesh: Mesh, cache: dict):
        self.mesh = mesh
        self.names = sorted(cache)
        self.specs = family.cache_specs(cfg)
        self.dtypes = {name: cache[name].dtype for name in self.names}
        self.shard_shapes = {name: tuple(cache[name].shape) for name in self.names}
        self.shapes = {}
        for name in self.names:
            spec = self.specs[name]
            self.shapes[name] = tuple(
                n * (mesh.size(spec[d]) if d < len(spec) and spec[d] else 1)
                for d, n in enumerate(self.shard_shapes[name]))
        seen, self.senders = set(), []
        for r in range(mesh.world_size):
            key = tuple(self._index(name, self.shapes[name], r) for name in self.names)
            if key not in seen:
                seen.add(key)
                self.senders.append(r)

    def _index(self, name: str, shape, rank: int) -> tuple:
        index = shard_index(shape, self.specs[name], self.mesh, name,
                            coords=rank_coords(self.mesh.config, rank))
        return tuple((s.start, s.stop) for s in index)

    def block_shape(self, name: str, n: int, shard: bool = False) -> tuple:
        """The shape of ``n`` blocks of leaf ``name``: whole, or one rank's
        shard."""
        shape = list(self.shard_shapes[name] if shard else self.shapes[name])
        shape[1] = n
        return tuple(shape)

    def slices(self, name: str, n: int, rank: int) -> tuple[slice, ...]:
        """Rank ``rank``'s slice of ``n`` whole blocks of leaf ``name``."""
        return tuple(slice(a, b) for a, b in
                     self._index(name, self.block_shape(name, n), rank))

    def nbytes(self, n: int) -> int:
        """The bytes of one rank's shard of ``n`` blocks, every leaf."""
        return sum(int(np.prod(self.block_shape(name, n, shard=True)))
                   * self.dtypes[name].itemsize for name in self.names)


def _pack(tensors) -> torch.Tensor:
    """Tensors as one byte tensor, in order."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _unpack(buf: torch.Tensor, shards: CacheShards, n: int) -> dict[str, torch.Tensor]:
    """``_pack``'s inverse for one rank's shard of ``n`` blocks."""
    out, at = {}, 0
    for name in shards.names:
        shape = shards.block_shape(name, n, shard=True)
        size = int(np.prod(shape)) * shards.dtypes[name].itemsize
        out[name] = buf[at:at + size].view(shards.dtypes[name]).view(shape)
        at += size
    return out


def gather_shards(mesh: Mesh, cache: dict, shards: CacheShards, ids: list[int]
                  ) -> dict[str, torch.Tensor] | None:
    """Row 6 over this rank's shard of blocks ``ids``, the shard to rank 0
    (one transfer a rank); on rank 0 the whole blocks ``{leaf: [L, n, bs,
    KVH, D]}`` on its device, each rank's shard in its place, bit for bit
    (None on the other ranks)."""
    from dynamo_tpu_torch.ops.kernels import block_copy

    n = len(ids)
    mine = None
    if mesh.rank in shards.senders:
        mine = {name: block_copy.gather_blocks(cache[name], ids, axis=1)
                for name in shards.names}
    if mesh.rank != 0:
        if mine is not None:
            gather_to_root(_pack(mine[name] for name in shards.names), mesh)
        return None
    like = torch.empty(shards.nbytes(n), dtype=torch.uint8, device=mesh.device)
    got = gather_to_root(None, mesh, {r: like for r in shards.senders if r != 0})
    got = {0: mine, **{r: _unpack(buf, shards, n) for r, buf in got.items()}}
    out = {}
    for name in shards.names:
        whole = torch.empty(shards.block_shape(name, n), dtype=shards.dtypes[name],
                            device=mesh.device)
        for r, parts in got.items():
            whole[shards.slices(name, n, r)] = parts[name]
        out[name] = whole
    return out


def scatter_shards(mesh: Mesh, cache: dict, shards: CacheShards, ids: list[int],
                   blocks: dict | None = None) -> None:
    """Whole blocks ``{leaf: [L, n, bs, KVH, D]}`` (rank 0's, on any device)
    into blocks ``ids`` of every rank's cache: rank 0 sends each rank its
    slice, cast to the cache's dtype (one transfer a rank), and every rank
    writes its own with row 7."""
    from dynamo_tpu_torch.ops.kernels import block_copy

    n = len(ids)
    if mesh.rank == 0:
        blocks = {name: blocks[name].to(dtype=shards.dtypes[name]) for name in shards.names}
        scatter_from_root({r: _pack(blocks[name][shards.slices(name, n, r)]
                                    for name in shards.names)
                           for r in range(1, mesh.world_size)}, mesh)
        mine = {name: blocks[name][shards.slices(name, n, 0)].to(mesh.device)
                for name in shards.names}
    else:
        like = torch.empty(shards.nbytes(n), dtype=torch.uint8, device=mesh.device)
        mine = _unpack(scatter_from_root(None, mesh, like), shards, n)
    for name in shards.names:
        block_copy.scatter_blocks(cache[name], mine[name], ids, axis=1)


def build_shard(mesh: Mesh, spec: ShardSpec, family, params: dict | None = None):
    """This rank's ``(params, cache, cos, sin)``: the weights drawn from the
    seed or received leaf by leaf from rank 0 (``params``, rank 0's full
    tree), each quantized where the engine quantizes and sliced under the
    family's specs before the next leaf comes; the cache of this rank's
    heads; the full rope tables."""
    from dynamo_tpu_torch.models.llama import leaf_sink
    from dynamo_tpu_torch.ops.quant import QuantizedMatrix

    cfg, dev = spec.model, mesh.device
    quant = family.quant_leaves if spec.quantize == "int8" else ()
    shard = leaf_sharder(family.mesh_param_specs(cfg, mesh), mesh, quant)
    if spec.leaves is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(spec.seed)
        out = family.init_params(cfg, gen, dev, shard=shard)
    else:
        source = dict(_flat_leaves(params)) if params is not None else {}
        out, put = leaf_sink()
        held = {}
        for path, shape, dtype in spec.leaves:
            full = source[path] if mesh.rank == 0 else torch.empty(
                shape, dtype=dtype, device=mesh.wire_device)
            full = broadcast(full, mesh).to(dev)
            if path[-1] == "#q":
                held[path[:-1]] = full
                continue
            if path[-1] == "#s":
                path, full = path[:-1], QuantizedMatrix(held.pop(path[:-1]), full)
            put(path, shard(path, full))
            del full
    cache = shard_cache(family, cfg, mesh, spec.num_blocks, spec.block_size,
                        spec.kv_cache_dtype, dev)
    cos, sin = family.make_rope_tables(cfg, dev, spec.max_len)
    return out, cache, cos, sin


def _send_object(obj, mesh: Mesh) -> Any:
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0, device=mesh.wire_device)
    return box[0]


def _encode(program: str, args) -> tuple[torch.Tensor, torch.Tensor]:
    header = torch.zeros(HEADER_LEN, dtype=torch.int64)
    header[0], header[1] = PROGRAMS.index(program), len(args)
    parts, pos = [], 2
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.dim() > MAX_DIMS or a.dtype not in _DTYPES:
                raise ValueError(f"mesh step input of shape {tuple(a.shape)} and {a.dtype}")
            code, shape = _DTYPES.index(a.dtype), tuple(a.shape)
            flat = a.reshape(-1).to("cpu")
            if a.dtype == torch.float32:
                flat = flat.view(torch.int32)
            parts.append(flat.to(torch.int64))
        else:
            code, shape = 0, ()
            parts.append(torch.tensor([int(a)], dtype=torch.int64))
        header[pos], header[pos + 1] = code, len(shape)
        header[pos + 2: pos + 2 + len(shape)] = torch.tensor(shape, dtype=torch.int64)
        pos += 2 + MAX_DIMS
    payload = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64)
    header[-1] = payload.numel()
    return header, payload


def _decode(header: torch.Tensor, payload: torch.Tensor, device) -> tuple[str, list]:
    h = header.tolist()
    args, pos, at = [], 2, 0
    for _ in range(h[1]):
        code, ndim = h[pos], h[pos + 1]
        shape = tuple(h[pos + 2: pos + 2 + ndim])
        n = 1
        for d in shape:
            n *= d
        chunk = payload[at: at + n]
        at += n
        if code == 0:
            args.append(int(chunk[0]))
        elif _DTYPES[code] == torch.float32:
            args.append(chunk.to(torch.int32).view(torch.float32).view(shape).to(device))
        else:
            args.append(chunk.view(shape).to(device=device, dtype=_DTYPES[code]))
        pos += 2 + MAX_DIMS
    return PROGRAMS[h[0]], args


def _recv_step(mesh: Mesh) -> tuple[str, list]:
    header = broadcast(torch.zeros(HEADER_LEN, dtype=torch.int64, device=mesh.wire_device), mesh)
    payload = torch.zeros(int(header[-1]), dtype=torch.int64, device=mesh.wire_device)
    if payload.numel():
        payload = broadcast(payload, mesh)
    return _decode(header.cpu(), payload.cpu(), mesh.device)


def _counts() -> dict:
    """This rank's kernel launch counters (``module.counter``) and its mesh
    traffic (``mesh.<kind>_calls`` / ``mesh.<kind>_s``)."""
    from dynamo_tpu_torch.engine.graphs import launch_counters

    out = {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": n
           for (mod, name), n in launch_counters().items()}
    out.update({f"mesh.{k}": v for k, v in comm_counters().items()})
    return out


def _zero_counts() -> None:
    from dynamo_tpu_torch.engine.graphs import launch_counters

    for mod, name in launch_counters():
        setattr(mod, name, 0)
    zero_comm_counters()


def _gather_counts(mesh: Mesh) -> list[dict]:
    import torch.distributed as dist

    out: list = [None] * mesh.world_size
    dist.all_gather_object(out, _counts())
    return out


# ---------------------------------------------------------------------------
# Rank 0
# ---------------------------------------------------------------------------


class MeshLeader:
    """Rank 0's end of the mesh: the workers it started (none where the
    process group was joined beforehand), the step broadcast, the
    keep-alive, the counters, the stop."""

    def __init__(self, mesh: Mesh, procs: list, store_dir: str | None, owns_group: bool):
        self.mesh = mesh
        self.procs = procs
        self._store_dir = store_dir
        self._owns_group = owns_group
        # one step's broadcast and forward at a time (the device thread's
        # steps, the idle pings and a caller's counters)
        self.lock = threading.RLock()
        self.broken: BaseException | None = None
        self.timeout_s = knobs.get("DYN_MESH_TIMEOUT_S")
        self._last_send = time.monotonic()
        self.steps = 0
        # rank 0's wall seconds of each program's steps, and of those the
        # seconds in its collectives, stage hand-offs and ring rotations
        self.step_time: dict[str, dict] = {}

    @classmethod
    def launch(cls, config: MeshConfig, *, device_type: str, backend: str | None = None,
               timeout_s: float | None = None) -> "MeshLeader":
        """Rank 0 of a mesh of ``config``: joins the initialised process
        group where there is one, else starts ``config.total() - 1`` shard
        workers as child processes and joins them over a FileStore."""
        import torch.distributed as dist

        timeout = timeout_s if timeout_s is not None else knobs.get("DYN_MESH_TIMEOUT_S")
        if dist.is_initialized():
            mesh = make_mesh(config, device_type=device_type, backend=backend)
            if mesh.rank != 0:
                raise ValueError(f"the engine runs on rank 0 of its mesh, not rank {mesh.rank}")
            return cls(mesh, [], None, owns_group=False)
        n = config.total()
        chosen = resolve_backend(config, device_type, backend, n)
        store_dir = tempfile.mkdtemp(prefix="dyn-mesh-")
        init = f"file://{store_dir}/store"
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        sizes = ",".join(str(getattr(config, a)) for a in ("dp", "pp", "ep", "tp", "sp"))
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "dynamo_tpu_torch.engine.shard_worker",
                 "--init-method", init, "--rank", str(r), "--world-size", str(n),
                 "--mesh", sizes, "--device-offset", str(config.device_offset),
                 "--device-type", device_type, "--backend", chosen,
                 "--timeout-s", str(timeout), "--parent-pid", str(os.getpid())],
                env=env, stdin=subprocess.DEVNULL)
            for r in range(1, n)
        ]
        try:
            mesh = make_mesh(config, device_type=device_type, backend=chosen, rank=0,
                             world_size=n, init_method=init, timeout_s=timeout)
        except BaseException:
            _end(procs)
            shutil.rmtree(store_dir, ignore_errors=True)
            raise
        logger.info("mesh up: %s, %d shard workers", mesh, len(procs))
        return cls(mesh, procs, store_dir, owns_group=True)

    def build(self, spec: ShardSpec, family, params: dict | None):
        """Broadcast ``spec`` (and the weights, where rank 0 was given them)
        and build rank 0's shard: ``build_shard``'s result."""
        if params is not None:
            spec.leaves = [(path, tuple(t.shape), t.dtype) for path, t in _flat_leaves(params)]
        with self.lock:
            _send_object(spec, self.mesh)
            return build_shard(self.mesh, spec, family, params)

    def send(self, program: str, args=()) -> None:
        """Broadcast one program and its inputs to every worker."""
        if self.broken is not None:
            raise MeshError(f"the mesh is broken: {self.broken!r}")
        header, payload = _encode(program, args)
        try:
            broadcast(header, self.mesh)
            if payload.numel():
                broadcast(payload, self.mesh)
        except Exception as exc:
            self.broken = exc
            raise MeshError(f"mesh step broadcast failed: {exc}") from exc
        self._last_send = time.monotonic()

    def _step(self, program: str, args, body):
        """One program on every rank: its inputs to the workers, then
        ``body()``, rank 0's part; its wall seconds and its traffic's
        seconds by kind go to ``step_time``."""
        with self.lock:
            t0, before = time.perf_counter(), comm_counters()
            self.send(program, args)
            try:
                out = body()
            except Exception as exc:
                # the ranks may be out of step now: nothing later can run
                self.broken = exc
                raise
            self.steps += 1
            after = comm_counters()
            rec = self.step_time.setdefault(program, dict.fromkeys(
                ("steps", "wall_s", *(f"{kind}_s" for kind in COMM_KINDS)), 0))
            rec["steps"] += 1
            rec["wall_s"] += time.perf_counter() - t0
            for kind in COMM_KINDS:
                rec[f"{kind}_s"] += after[f"{kind}_s"] - before[f"{kind}_s"]
            return out

    def run(self, program: str, forward, params, cfg, tokens, cache, *rest):
        """One step forward on every rank: the program and its inputs to the
        workers, then rank 0's own shard."""
        *mid, cos, sin = rest
        return self._step(program, [tokens, *mid], lambda: forward(
            params, cfg, tokens, cache, *mid, cos, sin, mesh=self.mesh))

    def gather(self, cache: dict, shards: CacheShards, ids) -> dict[str, torch.Tensor]:
        """Whole blocks ``ids`` of every leaf on rank 0's device, from every
        rank's shard (``gather_shards``)."""
        ids = [int(i) for i in ids]
        return self._step("gather", [torch.tensor(ids, dtype=torch.int32)],
                          lambda: gather_shards(self.mesh, cache, shards, ids))

    def scatter(self, cache: dict, shards: CacheShards, ids, blocks: dict) -> None:
        """Whole blocks into blocks ``ids`` of every rank's shard
        (``scatter_shards``)."""
        ids = [int(i) for i in ids]
        self._step("scatter", [torch.tensor(ids, dtype=torch.int32)],
                   lambda: scatter_shards(self.mesh, cache, shards, ids, blocks))

    def keepalive(self) -> None:
        """A ping where nothing was sent for a quarter of the timeout, so an
        idle engine's workers do not time out."""
        if self.broken is None and time.monotonic() - self._last_send > self.timeout_s / 4:
            with self.lock:
                self.send("ping")

    def zero_counts(self) -> None:
        """Every rank's kernel launch counters to 0 (rank 0's included)."""
        with self.lock:
            self.send("zero_counts")
            _zero_counts()

    def counts(self) -> list[dict]:
        """Every rank's kernel launch counters, in rank order."""
        with self.lock:
            self.send("counts")
            try:
                return _gather_counts(self.mesh)
            except Exception as exc:
                self.broken = exc
                raise MeshError(f"gathering the ranks' counters failed: {exc}") from exc

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop every worker and leave the process group: ``stop`` to each,
        then wait for the children (killed past ``timeout``)."""
        import torch.distributed as dist

        with self.lock:
            if self.broken is None:
                try:
                    self.send("stop")
                except MeshError:
                    pass
            _end(self.procs, timeout)
            if self._owns_group and dist.is_initialized():
                dist.destroy_process_group()

            if self._store_dir is not None:
                shutil.rmtree(self._store_dir, ignore_errors=True)
                self._store_dir = None


def _end(procs: list, timeout: float = 0.0) -> None:
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


class MeshFamily:
    """The engine's model family on rank 0 of a mesh: each step forward
    (``forward_prefill``, ``forward_prefill_with_prefix``,
    ``forward_decode``, ``forward_verify``, ``forward_prefill_spliced``)
    runs on every rank through the leader; everything else is the
    family's."""

    def __init__(self, family, leader: MeshLeader):
        self._family = family
        self._leader = leader

    def __getattr__(self, name):
        return getattr(self._family, name)

    def _run(self, program: str, *args):
        return self._leader.run(program, forward_of(self._family, program, self._leader.mesh),
                                *args)

    def forward_decode(self, *args):
        return self._run("decode", *args)

    def forward_prefill(self, *args):
        return self._run("prefill", *args)

    def forward_prefill_with_prefix(self, *args):
        return self._run("prefix", *args)

    def forward_verify(self, *args):
        return self._run("verify", *args)

    def forward_prefill_spliced(self, *args):
        return self._run("embeds", *args)


# ---------------------------------------------------------------------------
# Ranks >= 1
# ---------------------------------------------------------------------------


def serve(mesh: Mesh) -> int:
    """A shard worker's life on an initialised mesh: the spec, its shard,
    then one forward a step until ``stop``.  Returns the steps run."""
    from dynamo_tpu_torch.models.registry import get_family

    spec: ShardSpec = _send_object(None, mesh)
    family = get_family(spec.model_family)
    if spec.attention_impl == "kernel":
        from dynamo_tpu_torch.ops.kernels import build

        build.library()
    params, cache, cos, sin = build_shard(mesh, spec, family)
    cfg, steps = spec.model, 0
    shards = CacheShards(family, cfg, mesh, cache)
    logger.info("shard worker rank %d ready: %s", mesh.rank, mesh)
    while True:
        program, args = _recv_step(mesh)
        if program == "stop":
            return steps
        if program == "ping":
            continue
        if program == "zero_counts":
            _zero_counts()
        elif program == "counts":
            _gather_counts(mesh)
        elif program == "gather":
            gather_shards(mesh, cache, shards, args[0].cpu().tolist())
            steps += 1
        elif program == "scatter":
            scatter_shards(mesh, cache, shards, args[0].cpu().tolist())
            steps += 1
        else:
            tokens, *mid = args
            forward_of(family, program, mesh)(params, cfg, tokens, cache, *mid, cos, sin,
                                              mesh=mesh)
            steps += 1


def _watch_parent(parent_pid: int) -> None:
    """Exit at once when the process that started this worker is gone (a
    worker is never left behind its engine)."""
    def watch() -> None:
        while True:
            time.sleep(1.0)
            if os.getppid() != parent_pid:
                os._exit(3)

    threading.Thread(target=watch, name="parent-watch", daemon=True).start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one shard worker (rank >= 1) of an engine mesh")
    ap.add_argument("--init-method", help="file://STORE or tcp://HOST:PORT of the process group")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world-size", type=int)
    ap.add_argument("--mesh", default=None, help="dp,pp,ep,tp,sp (default: every rank on tp)")
    ap.add_argument("--device-offset", type=int, default=0)
    ap.add_argument("--device-type", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None)
    ap.add_argument("--timeout-s", type=float, default=None)
    ap.add_argument("--parent-pid", type=int, default=None)
    ap.add_argument("--control-plane", default=None, metavar="HOST:PORT",
                    help="join through the control plane (parallel/multihost.py) as node "
                         "--rank of --world-size, instead of --init-method")
    args = ap.parse_args(argv)
    if args.parent_pid is not None:
        _watch_parent(args.parent_pid)
    if args.device_type == "cpu":
        torch.set_num_threads(1)  # a CPU mesh's ranks share the host's cores
    if args.mesh:
        dp, pp, ep, tp, sp = (int(v) for v in args.mesh.split(","))
        config = MeshConfig(dp=dp, pp=pp, ep=ep, tp=tp, sp=sp, device_offset=args.device_offset)
    else:
        config = MeshConfig(tp=args.world_size, device_offset=args.device_offset)
    if args.control_plane:
        import asyncio

        from dynamo_tpu_torch.parallel.multihost import MultiNodeConfig, bootstrap_multihost
        from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
        from dynamo_tpu_torch.utils.config import RuntimeConfig

        async def join() -> None:
            rt = await DistributedRuntime.create(RuntimeConfig(control_plane=args.control_plane))
            try:
                await bootstrap_multihost(
                    rt.plane.kv, MultiNodeConfig(num_nodes=args.world_size, node_rank=args.rank),
                    backend=args.backend or "gloo", timeout=args.timeout_s or 300.0)
            finally:
                await rt.close()

        asyncio.run(join())
        mesh = make_mesh(config, device_type=args.device_type, backend=args.backend)
    else:
        mesh = make_mesh(config, device_type=args.device_type, backend=args.backend,
                         rank=args.rank, world_size=args.world_size,
                         init_method=args.init_method, timeout_s=args.timeout_s)
    try:
        steps = serve(mesh)
    except Exception as exc:  # noqa: BLE001 — rank 0 gone or out of step: leave
        logger.exception("shard worker rank %d stops: %r", mesh.rank, exc)
        os._exit(1)
    logger.info("shard worker rank %d stopped after %d steps", mesh.rank, steps)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
