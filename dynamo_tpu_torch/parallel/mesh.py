"""Device mesh over ``torch.distributed`` (counterpart of
dynamo_tpu/parallel/mesh.py).

The reference expresses its parallelism as one ``jax.sharding.Mesh`` with
named axes and PartitionSpecs, and XLA emits the collectives.  The port
runs one process a rank: ``make_mesh`` returns this rank's ``Mesh`` (its
rank, the world size, its device and the process groups of its axes), a
leaf's spec is a tuple of axis names as the reference's PartitionSpec
(``None`` = not sharded on that dimension), ``shard_leaf`` takes this
rank's slice of a full leaf as ``NamedSharding`` would place it, and the
forwards call ``all_reduce`` / ``all_gather`` where GSPMD would have put
its collectives.  Both helpers are the identity where the mesh is None or
the axes have size 1.  Pipeline stages and the sequence ring move their
tensors point to point (``exchange``, ``ring_shift``; the reference's
``ppermute``), bit for bit, and so do the cache blocks an engine mesh
gathers to rank 0 and scatters from it (``gather_to_root``,
``scatter_from_root``).  Every collective, stage hand-off, ring rotation
and block transfer is counted with the seconds it took (``comm_counters``).

Axes (any may be 1): ``dp`` data, ``pp`` pipeline stage, ``ep`` expert,
``tp`` tensor, ``sp`` sequence.  Ranks lay out in ``AXIS_ORDER`` with ``tp``
and ``sp`` innermost, as the reference lays out its devices.

Backend: ``nccl`` when every rank of this host has its own card, ``gloo`` on
the CPU.  Ranks may share a card only over ``gloo``, and only where the
caller names it (``backend="gloo"`` or ``DYN_MESH_BACKEND=gloo``); without
it a mesh wider than the host's cards is refused with the reference's
message.  Over gloo every collective stages its tensor through host memory
in float32 (gloo's bf16 support is not assured, and a float32 sum of bf16
partials is what the reference's all-reduce computes at best); over nccl
the float32 copy stays on the card.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch.utils import knobs

AXIS_ORDER = ("dp", "pp", "ep", "tp", "sp")

# the axis combinations a forward reduces over: tensor-parallel products,
# expert banks (each rank's experts, each expert's tp-sharded intermediate),
# data-parallel replicas, pipeline stages and the sequence ring
_GROUP_AXES = (("tp",), ("ep",), ("ep", "tp"), ("dp",), ("pp",), ("sp",))

# calls and seconds of this process's mesh traffic by kind: "collective"
# (all_reduce, all_gather), "handoff" (a pipeline stage's sends and
# receives), "ring" (the sequence ring's rotations), "transfer" (cache
# blocks gathered to rank 0 or scattered from it)
COMM_KINDS = ("collective", "handoff", "ring", "transfer")
_COMM = {kind: [0, 0.0] for kind in COMM_KINDS}


def comm_counters() -> dict[str, float]:
    """``{"<kind>_calls": n, "<kind>_s": seconds}`` of every kind of mesh
    traffic since the last ``zero_comm_counters``."""
    out: dict[str, float] = {}
    for kind, (calls, secs) in _COMM.items():
        out[f"{kind}_calls"], out[f"{kind}_s"] = calls, secs
    return out


def zero_comm_counters() -> None:
    for entry in _COMM.values():
        entry[:] = [0, 0.0]


def _count(kind: str, t0: float) -> None:
    entry = _COMM[kind]
    entry[0] += 1
    entry[1] += time.perf_counter() - t0


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    pp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1
    # first device index this mesh claims (two engines of one host on
    # disjoint cards)
    device_offset: int = 0

    def total(self) -> int:
        return self.dp * self.pp * self.ep * self.tp * self.sp

    def axis_sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    @classmethod
    def tp_only(cls, tp: int) -> "MeshConfig":
        return cls(tp=tp)


class Mesh:
    """One rank's view of the mesh: its rank, the world size, its device,
    its coordinate on every axis and the process group of each axis
    combination the forwards reduce over."""

    def __init__(self, config: MeshConfig, rank: int, world_size: int, device: torch.device,
                 backend: str, groups: dict[tuple[str, ...], Any]):
        self.config = config
        self.rank = rank
        self.world_size = world_size
        self.device = device
        self.backend = backend
        self._groups = groups
        self.coords = rank_coords(config, rank)
        # protocol tensors (step headers, weights) travel on the host over
        # gloo, on the card over nccl
        self.wire_device = torch.device("cpu") if backend == "gloo" else device

    def size(self, axes: str | tuple[str, ...]) -> int:
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([getattr(self.config, a) for a in axes]))

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axes: str | tuple[str, ...]):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self._groups[axes]

    def __repr__(self) -> str:
        sizes = ", ".join(f"{a}={getattr(self.config, a)}" for a in AXIS_ORDER)
        return f"Mesh({sizes}; rank {self.rank}/{self.world_size} on {self.device} over {self.backend})"


def mesh_size(mesh: Mesh | None, axes: str | tuple[str, ...] = "tp") -> int:
    return 1 if mesh is None else mesh.size(axes)


def all_reduce(x: torch.Tensor, mesh: Mesh | None, axes: str | tuple[str, ...] = "tp"
               ) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, in float32, cast back to
    ``x``'s dtype; ``x`` itself where the axes have size 1."""
    if mesh_size(mesh, axes) == 1:
        return x
    import torch.distributed as dist

    t0 = time.perf_counter()
    wire = x.detach().to(mesh.wire_device, torch.float32)
    dist.all_reduce(wire, group=mesh.group(axes))
    out = wire.to(x.device, x.dtype)
    _count("collective", t0)
    return out


def all_gather(x: torch.Tensor, mesh: Mesh | None, axes: str | tuple[str, ...] = "tp",
               dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` of ``axes`` concatenated on ``dim`` in rank order
    (float32 on the wire, exact for any float dtype); ``x`` itself where the
    axes have size 1."""
    n = mesh_size(mesh, axes)
    if n == 1:
        return x
    import torch.distributed as dist

    t0 = time.perf_counter()
    wire = x.detach().to(mesh.wire_device, torch.float32).contiguous()
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=mesh.group(axes))
    out = torch.cat(parts, dim=dim).to(x.device, x.dtype)
    _count("collective", t0)
    return out


def broadcast(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """``x`` from rank ``src`` to every rank of the world, bit for bit
    (through a byte view: every dtype, fp8 and bf16 included).  Returns the
    received tensor on ``x``'s device."""
    import torch.distributed as dist

    wire = x.detach().contiguous().to(mesh.wire_device)
    dist.broadcast(wire.view(-1).view(torch.uint8), src=src)
    return wire.to(x.device)


# ---------------------------------------------------------------------------
# Point to point: pipeline hand-offs and the sequence ring
# ---------------------------------------------------------------------------


def stage_peer(mesh: Mesh, delta: int, axis: str = "pp") -> int:
    """The rank at this rank's coordinates on every axis but ``axis``, which
    moves by ``delta`` (modulo its size): on pp, the same (ep, tp, sp)
    coordinates on stage ``pp + delta`` (a stage hands its activations to
    the tp rank of its own index on the next stage); on sp, the ring's
    neighbour."""
    coords = dict(mesh.coords)
    coords[axis] = (coords[axis] + delta) % mesh.size(axis)
    shape = [mesh.config.axis_sizes()[a] for a in AXIS_ORDER]
    return int(np.ravel_multi_index([coords[a] for a in AXIS_ORDER], shape))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def exchange(sends, recvs, mesh: Mesh, kind: str = "handoff") -> list[torch.Tensor]:
    """Point-to-point transfers in one batch: ``sends`` [(tensor, dst)],
    ``recvs`` [(template, src)] (a tensor of the shape, dtype and device to
    receive); returns the received tensors in order, bit for bit what was
    sent (through a byte view on the wire device).  Every transfer is posted
    before any is waited on (``batch_isend_irecv``), so no order of sends
    and receives among the ranks can deadlock."""
    import torch.distributed as dist

    if not sends and not recvs:
        return []
    t0 = time.perf_counter()
    ops, outs = [], []
    for t, dst in sends:
        wire = t.detach().contiguous().to(mesh.wire_device)
        ops.append(dist.P2POp(dist.isend, _bytes(wire), dst))
    for like, src in recvs:
        wire = torch.empty(like.shape, dtype=like.dtype, device=mesh.wire_device)
        outs.append(wire)
        ops.append(dist.P2POp(dist.irecv, _bytes(wire), src))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    got = [w.to(like.device) for w, (like, _) in zip(outs, recvs)]
    _count(kind, t0)
    return got


class Posted:
    """Sends posted by ``post_sends``: ``wait()`` completes them (their
    buffers live until then)."""

    def __init__(self, works, buffers, kind: str):
        self._works, self._buffers, self._kind = works, buffers, kind

    def wait(self) -> None:
        t0 = time.perf_counter()
        for work in self._works:
            work.wait()
        self._works, self._buffers = [], []
        _count(self._kind, t0)


def post_sends(sends, mesh: Mesh, kind: str = "handoff") -> Posted:
    """``sends`` [(tensor, dst)] posted and not waited on: a pipeline stage
    goes on to its next microbatch while its last output travels.  Bitwise
    as ``exchange``."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    buffers = [_bytes(t.detach().contiguous().to(mesh.wire_device)) for t, _ in sends]
    works = [dist.isend(b, dst) for b, (_, dst) in zip(buffers, sends)]
    _count(kind, t0)
    return Posted(works, buffers, kind)


def gather_to_root(x: torch.Tensor | None, mesh: Mesh, templates: dict | None = None
                   ) -> dict[int, torch.Tensor] | None:
    """Every sending rank's ``x`` to rank 0, bit for bit (``exchange``'s byte
    views).  On rank 0 ``templates`` {rank: a tensor of the shape, dtype
    and device to receive} names the ranks that send, and the received
    tensors come back by rank; a rank >= 1 sends ``x`` (None: it sends
    nothing) and gets None."""
    if mesh.rank == 0:
        got = exchange([], [(like, r) for r, like in sorted((templates or {}).items())], mesh,
                       "transfer")
        return dict(zip(sorted(templates or {}), got))
    if x is not None:
        exchange([(x, 0)], [], mesh, "transfer")
    return None


def scatter_from_root(parts: dict | None, mesh: Mesh, like: torch.Tensor | None = None
                      ) -> torch.Tensor | None:
    """Each rank's part from rank 0, bit for bit: rank 0 sends ``parts``
    {rank: tensor} (its own part, if any, stays where it is: None comes
    back); a rank >= 1 receives a tensor like ``like``."""
    if mesh.rank == 0:
        exchange([(t, r) for r, t in sorted((parts or {}).items()) if r != 0], [], mesh,
                 "transfer")
        return None
    return exchange([], [(like, 0)], mesh, "transfer")[0]


def ring_shift(tensors, mesh: Mesh | None, axis: str = "sp") -> list[torch.Tensor]:
    """Each rank's ``tensors`` to the next rank of ``axis`` (index i to
    i + 1, the last to the first), the previous rank's returned: the
    counterpart of ``jax.lax.ppermute`` with ``perm = [(i, (i + 1) % n)]``.
    Bitwise; the identity at size 1."""
    tensors = list(tensors)
    if mesh_size(mesh, axis) == 1:
        return tensors
    nxt, prev = stage_peer(mesh, 1, axis), stage_peer(mesh, -1, axis)
    return exchange([(t, nxt) for t in tensors], [(t, prev) for t in tensors], mesh, "ring")


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def resolve_backend(config: MeshConfig, device_type: str, requested: str | None,
                    local_ranks: int) -> str:
    """The process-group backend of a mesh of ``local_ranks`` ranks on this
    host: gloo on the CPU; on cards nccl, or gloo where the caller named it
    (the only way two ranks may share a card).  A mesh wider than the
    host's cards without gloo named is refused with the reference's
    message."""
    requested = requested or knobs.get("DYN_MESH_BACKEND") or None
    if requested not in (None, "gloo", "nccl"):
        raise ValueError(f"unknown mesh backend {requested!r} (want gloo or nccl)")
    if device_type == "cpu":
        if requested == "nccl":
            raise ValueError("a CPU mesh runs over gloo; nccl needs cards")
        return "gloo"
    have = torch.cuda.device_count()
    off = config.device_offset
    if requested == "gloo":
        if off < 0 or off >= have:
            raise ValueError(f"mesh needs devices [{off}, {off + 1}), have {have}")
        return "gloo"
    if off < 0 or off + local_ranks > have:
        raise ValueError(
            f"mesh needs devices [{off}, {off + local_ranks}), have {have}; ranks share a "
            "card only over gloo, named by the caller (backend='gloo' or DYN_MESH_BACKEND=gloo)"
        )
    return "nccl"


def rank_device(config: MeshConfig, device_type: str, local_rank: int) -> torch.device:
    """``cuda:{device_offset + local_rank}``, wrapped onto the host's cards
    where ranks share them (gloo, named); the CPU on a CPU mesh."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", (config.device_offset + local_rank) % torch.cuda.device_count())


def _make_groups(config: MeshConfig, backend: str, rank: int) -> dict:
    """Every rank creates every group, in one order (``new_group`` is
    collective over the world); each keeps the groups it belongs to."""
    import torch.distributed as dist

    shape = [config.axis_sizes()[a] for a in AXIS_ORDER]
    ranks = np.arange(config.total()).reshape(shape)
    groups: dict[tuple[str, ...], Any] = {}
    for axes in _GROUP_AXES:
        n = int(np.prod([getattr(config, a) for a in axes]))
        if n == 1:
            groups[axes] = None
            continue
        if n == config.total():
            groups[axes] = dist.group.WORLD
            continue
        keep = [AXIS_ORDER.index(a) for a in axes]
        other = [i for i in range(len(AXIS_ORDER)) if i not in keep]
        moved = np.moveaxis(ranks, other + keep, list(range(len(AXIS_ORDER))))
        for idx in itertools.product(*(range(shape[i]) for i in other)):
            members = [int(r) for r in moved[idx].reshape(-1)]
            g = dist.new_group(members, backend=backend)
            if rank in members:
                groups[axes] = g
    return groups


def make_mesh(config: MeshConfig | None = None, *, device_type: str = "cuda",
              backend: str | None = None, rank: int | None = None,
              world_size: int | None = None, init_method: str | None = None,
              local_rank: int | None = None, local_ranks: int | None = None,
              timeout_s: float | None = None) -> Mesh:
    """This rank's mesh.  Joins the process group first where none is
    initialised (``rank``, ``world_size`` and ``init_method``, e.g.
    ``file://`` a store file or ``tcp://host:port``), else takes the
    initialised group's rank and size.  ``config`` defaults to every rank on
    the tp axis.  ``local_rank`` (default the rank) picks the card,
    ``local_ranks`` (default the world) are this host's ranks."""
    import torch.distributed as dist

    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    elif rank is None or world_size is None or init_method is None:
        raise ValueError("no process group: make_mesh needs rank, world_size and init_method")
    config = config or MeshConfig(tp=world_size)
    if config.total() != world_size:
        raise ValueError(f"mesh of {config.total()} ranks over a world of {world_size}")
    local_rank = rank if local_rank is None else local_rank
    chosen = resolve_backend(config, device_type, backend, local_ranks or world_size)
    device = rank_device(config, device_type, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        timeout = timeout_s if timeout_s is not None else knobs.get("DYN_MESH_TIMEOUT_S")
        dist.init_process_group(chosen, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timedelta(seconds=timeout))
    return Mesh(config, rank, world_size, device, chosen, _make_groups(config, chosen, rank))


# ---------------------------------------------------------------------------
# Sharding: a leaf's slice on this rank, as NamedSharding places it
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def rank_coords(config: MeshConfig, rank: int) -> dict[str, int]:
    """Rank ``rank``'s coordinate on every axis of a mesh of ``config``."""
    shape = [config.axis_sizes()[a] for a in AXIS_ORDER]
    return dict(zip(AXIS_ORDER, (int(c) for c in np.unravel_index(rank, shape))))


def shard_index(shape, spec: tuple, mesh: Mesh, name: str = "leaf",
                coords: dict[str, int] | None = None) -> tuple[slice, ...]:
    """The slices of a leaf of ``shape`` that this rank (or the rank at
    ``coords``) holds under ``spec``: dimension d split into equal
    contiguous parts over the spec's axes (rank-major in the order named),
    as ``NamedSharding`` splits it.  A dimension the axes do not divide is
    refused with the reference's message (``jax.device_put`` refuses
    uneven shards; the reference pads nothing)."""
    coords = coords or mesh.coords
    if len(spec) > len(shape):
        raise ValueError(f"{name}: spec {spec} has more entries than the leaf's rank {len(shape)}")
    index = []
    for d, size in enumerate(shape):
        axes = _entry_axes(spec[d] if d < len(spec) else None)
        n = int(np.prod([mesh.size(a) for a in axes])) if axes else 1
        if size % n:
            raise ValueError(
                f"{name} was given the sharding PartitionSpec{tuple(spec)}, which implies that "
                f"the global size of its dimension {d} should be divisible by {n}, but it is "
                f"equal to {size} (full shape: {tuple(shape)})"
            )
        part = 0
        for a in axes:  # the first named axis is the most significant
            part = part * mesh.size(a) + coords[a]
        step = size // n
        index.append(slice(part * step, (part + 1) * step))
    return tuple(index)


def shard_leaf(x: torch.Tensor, spec: tuple, mesh: Mesh, name: str = "leaf") -> torch.Tensor:
    """This rank's slice of the full leaf ``x``, as a tensor of its own (the
    full leaf can be freed at once)."""
    return x[shard_index(x.shape, spec, mesh, name)].clone(memory_format=torch.contiguous_format)


def shard_tree(tree, specs, mesh: Mesh, path: tuple[str, ...] = ()):
    """This rank's slice of every leaf of ``tree`` under the matching
    ``specs`` tree.  A ``QuantizedMatrix`` leaf takes its spec twin from
    ``ops.quant.quantize_specs``, or a plain spec whose scale spec is
    derived (``scale_spec``)."""
    from dynamo_tpu_torch.ops.quant import QuantizedMatrix, scale_spec

    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, path + (k,)) for k, v in tree.items()}
    name = "/".join(path)
    if isinstance(tree, QuantizedMatrix):
        qs = specs if isinstance(specs, QuantizedMatrix) else QuantizedMatrix(
            specs, scale_spec(specs))
        return QuantizedMatrix(shard_leaf(tree.q, qs.q, mesh, name + "/q"),
                               shard_leaf(tree.s, qs.s, mesh, name + "/s"))
    return shard_leaf(tree, specs, mesh, name)


def spec_at(specs: dict, path: tuple[str, ...]):
    node = specs
    for key in path:
        node = node[key]
    return node


def leaf_sharder(specs: dict, mesh: Mesh, quantize_leaves: tuple[str, ...] = ()):
    """``shard(path, full) -> this rank's leaf``: the slice of one full leaf
    under its spec in ``specs``, quantized first (int8, on the full matrix,
    so every scale is its whole column's) where the leaf's name is in
    ``quantize_leaves``.  Weights reach a rank one full leaf at a time
    through it (``init_params(..., shard=)``, the engine's broadcast)."""
    from dynamo_tpu_torch.ops.quant import QuantizedMatrix, quantize_matrix

    def shard(path: tuple[str, ...], full):
        if path[-1] in quantize_leaves and not isinstance(full, QuantizedMatrix):
            full = quantize_matrix(full)
        return shard_tree(full, spec_at(specs, path), mesh, path)

    return shard


def shard_config(cfg, mesh: Mesh | None):
    """The family config one tp rank computes with: ``num_heads`` (and
    ``num_kv_heads`` where the config has one) divided by tp; widths of
    everything else, the vocabulary included, are the model's."""
    tp = mesh_size(mesh, "tp")
    if tp == 1:
        return cfg
    changes = {}
    for field in ("num_heads", "num_kv_heads"):
        if hasattr(cfg, field):
            n = getattr(cfg, field)
            if n % tp:
                raise ValueError(f"{field}={n} is not divisible by the tp axis ({tp})")
            changes[field] = n // tp
    return dataclasses.replace(cfg, **changes)


def clamp_token_ids(token_ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """The row of a ``vocab``-row table each id reads under the reference's
    gather: a negative id counts from the end, and the result is clamped
    into ``[0, vocab - 1]`` (``params["embed"][ids]`` in JAX clamps where
    torch's indexing raises, or asserts on the device).  Elementwise on the
    ids' device, so a captured step reads nothing back."""
    ids = torch.where(token_ids < 0, token_ids + vocab, token_ids)
    return ids.clamp(0, vocab - 1)


def embed_rows(table: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """``table[token_ids]`` with the reference's gather semantics
    (``clamp_token_ids``)."""
    return table[clamp_token_ids(token_ids, table.shape[0])]


def vocab_parallel_embed(table: torch.Tensor, token_ids: torch.Tensor, mesh: Mesh
                         ) -> torch.Tensor:
    """The rows of ``token_ids`` from a vocab-sharded embedding: each rank
    looks up the ids in its slice (zeros elsewhere), and the sum over tp
    holds each row once, exactly.  The global id is clamped first
    (``clamp_token_ids`` over the whole vocabulary), so an out-of-vocab id
    reads the row the reference's gather reads, from exactly one rank."""
    n = table.shape[0]
    ids = clamp_token_ids(token_ids.long(), n * mesh_size(mesh, "tp"))
    local = ids - mesh.index("tp") * n
    hit = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return all_reduce(rows, mesh, "tp")
