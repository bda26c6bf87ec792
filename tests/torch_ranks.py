"""A pool of rank processes for the port's mesh tests, and the jobs they run.

Each rank is ``python -m tests.torch_ranks``: it imports torch and the port,
never JAX.  The test process (which holds the JAX reference) sends every
rank the same job, length-prefixed pickles over stdin; the ranks of the
job's world join one process group over a FileStore under the test's
temporary directory, run the job with their mesh, leave the group, and
rank 0 answers.  One pool serves a whole test file, so the ranks' start-up
is paid once.
"""

from __future__ import annotations

import os
import pickle
import struct
import subprocess
import sys
from collections import namedtuple
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# a quantized leaf as the test sends it: the reference's QuantizedMatrix
# would import JAX where it is unpickled (``params_from_jax`` reads q and s)
QS = namedtuple("QS", "q s")


def plain_tree(tree):
    """The reference's numpy parameter tree with every quantized node as a
    ``QS`` (picklable without JAX)."""
    if isinstance(tree, dict):
        return {k: plain_tree(v) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "s"):
        return QS(tree.q, tree.s)
    return tree


def _read(stream):
    head = stream.read(8)
    if len(head) < 8:
        return None
    (n,) = struct.unpack("<Q", head)
    return pickle.loads(stream.read(n))


def _write(stream, obj) -> None:
    data = pickle.dumps(obj)
    stream.write(struct.pack("<Q", len(data)) + data)
    stream.flush()


class RankPool:
    """``size`` rank processes; ``run(world, mesh_sizes, job, **kw)`` runs
    ``job`` (a function of this module) on ranks 0..world-1 and returns
    rank 0's result."""

    def __init__(self, size: int, tmp_dir: Path):
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        env.pop("JAX_PLATFORMS", None)
        self.tmp_dir = Path(tmp_dir)
        self.procs = [
            subprocess.Popen([sys.executable, "-m", "tests.torch_ranks", str(r)], cwd=ROOT,
                             env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            for r in range(size)
        ]
        self._jobs = 0

    def run(self, world: int, mesh: dict, job: str, **kwargs):
        self._jobs += 1
        store = self.tmp_dir / f"store_{self._jobs}"
        for rank in range(world):
            _write(self.procs[rank].stdin, (str(store), rank, world, mesh, job, kwargs))
        results = [_read(self.procs[rank].stdout) for rank in range(world)]
        for r in results:
            if r is None or r[0] != "ok":
                raise RuntimeError(f"rank job {job} failed: {r}")
        return results[0][1]

    def close(self) -> None:
        for p in self.procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


# ---------------------------------------------------------------------------
# Jobs (run in the rank processes)
# ---------------------------------------------------------------------------


def _family_module(name: str):
    from dynamo_tpu_torch.models import deepseek, gemma2, gemma3, llama, mixtral

    return {"llama": llama, "mixtral": mixtral, "deepseek": deepseek, "gemma2": gemma2,
            "gemma3": gemma3}[name]


def forwards(mesh, *, family: str, cfg, params, blocks, steps, microbatches=None,
             caches=False):
    """Run ``steps`` (("prefill"|"prefix"|"decode", inputs)) through the
    family's forwards with this rank's shard of ``params`` (numpy, the
    reference's tree) and a zeroed cache of ``blocks`` (num_blocks,
    block_size) for this rank's heads and stage (``shard_cache``); the
    decode is the pipelined one on a pp mesh (``forward_of``), in
    ``microbatches`` where given.  Returns each step's logits (numpy
    float32), and with ``caches`` every rank's cache leaves after the last
    step, in rank order."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dynamo_tpu_torch.engine.shard_worker import forward_of, shard_cache
    from dynamo_tpu_torch.models.llama import params_from_jax
    from dynamo_tpu_torch.models.registry import get_family

    mod = _family_module(family)
    fam = get_family({"deepseek": "deepseek_v2"}.get(family, family))
    shard = mod.shard_params(params_from_jax(params, "cpu"), cfg, mesh)
    kv = shard_cache(fam, cfg, mesh, *blocks, None, "cpu")
    cos, sin = fam.make_rope_tables(cfg, "cpu", 256)
    out = []
    for kind, inputs in steps:
        args = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in inputs]
        fn = forward_of(fam, kind, mesh)
        kw = {"microbatches": microbatches} if fn is fam.forward_decode_pp and microbatches \
            else {}
        tokens, *mid = args
        logits, kv = fn(shard, cfg, tokens, kv, *mid, cos, sin, mesh=mesh, **kw)
        out.append(None if logits is None else logits.numpy())
    if not caches:
        return out
    every: list = [None] * mesh.world_size
    dist.all_gather_object(every, {k: v.numpy() for k, v in kv.items()})
    return out, every


def moe_drops(mesh, *, ids, capacity, num_experts):
    """The pairs this rank's experts dropped, summed over the ranks of ep."""
    import torch

    from dynamo_tpu_torch.ops.moe import expert_slots
    from dynamo_tpu_torch.parallel.mesh import all_reduce

    local = num_experts // mesh.size("ep")
    flat, _, within = expert_slots(torch.as_tensor(ids), capacity, mesh.index("ep") * local,
                                   local)
    mine = int(((flat >= 0) & (flat < local) & ~within).sum())
    total = all_reduce(torch.tensor([float(mine)]), mesh, "ep")
    return int(mine), int(total.item())


def ring_probe(mesh):
    """``ring_shift`` of each rank's index (bf16) round an sp ring: every
    rank's received value, in rank order."""
    import torch
    import torch.distributed as dist

    from dynamo_tpu_torch.parallel.mesh import ring_shift

    got, = ring_shift([torch.full((3,), float(mesh.rank), dtype=torch.bfloat16)], mesh)
    out: list = [None] * mesh.world_size
    dist.all_gather_object(out, float(got[0]))
    return {"ring": out}


def stage_probe(mesh):
    """Two microbatches of ones through ``pipeline_layer_stack`` at pp = 3,
    each stage adding one: every rank's output, and the hand-offs
    counted."""
    import torch
    import torch.distributed as dist

    from dynamo_tpu_torch.parallel.mesh import comm_counters
    from dynamo_tpu_torch.parallel.pipeline import pipeline_layer_stack

    x = torch.zeros((2, 1), dtype=torch.bfloat16)
    y = pipeline_layer_stack(lambda xm, aux, i, w: xm + 1, x, (), {"w": torch.zeros(1)}, mesh,
                             microbatches=2)
    out: list = [None] * mesh.world_size
    dist.all_gather_object(out, y[:, 0].float().tolist())
    return {"stages": out, "handoff_calls": comm_counters()["handoff_calls"]}


def card_identity(mesh):
    """Every rank's topology card identity (``topology/card.py``), in rank
    order."""
    import torch.distributed as dist

    from dynamo_tpu_torch.topology.card import local_card

    card = local_card(7)
    out: list = [None] * mesh.world_size
    dist.all_gather_object(out, (card.process_index, card.coords))
    return out


def all_reduce_224(mesh):
    """The reference multihost test's check: a global [8, 8] array of row
    indices, rows split over the ranks, summed everywhere: 224."""
    import torch

    from dynamo_tpu_torch.parallel.mesh import all_reduce

    rows = 8 // mesh.world_size
    mine = torch.arange(mesh.rank * rows, (mesh.rank + 1) * rows,
                        dtype=torch.float32)[:, None] * torch.ones(1, 8)
    return float(all_reduce(mine.sum().reshape(1), mesh, "tp").item())


def multihost(control_plane: str, rank: int, coordinator: str) -> int:
    """One of two processes of the multihost test: bootstrap through the
    control plane, build the mesh on the joined group, and print the
    all-reduce's value."""
    import asyncio

    import torch

    from dynamo_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from dynamo_tpu_torch.parallel.multihost import MultiNodeConfig, bootstrap_multihost
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    torch.set_num_threads(1)

    async def join() -> None:
        rt = await DistributedRuntime.create(RuntimeConfig(control_plane=control_plane))
        try:
            await bootstrap_multihost(rt.plane.kv, MultiNodeConfig(
                num_nodes=2, node_rank=rank, leader_addr=coordinator), timeout=90)
        finally:
            await rt.close()

    asyncio.run(join())
    mesh = make_mesh(MeshConfig(tp=2), device_type="cpu")
    print(f"RANK_OK {mesh.rank} {all_reduce_224(mesh)}", flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "multihost":
        return multihost(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    import torch
    import torch.distributed as dist

    from dynamo_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    torch.set_num_threads(1)
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    sys.stdout = sys.stderr  # logging and prints stay off the result pipe
    while True:
        job = _read(stdin)
        if job is None:
            return 0
        store, rank, world, sizes, name, kwargs = job
        try:
            mesh = make_mesh(MeshConfig(**sizes), device_type="cpu", rank=rank,
                             world_size=world, init_method=f"file://{store}", timeout_s=60)
            try:
                result = ("ok", globals()[name](mesh, **kwargs))
            finally:
                dist.destroy_process_group()
        except Exception as exc:  # noqa: BLE001 — reported to the test
            import traceback

            result = ("error", f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}")
        _write(stdout, result)


if __name__ == "__main__":
    sys.exit(main())
