"""The block copy kernels' plan (``plan_copy`` in
dynamo_tpu_torch/ops/kernels/block_copy.py) and the walk of
csrc/block_copy.cu, emulated on the CPU over byte tensors:
- pieces of equal size (a row's last may be shorter), numbered over
  (outer, i, piece); the grid's warps stride over them as the kernels do;
  the vector width's loads and stores
  are views of that width, at addresses it must divide;
- ids read as the kernels read them: from the by-value struct of the
  plan's capacity, and staged in a tensor;
- bitwise equal to the plain versions (``ops/block_copy.py``) for
  row_bytes in {1, 3, 1000, 1002, 2048, 16384, 2 MiB} x n in {1, 7, 93,
  256} x outer in {1, 27}, wherever the pool and batch fit in
  EMULATE_BYTES; on every shape, by interval arithmetic, each batch byte is
  covered exactly once and no piece crosses a row;
- bitwise equal to the Pallas kernels in interpret mode on two shapes;
- the plan's properties: the grid within its cap, the vector width a
  divisor of both bases and row_bytes, the smallest ids capacity that fits
  and the staged route above the largest, launch arguments that do not
  depend on the id values, and the C source's constants equal to the
  wrapper's."""

import math
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas import gather_blocks as pallas_gather
from dynamo_tpu.ops.pallas import scatter_blocks as pallas_scatter
from dynamo_tpu_torch.ops import block_copy as plain
from dynamo_tpu_torch.ops.kernels import block_copy as bk
from dynamo_tpu_torch.ops.kernels import build

SMS = 132  # an H100's SMs
ROWS = (1, 3, 1000, 1002, 2048, 16384, 2 << 20)
NS = (1, 7, 93, 256)
OUTERS = (1, 27)
SHAPES = [(r, n, o) for r in ROWS for n in NS for o in OUTERS]
EMULATE_BYTES = 64 << 20  # pool + batch sizes copied byte by byte
# a load or store of each vector width, as a view of that many bytes
VIEWS = {16: torch.complex128, 8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}
SOURCE = (Path(__file__).resolve().parents[1] / "dynamo_tpu_torch" / "csrc"
          / "block_copy.cu").read_text()


def check_plan(plan, outer, n, row_bytes, align=16):
    """The plan's shape-level properties, pieces by interval arithmetic."""
    assert plan.vec in bk.VECS and align % plan.vec == 0 and row_bytes % plan.vec == 0
    if plan.vec < 16:  # the widest: twice the width divides neither base nor row
        assert (align | row_bytes) % (2 * plan.vec) != 0
    assert plan.piece_bytes % plan.vec == 0 and 0 < plan.piece_bytes <= bk.PIECE_BYTES
    assert plan.pieces_per_row == math.ceil(row_bytes / plan.piece_bytes)
    assert plan.pieces == outer * n * plan.pieces_per_row
    assert 1 <= plan.grid <= bk.CTAS_PER_SM * SMS
    assert plan.grid == min(math.ceil(plan.pieces / bk.WARPS), bk.CTAS_PER_SM * SMS)
    # piece p of a row starts at p * piece_bytes: every piece non-empty and
    # inside its row, and the row's pieces tile it exactly once
    off = np.arange(plan.pieces_per_row, dtype=np.int64) * plan.piece_bytes
    length = np.minimum(plan.piece_bytes, row_bytes - off)
    assert (length > 0).all() and (off + length <= row_bytes).all()
    assert (off[1:] == off[:-1] + length[:-1]).all() and off[0] == 0
    assert int(length.sum()) == row_bytes
    # lengths equal up to the last piece, which is the shortest
    assert (length[:-1] == plan.piece_bytes).all()


def walk(plan):
    """Piece indices in the order the grid takes them: each warp (WARPS a
    CTA) strides by the grid's warp count."""
    workers = plan.grid * bk.WARPS
    for w in range(workers):
        yield from range(w, plan.pieces, workers)


def emulate(plan, src, dst, read_id, *, gather, n, n_pool, row_bytes, counts):
    """The kernel over flat byte tensors ``src`` and ``dst``: every piece
    copied in vector-width views, at addresses the width divides; each
    destination byte counted."""
    view = VIEWS[plan.vec]
    for t in walk(plan):
        row = t // plan.pieces_per_row
        off = (t - row * plan.pieces_per_row) * plan.piece_bytes
        o = row // n
        block = o * n_pool + read_id(row - o * n)
        src_row, dst_row = (block, row) if gather else (row, block)
        length = min(plan.piece_bytes, row_bytes - off)
        s, d = src_row * row_bytes + off, dst_row * row_bytes + off
        assert (src.data_ptr() + s) % plan.vec == 0 and (dst.data_ptr() + d) % plan.vec == 0
        dst[d:d + length].view(view).copy_(src[s:s + length].view(view))
        counts[d:d + length] += 1


def id_readers(plan, ids):
    """The kernels' two ids routes: the by-value struct of the plan's
    capacity (the largest when the plan stages), and ids staged in a
    tensor."""
    struct = np.zeros(plan.ids_cap or bk.ID_CAPS[-1], dtype=np.int32)
    struct[:len(ids)] = ids
    staged = torch.tensor(ids, dtype=torch.int32)
    return {"by_value": lambda i: int(struct[i]), "staged": lambda i: int(staged[i])}


def case_data(row_bytes, n, outer, seed):
    """A byte pool [outer, N, row] with N = n + 2, n distinct random ids,
    and a byte batch [outer, n, row]."""
    rng = np.random.default_rng(seed)
    n_pool = n + 2
    pool = torch.from_numpy(rng.integers(0, 256, (outer, n_pool, row_bytes), dtype=np.uint8))
    ids = rng.permutation(n_pool)[:n].tolist()
    blocks = torch.from_numpy(rng.integers(0, 256, (outer, n, row_bytes), dtype=np.uint8))
    return pool, ids, blocks


def emulate_both(plan, pool, ids, blocks, read_id):
    """(gathered batch, scattered pool, gather counts, scatter counts)."""
    outer, n_pool, row_bytes = pool.shape
    n = len(ids)
    out = torch.zeros((outer, n, row_bytes), dtype=torch.uint8)
    g_counts = torch.zeros(out.numel(), dtype=torch.int16)
    emulate(plan, pool.reshape(-1), out.view(-1), read_id, gather=True, n=n, n_pool=n_pool,
            row_bytes=row_bytes, counts=g_counts)
    target = pool.clone()
    s_counts = torch.zeros(target.numel(), dtype=torch.int16)
    emulate(plan, blocks.reshape(-1), target.view(-1), read_id, gather=False, n=n,
            n_pool=n_pool, row_bytes=row_bytes, counts=s_counts)
    return out, target, g_counts, s_counts


@pytest.mark.parametrize("row_bytes,n,outer", SHAPES, ids=lambda v: str(v))
def test_emulated_plan_matches_plain_and_copies_every_byte_once(row_bytes, n, outer):
    plan = bk.plan_copy(outer, n, row_bytes, SMS)
    check_plan(plan, outer, n, row_bytes)
    assert plan.ids_cap == min(c for c in bk.ID_CAPS if c >= n)
    if outer * (2 * n + 2) * row_bytes > EMULATE_BYTES:
        return  # the interval checks above cover this shape
    pool, ids, blocks = case_data(row_bytes, n, outer, seed=row_bytes + n + outer)
    ref_gather = plain.gather_blocks(pool, ids, 1)
    ref_scatter = plain.scatter_blocks(pool.clone(), blocks, ids, 1)
    for route_name, read_id in id_readers(plan, ids).items():
        out, target, g_counts, s_counts = emulate_both(plan, pool, ids, blocks, read_id)
        assert torch.equal(out, ref_gather), route_name
        assert torch.equal(target, ref_scatter), route_name
        assert bool((g_counts == 1).all()), route_name
        expect = torch.zeros((outer, n + 2, 1), dtype=torch.int16)
        expect[:, ids] = 1
        assert torch.equal(s_counts.view(outer, n + 2, row_bytes),
                           expect.expand(-1, -1, row_bytes)), route_name


@pytest.mark.parametrize("offset", [0, 1, 2, 4, 8, 12])
@pytest.mark.parametrize("row_bytes", [1000, 1002, 2048, 4100])
def test_vector_width_divides_both_bases_and_the_row(row_bytes, offset):
    """Bases ``offset`` bytes past an aligned address: the plan's width
    divides both, the emulation's views sit at addresses it divides, and
    the copy is bitwise the plain version's."""
    n, outer, n_pool = 5, 3, 9
    rng = np.random.default_rng(offset + row_bytes)
    raw = torch.from_numpy(rng.integers(0, 256, outer * n_pool * row_bytes + 64, dtype=np.uint8))
    base = (-raw.data_ptr()) % 64 + offset  # 64-byte aligned + offset
    pool = raw[base:base + outer * n_pool * row_bytes]
    out_raw = torch.zeros(outer * n * row_bytes + 64, dtype=torch.uint8)
    out_base = (-out_raw.data_ptr()) % 64 + offset
    out = out_raw[out_base:out_base + outer * n * row_bytes]
    align = bk.base_align(pool.data_ptr(), out.data_ptr())
    assert align == (offset | 16) & -(offset | 16)
    plan = bk.plan_copy(outer, n, row_bytes, SMS, align=align)
    check_plan(plan, outer, n, row_bytes, align)
    ids = rng.permutation(n_pool)[:n].tolist()
    counts = torch.zeros(out.numel(), dtype=torch.int16)
    emulate(plan, pool, out, lambda i: ids[i], gather=True, n=n, n_pool=n_pool,
            row_bytes=row_bytes, counts=counts)
    ref = plain.gather_blocks(pool.view(outer, n_pool, row_bytes), ids, 1)
    assert torch.equal(out.view(outer, n, row_bytes), ref)
    assert bool((counts == 1).all())


@pytest.mark.parametrize("piece_kib,ctas", [(4, 1), (4, 8), (8, 2), (32, 4), (64, 8)])
def test_plan_properties_hold_under_the_swept_constants(piece_kib, ctas, monkeypatch):
    """Phase ``sweep``'s other piece sizes and grid aims give plans with
    the same properties on every shape."""
    monkeypatch.setattr(bk, "PIECE_BYTES", piece_kib * 1024)
    monkeypatch.setattr(bk, "CTAS_PER_SM", ctas)
    for row_bytes, n, outer in SHAPES:
        plan = bk.plan_copy(outer, n, row_bytes, SMS)
        check_plan(plan, outer, n, row_bytes)
        assert plan.piece_bytes <= piece_kib * 1024


def test_a_2mib_block_spreads_over_every_sm_and_small_rows_share_a_cta():
    kvbm = bk.plan_copy(1, 64, 2 << 20, SMS)
    assert kvbm.grid == bk.CTAS_PER_SM * SMS and kvbm.pieces >= kvbm.grid * bk.WARPS // 2
    rope = bk.plan_copy(27, 93, 2048, SMS)
    assert rope.pieces == 27 * 93 and rope.grid == math.ceil(27 * 93 / bk.WARPS)
    assert rope.vec == 16 and rope.piece_bytes == 2048


@pytest.mark.parametrize("n,cap", [(1, 64), (64, 64), (65, 1024), (1024, 1024), (1025, 8160),
                                   (8160, 8160), (8161, 0), (20000, 0)])
def test_ids_capacity_is_the_smallest_that_fits(n, cap):
    assert bk.plan_copy(2, n, 1000, SMS).ids_cap == cap


def test_the_plan_refuses_an_empty_copy():
    with pytest.raises(ValueError, match="no copy to plan"):
        bk.plan_copy(1, 0, 1000, SMS)


@pytest.mark.parametrize("ptrs,align", [((0,), 16), ((0, 32), 16), ((8, 16), 8), ((2,), 2),
                                        ((1, 16), 1), ((4, 12), 4)])
def test_base_align(ptrs, align):
    assert bk.base_align(*ptrs) == align


class _Lib:
    """Stands in for the loaded library: each entry point a plain object
    that ``build._declare`` fills."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("n", [93, 9000])
def test_launch_arguments_do_not_depend_on_the_id_values(n, monkeypatch):
    """The wrapper's launch with a recording entry point: the same
    arguments for two id lists of one length, but the host ids' address
    (and the staged copy's); the staged route above the largest capacity;
    as many arguments as the entry's ctypes declaration and C signature."""
    monkeypatch.setattr(bk, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(bk, "stream_ptr", lambda dev: 4096)
    staged = []

    def stage(ids, device):
        staged.append(torch.from_numpy(ids.copy()))
        return staged[-1]

    monkeypatch.setattr(bk, "_stage_ids", stage)
    calls = []
    n_pool = 12000
    pool = torch.zeros((3, n_pool, 64), dtype=torch.uint8)
    out = torch.zeros((3, n, 64), dtype=torch.uint8)
    rng = np.random.default_rng(n)
    for ids in (rng.permutation(n_pool)[:n], rng.permutation(n_pool)[:n]):
        checked = bk._check_ids(ids.tolist(), n_pool, unique=True)
        bk._launch(lambda *a: calls.append(a) or 0, "scatter_blocks", pool, out, checked,
                   3, n_pool, 64)
    a, b = calls
    assert a[:2] == b[:2] and a[4:] == b[4:]
    assert a[2] != b[2]  # each call's own host ids
    if n > bk.ID_CAPS[-1]:
        assert a[11] == 0 and len(staged) == 2 and a[3] == staged[0].data_ptr()
    else:
        assert a[11] == 1024 and a[3] is None and not staged
    lib = _Lib()
    build._declare(lib)
    for entry in ("dyn_gather_blocks", "dyn_scatter_blocks"):
        assert len(getattr(lib, entry).argtypes) == len(a)
        params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', SOURCE).group(1)
        assert len(params.split(",")) == len(a)


def test_the_c_source_constants_equal_the_wrappers():
    caps = re.search(r"constexpr int ID_CAPS\[\] = \{([^}]*)\};", SOURCE).group(1)
    assert tuple(int(c) for c in caps.split(",")) == bk.ID_CAPS
    assert int(re.search(r"constexpr int THREADS = (\d+);", SOURCE).group(1)) == 32 * bk.WARPS
    # the by-value struct: a 64-byte header and the largest list within the
    # 32,764 bytes of parameters a launch may pass
    assert 64 + 4 * bk.ID_CAPS[-1] <= 32764


@pytest.mark.parametrize("row_bytes,dtype,block", [(1000, np.uint8, (1000,)),
                                                   (16384, np.float32, (32, 128))])
def test_emulated_plan_matches_pallas_kernels_in_interpret_mode(row_bytes, dtype, block):
    n, n_pool = 7, 12
    rng = np.random.default_rng(row_bytes)
    if dtype == np.uint8:
        pool_np = rng.integers(0, 256, (n_pool, *block), dtype=np.uint8)
        blocks_np = rng.integers(0, 256, (n, *block), dtype=np.uint8)
    else:
        pool_np = rng.standard_normal((n_pool, *block)).astype(dtype)
        blocks_np = rng.standard_normal((n, *block)).astype(dtype)
    ids = rng.permutation(n_pool)[:n].tolist()
    ref_gather = np.asarray(pallas_gather(jnp.asarray(pool_np), jnp.asarray(ids, jnp.int32),
                                          interpret=True))
    ref_scatter = np.asarray(pallas_scatter(jnp.asarray(pool_np), jnp.asarray(blocks_np),
                                            jnp.asarray(ids, jnp.int32), interpret=True))
    pool = torch.from_numpy(pool_np.view(np.uint8).reshape(1, n_pool, row_bytes).copy())
    blocks = torch.from_numpy(blocks_np.view(np.uint8).reshape(1, n, row_bytes).copy())
    plan = bk.plan_copy(1, n, row_bytes, SMS)
    for route, read_id in id_readers(plan, ids).items():
        out, target, _, _ = emulate_both(plan, pool, ids, blocks, read_id)
        np.testing.assert_array_equal(out.numpy().reshape(n, -1),
                                      ref_gather.view(np.uint8).reshape(n, -1), err_msg=route)
        np.testing.assert_array_equal(target.numpy().reshape(n_pool, -1),
                                      ref_scatter.view(np.uint8).reshape(n_pool, -1),
                                      err_msg=route)


def test_id_checks_name_the_first_bad_and_the_sorted_duplicate_ids():
    ids = [5, 900, 3, -2, 7, 900, 3] + list(range(10, 20))
    with pytest.raises(ValueError, match=r"block ids \[900, -2, 900\] outside the pool's"):
        bk._check_ids(ids, 100, unique=False)
    with pytest.raises(ValueError, match=r"duplicate scatter block ids \[3, 11\]"):
        bk._check_ids([11, 3, 4, 3, 11, 11], 100, unique=True)
    checked = bk._check_ids([4, 4, 0], 5, unique=False)
    assert checked.dtype == np.int32 and checked.flags.c_contiguous
    assert checked.tolist() == [4, 4, 0]
