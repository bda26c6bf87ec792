"""Kernel autotuner for the ragged packed attention family (counterpart of
dynamo_tpu/ops/autotune.py, whose host logic this copies).

The unified step's kernel (row 1, ``ops/kernels/ragged_attention.py``)
exposes a small tunable space that the engine otherwise fills with
heuristics:

- ``tb_tokens`` — token-block size of the packed ragged kernel (default
  ``gcd(block_size, 8)``);
- ``page_slots`` — static width of the per-token-block page worklist
  (default ``tb_tokens * max_blocks_per_seq``, far wider than a
  decode-heavy window's worklist needs);
- ``pages_per_step`` — KV pages fetched per grid step (the port's kernels
  accept it and ignore it: their output and their walk do not depend on
  it).

This module sweeps that space per **(model geometry, device_kind,
dtype)** key.  Without a runner the sweep is scored by a deterministic
cost model over the REAL host packer (``pack_page_meta`` builds the
worklists of a synthetic decode-heavy and a mixed-chunk workload, so
packing waste and feasibility are exact); on the card ``measured_runner``
times row 1's CUDA kernel on the same workloads and the winner is
measured, not modeled.  Winners persist as provenance-stamped rows in the
port's kernel-perf table (``DYN_KERNEL_PERF``, else
``dynamo_tpu_torch/KERNEL_PERF_CUDA.json``, absent until a tuning run
writes it); the engine resolves them at init with the precedence
**explicit knob > tuned row > heuristic default**.

Row schema (version 1)::

    {"bench": "autotune_ragged", "geometry": "h4kv2d64-bs4-l4-mb16",
     "device_kind": "any" | "<torch.cuda.get_device_name()>",
     "dtype": "float32", "source": "cost_model" | "measured", "version": 1,
     "tb_tokens": 4, "page_slots": 16, "pages_per_step": 2,
     "cost": 123.4, "swept": 18}

``source="cost_model"`` rows are hardware-independent layout choices and
are stamped ``device_kind="any"``; ``source="measured"`` rows are only
trusted for the device kind that produced them.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np

RAGGED_BENCH = "autotune_ragged"
SCHEMA_VERSION = 1

# cost-model coefficients (arbitrary units; only ratios matter).  DMA is
# the dominant real cost of decode attention, per-step overhead is the
# pipeline bubble each grid step pays, MAC covers the masked score/row
# waste that grows with tb_tokens, SELECT the per-token routing chain,
# PAD the dead pipeline tick a deduped pad slot still occupies.
_C_DMA = 1.0        # per KV byte streamed
_C_STEP = 4096.0    # per grid step
_C_MAC = 0.002      # per masked MAC in the score matrix
_C_SELECT = 64.0    # per select in the routing chain, per live page
_C_PAD = 256.0      # per dead (pad) worklist slot


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The shape key the tuned parameters depend on: attention geometry,
    cache page size, and the engine's packing envelope (decode lanes and
    worst-case pages per lane)."""

    num_heads: int
    num_kv_heads: int
    head_dim: int
    block_size: int
    lanes: int               # max_batch_size — decode lanes per window
    max_blocks_per_seq: int

    @property
    def key(self) -> str:
        return (
            f"h{self.num_heads}kv{self.num_kv_heads}d{self.head_dim}"
            f"-bs{self.block_size}-l{self.lanes}-mb{self.max_blocks_per_seq}"
        )


def _synthetic_workloads(geom: Geometry, tb: int):
    """Deterministic (token_lane, token_pos, block_tables) workloads the
    cost model scores: a full decode window with every lane mid-stream,
    and a mixed window (decode lanes + one chunked-prefill span).  Both
    are derived purely from the geometry — no RNG, no wall clock."""
    lanes = geom.lanes
    bs = geom.block_size
    mid = max(bs, (geom.max_blocks_per_seq * bs) // 2)
    bt = np.arange(
        lanes * geom.max_blocks_per_seq, dtype=np.int32
    ).reshape(lanes, geom.max_blocks_per_seq)

    def pad_to(arr, fill):
        t_pad = -(-len(arr) // tb) * tb
        out = np.full(t_pad, fill, np.int32)
        out[: len(arr)] = arr
        return out

    # decode-heavy: one token per lane, staggered contexts around mid
    d_lane = np.arange(lanes, dtype=np.int32)
    d_pos = np.array([mid - 1 + (i % bs) for i in range(lanes)], np.int32)
    decode = (pad_to(d_lane, lanes), pad_to(d_pos, -1), bt)

    # mixed: a 2-page prefill chunk on lane 0 + the other lanes decoding
    chunk = 2 * bs
    m_lane = np.concatenate([
        np.zeros(chunk, np.int32), np.arange(1, lanes, dtype=np.int32)
    ])
    m_pos = np.concatenate([
        np.arange(chunk, dtype=np.int32),
        np.array([mid - 1 + (i % bs) for i in range(1, lanes)], np.int32),
    ])
    mixed = (pad_to(m_lane, lanes), pad_to(m_pos, -1), bt)
    return (decode, mixed)


def _pack_stats(geom: Geometry, tb: int):
    """Run the real host packer over the synthetic workloads; return
    (need, per-workload [num_tb, live_pages] pairs).  ``need`` is the
    tightest page_slots width that fits every workload."""
    from dynamo_tpu_torch.ops.kernels.ragged_attention import pack_page_meta

    need = 1
    stats = []
    for token_lane, token_pos, bt in _synthetic_workloads(geom, tb):
        page_phys, _, _, page_count = pack_page_meta(
            token_lane, token_pos, bt,
            tb_tokens=tb, block_size=geom.block_size,
        )
        need = max(need, page_phys.shape[1])
        stats.append((page_phys.shape[0], int(page_count.sum())))
    return need, stats


def cost_model(geom: Geometry, tb: int, ps: int, pps: int,
               dtype_bytes: int = 4) -> float | None:
    """Deterministic score (lower is better) for one candidate; None when
    the candidate cannot hold the synthetic workloads (the engine would
    hit the overflow-repack ladder on typical traffic)."""
    need, stats = _pack_stats(geom, tb)
    if ps < need or ps % pps:
        return None
    page_bytes = (
        2 * geom.block_size * geom.num_kv_heads * geom.head_dim * dtype_bytes
    )
    tbh = tb * geom.num_heads
    score_cols = geom.block_size * geom.num_kv_heads
    cost = 0.0
    for num_tb, live in stats:
        steps = num_tb * (ps // pps)
        cost += _C_STEP * steps
        cost += _C_DMA * live * page_bytes
        cost += _C_MAC * live * tbh * score_cols
        cost += _C_SELECT * live * tb
        cost += _C_PAD * (num_tb * ps - live)
    return cost


# bytes an element of the cache dtypes numpy does not know without
# ml_dtypes (the reference's numpy has them through JAX)
_NARROW_BYTES = {"bfloat16": 2, "float8_e4m3fn": 1, "float8_e5m2": 1}


def _itemsize(dtype) -> int:
    name = str(dtype).removeprefix("torch.")
    return _NARROW_BYTES.get(name) or np.dtype(name).itemsize


def candidate_grid(geom: Geometry, buckets: tuple[int, ...] = ()) -> list[dict]:
    """The swept (tb_tokens, page_slots, pages_per_step) candidates.
    ``buckets`` (the engine's unified token buckets) constrain tb_tokens:
    a tb that does not divide every bucket would force the split
    fallback, so it is never a valid winner."""
    default_tb = math.gcd(geom.block_size, 8) or 1
    tbs = sorted({
        t for t in (1, 2, 4, 8, 16, default_tb)
        if t <= max(geom.lanes, default_tb)
        and all(b % t == 0 for b in buckets)
    })
    out = []
    for tb in tbs:
        need, _ = _pack_stats(geom, tb)
        full = tb * geom.max_blocks_per_seq
        for pps in (1, 2, 4, 8):
            # round the tight width up to a pps multiple; also sweep a
            # 2x-slack width and the legacy full width
            tight = -(-need // pps) * pps
            for ps in sorted({tight, min(full, 2 * tight), full}):
                if ps < need or ps % pps:
                    continue
                out.append(
                    {"tb_tokens": tb, "page_slots": ps, "pages_per_step": pps}
                )
    # dedup, preserving order
    seen = set()
    uniq = []
    for c in out:
        k = (c["tb_tokens"], c["page_slots"], c["pages_per_step"])
        if k not in seen:
            seen.add(k)
            uniq.append(c)
    return uniq


def sweep(
    geom: Geometry,
    *,
    dtype: str = "float32",
    buckets: tuple[int, ...] = (),
    runner=None,
    device_kind: str | None = None,
) -> dict:
    """Score every candidate and return the winner row (plus the swept
    grid under ``"grid"`` for bench reporting).  ``runner`` is an optional
    ``callable(candidate) -> wall_us | None`` — when present the sweep is
    *measured* and stamped with the real device kind; otherwise the
    deterministic cost model scores it (``device_kind="any"``)."""
    dtype_bytes = max(1, _itemsize(dtype))
    grid = candidate_grid(geom, buckets)
    if not grid:
        raise ValueError(f"no feasible candidates for {geom.key}")
    scored = []
    for cand in grid:
        if runner is not None:
            cost = runner(dict(cand))
        else:
            cost = cost_model(
                geom, cand["tb_tokens"], cand["page_slots"],
                cand["pages_per_step"], dtype_bytes,
            )
        if cost is None:
            continue
        scored.append((float(cost), cand))
    if not scored:
        raise ValueError(f"no candidate survived the sweep for {geom.key}")
    scored.sort(key=lambda it: (it[0], sorted(it[1].items())))
    best_cost, best = scored[0]
    row = {
        "bench": RAGGED_BENCH,
        "geometry": geom.key,
        "device_kind": device_kind if runner is not None else "any",
        "dtype": str(dtype),
        "source": "measured" if runner is not None else "cost_model",
        "version": SCHEMA_VERSION,
        **best,
        "cost": round(best_cost, 3),
        "swept": len(grid),
    }
    row["grid"] = [
        {**cand, "cost": round(cost, 3)} for cost, cand in scored
    ]
    return row


# ------------------------------------------------------------ persistence


def _row_key(row: dict) -> tuple:
    return (
        row.get("bench"), row.get("geometry"), row.get("device_kind"),
        row.get("dtype"), row.get("source"), row.get("version"),
    )


def load_table(path) -> dict:
    """Read a KERNEL_PERF-format table ({header..., "rows": [...]}) or
    return an empty shell when the file does not exist / fails to parse."""
    try:
        with open(path) as fh:
            table = json.load(fh)
    except (OSError, ValueError):
        return {"rows": []}
    if not isinstance(table, dict):
        return {"rows": []}
    table.setdefault("rows", [])
    return table


def tune(
    path,
    geom: Geometry,
    *,
    dtype: str = "float32",
    buckets: tuple[int, ...] = (),
    runner=None,
    device_kind: str | None = None,
) -> tuple[dict, bool]:
    """Sweep-or-load: return ``(row, cached)``.  An existing row for the
    same (bench, geometry, device_kind, dtype, source, version) key is a
    cache hit — the file is not touched and no sweep runs.  Otherwise the
    winner is upserted into ``path`` (header and unrelated rows are
    preserved)."""
    source = "measured" if runner is not None else "cost_model"
    kind = device_kind if runner is not None else "any"
    probe = {
        "bench": RAGGED_BENCH, "geometry": geom.key, "device_kind": kind,
        "dtype": str(dtype), "source": source, "version": SCHEMA_VERSION,
    }
    table = load_table(path)
    for row in table["rows"]:
        if _row_key(row) == _row_key(probe):
            return row, True
    row = sweep(
        geom, dtype=dtype, buckets=buckets, runner=runner,
        device_kind=device_kind,
    )
    row = {k: v for k, v in row.items() if k != "grid"}
    table["rows"] = [
        r for r in table["rows"] if _row_key(r) != _row_key(row)
    ] + [row]
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(table, fh, indent=1)
        fh.write("\n")
    os.replace(tmp, path)
    return row, False


def resolve(
    table: dict,
    *,
    geometry_key: str,
    device_kind: str | None,
    dtype: str,
    bench: str = RAGGED_BENCH,
) -> dict | None:
    """Pick the tuned row for a geometry: a measured row for this exact
    device kind wins over the hardware-independent cost-model row; rows
    for other devices, dtypes, or schema versions never match."""
    rows = [
        r for r in table.get("rows", ())
        if r.get("bench") == bench
        and r.get("geometry") == geometry_key
        and r.get("dtype") == str(dtype)
        and r.get("version") == SCHEMA_VERSION
        and all(k in r for k in ("tb_tokens", "page_slots", "pages_per_step"))
    ]
    measured = [
        r for r in rows
        if r.get("source") == "measured"
        and device_kind is not None
        and r.get("device_kind") == device_kind
    ]
    if measured:
        return measured[0]
    modeled = [
        r for r in rows
        if r.get("source") == "cost_model" and r.get("device_kind") == "any"
    ]
    return modeled[0] if modeled else None


# ------------------------------------------------------------ the card


def table_path() -> str:
    """The port's kernel-perf table: ``DYN_KERNEL_PERF``, else
    ``KERNEL_PERF_CUDA.json`` beside this package's modules (git-ignored;
    never the repo-root table, whose rows were tuned for a TPU)."""
    from dynamo_tpu_torch.utils import knobs

    return knobs.get("DYN_KERNEL_PERF") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "KERNEL_PERF_CUDA.json",
    )


def device_kind(device) -> str:
    """The device kind a measured row is stamped with and resolved
    against: ``torch.cuda.get_device_name`` on a card, ``"cpu"`` on the
    CPU (the kind the reference's CPU device reports)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


_SLEEP_CYCLES_PER_MS: dict = {}  # torch.cuda._sleep's rate, by device


def _sleep_cycles(device, ms: float) -> int:
    """``torch.cuda._sleep`` cycles that keep ``device`` busy about ``ms``."""
    import torch

    if device not in _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(10**7)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS[device] = 10**7 / start.elapsed_time(end)
    return int(_SLEEP_CYCLES_PER_MS[device] * ms)


def measure_ragged(geom: Geometry, candidate: dict, *, device, dtype=None,
                   reps: int = 50, sms: int | None = None) -> float | None:
    """Row 1's CUDA kernel at one candidate layout, on this geometry's two
    synthetic workloads (``_synthetic_workloads``: the worklists the cost
    model scores, packed at the candidate's ``page_slots``), each balanced
    by the work plan the engine would make for it: the sum of the two
    workloads' mean device times a launch, in µs, each from CUDA events
    around ``reps`` launches queued behind a device sleep (so the events
    time the card's back-to-back run of them, not the host's launch cost;
    the wrapper never waits for the stream).  The cache is ``lanes x
    max_blocks_per_seq`` pages of ``dtype`` (default bf16) from a fixed
    seed.  ``None`` for a candidate the kernel refuses (``tb x H/KVH``
    above ``MAX_ROWS`` query rows, or a width its worklist does not fit).
    ``pages_per_step`` is not read: the kernel accepts it and ignores
    it."""
    import torch

    from dynamo_tpu_torch.ops.kernels import ragged_attention as ra

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"measure_ragged times the CUDA kernel; got {device}")
    dtype = dtype or torch.bfloat16
    tb, ps = int(candidate["tb_tokens"]), int(candidate["page_slots"])
    h, kvh, d, bs = geom.num_heads, geom.num_kv_heads, geom.head_dim, geom.block_size
    rows = tb * (h // kvh)
    if rows > ra.MAX_ROWS:
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    pages = geom.lanes * geom.max_blocks_per_seq
    k = torch.randn((pages, bs, kvh, d), generator=gen, device=device).to(dtype)
    v = torch.randn((pages, bs, kvh, d), generator=gen, device=device).to(dtype)
    planner = None
    if ra.split_route(dtype, d, bs, rows, dtype):
        sms = sms or torch.cuda.get_device_properties(device).multi_processor_count
        planner = ra.ragged_planner(kvh, sms, rows, d)
    total_us = 0.0
    for token_lane, token_pos, bt in _synthetic_workloads(geom, tb):
        try:
            meta = ra.pack_page_meta(token_lane, token_pos, bt, tb_tokens=tb,
                                     block_size=bs, page_slots=ps)
        except ValueError:
            return None
        plan = planner.plan(meta[3]) if planner is not None else None
        q = torch.randn((len(token_lane), h, d), generator=gen, device=device).to(dtype)
        args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
                for a in (bt, token_lane, token_pos, *meta)]

        def call():
            return ra.ragged_paged_attention(q, k, v, *args, tb_tokens=tb, plan=plan)

        try:
            call()  # the first launch, untimed
        except ValueError:
            return None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        torch.cuda._sleep(_sleep_cycles(device, 0.2 * reps))  # outlasts the enqueue
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        total_us += start.elapsed_time(end) * 1e3 / reps
    return total_us


def measured_runner(geom: Geometry, *, device, dtype=None, reps: int = 50):
    """A ``sweep`` / ``tune`` runner over ``measure_ragged``: it times each
    ``(tb_tokens, page_slots)`` once and gives every ``pages_per_step``
    variant of it that time (the kernel ignores ``pages_per_step``), so
    ``sweep``'s tie-break picks the lowest ``pages_per_step``.  The times
    are kept in ``runner.times`` ({(tb, page_slots): µs or None})."""
    times: dict[tuple[int, int], float | None] = {}

    def runner(cand: dict) -> float | None:
        key = (int(cand["tb_tokens"]), int(cand["page_slots"]))
        if key not in times:
            times[key] = measure_ragged(geom, cand, device=device, dtype=dtype, reps=reps)
        return times[key]

    runner.times = times
    return runner
