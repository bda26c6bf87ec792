"""The port's kernel autotuner (dynamo_tpu_torch/ops/autotune.py) and the
engine's resolution of the ragged kernel's layout, against the reference's
(dynamo_tpu/ops/autotune.py, JaxLlmEngine), on the CPU.

- ``candidate_grid``, ``cost_model``, ``sweep``, ``tune`` and ``resolve``
  give what the reference's give, on the reference test's ``TINY``
  geometry and on Llama-3-8B's ``h32kv8d128-bs16-l16-mb256``; the cache
  hit, measured rows outranking cost-model rows, and the measured runner's
  stamp (one timing a ``(tb, page_slots)``, its ``pages_per_step``
  variants given the same time);
- engines: a tuned row, no row, a knob over a row, ``DYN_AUTOTUNE=0`` and a
  ``tb`` that breaks the buckets each give the ``kernel_config`` that
  ``JaxLlmEngine`` gives on the same ``DYN_KERNEL_PERF`` table; a ``tb``
  the family's kernel refuses and a table from another platform fall back
  to the default, by name;
- with a tuned row (``tb`` 4, a tight width), greedy and seeded streams
  are byte-identical to the port's default engine and to the reference
  engine's; a window past the tuned width is repacked at the full width,
  counted, and leaves the stream unchanged.
"""

import dataclasses
import json
import logging

import numpy as np
import pytest

from dynamo_tpu.ops import autotune as ref_autotune
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import deepseek
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.ops import autotune
from dynamo_tpu_torch.runtime.engine import Context

from tests.test_torch_engine import BASE, CFG, PARAMS, request
from tests.test_torch_overlap import jax_engine, serve

TINY = autotune.Geometry(num_heads=4, num_kv_heads=2, head_dim=16, block_size=4, lanes=4,
                         max_blocks_per_seq=32)
LLAMA3_8B = autotune.Geometry(num_heads=32, num_kv_heads=8, head_dim=128, block_size=16,
                              lanes=16, max_blocks_per_seq=256)
GEOMETRIES = [(TINY, (16, 32, 64)), (LLAMA3_8B, (512, 1024, 2048, 4096))]


def ref_geom(geom):
    return ref_autotune.Geometry(**dataclasses.asdict(geom))


@pytest.mark.parametrize("geom,buckets", GEOMETRIES, ids=["tiny", "llama3_8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn"])
def test_sweep_and_grid_equal_the_reference(geom, buckets, dtype):
    assert geom.key == ref_geom(geom).key
    assert autotune.candidate_grid(geom, buckets) == ref_autotune.candidate_grid(
        ref_geom(geom), buckets)
    assert autotune.sweep(geom, dtype=dtype, buckets=buckets) == ref_autotune.sweep(
        ref_geom(geom), dtype=dtype, buckets=buckets)


@pytest.mark.parametrize("geom,buckets", GEOMETRIES, ids=["tiny", "llama3_8b"])
def test_cost_model_and_pack_stats_equal_the_reference(geom, buckets):
    for tb in (1, 2, 4, 8):
        assert autotune._pack_stats(geom, tb) == ref_autotune._pack_stats(ref_geom(geom), tb)
        need, _ = autotune._pack_stats(geom, tb)
        for ps in (max(1, need - 1), need, 2 * need, tb * geom.max_blocks_per_seq):
            for pps in (1, 2, 4, 8):
                assert autotune.cost_model(geom, tb, ps, pps, 2) == ref_autotune.cost_model(
                    ref_geom(geom), tb, ps, pps, 2)


def test_tune_persists_like_the_reference_and_rerun_is_a_cache_hit(tmp_path):
    ours, ref = tmp_path / "ours.json", tmp_path / "ref.json"
    row, cached = autotune.tune(ours, TINY, buckets=(16, 32))
    ref_row, ref_cached = ref_autotune.tune(ref, ref_geom(TINY), buckets=(16, 32))
    assert (row, cached) == (ref_row, ref_cached) and cached is False
    assert ours.read_text() == ref.read_text()
    before = ours.read_text()
    row2, cached2 = autotune.tune(ours, TINY, buckets=(16, 32))
    assert cached2 is True and row2 == row
    assert ours.read_text() == before  # a hit leaves the file untouched
    # the header and unrelated rows survive an upsert, as the reference's
    for path, mod in ((ours, autotune), (ref, ref_autotune)):
        table = json.loads(path.read_text())
        table["platform"] = "gpu"
        table["rows"].append({"bench": "calib_matmul", "tflops": 1.0})
        path.write_text(json.dumps(table))
        other = mod.Geometry(num_heads=8, num_kv_heads=8, head_dim=64, block_size=8,
                             lanes=8, max_blocks_per_seq=16)
        mod.tune(path, other, buckets=(32,))
    assert ours.read_text() == ref.read_text()
    assert json.loads(ours.read_text())["platform"] == "gpu"


def test_resolve_prefers_measured_rows_of_this_device_kind():
    modeled = {"bench": autotune.RAGGED_BENCH, "geometry": TINY.key, "device_kind": "any",
               "dtype": "float32", "source": "cost_model", "version": 1, "tb_tokens": 4,
               "page_slots": 8, "pages_per_step": 1}
    measured = dict(modeled, device_kind="NVIDIA H100 80GB HBM3", source="measured",
                    page_slots=16, pages_per_step=4)
    table = {"rows": [modeled, measured]}
    cases = [("NVIDIA H100 80GB HBM3", "float32", TINY.key),
             ("NVIDIA A100-SXM4-80GB", "float32", TINY.key),
             (None, "bfloat16", TINY.key), (None, "float32", "h1kv1d8-bs4-l2-mb4")]
    for kind, dtype, key in cases:
        got = autotune.resolve(table, geometry_key=key, device_kind=kind, dtype=dtype)
        assert got == ref_autotune.resolve(table, geometry_key=key, device_kind=kind,
                                           dtype=dtype)
    assert autotune.resolve(table, geometry_key=TINY.key, device_kind="NVIDIA H100 80GB HBM3",
                            dtype="float32") is measured
    assert autotune.resolve(table, geometry_key=TINY.key, device_kind="other",
                            dtype="float32") is modeled


def test_measured_runner_times_each_width_once_and_stamps_the_card(monkeypatch):
    """The runner measures each (tb, page_slots) once and hands every
    pages_per_step variant that time, so the sweep's tie-break picks the
    lowest pages_per_step; the row is stamped with the card's name."""
    calls = []

    def fake(geom, cand, *, device, dtype=None, reps=20):
        calls.append((cand["tb_tokens"], cand["page_slots"]))
        # the tightest width of tb 2 is fastest on this pretend card
        return 10.0 + cand["page_slots"] if cand["tb_tokens"] == 2 else 1000.0

    monkeypatch.setattr(autotune, "measure_ragged", fake)
    runner = autotune.measured_runner(TINY, device="cuda")
    row = autotune.sweep(TINY, buckets=(16, 32), runner=runner,
                         device_kind="NVIDIA H100 80GB HBM3")
    grid = autotune.candidate_grid(TINY, (16, 32))
    widths = {(c["tb_tokens"], c["page_slots"]) for c in grid}
    assert sorted(calls) == sorted(widths)  # one timing a width
    assert len(calls) < len(grid)           # pps variants share one
    assert row["source"] == "measured" and row["device_kind"] == "NVIDIA H100 80GB HBM3"
    need, _ = autotune._pack_stats(TINY, 2)
    assert (row["tb_tokens"], row["page_slots"], row["pages_per_step"]) == (2, need, 1)
    assert row["swept"] == len(grid)
    assert runner.times == {k: fake(TINY, {"tb_tokens": k[0], "page_slots": k[1]},
                                    device=None) for k in widths}
    # the reference's sweep scores the same grid with the same runner alike
    ref_row = ref_autotune.sweep(ref_geom(TINY), buckets=(16, 32), runner=runner,
                                 device_kind="NVIDIA H100 80GB HBM3")
    assert ref_row == row


def test_measure_ragged_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        autotune.measure_ragged(TINY, {"tb_tokens": 4, "page_slots": 8}, device="cpu")


def test_table_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("DYN_KERNEL_PERF", raising=False)
    path = autotune.table_path()
    assert path.endswith("dynamo_tpu_torch/KERNEL_PERF_CUDA.json")
    monkeypatch.setenv("DYN_KERNEL_PERF", str(tmp_path / "t.json"))
    assert autotune.table_path() == str(tmp_path / "t.json")
    assert autotune.device_kind("cpu") == "cpu"


# ---------------------------------------------------------------- engines


def tuned_row(**kw):
    row = {"bench": autotune.RAGGED_BENCH, "geometry": TINY.key, "device_kind": "any",
           "dtype": "float32", "source": "cost_model", "version": 1, "tb_tokens": 4,
           "page_slots": 8, "pages_per_step": 2}
    row.update(kw)
    return row


def write_table(tmp_path, monkeypatch, rows, **header):
    path = tmp_path / "perf.json"
    path.write_text(json.dumps({**header, "rows": rows}))
    monkeypatch.setenv("DYN_KERNEL_PERF", str(path))
    return path


ENGINE_KW = dict(num_blocks=64, block_size=4, max_batch_size=4, max_model_len=128)


@pytest.fixture
def engine_warnings():
    """The warnings the port's engine logs during the test (its logger
    does not propagate to the root, so caplog does not see them)."""
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: records.append(record.getMessage())
    log = logging.getLogger("dynamo_tpu_torch.engine")
    log.addHandler(handler)
    yield records
    log.removeHandler(handler)


def kernel_configs(**overrides):
    """``stats()["kernel_config"]`` (and the overflow count) of the port's
    engine and of JaxLlmEngine on the reference test's tiny engine."""
    from tests.engine.test_jax_engine import make_engine

    kw = {**ENGINE_KW, **overrides}
    ours = TorchLlmEngine(EngineConfig(model=LlamaConfig.tiny(), **{
        "prefill_buckets": (16, 32, 64), **kw}), device="cpu")
    ref = make_engine(**kw)
    try:
        ref_stats = ref.stats()
    finally:
        ref.stop()
    stats = ours.stats()
    assert stats["unified_ps_overflows_total"] == ref_stats["unified_ps_overflows_total"] == 0
    return stats["kernel_config"], ref_stats["kernel_config"], ours


@pytest.mark.parametrize("case", ["tuned", "default", "knob", "opt_out", "bad_tb"])
def test_engine_kernel_config_equals_the_reference(case, tmp_path, monkeypatch):
    overrides = {}
    rows = [tuned_row()]
    if case == "default":
        rows = []
    elif case == "knob":
        monkeypatch.setenv("DYN_AUTOTUNE_PAGE_SLOTS", "24")
        monkeypatch.setenv("DYN_AUTOTUNE_PAGES_PER_STEP", "4")
    elif case == "opt_out":
        monkeypatch.setenv("DYN_AUTOTUNE", "0")
    elif case == "bad_tb":
        rows = [tuned_row(tb_tokens=16, page_slots=32)]
        overrides = dict(prefill_buckets=(24, 48))
    write_table(tmp_path, monkeypatch, rows)
    ours, ref, engine = kernel_configs(**overrides)
    assert ours == ref
    expect = {"tuned": ("tuned", 4, 8, 2), "default": ("default", 4, 128, 1),
              "knob": ("knob", 4, 24, 4), "opt_out": ("default", 4, 128, 1),
              "bad_tb": ("default", 4, 128, 1)}[case]
    assert (ours["source"], ours["tb_tokens"], ours["page_slots"],
            ours["pages_per_step"]) == expect
    assert ours["geometry"] == (None if case == "opt_out" else TINY.key)
    ug = engine._unified
    assert (ug.tb, ug.page_slots, ug.pps) == expect[1:]
    assert ug.full_slots == 4 * 32
    # below the full width every bucket also has a full-width layout
    assert (("full", 16) in ug.inputs._layouts) == (expect[2] < 128)


def test_engine_refuses_a_tb_its_kernel_refuses(tmp_path, monkeypatch, engine_warnings):
    """A tuned tb that the family's unified kernel cannot take (the ragged
    MLA kernel takes token blocks of at most 8) falls back to the default,
    with a warning that names it."""
    cfg = deepseek.DeepseekConfig.tiny_mla(vocab_size=481)
    geom = autotune.Geometry(num_heads=cfg.num_heads, num_kv_heads=cfg.num_heads,
                             head_dim=cfg.kv_lora_rank, block_size=4, lanes=4,
                             max_blocks_per_seq=32)
    write_table(tmp_path, monkeypatch, [tuned_row(geometry=geom.key, tb_tokens=16,
                                                  page_slots=64)])
    engine = TorchLlmEngine(EngineConfig(model=cfg, model_family="deepseek_v2",
                                         prefill_buckets=(16, 32, 64), **ENGINE_KW),
                            device="cpu")
    kc = engine.stats()["kernel_config"]
    assert kc["geometry"] == geom.key
    assert (kc["source"], kc["tb_tokens"], kc["page_slots"]) == ("default", 4, 128)
    assert any("tb_tokens=16 is refused by the deepseek_v2 family's unified kernel" in w
               for w in engine_warnings)


@pytest.mark.parametrize("header", [{"platform": "tpu"}, {"interpret": True}])
def test_engine_refuses_a_table_of_another_platform_loudly(tmp_path, monkeypatch,
                                                           engine_warnings, header):
    path = write_table(tmp_path, monkeypatch, [tuned_row()], **header)
    engine = TorchLlmEngine(EngineConfig(model=LlamaConfig.tiny(), prefill_buckets=(16, 32, 64),
                                         **ENGINE_KW), device="cpu")
    kc = engine.stats()["kernel_config"]
    assert kc["source"] == "default" and kc["page_slots"] == 128
    assert any(w.startswith(f"DYN_KERNEL_PERF={path} ignored") for w in engine_warnings)


def test_no_table_leaves_the_unified_graphs_as_they_were(tmp_path, monkeypatch):
    """Without a table (the port's default path, absent): the default layout,
    tb gcd(block_size, 8) and the full width, and no full-width layout."""
    monkeypatch.setenv("DYN_KERNEL_PERF", str(tmp_path / "absent.json"))
    engine = TorchLlmEngine(EngineConfig(model=CFG, **BASE), params=PARAMS, device="cpu")
    kc = engine.stats()["kernel_config"]
    assert kc["source"] == "default"
    assert kc["tb_tokens"] == 4 and kc["page_slots"] == 4 * engine.max_blocks_per_seq
    ug = engine._unified
    assert set(ug.inputs._layouts) == set(ug.buckets)
    assert engine.stats()["unified_full_width_graphs_captured"] == 0


def stream_requests(vocab: int, long: bool) -> list[dict]:
    """Greedy and seeded sampled requests across several buckets, queued
    together (lanes share token blocks); ``long``: contexts past 64
    positions, whose windows outgrow an 8-slot worklist."""
    rng = np.random.default_rng(11)
    seeded = SamplingOptions(temperature=3.0, seed=5, frequency_penalty=0.4)
    lens = (27, 60, 9, 45) if long else (7, 13, 21, 30)
    return [request(rng.integers(3, vocab, n).tolist(), max_tokens=8,
                    sampling=seeded if i % 2 else None, ignore_eos=True)
            for i, n in enumerate(lens)]


def tiny_chat_row(page_slots: int) -> dict:
    geom = autotune.Geometry(num_heads=CFG.num_heads, num_kv_heads=CFG.num_kv_heads,
                             head_dim=CFG.head_dim, block_size=4, lanes=4,
                             max_blocks_per_seq=32)
    return tuned_row(geometry=geom.key, page_slots=page_slots, pages_per_step=1)


@pytest.mark.parametrize("page_slots,long", [(8, True), (64, False)],
                         ids=["overflowing_width", "holding_width"])
async def test_tuned_streams_equal_default_and_reference(page_slots, long, tmp_path,
                                                         monkeypatch):
    reqs = stream_requests(CFG.vocab_size, long)
    monkeypatch.setenv("DYN_AUTOTUNE", "0")
    default = TorchLlmEngine(EngineConfig(model=CFG, **BASE), params=PARAMS, device="cpu")
    base_out = await serve(default, Context, reqs)
    monkeypatch.delenv("DYN_AUTOTUNE")
    write_table(tmp_path, monkeypatch, [tiny_chat_row(page_slots)])
    tuned = TorchLlmEngine(EngineConfig(model=CFG, **BASE), params=PARAMS, device="cpu")
    assert tuned.stats()["kernel_config"]["source"] == "tuned"
    assert tuned._unified.page_slots == page_slots
    # every window's worklist, at the width the step ran it
    widths = []
    step = tuned._unified.step

    def spy(bucket, noise, top=0, idle=False, full=False):
        if not idle:
            widths.append(tuned._unified.full_slots if full else page_slots)
        return step(bucket, noise, top=top, idle=idle, full=full)

    tuned._unified.step = spy
    ours = await serve(tuned, Context, reqs)
    ref = await serve(jax_engine(True), JaxContext, reqs)
    assert ours == base_out == ref
    stats = tuned.stats()
    assert stats["decode_windows_unified_total"] == default.stats()[
        "decode_windows_unified_total"] == len(widths) > 0
    overflows = stats["unified_ps_overflows_total"]
    assert overflows == widths.count(tuned._unified.full_slots)
    if long:
        assert overflows > 0  # repacked at the full width, counted
    else:
        assert overflows == 0 and set(widths) == {page_slots}


def test_sweep_needs_no_jax_for_narrow_dtypes():
    """On the card no JAX registers bfloat16 or fp8 with numpy: the port's
    sweep sizes those dtypes itself, and scores as the reference does."""
    import subprocess
    import sys

    code = ("import sys\n"
            "from dynamo_tpu_torch.ops import autotune as a\n"
            "g = a.Geometry(num_heads=4, num_kv_heads=2, head_dim=16, block_size=4, lanes=4,"
            " max_blocks_per_seq=32)\n"
            "rows = [a.sweep(g, dtype=d, buckets=(16, 32))['cost'] for d in"
            " ('bfloat16', 'float8_e4m3fn', 'float8_e5m2', 'float32')]\n"
            "assert 'jax' not in sys.modules and 'ml_dtypes' not in sys.modules\n"
            "print(rows)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = eval(out.stdout.strip().splitlines()[-1])
    want = [ref_autotune.sweep(ref_geom(TINY), dtype=d, buckets=(16, 32))["cost"]
            for d in ("bfloat16", "float8_e4m3fn", "float8_e5m2", "float32")]
    assert got == want
