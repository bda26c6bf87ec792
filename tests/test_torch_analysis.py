"""dynlint over the port (``dynamo_tpu_torch/analysis/``,
``python -m dynamo_tpu_torch.scripts.dynlint``): tests/analysis/'s cases
against the port's passes, ratchet, CLI and knob registry — the passes on
the reference's fixture twins (tests/analysis/fixtures/), ``graph-purity``
on its own (tests/torch_analysis_fixtures/graph_purity/) in place of
``jit-purity``'s — and the gate: the port is clean against its empty
``ANALYSIS_BASELINE_CUDA.json``, its knob page is the generated one, and the
analyzer imports neither torch nor JAX."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from dynamo_tpu_torch import analysis
from dynamo_tpu_torch.analysis import core
from dynamo_tpu_torch.scripts import dynlint
from dynamo_tpu_torch.utils import knobs

REPO_ROOT = Path(__file__).resolve().parent.parent
FIXTURES = REPO_ROOT / "tests" / "analysis" / "fixtures"
OWN_FIXTURES = REPO_ROOT / "tests" / "torch_analysis_fixtures"
FIXTURE_ROOT = "tests/analysis/fixtures/async_hygiene"


def run_fixture(name: str, passes: tuple[str, ...], root: Path = FIXTURES, **kw):
    return analysis.analyze(root / name, roots=(".",), passes=passes, **kw)


def by_file(findings, filename):
    return [f for f in findings if f.path == filename]


def rules(findings):
    return sorted(f.rule for f in findings)


# -- the passes (tests/analysis/test_passes.py) -------------------------------

def test_async_hygiene_bad_twin():
    findings, _ = run_fixture("async_hygiene", ("async-hygiene",))
    assert not by_file(findings, "good.py"), [f.render() for f in findings]
    assert rules(by_file(findings, "bad.py")) == [
        "blocking-call", "blocking-call",
        "fire-and-forget", "fire-and-forget",
        "unawaited-coroutine",
    ]
    faf = [f for f in findings if f.rule == "fire-and-forget"]
    assert any("discarded" in f.message for f in faf)
    assert any("_task" in f.message for f in faf)


def test_lock_discipline_bad_twin():
    findings, _ = run_fixture("lock_discipline", ("lock-discipline",))
    assert not by_file(findings, "good.py"), [f.render() for f in findings]
    assert rules(by_file(findings, "bad.py")) == [
        "asyncio-from-thread", "lock-across-await",
    ]


def test_graph_purity_bad_twin():
    """Roots are the registry's forward fields and the names the capture
    module imports from the sampling tail; the walk follows calls inside a
    module, a pragma with a reason suppresses, and functions no root
    reaches may sync."""
    findings, summary = run_fixture("graph_purity", ("graph-purity",), OWN_FIXTURES)
    assert not by_file(findings, "models/good.py"), [f.render() for f in findings]
    assert summary["suppressed"] == 1  # good.prefill's pragma
    bad = by_file(findings, "models/bad.py")
    assert all(f.rule == "host-sync" for f in bad)
    assert sorted(f.context for f in bad) == [
        "embed", "embed", "log", "scale_of", "unified", "unified", "unified"]
    assert {f.message.split("`")[1] for f in bad} == {
        "print", ".item()", "torch.cuda.synchronize", "np.asarray", ".cpu()",
        "time.perf_counter", ".tolist()"}
    tail = by_file(findings, "ops/sampling.py")
    assert [(f.context, f.rule) for f in tail] == [("penalize", "host-sync")]


def test_graph_purity_roots_of_the_port():
    """The port's roots: every family's forwards in models/, and the
    sampling tail engine/graphs.py imports."""
    from dynamo_tpu_torch.analysis import graph_purity

    modules, _ = core.load_modules(REPO_ROOT, ["dynamo_tpu_torch"])
    roots = graph_purity.graph_roots(core.Context(REPO_ROOT, modules))
    assert {"llama_forward_decode", "llama_forward_unified", "llama_forward_verify",
            "llama_forward_prefill", "_embed"} <= roots["dynamo_tpu_torch/models/llama.py"]
    assert {"deepseek_forward_decode", "deepseek_forward_unified"} <= roots[
        "dynamo_tpu_torch/models/deepseek.py"]
    for family in ("mixtral", "gemma2", "gemma3"):
        assert roots[f"dynamo_tpu_torch/models/{family}.py"]
    assert roots["dynamo_tpu_torch/ops/sampling.py"] == {
        "apply_logit_bias", "apply_penalties", "sample_tokens", "token_logprobs",
        "topk_logprobs"}


def test_knob_registry_bad_twin():
    findings, _ = run_fixture("knob_registry", ("knob-registry",),
                              knob_docs=("docs/knobs.md",))
    assert not by_file(findings, "good.py"), [f.render() for f in findings]
    assert rules(by_file(findings, "bad.py")) == [
        "raw-env-read", "raw-env-read", "raw-env-read", "unregistered-knob",
    ]
    undoc = [f for f in findings if f.rule == "undocumented-knob"]
    assert [f.context for f in undoc] == ["DYN_FIX_SILENT"]
    assert undoc[0].path == "utils/knobs.py"


def test_knob_docs_are_the_port_page_only():
    """The knob pass reads the port's page, never docs/ or the README: a
    fixture tree without the page documents nothing."""
    findings, _ = run_fixture("knob_registry", ("knob-registry",))
    undoc = sorted(f.context for f in findings if f.rule == "undocumented-knob")
    assert undoc == ["DYN_FIX_GOOD", "DYN_FIX_SILENT"]


def test_metric_names_bad_twin():
    findings, _ = run_fixture("metric_names", ("metric-names",))
    assert not by_file(findings, "good.py"), [f.render() for f in findings]
    bad = by_file(findings, "bad.py")
    assert all(f.rule == "bad-family-name" for f in bad)
    assert {f.context for f in bad} == {
        "dyn_fixture_requests", "dyn_fixture_latency_ms", "fixture_depth",
        "dyn_fixture_queue_pct",
    }


def test_pragmas_suppress_and_demand_reasons():
    findings, summary = run_fixture("pragmas", ("async-hygiene",))
    assert summary["suppressed"] == 3
    assert not [f for f in findings if f.path == "suppressed.py"
                and f.pass_id == "async-hygiene"]
    assert [f.rule for f in by_file(findings, "suppressed.py")] == ["missing-reason"]
    unknown = by_file(findings, "unknown.py")
    assert sorted(f.rule for f in unknown) == ["blocking-call", "unknown-pass"]


# -- the ratchet (tests/analysis/test_ratchet.py) ------------------------------

def _finding(rule="blocking-call", path="x.py", line=3, context="f"):
    return core.Finding("async-hygiene", rule, path, line, "msg", context=context)


def test_ratchet_units(tmp_path):
    f = _finding()
    new, stale = core.diff_baseline([f], {})
    assert len(new) == 1 and not stale  # new
    baseline = core.fingerprints([f])
    assert core.diff_baseline([f], baseline) == ([], [])  # baselined
    assert core.diff_baseline([_finding(line=300)], baseline) == ([], [])  # line-free
    new, stale = core.diff_baseline([f, _finding(line=9)], baseline)
    assert len(new) == 1 and not stale  # a repeat beyond the count is new
    new, stale = core.diff_baseline([], baseline)
    assert not new and stale == list(baseline)  # stale
    path = tmp_path / core.BASELINE_NAME
    core.write_baseline(path, [f])
    assert core.load_baseline(path) == core.fingerprints([f])


def _cli(tmp_path, *args, root=FIXTURE_ROOT):
    baseline = tmp_path / "baseline.json"
    summary = tmp_path / "summary.json"
    rc = dynlint.main([*args, "--baseline", str(baseline), "--summary", str(summary), root])
    return rc, baseline, summary


def test_cli_check_fails_without_baseline(tmp_path):
    rc, _, summary = _cli(tmp_path, "--check")
    assert rc == 1
    assert json.loads(summary.read_text())["new"] > 0


def test_cli_check_passes_after_write_baseline(tmp_path):
    rc, baseline, _ = _cli(tmp_path, "--write-baseline")
    assert rc == 0 and baseline.exists()
    rc, _, summary = _cli(tmp_path, "--check")
    assert rc == 0
    data = json.loads(summary.read_text())
    assert data["new"] == 0 and data["stale_baseline_entries"] == 0


def test_cli_check_fails_on_stale_baseline(tmp_path):
    _cli(tmp_path, "--write-baseline")
    baseline = tmp_path / "baseline.json"
    data = json.loads(baseline.read_text())
    data["counts"]["async-hygiene|ghost.py|blocking-call|f"] = 1
    baseline.write_text(json.dumps(data))
    rc, _, summary = _cli(tmp_path, "--check")
    assert rc == 1
    assert json.loads(summary.read_text())["stale_baseline_entries"] == 1


def test_cli_check_fails_on_new_debt(tmp_path):
    _cli(tmp_path, "--write-baseline")
    rc, _, summary = _cli(tmp_path, "--check", root="tests/analysis/fixtures/lock_discipline")
    assert rc == 1
    data = json.loads(summary.read_text())
    assert data["new"] > 0 and data["stale_baseline_entries"] > 0


# -- the knob registry (tests/analysis/test_knobs.py) ---------------------------

def test_str_knob_default_and_override():
    assert knobs.get("DYN_LOG", env={}) == "info"
    assert knobs.get("DYN_LOG", env={"DYN_LOG": "debug"}) == "debug"


def test_bool_knob_semantics():
    assert knobs.get("DYN_KV_STREAM", env={}) is True
    for raw in ("0", "false", "off", "no", ""):
        assert knobs.get("DYN_KV_STREAM", env={"DYN_KV_STREAM": raw}) is False
    for raw in ("1", "true", "yes", "on"):
        assert knobs.get("DYN_KV_STREAM", env={"DYN_KV_STREAM": raw}) is True
    # an unrecognized token keeps the default
    assert knobs.get("DYN_CP_RECONNECT", env={"DYN_CP_RECONNECT": "2"}) is True
    # the knobs this slice registers read the same way
    for raw, want in (("on", True), ("yes", True), ("off", False), ("2", False)):
        assert knobs.get("DYN_ENGINE_PHASE_TIMING",
                         env={"DYN_ENGINE_PHASE_TIMING": raw}) is want
        assert knobs.get("DYN_LOGGING_JSONL", env={"DYN_LOGGING_JSONL": raw}) is want
        assert knobs.get("DYN_OFFLINE", env={"DYN_OFFLINE": raw}) is want


def test_tri_state_bool_distinguishes_unset():
    knob = knobs.register("DYN_TEST_TRI_STATE", type="bool", default=None, doc="test")
    try:
        assert knobs.get(knob, env={}) is None
        assert knobs.get(knob, env={knob: "0"}) is False
        assert knobs.get(knob, env={knob: "1"}) is True
    finally:
        knobs._REGISTRY.pop(knob)


def test_numeric_knobs_degrade_to_default_on_garbage():
    assert knobs.get("DYN_RETRY_MAX", env={"DYN_RETRY_MAX": "3"}) == 3
    assert knobs.get("DYN_RETRY_MAX", env={"DYN_RETRY_MAX": "zz"}) == 1
    assert knobs.get("DYN_CONNECT_TIMEOUT_S", env={"DYN_CONNECT_TIMEOUT_S": "2.5"}) == 2.5
    assert knobs.get("DYN_CONNECT_TIMEOUT_S", env={}) == 30.0
    assert knobs.get("DYN_PEAK_TFLOPS", env={"DYN_PEAK_TFLOPS": ""}) is None


def test_unregistered_name_raises():
    with pytest.raises(KeyError):
        knobs.get("DYN_NO_SUCH_KNOB")
    with pytest.raises(KeyError):
        knobs.get_raw("DYN_NO_SUCH_KNOB")


def test_registration_guards():
    with pytest.raises(ValueError):
        knobs.register("DYN_LOG", type="str", doc="duplicate")
    with pytest.raises(ValueError):
        knobs.register("DYN_TEST_NO_DOC", type="str")
    with pytest.raises(ValueError):
        knobs.register("DYN_TEST_BAD_TYPE", type="blob", doc="x")
    with pytest.raises(ValueError):
        knobs.register("DYN_TEST_BAD_SECTION", type="str", doc="x", section="nowhere")


def test_is_set():
    assert knobs.is_set("DYN_LOG", env={"DYN_LOG": "info"})
    assert not knobs.is_set("DYN_LOG", env={})


def test_shared_knobs_keep_the_reference_types_and_defaults():
    from dynamo_tpu.utils import knobs as ref

    theirs = {k.name: k for k in ref.all_knobs()}
    shared = [k for k in knobs.all_knobs() if k.name in theirs]
    assert len(shared) > 60
    for knob in shared:
        assert (knob.type, knob.default) == (theirs[knob.name].type,
                                             theirs[knob.name].default), knob.name


def test_knob_page_is_generated():
    """``KNOBS.md`` is ``--knob-table``'s output, every knob in one of the
    reference's four sections, and each section's table in it."""
    page = (REPO_ROOT / "dynamo_tpu_torch" / "KNOBS.md").read_text()
    assert page == knobs.knob_page()
    for knob in knobs.all_knobs():
        assert knob.section in knobs.SECTIONS, knob.name
    for section in knobs.SECTIONS:
        assert knobs.knob_table(section) in page


def test_backoff_reads_its_registered_knobs(monkeypatch):
    from dynamo_tpu_torch.robustness.retry import Backoff

    monkeypatch.setenv("DYN_CP_RECONNECT_BACKOFF_S", "0.25")
    monkeypatch.setenv("DYN_CP_RECONNECT_BACKOFF_MAX_S", "junk")
    b = Backoff.from_env("DYN_CP_RECONNECT", initial=0.05, max_delay=2.0)
    assert (b.initial, b.max_delay) == (0.25, 2.0)


# -- the gate (tests/analysis/test_gate.py) -------------------------------------

def test_the_baseline_is_empty():
    path = REPO_ROOT / core.BASELINE_NAME
    data = json.loads(path.read_text())
    assert data["version"] == 1
    assert core.load_baseline(path) == {}


def test_the_port_is_dynlint_clean():
    findings, summary = analysis.analyze(REPO_ROOT)
    new, stale = core.diff_baseline(findings, core.load_baseline(REPO_ROOT / core.BASELINE_NAME))
    assert not new, "\n".join(f.render() for f in new)
    assert not stale, "\n".join(stale)
    assert summary["files_scanned"] > 150
    assert summary["per_pass"]["knob-registry"] == summary["per_pass"]["graph-purity"] == 0


def test_the_cli_gate_exits_zero(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.scripts.dynlint", "--check",
         "--summary", str(tmp_path / "summary.json")],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads((tmp_path / "summary.json").read_text())["new"] == 0


def test_the_analyzer_imports_neither_torch_nor_jax():
    code = ("import sys\n"
            "from dynamo_tpu_torch import analysis\n"
            "from dynamo_tpu_torch.scripts import dynlint\n"
            "from dynamo_tpu_torch.utils import knobs\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'dynamo_tpu', 'numpy')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
