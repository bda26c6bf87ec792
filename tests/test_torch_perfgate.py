"""The port's perf regression gate (dynamo_tpu_torch/bench/perfgate.py): the
cases of tests/bench/test_perf_gate.py on synthetic headline artifacts in
``tmp_path`` (the port commits no artifact and no baseline): a pile passes
against its own baseline, a degraded metric fails by its name, improvements
and in-band drift pass, a lower-is-better metric regresses upward, stale and
unbaselined entries fail, an artifact of another schema generation is
refused without cascading, a missing artifact is a finding, the provenance
stamp carries the card's name and power limit, and ``--write-baseline``
refuses a dirty pile and re-records a clean one."""

import json
import subprocess
import sys

import pytest

from dynamo_tpu_torch.bench import perfgate
from dynamo_tpu_torch.bench.perfgate import main as perfgate_main


def headline_line(tok_s=1234.5, ttft=800.0, itl=25.0) -> dict:
    """A headline bench line with the keys the gate reads (the shape
    ``python -m dynamo_tpu_torch.bench.headline`` prints)."""
    return {
        "metric": "decode_tok_s_per_chip", "value": tok_s, "unit": "tok/s/chip",
        "vs_baseline": round(tok_s / 145.0, 3),
        "detail": {"decode_phase_tok_s": tok_s * 1.1, "ttft_p50_ms": ttft, "itl_p50_ms": itl,
                   "mfu": 0.31, "prefix_ttft_speedup": 7.5, "pipeline_tok_s": tok_s * 0.95,
                   "graphs_captured_after_warmup": 0, "outputs_ok": True,
                   "device_kind": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0},
    }


def write_pile(root, **lines) -> None:
    for config in perfgate.CONFIGS:
        perfgate.write_artifact(root, config, lines.get(config) or headline_line())


def edit(path, mutate) -> None:
    data = json.loads(path.read_text())
    mutate(data)
    path.write_text(json.dumps(data, indent=2) + "\n")


@pytest.fixture
def pile(tmp_path):
    write_pile(tmp_path, C=headline_line(tok_s=600.0, ttft=400.0, itl=12.0))
    perfgate.write_baseline(tmp_path)
    return tmp_path


def test_pile_passes_against_its_baseline(pile):
    assert perfgate.check(pile) == []
    values, findings = perfgate.extract_metrics(pile)
    assert findings == []
    assert set(values) == {spec.name for spec in perfgate.METRICS}
    baseline = perfgate.load_baseline(perfgate.baseline_path(pile))
    assert set(baseline["metrics"]) == set(values)
    assert baseline["metrics"]["headline_c.tok_s"] == 600.0
    assert baseline["metrics"]["headline_a.outputs_ok"] == 1.0


def test_the_gate_reads_only_its_own_files(pile):
    assert perfgate.BASELINE_NAME == "PERF_BASELINE_CUDA.json"
    assert perfgate.ARTIFACTS == ("HEADLINE_A.json", "HEADLINE_C.json")
    # the repository's TPU artifacts beside the pile change nothing
    (pile / "PERF_BASELINE.json").write_text("{}")
    (pile / "KERNEL_PERF.json").write_text("not json")
    assert perfgate.check(pile) == []


def test_degraded_metric_fails_with_a_named_finding(pile):
    edit(pile / "HEADLINE_A.json", lambda d: d.update(value=d["value"] * 0.5))
    findings = perfgate.check(pile)
    assert [(f.kind, f.metric) for f in findings] == [("regression", "headline_a.tok_s")]
    assert "HEADLINE_A.json" in findings[0].detail and "baseline" in findings[0].detail


def test_improvement_and_in_band_drift_pass(pile):
    def mutate(d):
        d["value"] *= 1.5                       # improvement
        d["detail"]["itl_p50_ms"] *= 1.10       # within the 15% band

    edit(pile / "HEADLINE_C.json", mutate)
    assert perfgate.check(pile) == []


def test_lower_direction_metric_regresses_upward(pile):
    edit(pile / "HEADLINE_C.json", lambda d: d["detail"].update(ttft_p50_ms=4000.0))
    findings = perfgate.check(pile)
    assert [(f.kind, f.metric) for f in findings] == [("regression", "headline_c.ttft_p50_ms")]


def test_a_late_capture_or_a_wrong_output_regresses(pile):
    edit(pile / "HEADLINE_A.json", lambda d: d["detail"].update(
        graphs_captured_after_warmup=1, outputs_ok=False))
    assert sorted(f.metric for f in perfgate.check(pile)) == [
        "headline_a.graphs_captured_after_warmup", "headline_a.outputs_ok"]


def test_stale_baseline_entry_fails(pile):
    edit(pile / perfgate.BASELINE_NAME, lambda d: d["metrics"].update({"ghost.gone": 1.0}))
    assert [(f.kind, f.metric) for f in perfgate.check(pile)] == [("stale", "ghost.gone")]


def test_no_longer_extractable_entry_is_stale(pile):
    edit(pile / "HEADLINE_C.json", lambda d: d["detail"].pop("mfu"))
    assert [(f.kind, f.metric) for f in perfgate.check(pile)] == [("stale", "headline_c.mfu")]


def test_unbaselined_metric_fails(pile):
    edit(pile / perfgate.BASELINE_NAME, lambda d: d["metrics"].pop("headline_a.mfu"))
    assert [(f.kind, f.metric) for f in perfgate.check(pile)] == [
        ("unbaselined", "headline_a.mfu")]


def test_incompatible_provenance_is_refused_not_diffed(pile):
    edit(pile / "HEADLINE_C.json", lambda d: d.update(provenance={"schema_version": 999}))
    assert [(f.kind, f.metric) for f in perfgate.check(pile)] == [
        ("incompatible-artifact", "HEADLINE_C.json")]


def test_missing_artifact_is_a_finding(pile):
    (pile / "HEADLINE_A.json").unlink()
    kinds = {(f.kind, f.metric) for f in perfgate.check(pile)}
    assert ("missing-artifact", "HEADLINE_A.json") in kinds
    with pytest.raises(ValueError, match="refusing to write a baseline"):
        perfgate.write_baseline(pile)


def test_provenance_stamp_carries_the_card(pile, monkeypatch):
    data = json.loads((pile / "HEADLINE_A.json").read_text())
    prov = data["provenance"]
    assert prov["schema_version"] == perfgate.PERFGATE_SCHEMA_VERSION
    assert (prov["host_class"], prov["power_limit_w"]) == ("NVIDIA H100 80GB HBM3", 700.0)
    assert perfgate.provenance_finding("X.json", data) is None
    assert perfgate.provenance_finding("X.json", {}) is None  # pre-provenance: accepted
    assert perfgate.provenance_stamp()["host_class"] == "cpu"  # no card up here
    monkeypatch.setenv("DYN_PERFGATE_HOST_CLASS", "h100-700w")
    monkeypatch.setenv("DYN_PERFGATE_GIT_DESCRIBE", "v0-1-gabc")
    stamp = perfgate.provenance_stamp({"device_kind": "x", "power_limit_w": 350.0})
    assert (stamp["host_class"], stamp["git_describe"], stamp["power_limit_w"]) == (
        "h100-700w", "v0-1-gabc", 350.0)
    with pytest.raises(ValueError, match="unknown headline configuration"):
        perfgate.write_artifact(pile, "B", headline_line())


def git(cwd, *args) -> None:
    subprocess.run(["git", "-c", "user.name=t", "-c", "user.email=t@t", *args], cwd=str(cwd),
                   check=True, capture_output=True)


@pytest.fixture
def committed_pile(pile):
    git(pile, "init", "-q")
    git(pile, "add", "-A")
    git(pile, "commit", "-q", "-m", "pile")
    return pile


def test_write_baseline_refuses_a_dirty_pile(committed_pile, capsys):
    edit(committed_pile / "HEADLINE_A.json", lambda d: d.update(value=42.0))
    assert perfgate.dirty_artifacts(committed_pile) == ["HEADLINE_A.json"]
    assert perfgate_main(["--root", str(committed_pile), "--write-baseline"]) == 1
    out = capsys.readouterr().out
    assert "refusing --write-baseline" in out and "HEADLINE_A.json" in out


def test_write_baseline_over_a_clean_pile_then_the_gate_passes(committed_pile, capsys):
    edit(committed_pile / "HEADLINE_A.json", lambda d: d.update(value=42.0))
    git(committed_pile, "add", "-A")
    git(committed_pile, "commit", "-q", "-m", "a legitimate perf change")
    assert perfgate_main(["--root", str(committed_pile), "--write-baseline"]) == 0
    baseline = perfgate.load_baseline(committed_pile / perfgate.BASELINE_NAME)
    assert baseline["metrics"]["headline_a.tok_s"] == 42.0
    assert perfgate_main(["--root", str(committed_pile)]) == 0
    assert "perf gate ok (18 metrics within band)" in capsys.readouterr().out


def test_cli_exit_code_and_findings(pile, capsys, tmp_path):
    edit(pile / "HEADLINE_A.json", lambda d: d.update(value=d["value"] * 0.5))
    assert perfgate_main(["--root", str(pile)]) == 1
    assert "[regression] headline_a.tok_s" in capsys.readouterr().out
    assert perfgate_main(["--root", str(pile), "--json"]) == 1
    assert json.loads(capsys.readouterr().out)[0]["metric"] == "headline_a.tok_s"
    # no baseline: a pointer to --write-baseline
    assert perfgate_main(["--root", str(pile), "--baseline", str(tmp_path / "none.json")]) == 1
    assert "--write-baseline" in capsys.readouterr().out
    # and the module runs as a command
    out = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.bench.perfgate", "--root",
                          str(pile)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "[regression] headline_a.tok_s" in out.stdout
