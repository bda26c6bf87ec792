"""Perf regression gate over the port's benchmark artifacts: the
reference's ratchet (dynamo_tpu/bench/perfgate.py: schema, provenance,
tolerance bands, stale and unbaselined findings, a ``--write-baseline``
that refuses a dirty pile), pointed at the port's headline bench.

The artifacts are the JSON lines ``python -m dynamo_tpu_torch.bench.headline``
prints, one file a configuration of bench.py's headline (``HEADLINE_A.json``:
configuration A, int8 weights and an fp8 cache; ``HEADLINE_C.json``:
configuration C, bf16 throughout, ``decode_steps`` 1), each written by
:func:`write_artifact`, which stamps the line with a provenance header
carrying the card's name and power limit.  The gate never reads the
repository's TPU artifacts or their ``PERF_BASELINE.json``: its files have
names of their own.

- a canonical metric-extraction schema (:data:`METRICS`) names the
  headline numbers of each configuration's line, their direction, and
  their tolerance band;
- ``PERF_BASELINE_CUDA.json`` (beside the artifacts) records the accepted
  values;
- a NEW regression (metric degraded beyond its band vs baseline) FAILS;
- a STALE baseline entry (metric no longer extractable / no longer in the
  schema) FAILS — the baseline must be regenerated, never hand-edited;
- an artifact whose provenance header names a different schema generation
  is refused (its metrics are excluded from both checks) instead of being
  diffed as garbage;
- ``python -m dynamo_tpu_torch.bench.perfgate --write-baseline``
  re-records legitimately — and refuses to run over a dirty artifact set.

Pure stdlib but for the card's name in the provenance stamp.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path

# Bumped when the meaning of extracted metrics changes incompatibly —
# artifacts stamped with a DIFFERENT generation are refused, not diffed.
PERFGATE_SCHEMA_VERSION = 1

BASELINE_NAME = "PERF_BASELINE_CUDA.json"
REPO_ROOT = Path(__file__).resolve().parent.parent.parent

# the headline configurations whose lines the gate ratchets (bench.py's
# names: A the headline, C bf16 at decode_steps 1)
CONFIGS = ("A", "C")
ARTIFACTS = tuple(f"HEADLINE_{c}.json" for c in CONFIGS)


@dataclass(frozen=True)
class MetricSpec:
    """One ratcheted metric: where it lives, which way is better, and how
    much drift the band forgives.

    ``path`` is a dot path into the artifact JSON.  A ``max:`` prefix folds
    a list: ``max:rows[].tflops`` is the max of ``row["tflops"]`` over
    ``rows``.  Booleans extract as 0/1 so "must stay true" is just a
    higher-direction metric with a zero band.
    """

    name: str           # stable metric id (baseline key)
    artifact: str       # which artifact file it comes from
    path: str           # extraction path (see above)
    direction: str      # "higher" | "lower" — which way is BETTER
    rel_tol: float      # relative drift forgiven before a regression fires
    abs_slack: float = 0.0  # additive slack (for near-zero baselines)
    doc: str = ""


def _headline_metrics(config: str) -> tuple[MetricSpec, ...]:
    """The ratcheted numbers of one configuration's headline line."""
    art, c = f"HEADLINE_{config}.json", f"headline_{config.lower()}"
    return (
        MetricSpec(f"{c}.tok_s", art, "value", "higher", 0.10,
                   doc="generated tokens/s/card over the burst"),
        MetricSpec(f"{c}.decode_phase_tok_s", art, "detail.decode_phase_tok_s", "higher", 0.10,
                   doc="decode-phase tokens/s"),
        MetricSpec(f"{c}.ttft_p50_ms", art, "detail.ttft_p50_ms", "lower", 0.25,
                   doc="time to first token, p50"),
        MetricSpec(f"{c}.itl_p50_ms", art, "detail.itl_p50_ms", "lower", 0.15,
                   doc="per-request mean inter-token latency, p50"),
        MetricSpec(f"{c}.mfu", art, "detail.mfu", "higher", 0.10,
                   doc="model FLOP utilization against the card's peak"),
        MetricSpec(f"{c}.prefix_ttft_speedup", art, "detail.prefix_ttft_speedup", "higher",
                   0.25, doc="TTFT of a prompt again over its first time"),
        MetricSpec(f"{c}.pipeline_tok_s", art, "detail.pipeline_tok_s", "higher", 0.15,
                   doc="the same burst through the HTTP serving stack"),
        MetricSpec(f"{c}.graphs_captured_after_warmup", art,
                   "detail.graphs_captured_after_warmup", "lower", 0.0,
                   doc="graphs captured after warmup (stay 0)"),
        MetricSpec(f"{c}.outputs_ok", art, "detail.outputs_ok", "higher", 0.0,
                   doc="every rung streamed requests x OSL tokens, the cache finite"),
    )


METRICS: tuple[MetricSpec, ...] = tuple(m for c in CONFIGS for m in _headline_metrics(c))


@dataclass(frozen=True)
class Finding:
    """One gate failure, named like a dynlint finding."""

    kind: str    # "regression" | "stale" | "unbaselined" | "missing-artifact"
                 # | "unreadable-artifact" | "incompatible-artifact"
    metric: str  # metric id, or artifact name for artifact-level findings
    detail: str

    def __str__(self) -> str:
        return f"[{self.kind}] {self.metric}: {self.detail}"


# -- provenance --------------------------------------------------------------


def _card_name() -> str:
    """The card's name where CUDA is up in this process, else ``cpu``
    (never initializes CUDA for a stamp)."""
    try:
        import torch

        if torch.cuda.is_initialized():
            return torch.cuda.get_device_name(0)
    except Exception:  # noqa: BLE001 — the stamp must work without a card
        pass
    return "cpu"


def provenance_stamp(card: dict | None = None) -> dict:
    """The provenance header an artifact carries (under the ``provenance``
    key) so the gate can refuse to diff incompatible artifact generations,
    and a reader can see the card a number came from: ``host_class`` is the
    knob override, else ``card["device_kind"]`` (the headline line's), else
    the card CUDA runs on in this process; ``power_limit_w`` is
    ``card["power_limit_w"]``; git describe is passed via env by CI."""
    from dynamo_tpu_torch.utils import knobs

    card = card or {}
    host_class = (knobs.get(knobs.K_PERFGATE_HOST_CLASS) or card.get("device_kind")
                  or _card_name())
    return {
        "schema_version": PERFGATE_SCHEMA_VERSION,
        "git_describe": knobs.get(knobs.K_PERFGATE_GIT_DESCRIBE) or "",
        "host_class": host_class,
        "power_limit_w": card.get("power_limit_w"),
    }


def write_artifact(root: str | os.PathLike, config: str, line: dict) -> Path:
    """Write configuration ``config``'s headline line (the JSON object
    ``bench.headline`` prints) as its artifact under ``root``, stamped with
    the provenance of the card in its ``detail``."""
    if config not in CONFIGS:
        raise ValueError(f"unknown headline configuration {config!r} (want {CONFIGS})")
    data = dict(line)
    data["provenance"] = provenance_stamp(line.get("detail") or {})
    out = Path(root) / f"HEADLINE_{config}.json"
    out.write_text(json.dumps(data, indent=2) + "\n")
    return out


def provenance_finding(artifact: str, data: dict) -> Finding | None:
    """A finding iff the artifact carries a provenance header from a
    DIFFERENT schema generation.  Artifacts without a header predate the
    provenance stamp and are accepted as the current generation."""
    prov = data.get("provenance")
    if not isinstance(prov, dict):
        return None
    version = prov.get("schema_version")
    if version != PERFGATE_SCHEMA_VERSION:
        return Finding(
            "incompatible-artifact", artifact,
            f"provenance schema_version={version!r} but this gate speaks "
            f"{PERFGATE_SCHEMA_VERSION}; regenerate the artifact",
        )
    return None


# -- extraction --------------------------------------------------------------


def _extract_path(data, path: str):
    """Value at a dot path; ``max:`` folds a ``seg[]`` list segment."""
    fold = None
    if path.startswith("max:"):
        fold, path = max, path[4:]
    node = data
    for seg in path.split("."):
        if seg.endswith("[]"):
            if isinstance(node, dict):
                node = node.get(seg[:-2])
            if not isinstance(node, list):
                return None
            continue
        if isinstance(node, list):
            node = [item.get(seg) for item in node
                    if isinstance(item, dict) and item.get(seg) is not None]
        elif isinstance(node, dict):
            node = node.get(seg)
        else:
            return None
        if node is None:
            return None
    if isinstance(node, list):
        if fold is None or not node:
            return None
        return fold(node)
    if fold is not None:
        return None
    return node


def _as_number(value) -> float | None:
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    if isinstance(value, (int, float)):
        return float(value)
    return None


def extract_metrics(root: str | os.PathLike) -> tuple[dict, list[Finding]]:
    """(metric id → value) over every readable, compatible artifact under
    ``root``, plus artifact-level findings (missing / unreadable /
    incompatible).  Metrics of refused artifacts are absent from the value
    map AND recorded in the second element of the return so callers can
    exclude them from stale checks."""
    root = Path(root)
    values: dict[str, float] = {}
    findings: list[Finding] = []
    refused: set[str] = set()
    loaded: dict[str, dict] = {}
    for artifact in ARTIFACTS:
        path = root / artifact
        if not path.exists():
            findings.append(Finding(
                "missing-artifact", artifact, f"{path} does not exist"))
            refused.add(artifact)
            continue
        try:
            data = json.loads(path.read_text())
        except (OSError, ValueError) as exc:
            findings.append(Finding(
                "unreadable-artifact", artifact, f"{path}: {exc}"))
            refused.add(artifact)
            continue
        bad = provenance_finding(artifact, data)
        if bad is not None:
            findings.append(bad)
            refused.add(artifact)
            continue
        loaded[artifact] = data
    for spec in METRICS:
        if spec.artifact in refused:
            continue
        value = _as_number(_extract_path(loaded[spec.artifact], spec.path))
        if value is not None:
            values[spec.name] = value
    return values, findings


def refused_artifacts(findings: list[Finding]) -> set[str]:
    return {
        f.metric for f in findings
        if f.kind in ("missing-artifact", "unreadable-artifact",
                      "incompatible-artifact")
    }


# -- baseline ----------------------------------------------------------------


def baseline_path(root: str | os.PathLike) -> Path:
    from dynamo_tpu_torch.utils import knobs

    explicit = knobs.get(knobs.K_PERFGATE_BASELINE)
    if explicit:
        return Path(explicit)
    return Path(root) / BASELINE_NAME


def load_baseline(path: str | os.PathLike) -> dict:
    data = json.loads(Path(path).read_text())
    if not isinstance(data.get("metrics"), dict):
        raise ValueError(f"{path}: no 'metrics' map (not a perf baseline?)")
    return data


def write_baseline(root: str | os.PathLike,
                   path: str | os.PathLike | None = None,
                   note: str | None = None) -> Path:
    """Re-record the baseline from the current artifact pile.  Refuses when
    any artifact is missing/unreadable/incompatible — a baseline must only
    ever be written over a clean, current pile."""
    values, findings = extract_metrics(root)
    if findings:
        raise ValueError(
            "refusing to write a baseline over a broken artifact pile:\n"
            + "\n".join(str(f) for f in findings)
        )
    out = Path(path) if path is not None else baseline_path(root)
    payload = {
        "version": 1,
        "schema_version": PERFGATE_SCHEMA_VERSION,
        "note": note or (
            "Perf-gate ratchet over the port's headline artifacts. "
            "Regenerate with python -m dynamo_tpu_torch.bench.perfgate "
            "--write-baseline after a LEGITIMATE perf change — never "
            "hand-edit."
        ),
        "metrics": {name: values[name] for name in sorted(values)},
    }
    out.write_text(json.dumps(payload, indent=2) + "\n")
    return out


def dirty_artifacts(root: str | os.PathLike) -> list[str]:
    """Artifact files with uncommitted modifications per git — the
    --write-baseline refusal: a baseline recorded over a dirty pile would
    launder unreviewed numbers into the ratchet."""
    try:
        proc = subprocess.run(
            ["git", "status", "--porcelain", "--", *ARTIFACTS, BASELINE_NAME],
            cwd=str(root), capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return []
    if proc.returncode != 0:
        return []  # not a git checkout: nothing to refuse on
    dirty = []
    for line in proc.stdout.splitlines():
        name = line[3:].strip()
        if name and name != BASELINE_NAME:
            dirty.append(name)
    return sorted(set(dirty))


# -- the gate ----------------------------------------------------------------


def _band_ok(spec: MetricSpec, value: float, base: float) -> bool:
    if spec.direction == "higher":
        floor = base * (1.0 - spec.rel_tol) - spec.abs_slack
        return value >= floor
    ceiling = base * (1.0 + spec.rel_tol) + spec.abs_slack
    return value <= ceiling


def check(root: str | os.PathLike,
          baseline: dict | None = None) -> list[Finding]:
    """All gate findings for the artifact pile under ``root``.  Empty list =
    gate passes."""
    root = Path(root)
    if baseline is None:
        baseline = load_baseline(baseline_path(root))
    values, findings = extract_metrics(root)
    refused = refused_artifacts(findings)
    specs = {spec.name: spec for spec in METRICS}
    base_metrics = baseline.get("metrics", {})
    for name, base in sorted(base_metrics.items()):
        spec = specs.get(name)
        if spec is None:
            findings.append(Finding(
                "stale", name,
                "baseline entry is not in the metric schema anymore; "
                "regenerate with python -m dynamo_tpu_torch.bench.perfgate --write-baseline"))
            continue
        if spec.artifact in refused:
            continue  # already failed artifact-level; don't double-report
        value = values.get(name)
        if value is None:
            findings.append(Finding(
                "stale", name,
                f"baseline entry no longer extractable from {spec.artifact} "
                f"(path {spec.path!r}); regenerate the baseline"))
            continue
        base_num = _as_number(base)
        if base_num is None:
            findings.append(Finding(
                "stale", name, f"baseline value {base!r} is not numeric"))
            continue
        if not _band_ok(spec, value, base_num):
            findings.append(Finding(
                "regression", name,
                f"{spec.artifact}:{spec.path} = {value:g}, baseline "
                f"{base_num:g}, direction={spec.direction} "
                f"rel_tol={spec.rel_tol:g} abs_slack={spec.abs_slack:g} "
                f"({spec.doc})"))
    for name in sorted(values):
        if name not in base_metrics and specs[name].artifact not in refused:
            findings.append(Finding(
                "unbaselined", name,
                "metric extracted but absent from the baseline; record it "
                "with python -m dynamo_tpu_torch.bench.perfgate --write-baseline"))
    return findings


# -- the command line -----------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    """The gate's command line: exit 0 when it passes, 1 on findings
    (printed one a line).  ``--write-baseline`` re-records the baseline
    (refusing a dirty artifact set)."""
    parser = argparse.ArgumentParser(
        description="perf regression gate over the port's headline artifacts")
    parser.add_argument("--root", default=str(REPO_ROOT),
                        help="directory holding the artifact pile "
                             "(default: the repo root)")
    parser.add_argument("--baseline", default=None,
                        help=f"explicit baseline path (default: "
                             f"DYN_PERFGATE_BASELINE or <root>/{BASELINE_NAME})")
    parser.add_argument("--json", action="store_true",
                        help="emit findings as JSON")
    parser.add_argument("--write-baseline", action="store_true",
                        help="re-record the baseline from the current pile "
                             "(refuses over a dirty artifact set)")
    args = parser.parse_args(argv)

    root = Path(args.root)
    if args.write_baseline:
        dirty = dirty_artifacts(root)
        if dirty:
            print(
                "refusing --write-baseline: uncommitted artifact changes in "
                + ", ".join(dirty)
            )
            print("commit (or revert) the artifacts first, then re-record.")
            return 1
        try:
            out = write_baseline(root, args.baseline)
        except ValueError as exc:
            print(exc)
            return 1
        print(f"baseline written to {out}")
        return 0

    baseline_file = (
        Path(args.baseline) if args.baseline else baseline_path(root)
    )
    try:
        baseline = load_baseline(baseline_file)
    except (OSError, ValueError) as exc:
        print(f"cannot load baseline {baseline_file}: {exc}")
        print("record one with: python -m dynamo_tpu_torch.bench.perfgate --write-baseline")
        return 1
    findings = check(root, baseline)
    if args.json:
        print(json.dumps(
            [{"kind": f.kind, "metric": f.metric, "detail": f.detail}
             for f in findings], indent=2))
    else:
        for f in findings:
            print(f)
        if not findings:
            values, _ = extract_metrics(root)
            print(f"perf gate ok ({len(values)} metrics within band)")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
