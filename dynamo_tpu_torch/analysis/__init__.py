"""dynlint over the port — counterpart of dynamo_tpu/analysis/.

Five AST passes purpose-built for this codebase's failure surfaces (silent
asyncio bugs, host syncs in code a CUDA graph captures, knob/doc drift,
metric-name drift), run as a tier-1 gate with a baseline ratchet
(``ANALYSIS_BASELINE_CUDA.json``, kept empty).  The reference's
``jit-purity`` pass becomes ``graph-purity`` here: its roots are the
forwards and the sampling tail the engine's CUDA graphs capture.  The CLI is
``python -m dynamo_tpu_torch.scripts.dynlint``; the pass catalog and the
suppression syntax are the reference's (docs/analysis.md).

Stdlib-only on purpose: the gate must run without importing the package
under analysis (no torch, no prometheus_client).
"""

from __future__ import annotations

from pathlib import Path

from dynamo_tpu_torch.analysis import (
    async_hygiene,
    graph_purity,
    knob_registry,
    lock_discipline,
    metric_names,
)
from dynamo_tpu_torch.analysis.core import (
    ASYNC_HYGIENE,
    BASELINE_NAME,
    GRAPH_PURITY,
    KNOB_DOCS,
    KNOB_REGISTRY,
    LOCK_DISCIPLINE,
    METRIC_NAMES,
    PASS_IDS,
    SUMMARY_NAME,
    Context,
    Finding,
    apply_pragmas,
    diff_baseline,
    fingerprints,
    load_baseline,
    load_modules,
    write_baseline,
)

PASSES = {
    ASYNC_HYGIENE: async_hygiene.run,
    LOCK_DISCIPLINE: lock_discipline.run,
    GRAPH_PURITY: graph_purity.run,
    KNOB_REGISTRY: knob_registry.run,
    METRIC_NAMES: metric_names.run,
}

DEFAULT_ROOTS = ("dynamo_tpu_torch",)


def analyze(
    repo_root: Path, roots: tuple[str, ...] = DEFAULT_ROOTS,
    passes: tuple[str, ...] | None = None, knob_docs: tuple[str, ...] = KNOB_DOCS,
) -> tuple[list[Finding], dict]:
    """Run the selected passes; -> (pragma-filtered findings, summary dict).

    The summary carries per-pass found/suppressed counts — the artifact CI
    diffs across PRs.  ``knob_docs`` names the knob pass's docs pages,
    relative to ``repo_root``.
    """
    modules, load_findings = load_modules(repo_root, list(roots))
    ctx = Context(repo_root=Path(repo_root), modules=modules, knob_docs=tuple(knob_docs))
    raw: list[Finding] = list(load_findings)
    selected = passes or tuple(PASSES)
    per_pass_found: dict[str, int] = {}
    for pass_id in selected:
        produced = PASSES[pass_id](ctx)
        per_pass_found[pass_id] = len(produced)
        raw.extend(produced)
    findings, suppressed = apply_pragmas(modules, raw)
    findings.sort(key=lambda f: (f.path, f.line, f.pass_id, f.rule))
    summary = {
        "files_scanned": len(modules),
        "findings": len(findings),
        "suppressed": suppressed,
        "per_pass": {
            pass_id: sum(1 for f in findings if f.pass_id == pass_id)
            for pass_id in (*selected, "pragma")
        },
        "per_pass_pre_suppression": per_pass_found,
    }
    return findings, summary


__all__ = [
    "PASSES", "PASS_IDS", "DEFAULT_ROOTS", "BASELINE_NAME", "SUMMARY_NAME", "KNOB_DOCS",
    "Context", "Finding", "analyze", "apply_pragmas", "diff_baseline",
    "fingerprints", "load_baseline", "load_modules", "write_baseline",
]
