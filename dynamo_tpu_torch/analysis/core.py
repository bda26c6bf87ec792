"""dynlint core: module loading, pragmas, findings, and the baseline ratchet
(counterpart of dynamo_tpu/analysis/core.py).

The analyzer is deliberately pure-AST and stdlib-only — it runs in tier-1
without importing the package under analysis (no torch, no
prometheus_client), so a broken runtime import can never take the lint gate
down with it.

Key pieces:

- :class:`Module` — one parsed source file with its import map, module-level
  string constants, and ``# dynlint: disable=`` pragma table.
- :class:`Finding` — one diagnostic; its :func:`fingerprint` is line-free
  (pass, path, rule, enclosing context + occurrence ordinal) so baselines
  survive unrelated edits to the same file.
- :func:`apply_pragmas` — drops findings suppressed at their line; a
  suppression without a reason is itself a finding (``pragma`` pass).
- :func:`diff_baseline` — the ratchet: NEW findings (not in the recorded
  baseline) fail; findings IN the baseline pass; a baseline entry with no
  surviving finding fails too ("stale"), forcing the baseline to be
  re-recorded (``--write-baseline``) so recorded debt only ever shrinks
  deliberately.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BASELINE_NAME = "ANALYSIS_BASELINE_CUDA.json"
SUMMARY_NAME = "ANALYSIS_SUMMARY_CUDA.json"
# the knob pass's docs corpus: the port's own knob page (never docs/ or the
# README, whose pages document the reference's knobs)
KNOB_DOCS = ("dynamo_tpu_torch/KNOBS.md",)

# pass ids (the ``pragma`` pseudo-pass carries suppression-syntax findings)
ASYNC_HYGIENE = "async-hygiene"
LOCK_DISCIPLINE = "lock-discipline"
GRAPH_PURITY = "graph-purity"
KNOB_REGISTRY = "knob-registry"
METRIC_NAMES = "metric-names"
PRAGMA = "pragma"

PASS_IDS = (ASYNC_HYGIENE, LOCK_DISCIPLINE, GRAPH_PURITY, KNOB_REGISTRY, METRIC_NAMES)

# pass list stops at "--" (the reason separator) — pass names themselves may
# contain single hyphens, so the list group is non-greedy with an anchored tail
_PRAGMA_RE = re.compile(
    r"#\s*dynlint:\s*disable=([a-zA-Z0-9_,\- ]+?)(?:\s*--\s*(.*))?$"
)


@dataclass(frozen=True)
class Finding:
    pass_id: str
    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    context: str = ""  # enclosing function/class qualname (fingerprint key)

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        ctx = f" [{self.context}]" if self.context else ""
        return f"{where}: {self.pass_id}/{self.rule}: {self.message}{ctx}"


def fingerprints(findings: list[Finding]) -> dict[str, int]:
    """Line-free fingerprint -> count (counts make repeats in one context
    ratchet-able without encoding line numbers)."""
    counts: dict[str, int] = {}
    for f in findings:
        key = f"{f.pass_id}|{f.path}|{f.rule}|{f.context}"
        counts[key] = counts.get(key, 0) + 1
    return counts


class Module:
    """One parsed source file plus the lookup tables every pass wants."""

    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.tree = ast.parse(source)
        self.lines = source.splitlines()
        # line -> set of disabled pass ids; line -> reason text
        self.pragma_lines: dict[int, set[str]] = {}
        self.pragma_reasons: dict[int, str] = {}
        self.pragma_findings: list[Finding] = []
        self._scan_pragmas()
        # local name -> dotted origin ("np" -> "numpy", "sleep" -> "time.sleep")
        self.imports: dict[str, str] = {}
        # module-level UPPER_CASE string constants (resolves env-name aliases)
        self.constants: dict[str, str] = {}
        self._scan_top_level()

    # -- pragmas -----------------------------------------------------------
    def _scan_pragmas(self) -> None:
        for idx, text in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(text)
            if m is None:
                continue
            passes = {p.strip() for p in m.group(1).split(",") if p.strip()}
            reason = (m.group(2) or "").strip()
            # a pragma on a comment-only line suppresses the NEXT line
            target = idx + 1 if text.strip().startswith("#") else idx
            self.pragma_lines.setdefault(target, set()).update(passes)
            self.pragma_reasons[target] = reason
            unknown = passes - set(PASS_IDS)
            if unknown:
                self.pragma_findings.append(Finding(
                    PRAGMA, "unknown-pass", self.rel, idx,
                    f"pragma disables unknown pass(es): {', '.join(sorted(unknown))}",
                ))
            if len(reason) < 3:
                self.pragma_findings.append(Finding(
                    PRAGMA, "missing-reason", self.rel, idx,
                    "suppression must carry a reason: "
                    "`# dynlint: disable=<pass> -- <why this is safe>`",
                ))

    def suppressed(self, pass_id: str, line: int) -> bool:
        return pass_id in self.pragma_lines.get(line, set())

    # -- imports / constants ----------------------------------------------
    def _scan_top_level(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.imports[alias.asname or alias.name.split(".")[0]] = alias.name
            elif isinstance(node, ast.ImportFrom):
                prefix = node.module or ""
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = (
                        f"{prefix}.{alias.name}" if prefix else alias.name
                    )
        for node in self.tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                self.constants[node.targets[0].id] = node.value.value

    def dotted(self, node: ast.AST) -> str | None:
        """Dotted origin of an expression: ``np.asarray`` -> ``numpy.asarray``,
        ``asyncio.get_running_loop().create_task`` ->
        ``asyncio.get_running_loop().create_task``.  None when unresolvable."""
        if isinstance(node, ast.Name):
            return self.imports.get(node.id, node.id)
        if isinstance(node, ast.Attribute):
            base = self.dotted(node.value)
            return None if base is None else f"{base}.{node.attr}"
        if isinstance(node, ast.Call):
            base = self.dotted(node.func)
            return None if base is None else f"{base}()"
        return None

    def literal_str(self, node: ast.AST) -> str | None:
        """A string literal, or a Name resolving to a module-level string
        constant (``os.environ.get(ALLOW_PRIVATE_ENV)``)."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            return self.constants.get(node.id)
        return None


def leaf_token(node: ast.AST) -> str | None:
    """The rightmost identifier of a Name/Attribute/Subscript chain — the
    token two sites share when they talk about the same handle
    (``self._read_task`` -> ``_read_task``; ``tasks[k]`` -> ``tasks``)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        return leaf_token(node.value)
    if isinstance(node, ast.Starred):
        return leaf_token(node.value)
    return None


def attach_parents(tree: ast.Module) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._dynlint_parent = node  # type: ignore[attr-defined]


def parent_of(node: ast.AST) -> ast.AST | None:
    return getattr(node, "_dynlint_parent", None)


@dataclass
class Context:
    """What passes get besides the module list."""

    repo_root: Path
    modules: list[Module] = field(default_factory=list)
    knob_docs: tuple[str, ...] = KNOB_DOCS

    def module(self, rel_suffix: str) -> Module | None:
        for m in self.modules:
            if m.rel.endswith(rel_suffix):
                return m
        return None

    def docs_text(self) -> str:
        """Concatenated docs corpus the knob pass checks names against: the
        pages ``knob_docs`` names, relative to the repo root."""
        chunks = []
        for rel in self.knob_docs:
            page = self.repo_root / rel
            if page.exists():
                chunks.append(page.read_text())
        return "\n".join(chunks)


def load_modules(repo_root: Path, roots: list[str]) -> tuple[list[Module], list[Finding]]:
    modules: list[Module] = []
    findings: list[Finding] = []
    seen: set[Path] = set()
    for root in roots:
        base = (repo_root / root).resolve()
        paths = [base] if base.is_file() else sorted(base.rglob("*.py"))
        for path in paths:
            if path in seen or "__pycache__" in path.parts:
                continue
            seen.add(path)
            rel = path.relative_to(repo_root).as_posix()
            try:
                modules.append(Module(path, rel, path.read_text()))
            except SyntaxError as exc:
                findings.append(Finding(
                    PRAGMA, "parse-error", rel, exc.lineno or 0,
                    f"file does not parse: {exc.msg}",
                ))
    return modules, findings


def apply_pragmas(modules: list[Module], findings: list[Finding]) -> tuple[list[Finding], int]:
    """Drop suppressed findings; append pragma-syntax findings."""
    by_rel = {m.rel: m for m in modules}
    kept: list[Finding] = []
    suppressed = 0
    for f in findings:
        mod = by_rel.get(f.path)
        if mod is not None and mod.suppressed(f.pass_id, f.line):
            suppressed += 1
            continue
        kept.append(f)
    for mod in modules:
        kept.extend(mod.pragma_findings)
    return kept, suppressed


# -- baseline ratchet -------------------------------------------------------

def load_baseline(path: Path) -> dict[str, int]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return dict(data.get("counts", {}))


def write_baseline(path: Path, findings: list[Finding]) -> None:
    payload = {
        "version": 1,
        "note": "dynlint debt baseline — regenerate with python -m "
                "dynamo_tpu_torch.scripts.dynlint "
                "--write-baseline after deliberately paying down or accepting "
                "debt; CI fails on new findings AND on stale entries here.",
        "counts": dict(sorted(fingerprints(findings).items())),
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")


def diff_baseline(
    findings: list[Finding], baseline: dict[str, int]
) -> tuple[list[Finding], list[str]]:
    """-> (new findings beyond the baseline, stale baseline fingerprints)."""
    current = fingerprints(findings)
    new: list[Finding] = []
    budget = dict(baseline)
    # deterministic order so "which occurrence is new" is stable
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        key = f"{f.pass_id}|{f.path}|{f.rule}|{f.context}"
        if budget.get(key, 0) > 0:
            budget[key] -= 1
        else:
            new.append(f)
    stale = sorted(
        key for key, count in baseline.items() if current.get(key, 0) < count
    )
    return new, stale
