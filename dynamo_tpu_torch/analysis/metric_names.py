"""metric-names pass: the metrics contract, enforced both statically and at
render time (counterpart of dynamo_tpu/analysis/metric_names.py).

The rules — ``dyn_`` prefix, canonical unit suffixes (``_seconds`` for
time, ``_total`` for counters, ``_perc``/``_ratio`` for fractions; never
``_ms``/``_pct``/``_count``), no duplicate family declarations:

- :func:`lint_family_name` / :func:`lint_exposition` — shared rule
  functions, for a rendered registry (requires prometheus_client);
- :func:`run` — the pure-AST dynlint pass: it lints family-name string
  literals at ``Counter(...)``/``Gauge(...)``/``Histogram(...)``
  construction sites (resolving ``f"{PREFIX}_..."`` against module
  constants), so a bad name fails the lint gate even in environments where
  the registry never renders.
"""

from __future__ import annotations

import ast
import re

from dynamo_tpu_torch.analysis.core import Context, Finding, METRIC_NAMES, Module

NAME_RE = re.compile(r"^dyn_[a-z0-9_]+$")

# unit spellings that have a canonical form in this repo
FORBIDDEN_SUFFIXES = (
    "_ms", "_us", "_millis", "_milliseconds", "_microseconds", "_sec",
    "_secs", "_percent", "_pct", "_count", "_num",
)

TIME_TOKENS = ("duration", "latency", "_time_")

_TYPE_RE = re.compile(r"^# TYPE (\S+) (\S+)$", re.MULTILINE)

PROM_CONSTRUCTORS = {"Counter", "Gauge", "Histogram", "Summary", "Info"}


def lint_family_name(name: str, *, metric_type: str | None = None) -> list[str]:
    """Problems with one metric family name (empty list = clean)."""
    problems: list[str] = []
    if not NAME_RE.match(name):
        problems.append(f"{name}: not dyn_-prefixed lower_snake")
    for suffix in FORBIDDEN_SUFFIXES:
        if name.endswith(suffix):
            problems.append(f"{name}: forbidden unit suffix {suffix}")
    if any(tok in name for tok in TIME_TOKENS) and not (
        name.endswith("_seconds") or name.endswith("_seconds_total")
    ):
        problems.append(f"{name}: time-valued family must end in _seconds")
    if metric_type == "counter" and not name.endswith("_total"):
        problems.append(f"{name}: counter families must end in _total")
    return problems


def lint_exposition(text: str, families: set[str]) -> list[str]:
    """Problems across a rendered Prometheus exposition (the render-time
    twin of the AST pass; ``families`` comes from the caller's scrape
    parser so frontend and worker surfaces share one implementation)."""
    problems: list[str] = []
    for name in sorted(families):
        problems.extend(lint_family_name(name))
    for name, mtype in _TYPE_RE.findall(text):
        if mtype == "counter" and not name.endswith("_total"):
            problems.append(f"{name}: counter families must end in _total")
    return problems


def _family_literal(mod: Module, node: ast.AST) -> str | None:
    """Resolve a constructor's name argument: plain literal, module
    constant, or an f-string whose placeholders are module constants."""
    direct = mod.literal_str(node)
    if direct is not None:
        return direct
    if isinstance(node, ast.JoinedStr):
        parts: list[str] = []
        for value in node.values:
            if isinstance(value, ast.Constant) and isinstance(value.value, str):
                parts.append(value.value)
            elif isinstance(value, ast.FormattedValue):
                resolved = mod.literal_str(value.value)
                if resolved is None:
                    return None  # dynamic segment: not lintable statically
                parts.append(resolved)
            else:
                return None
        return "".join(parts)
    return None


def run(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    for mod in ctx.modules:
        uses_prometheus = any(
            origin.startswith("prometheus_client") for origin in mod.imports.values()
        )
        if not uses_prometheus:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            ctor = (
                func.id if isinstance(func, ast.Name)
                else func.attr if isinstance(func, ast.Attribute) else None
            )
            if ctor not in PROM_CONSTRUCTORS or not node.args:
                continue
            name = _family_literal(mod, node.args[0])
            if name is None:
                continue
            metric_type = "counter" if ctor == "Counter" else None
            for problem in lint_family_name(name, metric_type=metric_type):
                findings.append(Finding(
                    METRIC_NAMES, "bad-family-name", mod.rel, node.lineno,
                    problem, context=name,
                ))
    return findings
