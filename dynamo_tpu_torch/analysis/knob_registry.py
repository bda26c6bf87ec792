"""knob-registry pass: every ``DYN_*`` environment read goes through the
typed registry in ``dynamo_tpu_torch/utils/knobs.py`` and every registered
knob is documented (counterpart of dynamo_tpu/analysis/knob_registry.py).

The registry itself is read *statically*: ``register("DYN_X", ...)`` calls
are literal by design, so this pass — like the rest of dynlint — never
imports the package under analysis.

Rules:

- ``raw-env-read``: ``os.environ.get/[]``, ``os.getenv``, or any
  ``<mapping>.get("DYN_...")`` outside knobs.py.  Reads through mapping
  parameters count too (they read a process environment by convention —
  ``knobs.get(name, env=...)`` covers that case).  Env *writes*
  (``os.environ["DYN_X"] = ...``) are allowed: that is how supervisors
  configure children.
- ``unregistered-knob``: a ``knobs.get``/``get_raw`` call naming a knob the
  registry does not declare (would raise KeyError at runtime; caught here).
- ``undocumented-knob``: a registered knob whose literal name appears
  nowhere on the port's knob page (``dynamo_tpu_torch/KNOBS.md``, written
  by ``python -m dynamo_tpu_torch.scripts.dynlint --knob-table``).
"""

from __future__ import annotations

import ast

from dynamo_tpu_torch.analysis.core import Context, Finding, KNOB_REGISTRY, Module

KNOBS_MODULE_SUFFIX = "utils/knobs.py"
KNOB_PREFIX = "DYN_"
ENV_READERS = {"os.environ.get", "os.getenv", "environ.get"}
KNOB_READERS = {"get", "get_raw", "is_set"}


def registered_knobs(mod: Module) -> dict[str, int]:
    """Knob name -> registration line, parsed from knobs.py's AST."""
    names: dict[str, int] = {}
    for node in ast.walk(mod.tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "register"
            and node.args
        ):
            name = mod.literal_str(node.args[0])
            if name:
                names[name] = node.lineno
    return names


def _knob_read_name(mod: Module, call: ast.Call) -> str | None:
    """The DYN_* literal a ``knobs.get(...)``-style call names, if any."""
    func = call.func
    if not (isinstance(func, ast.Attribute) and func.attr in KNOB_READERS):
        return None
    base = mod.dotted(func.value)
    if base is None or not base.endswith("knobs"):
        return None
    if not call.args:
        return None
    name = mod.literal_str(call.args[0])
    if name and name.startswith(KNOB_PREFIX):
        return name
    return None


def _raw_env_read(mod: Module, node: ast.AST) -> tuple[str, int] | None:
    """-> (knob name, line) for a raw environment read of a DYN_* name."""
    if isinstance(node, ast.Call):
        func = node.func
        if not isinstance(func, ast.Attribute):
            # os.getenv imported bare as getenv
            if mod.dotted(func) == "os.getenv" and node.args:
                name = mod.literal_str(node.args[0])
                if name and name.startswith(KNOB_PREFIX):
                    return name, node.lineno
            return None
        dotted = mod.dotted(func)
        if dotted in ENV_READERS or (func.attr == "get" and node.args):
            if dotted is not None and dotted.endswith("knobs.get"):
                return None
            if node.args:
                name = mod.literal_str(node.args[0])
                if name and name.startswith(KNOB_PREFIX):
                    return name, node.lineno
        return None
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        base = mod.dotted(node.value)
        if base in ("os.environ", "environ"):
            name = mod.literal_str(node.slice)
            if name and name.startswith(KNOB_PREFIX):
                return name, node.lineno
    return None


def run(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    knobs_mod = ctx.module(KNOBS_MODULE_SUFFIX)
    registry: dict[str, int] = {}
    if knobs_mod is None:
        findings.append(Finding(
            KNOB_REGISTRY, "no-registry", "dynamo_tpu_torch/utils/knobs.py", 0,
            "knob registry module not found under the scanned roots",
        ))
    else:
        registry = registered_knobs(knobs_mod)

    for mod in ctx.modules:
        if mod.rel.endswith(KNOBS_MODULE_SUFFIX):
            continue
        for node in ast.walk(mod.tree):
            raw = _raw_env_read(mod, node)
            if raw is not None:
                name, line = raw
                extra = "" if name in registry else " (and it is not registered)"
                findings.append(Finding(
                    KNOB_REGISTRY, "raw-env-read", mod.rel, line,
                    f"raw environment read of `{name}`{extra}; route through "
                    "utils/knobs.py (`knobs.get`)",
                    context=name,
                ))
            elif isinstance(node, ast.Call):
                name = _knob_read_name(mod, node)
                if name is not None and name not in registry:
                    findings.append(Finding(
                        KNOB_REGISTRY, "unregistered-knob", mod.rel, node.lineno,
                        f"`{name}` read through knobs.get but never "
                        "registered — this raises KeyError at runtime",
                        context=name,
                    ))

    if knobs_mod is not None and registry:
        docs = ctx.docs_text()
        for name, line in sorted(registry.items()):
            if name not in docs:
                findings.append(Finding(
                    KNOB_REGISTRY, "undocumented-knob", knobs_mod.rel, line,
                    f"registered knob `{name}` appears nowhere on the knob "
                    "page — regenerate it (python -m "
                    "dynamo_tpu_torch.scripts.dynlint --knob-table)",
                    context=name,
                ))
    return findings
