"""graph-purity pass: host syncs and impure Python inside code a CUDA graph
captures (the port's counterpart of dynamo_tpu/analysis/jit_purity.py).

The engine captures every step as a CUDA graph at one site
(``engine/graphs.py`` ``capture``), and what it captures is fixed by two
static facts, which this pass reads from the AST as the reference reads its
``@jax.jit`` decorators:

- the forwards ``models/registry.py`` hands the engine: every
  ``forward_*`` / ``embed`` keyword of a ``ModelFamily(...)`` whose value is
  ``module.function`` (``forward_decode=llama.llama_forward_decode``);
- the sampling tail: the names the capture module imports from
  ``ops/sampling.py``.

Those are the *graph roots*.  The pass walks the intra-module call graph
reachable from them (plain ``f(...)`` and ``self.f(...)`` edges) and flags
operations that force a device→host sync or run only at capture time:

- ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` — a blocking
  device readback; under capture it raises, and eagerly it stalls the step;
- ``torch.cuda.synchronize`` / ``.block_until_ready()`` /
  ``jax.device_get`` — explicit host syncs;
- ``np.asarray`` / ``np.array`` / ``np.frombuffer`` — host arrays whose
  values the graph freezes at capture;
- ``print`` and ``time.time``-family calls — side effects that fire once at
  capture, not at each replay.

A call that is safe (it reads a host constant, not a device tensor) takes a
pragma with the reason (``disable=graph-purity``).
"""

from __future__ import annotations

import ast

from dynamo_tpu_torch.analysis.core import Context, Finding, GRAPH_PURITY, Module

REGISTRY_SUFFIX = "models/registry.py"
CAPTURE_SUFFIX = "engine/graphs.py"
TAIL_SUFFIXES = ("ops/sampling.py",)
FORWARD_FIELDS = {
    "forward_decode", "forward_unified", "forward_prefill",
    "forward_prefill_with_prefix", "forward_verify", "forward_prefill_embeds",
    "forward_decode_pp", "embed",
}

HOST_SYNC_METHODS = {
    "item": "`.item()` forces a blocking device->host readback",
    "tolist": "`.tolist()` forces a blocking device->host readback",
    "cpu": "`.cpu()` copies to the host and waits for the device",
    "numpy": "`.numpy()` needs a host tensor: a device->host readback",
    "block_until_ready": "`.block_until_ready()` is an explicit host sync",
}
HOST_SYNC_DOTTED = {
    "torch.cuda.synchronize": "`torch.cuda.synchronize` is an explicit host sync",
    "jax.device_get": "`jax.device_get` is an explicit host sync",
    "numpy.asarray": "`np.asarray` makes a host array the graph freezes",
    "numpy.array": "`np.array` makes a host array the graph freezes",
    "numpy.frombuffer": "`np.frombuffer` inside captured code is host-only",
}
CAPTURE_TIME_EFFECTS = {
    "print": "`print` inside captured code fires at capture, not at replay",
    "time.time": "`time.time` inside captured code is read at capture",
    "time.perf_counter": "`time.perf_counter` inside captured code is read at capture",
    "time.monotonic": "`time.monotonic` inside captured code is read at capture",
}


def _dotted_module(rel: str) -> str:
    """The import path of a scanned module (``pkg/models/llama.py`` ->
    ``pkg.models.llama``)."""
    return rel.removesuffix(".py").replace("/", ".")


def graph_roots(ctx: Context) -> dict[str, set[str]]:
    """Module rel path -> names of the functions a CUDA graph captures."""
    roots: dict[str, set[str]] = {}
    by_name = {_dotted_module(m.rel): m for m in ctx.modules}
    registry = ctx.module(REGISTRY_SUFFIX)
    if registry is not None:
        for node in ast.walk(registry.tree):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if kw.arg not in FORWARD_FIELDS or not isinstance(kw.value, ast.Attribute):
                    continue
                mod = by_name.get(registry.dotted(kw.value.value))
                if mod is not None:
                    roots.setdefault(mod.rel, set()).add(kw.value.attr)
    capture = ctx.module(CAPTURE_SUFFIX)
    if capture is not None:
        for node in ast.walk(capture.tree):
            if not isinstance(node, ast.ImportFrom) or node.module is None:
                continue
            mod = by_name.get(node.module)
            if mod is not None and mod.rel.endswith(TAIL_SUFFIXES):
                roots.setdefault(mod.rel, set()).update(a.name for a in node.names)
    return roots


def _functions(mod: Module) -> dict[str, ast.AST]:
    functions: dict[str, ast.AST] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            functions.setdefault(node.name, node)
    return functions


def _reachable(functions: dict[str, ast.AST], roots: set[str]) -> set[str]:
    seen: set[str] = set()
    frontier = [r for r in roots if r in functions]
    while frontier:
        name = frontier.pop()
        if name in seen:
            continue
        seen.add(name)
        for sub in ast.walk(functions[name]):
            if isinstance(sub, ast.Call):
                callee: str | None = None
                if isinstance(sub.func, ast.Name):
                    callee = sub.func.id
                elif isinstance(sub.func, ast.Attribute) and isinstance(
                    sub.func.value, ast.Name
                ) and sub.func.value.id in ("self", "cls"):
                    callee = sub.func.attr
                if callee and callee in functions and callee not in seen:
                    frontier.append(callee)
    return seen


def run(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    by_rel = {m.rel: m for m in ctx.modules}
    for rel, roots in sorted(graph_roots(ctx).items()):
        mod = by_rel[rel]
        functions = _functions(mod)
        for name in sorted(_reachable(functions, roots)):
            node = functions[name]
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and sub is not node:
                    continue  # nested defs get their own entry if reachable
                if not isinstance(sub, ast.Call):
                    continue
                message: str | None = None
                if isinstance(sub.func, ast.Attribute) and sub.func.attr in HOST_SYNC_METHODS:
                    message = HOST_SYNC_METHODS[sub.func.attr]
                else:
                    dotted = mod.dotted(sub.func)
                    if dotted in HOST_SYNC_DOTTED:
                        message = HOST_SYNC_DOTTED[dotted]
                    elif dotted in CAPTURE_TIME_EFFECTS:
                        message = CAPTURE_TIME_EFFECTS[dotted]
                if message is not None:
                    findings.append(Finding(
                        GRAPH_PURITY, "host-sync", mod.rel, sub.lineno,
                        f"{message} (reachable from a CUDA graph root)",
                        context=name,
                    ))
    return findings
