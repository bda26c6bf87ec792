"""async-hygiene pass: blocking calls in coroutines, unawaited coroutines,
and fire-and-forget task spawns with no exception surface (counterpart of
dynamo_tpu/analysis/async_hygiene.py).

Fire-and-forget is the rule that found the real bugs this framework was
built for: a raw ``asyncio.ensure_future``/``create_task`` whose Task handle
is neither consumed by an ``await``/``gather``/``wait`` nor given an
``add_done_callback`` swallows its exception until interpreter GC prints
"Task exception was never retrieved" — long after the background loop died.
The sanctioned spawn path is ``dynamo_tpu_torch/utils/tasks.py`` (``spawn_logged``
/ ``CriticalTaskGroup``), which is the one module this pass exempts.

Heuristics (tuned for this tree; module-wide, not flow-sensitive):

- a spawn whose value is discarded (bare expression statement) is always a
  finding;
- a spawn assigned to a name/attribute (or appended/collected into one) is a
  finding unless that token is *surfaced* somewhere in the module: awaited,
  passed through ``asyncio.gather``/``wait``/``wait_for``/``shield``, or
  given an ``add_done_callback``;
- a spawn consumed directly as an argument (``await gather(spawn(...))``) or
  returned is fine.
"""

from __future__ import annotations

import ast

from dynamo_tpu_torch.analysis.core import (
    ASYNC_HYGIENE,
    Context,
    Finding,
    Module,
    attach_parents,
    leaf_token,
    parent_of,
)

SANCTIONED_MODULES = ("utils/tasks.py",)

BLOCKING_CALLS = {
    "time.sleep": "time.sleep blocks the event loop; use asyncio.sleep",
    "os.system": "os.system blocks the event loop; use asyncio.create_subprocess_shell",
    "socket.create_connection": "sync socket I/O blocks the event loop; use asyncio.open_connection",
    "urllib.request.urlopen": "sync HTTP blocks the event loop; use an async client or to_thread",
}
for _fn in ("run", "call", "check_call", "check_output", "Popen", "getoutput",
            "getstatusoutput"):
    BLOCKING_CALLS[f"subprocess.{_fn}"] = (
        f"subprocess.{_fn} blocks the event loop; use asyncio.create_subprocess_exec"
    )
for _fn in ("get", "post", "put", "patch", "delete", "head", "request"):
    BLOCKING_CALLS[f"requests.{_fn}"] = (
        f"requests.{_fn} blocks the event loop; use an async client or to_thread"
    )

SPAWN_DOTTED = {"asyncio.ensure_future", "asyncio.create_task"}
LOOP_FACTORY_DOTTED = {"asyncio.get_event_loop()", "asyncio.get_running_loop()"}
LOOP_NAME_HINTS = {"loop", "_loop", "event_loop"}
GATHER_DOTTED = {"asyncio.gather", "asyncio.wait", "asyncio.wait_for", "asyncio.shield"}


def _is_spawn(mod: Module, call: ast.Call) -> bool:
    dotted = mod.dotted(call.func)
    if dotted in SPAWN_DOTTED:
        return True
    if isinstance(call.func, ast.Attribute) and call.func.attr == "create_task":
        base = mod.dotted(call.func.value)
        if base in LOOP_FACTORY_DOTTED:
            return True
        base_leaf = leaf_token(call.func.value)
        if base_leaf in LOOP_NAME_HINTS:
            return True
    return False


def _surfaced_tokens(mod: Module) -> set[str]:
    """Module-wide set of handle tokens that have an exception surface."""
    tokens: set[str] = set()

    def collect_names(node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Name, ast.Attribute, ast.Starred)):
                tok = leaf_token(sub)
                if tok:
                    tokens.add(tok)

    awaited_names: set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Await):
            inner = node.value
            if isinstance(inner, (ast.Name, ast.Attribute, ast.Subscript)):
                tok = leaf_token(inner)
                if tok:
                    tokens.add(tok)
                    awaited_names.add(tok)
            elif isinstance(inner, ast.Call):
                if mod.dotted(inner.func) in GATHER_DOTTED:
                    for arg in inner.args:
                        collect_names(arg)
        elif isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) and node.func.attr == "add_done_callback":
                tok = leaf_token(node.func.value)
                if tok:
                    tokens.add(tok)
    # `for t in tasks: await t` surfaces the *collection* token too
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            target_tok = leaf_token(node.target)
            if target_tok and target_tok in awaited_names:
                tok = leaf_token(node.iter)
                if tok:
                    tokens.add(tok)
    return tokens


def _spawn_sink(node: ast.Call) -> tuple[str, str | None]:
    """Classify how a spawn's Task handle is consumed.

    -> ("discarded", None) | ("token", token) | ("consumed", None)
    """
    child: ast.AST = node
    parent = parent_of(node)
    while parent is not None:
        if isinstance(parent, ast.Expr):
            return "discarded", None
        if isinstance(parent, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = parent.targets if isinstance(parent, ast.Assign) else [parent.target]
            for target in targets:
                tok = leaf_token(target)
                if tok:
                    return "token", tok
            return "consumed", None  # tuple-unpack etc: assume handled
        if isinstance(parent, ast.Call) and parent is not node:
            if child in parent.args or any(
                child is kw.value for kw in parent.keywords
            ) or any(
                isinstance(a, ast.Starred) and a.value is child for a in parent.args
            ):
                func = parent.func
                if isinstance(func, ast.Attribute) and func.attr in ("append", "add", "insert"):
                    tok = leaf_token(func.value)
                    if tok:
                        return "token", tok
                return "consumed", None
            # we were the .func of a chained call — keep climbing
        if isinstance(parent, (ast.Return, ast.Await, ast.Yield, ast.YieldFrom)):
            return "consumed", None
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module,
                               ast.ClassDef)):
            return "consumed", None
        child, parent = parent, parent_of(parent)
    return "consumed", None


class _FuncStack(ast.NodeVisitor):
    """Walk with an innermost-function-kind stack shared by the sub-rules."""

    def __init__(self, mod: Module, async_defs: set[str], surfaced: set[str],
                 findings: list[Finding]):
        self.mod = mod
        self.async_defs = async_defs
        self.surfaced = surfaced
        self.findings = findings
        self.stack: list[ast.AST] = []  # FunctionDef / AsyncFunctionDef

    # -- scope tracking
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.stack.append(node)
        self.generic_visit(node)
        self.stack.pop()

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self.stack.append(node)
        self.generic_visit(node)
        self.stack.pop()

    def _context(self) -> str:
        return ".".join(getattr(f, "name", "?") for f in self.stack)

    def _in_async(self) -> bool:
        return bool(self.stack) and isinstance(self.stack[-1], ast.AsyncFunctionDef)

    # -- rules
    def visit_Call(self, node: ast.Call) -> None:
        mod = self.mod
        dotted = mod.dotted(node.func)
        if self._in_async() and dotted in BLOCKING_CALLS:
            self.findings.append(Finding(
                ASYNC_HYGIENE, "blocking-call", mod.rel, node.lineno,
                BLOCKING_CALLS[dotted], context=self._context(),
            ))
        if _is_spawn(mod, node):
            sink, token = _spawn_sink(node)
            if sink == "discarded" or (sink == "token" and token not in self.surfaced):
                handle = "discarded" if sink == "discarded" else f"`{token}` is never awaited or given a done-callback"
                self.findings.append(Finding(
                    ASYNC_HYGIENE, "fire-and-forget", mod.rel, node.lineno,
                    f"task spawn with no exception surface ({handle}); "
                    "use utils.tasks.spawn_logged / CriticalTaskGroup",
                    context=self._context(),
                ))
        elif isinstance(parent_of(node), ast.Expr) and not node.keywords:
            # Bare statement calling a same-module coroutine function.  Only
            # `f(...)` and `self.f(...)`/`cls.f(...)` receivers: an arbitrary
            # `obj.close()` may be a *different* class's sync method that
            # happens to share a name with an async def here (StreamWriter
            # .close vs our async close), which we cannot resolve.
            name: str | None = None
            if isinstance(node.func, ast.Name):
                name = node.func.id
            elif (
                isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in ("self", "cls")
            ):
                name = node.func.attr
            if name in self.async_defs:
                self.findings.append(Finding(
                    ASYNC_HYGIENE, "unawaited-coroutine", mod.rel, node.lineno,
                    f"result of coroutine function `{name}` is discarded "
                    "without await — the body never runs",
                    context=self._context(),
                ))
        self.generic_visit(node)


def run(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    for mod in ctx.modules:
        if mod.rel.endswith(SANCTIONED_MODULES):
            continue
        attach_parents(mod.tree)
        async_defs = {
            n.name for n in ast.walk(mod.tree) if isinstance(n, ast.AsyncFunctionDef)
        }
        # a same-named sync def anywhere in the module makes the name ambiguous
        sync_defs = {
            n.name for n in ast.walk(mod.tree) if isinstance(n, ast.FunctionDef)
        }
        surfaced = _surfaced_tokens(mod)
        _FuncStack(mod, async_defs - sync_defs, surfaced, findings).visit(mod.tree)
    return findings
