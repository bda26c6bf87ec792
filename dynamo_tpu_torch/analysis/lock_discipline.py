"""lock-discipline pass: threading locks held across ``await``, and asyncio
primitives touched from executor threads (counterpart of
dynamo_tpu/analysis/lock_discipline.py).

Two ways this codebase can deadlock or corrupt state that no unit test
reliably reproduces:

- ``with self._lock:`` (a ``threading.Lock``) around an ``await`` parks the
  OS lock while the event loop runs arbitrary other tasks — any of which may
  try to take the same lock from the same thread and deadlock, or from the
  engine thread and stall the device loop;
- a function handed to ``run_in_executor``/``asyncio.to_thread`` runs OFF
  the event-loop thread, where calling asyncio APIs (other than
  ``run_coroutine_threadsafe``/``call_soon_threadsafe``) races loop
  internals.

Detection is token-based: lock identity is the assigned attribute/name of a
``threading.Lock()``-family constructor anywhere in the module.
"""

from __future__ import annotations

import ast

from dynamo_tpu_torch.analysis.core import (
    LOCK_DISCIPLINE,
    Context,
    Finding,
    Module,
    leaf_token,
)

LOCK_CONSTRUCTORS = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
}

THREADSAFE_ALLOWED = {
    "asyncio.run_coroutine_threadsafe",
    # reading loop handles / time is fine off-thread
    "asyncio.get_event_loop",
}


def _lock_tokens(mod: Module) -> set[str]:
    tokens: set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if mod.dotted(node.value.func) in LOCK_CONSTRUCTORS:
                for target in node.targets:
                    tok = leaf_token(target)
                    if tok:
                        tokens.add(tok)
    return tokens


def _contains_await(body: list[ast.stmt]) -> ast.Await | None:
    """First Await in these statements, not descending into nested defs."""
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(node, ast.Await):
                return node
    return None


def _check_lock_across_await(mod: Module, findings: list[Finding]) -> None:
    locks = _lock_tokens(mod)
    if not locks:
        return

    class Visitor(ast.NodeVisitor):
        def __init__(self) -> None:
            self.async_stack: list[str] = []

        def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
            self.async_stack.append(node.name)
            self.generic_visit(node)
            self.async_stack.pop()

        def visit_With(self, node: ast.With) -> None:
            if self.async_stack:
                for item in node.items:
                    tok = leaf_token(item.context_expr)
                    if tok in locks:
                        awaited = _contains_await(node.body)
                        if awaited is not None:
                            findings.append(Finding(
                                LOCK_DISCIPLINE, "lock-across-await", mod.rel,
                                awaited.lineno,
                                f"threading lock `{tok}` (taken at line "
                                f"{node.lineno}) is held across an await — "
                                "the event loop runs other tasks while the OS "
                                "lock is parked; use asyncio.Lock or drop the "
                                "lock before awaiting",
                                context=".".join(self.async_stack),
                            ))
            self.generic_visit(node)

    Visitor().visit(mod.tree)


def _executor_targets(mod: Module) -> set[str]:
    """Names of functions handed to run_in_executor / asyncio.to_thread."""
    targets: set[str] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        picked: ast.AST | None = None
        if isinstance(func, ast.Attribute) and func.attr == "run_in_executor":
            if len(node.args) >= 2:
                picked = node.args[1]
        elif mod.dotted(func) == "asyncio.to_thread" and node.args:
            picked = node.args[0]
        if picked is not None:
            tok = leaf_token(picked)
            if tok:
                targets.add(tok)
    return targets


def _check_asyncio_from_thread(mod: Module, findings: list[Finding]) -> None:
    targets = _executor_targets(mod)
    if not targets:
        return
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.FunctionDef) and node.name in targets:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    dotted = mod.dotted(sub.func)
                    if (
                        dotted is not None
                        and dotted.startswith("asyncio.")
                        and dotted not in THREADSAFE_ALLOWED
                    ):
                        findings.append(Finding(
                            LOCK_DISCIPLINE, "asyncio-from-thread", mod.rel,
                            sub.lineno,
                            f"`{dotted}` called inside `{node.name}`, which "
                            "runs on an executor thread — asyncio objects are "
                            "not thread-safe; marshal through "
                            "run_coroutine_threadsafe/call_soon_threadsafe",
                            context=node.name,
                        ))
    return


def run(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    for mod in ctx.modules:
        _check_lock_across_await(mod, findings)
        _check_asyncio_from_thread(mod, findings)
    return findings
