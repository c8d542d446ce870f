"""Check family 9: async failure-path hygiene over the library.

The membership protocol's stability claim lives or dies in its failure
paths: a swallowed exception or a dropped background task turns a crash
(restartable, alertable) into a silent wedge — exactly the failure mode
the reconfiguration literature identifies as the hard part. These checks
cover the four ways an asyncio codebase loses an error, over all of
``rapid_tpu_torch/``:

- ``leaked-task`` — ``asyncio.create_task(...)`` / ``ensure_future(...)``
  whose result is discarded as an expression statement: nothing retains
  the task (the loop holds it weakly — it can be garbage-collected
  mid-flight) and nothing observes its exception. Retain it, add it to a
  tracked set with a done-callback, or chain ``.add_done_callback``.
- ``swallowed-exception`` — ``except Exception:`` / ``except
  BaseException:`` / bare ``except:`` that neither re-raises nor carries
  a ``# noqa: BLE001 — <reason>`` justification on the ``except`` line.
  A broad catch is sometimes right (fault-isolation boundaries, app
  callbacks); it is never right silently.
- ``cancellation-swallow`` — a handler inside ``async def`` that catches
  ``asyncio.CancelledError`` (explicitly, via ``BaseException``, or via
  bare ``except``) without a ``raise`` in its body: the task absorbs its
  own cancellation and ``shutdown()`` hangs on the gather. (Plain
  ``except Exception`` is safe here — ``CancelledError`` derives from
  ``BaseException`` since Python 3.8 — which is why the broad catches in
  the liveness loops are legal once justified.)
- ``unawaited-coroutine`` — a call whose target resolves to an ``async
  def`` in the same module/class, discarded as an expression statement:
  the coroutine object is built and dropped, the body never runs.

Escape hatch: ``# taskflow-ok: <reason>`` on the offending line
allowlists any of the four (``swallowed-exception`` also honors the
conventional ``# noqa: BLE001``). Resolution is conservative: only
targets provable from the same file are judged.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set

from . import core
from .core import Finding

#: The tree this discipline applies to (posix-style relative prefixes).
TASKFLOW_PREFIXES = ("rapid_tpu_torch/",)

_SPAWN_NAMES = frozenset({"create_task", "ensure_future"})
_BROAD_EXC_NAMES = frozenset({"Exception", "BaseException"})
_CANCEL_EXC_NAMES = frozenset({"BaseException", "CancelledError"})

_ALLOW_RE = re.compile(r"#\s*taskflow-ok\b")
_NOQA_BLE_RE = re.compile(r"#\s*noqa:\s*BLE001\b")


def _exc_names(node: Optional[ast.AST]) -> Optional[Set[str]]:
    """The exception-class names a handler's ``type`` clause mentions, or
    None for a bare ``except:`` (which catches everything)."""
    if node is None:
        return None
    names: Set[str] = set()
    elts = node.elts if isinstance(node, ast.Tuple) else [node]
    for elt in elts:
        if isinstance(elt, ast.Name):
            names.add(elt.id)
        elif isinstance(elt, ast.Attribute):
            names.add(elt.attr)
    return names


def _has_raise(stmts: List[ast.stmt]) -> bool:
    """A ``raise`` anywhere in these statements' own function scope."""

    def walk(node: ast.AST) -> bool:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return False
        if isinstance(node, ast.Raise):
            return True
        return any(walk(child) for child in ast.iter_child_nodes(node))

    return any(walk(stmt) for stmt in stmts)


def _is_spawn_call(call: ast.Call) -> bool:
    func = call.func
    if isinstance(func, ast.Name):
        return func.id in _SPAWN_NAMES
    return isinstance(func, ast.Attribute) and func.attr in _SPAWN_NAMES


class _AsyncIndex:
    """Same-file resolution targets: module-level async defs and per-class
    async methods."""

    def __init__(self, tree: ast.AST) -> None:
        self.module_async: Set[str] = {
            node.name
            for node in getattr(tree, "body", [])
            if isinstance(node, ast.AsyncFunctionDef)
        }
        self.class_async: Dict[str, Set[str]] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self.class_async[node.name] = {
                    item.name
                    for item in node.body
                    if isinstance(item, ast.AsyncFunctionDef)
                }


def check_taskflow(
    path: Path,
    source: Optional[str] = None,
    tree: "Optional[ast.AST]" = None,
) -> List[Finding]:
    rel = core.rel(path)
    posix = rel.replace("\\", "/")
    if not any(posix.startswith(p) for p in TASKFLOW_PREFIXES):
        return []
    src = source if source is not None else path.read_text()
    if tree is None:
        tree = ast.parse(src, filename=str(path))
    lines = src.splitlines()

    def allowed(lineno: int, extra: Optional[re.Pattern] = None) -> bool:
        line = lines[lineno - 1] if 0 < lineno <= len(lines) else ""
        if _ALLOW_RE.search(line):
            return True
        return bool(extra and extra.search(line))

    index = _AsyncIndex(tree)
    findings: List[Finding] = []

    def visit(node: ast.AST, in_async: bool, cls: Optional[str]) -> None:
        if isinstance(node, ast.ClassDef):
            for child in node.body:
                visit(child, in_async, node.name)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            child_async = isinstance(node, ast.AsyncFunctionDef)
            for child in node.body:
                visit(child, child_async, cls)
            return
        if isinstance(node, ast.Lambda):
            return

        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
            if _is_spawn_call(call):
                if not allowed(node.lineno):
                    findings.append(Finding(
                        rel, node.lineno, "leaked-task",
                        "fire-and-forget task: the result of "
                        f"{ast.unparse(call.func)}(...) is neither retained, "
                        "tracked in a set, nor given a done-callback — the "
                        "loop holds tasks weakly and its exception is never "
                        "observed",
                    ))
            else:
                target = None
                func = call.func
                if (
                    isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Name)
                    and func.value.id == "self"
                    and cls is not None
                    and func.attr in index.class_async.get(cls, ())
                ):
                    target = f"self.{func.attr}"
                elif isinstance(func, ast.Name) and func.id in index.module_async:
                    target = func.id
                if target is not None and not allowed(node.lineno):
                    findings.append(Finding(
                        rel, node.lineno, "unawaited-coroutine",
                        f"{target}(...) is an async def but its coroutine is "
                        "discarded as a statement — the body never runs; "
                        "await it or schedule it as a tracked task",
                    ))

        if isinstance(node, ast.ExceptHandler):
            names = _exc_names(node.type)
            broad = names is None or bool(names & _BROAD_EXC_NAMES)
            catches_cancel = names is None or bool(names & _CANCEL_EXC_NAMES)
            reraises = _has_raise(node.body)
            if broad and not reraises and not allowed(node.lineno, _NOQA_BLE_RE):
                caught = "bare except" if names is None else ", ".join(sorted(names))
                findings.append(Finding(
                    rel, node.lineno, "swallowed-exception",
                    f"broad catch ({caught}) neither re-raises nor carries a "
                    "`# noqa: BLE001 — <reason>` justification — a silent "
                    "failure path turns crashes into wedges",
                ))
            if in_async and catches_cancel and not reraises and not allowed(node.lineno):
                caught = "bare except" if names is None else ", ".join(
                    sorted(names & _CANCEL_EXC_NAMES) or sorted(names)
                )
                findings.append(Finding(
                    rel, node.lineno, "cancellation-swallow",
                    f"handler ({caught}) inside async def absorbs "
                    "asyncio.CancelledError without re-raising — the task "
                    "survives its own cancellation and shutdown hangs on it",
                ))

        for child in ast.iter_child_nodes(node):
            visit(child, in_async, cls)

    for stmt in getattr(tree, "body", []):
        visit(stmt, False, None)
    return findings
