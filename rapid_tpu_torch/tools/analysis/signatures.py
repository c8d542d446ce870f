"""Check family 2: call-signature conformance against imported runtime
modules.

For call sites whose callee statically resolves to a module-level object of
an imported module (``f(...)`` where ``f`` is module-global in the calling
module, or ``mod.f(...)`` where ``mod`` is a module-level module import),
bind the call's shape (positional arity + keyword names) against
``inspect.signature`` of the real runtime object. Catches wrong-arity
calls, typo'd keywords, and stale references to renamed module attributes —
the highest-value slice of what a type checker does for a dynamically-typed
codebase. Resolution is deliberately conservative: names shadowed in any
enclosing function scope, call sites using ``*args``/``**kwargs``, and
objects whose signature is undiscoverable are all skipped, so every finding
is a real defect, never a maybe.

Importing a module to inspect its runtime surface runs its import-time
code: the port's test modules import the JAX reference, which the
suite's conftest has pointed at the CPU under pytest (``JAX_PLATFORMS=cpu``
outside it).
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import inspect
import types
from pathlib import Path
from typing import List, Optional, Tuple

from . import core
from .core import Finding

#: Top-level packages a root may import that the port itself never needs:
#: the JAX reference its differential tests hold it against, and the
#: interop's optional wire stacks. A machine without one (the card
#: machine has no JAX, grpc or protobuf) cannot import the modules that
#: need it; they are skipped there, as pytest's importorskip would, and
#: analyzed wherever the package is installed.
OPTIONAL_IMPORTS = frozenset({"jax", "jaxlib", "grpc", "google", "hypothesis"})


def _optional_missing(exc: Exception) -> bool:
    """True when ``exc`` says an optional dependency is not installed: a
    missing :data:`OPTIONAL_IMPORTS` package, or the JAX reference package
    (``rapid_tpu``) failing to provide a name where JAX itself is not
    installed."""
    if not isinstance(exc, ImportError):
        return False
    root = (exc.name or "").split(".")[0]
    if isinstance(exc, ModuleNotFoundError) and root in OPTIONAL_IMPORTS:
        return True
    return root == "rapid_tpu" and importlib.util.find_spec("jax") is None


class _ScopeStack:
    """Tracks, per enclosing function/lambda/comprehension scope, the names
    bound locally — so a module-global resolution is only trusted when no
    enclosing scope shadows the name."""

    def __init__(self) -> None:
        self.stack: List[set] = []

    def shadowed(self, name: str) -> bool:
        return any(name in scope for scope in self.stack)


def _local_bindings(node: ast.AST) -> set:
    """Names bound in THIS function scope (params, assignments, imports,
    inner defs) — without descending into nested function scopes."""
    names = set()
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        a = node.args
        for arg in [*a.posonlyargs, *a.args, *a.kwonlyargs]:
            names.add(arg.arg)
        if a.vararg:
            names.add(a.vararg.arg)
        if a.kwarg:
            names.add(a.kwarg.arg)
    body = getattr(node, "body", [])
    stack = list(body) if isinstance(body, list) else []
    while stack:
        cur = stack.pop()
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(cur.name)
            continue  # nested scope: its internals don't bind here
        if isinstance(cur, ast.Lambda):
            continue
        if isinstance(cur, ast.Name) and isinstance(cur.ctx, (ast.Store, ast.Del)):
            names.add(cur.id)
        # Bindings whose target is a plain str, not a Name node:
        if isinstance(cur, ast.ExceptHandler) and cur.name:
            names.add(cur.name)
        if isinstance(cur, (ast.MatchAs, ast.MatchStar)) and cur.name:
            names.add(cur.name)
        if isinstance(cur, ast.MatchMapping) and cur.rest:
            names.add(cur.rest)
        if isinstance(cur, (ast.Import, ast.ImportFrom)):
            for alias in cur.names:
                if alias.name != "*":
                    names.add(alias.asname or alias.name.split(".")[0])
        if isinstance(cur, (ast.Global, ast.Nonlocal)):
            # Declared non-local: reads go to the outer binding — but for
            # shadow-tracking, treating as local only SKIPS checks (safe).
            names.update(cur.names)
        stack.extend(ast.iter_child_nodes(cur))
    return names


def _module_name_for(path: Path) -> Optional[str]:
    """Import path for a repo file, or None if it isn't importable as a
    module of this repo. A file in a regular package imports by its dotted
    path from the repo root; a file in a directory that is not one
    (``tests/``, which ``run()`` puts on ``sys.path``; the repo root's
    scripts) imports by its bare name, as pytest imports a test module. A
    dotted ``tests.<name>`` would also be shadowed by any installed
    distribution that ships a top-level ``tests`` package."""
    try:
        path.resolve().relative_to(core.REPO)
    except ValueError:
        return None
    resolved = path.resolve()
    parts = [] if resolved.stem == "__init__" else [resolved.stem]
    directory = resolved.parent
    while directory != core.REPO and (directory / "__init__.py").exists():
        parts.insert(0, directory.name)
        directory = directory.parent
    return ".".join(parts) if parts else None


def _bindable(sig: inspect.Signature) -> bool:
    """Signatures with *args/**kwargs accept almost anything; checking them
    would only ever produce noise."""
    return not any(
        p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        for p in sig.parameters.values()
    )


def _try_signature(obj) -> Optional[inspect.Signature]:
    try:
        return inspect.signature(obj)
    except (ValueError, TypeError):
        return None


def _check_one_call(
    call: ast.Call, obj, dotted: str, rel: str, findings: List[Finding]
) -> None:
    if any(isinstance(a, ast.Starred) for a in call.args):
        return
    if any(kw.arg is None for kw in call.keywords):  # **kwargs at site
        return
    sig = _try_signature(obj)
    if sig is None or not _bindable(sig):
        return
    # Bound methods/classmethods accessed via instance aren't resolved here
    # (module-level objects only), so no self-adjustment is needed.
    placeholders = [object()] * len(call.args)
    kwargs = {kw.arg: object() for kw in call.keywords}
    try:
        sig.bind(*placeholders, **kwargs)
    except TypeError as exc:
        findings.append(
            Finding(rel, call.lineno, "call-signature",
                    f"{dotted}{sig} cannot bind this call: {exc}")
        )


def check_call_signatures(
    path: Path,
    source: Optional[str] = None,
    tree: "Optional[ast.AST]" = None,
) -> List[Finding]:
    """Arity/keyword conformance for statically-resolvable call sites, plus
    existence of ``mod.attr`` references on module-level module imports."""
    src = source if source is not None else path.read_text()
    rel = core.rel(path)
    if tree is None:
        tree = ast.parse(src, filename=str(path))
    mod_name = _module_name_for(path)
    if mod_name is None:
        return []
    try:
        module = importlib.import_module(mod_name)
    except BaseException as exc:  # noqa: BLE001 — any import failure is a finding
        # BaseException, not Exception: pytest.importorskip raises Skipped,
        # which subclasses BaseException so that test code can't swallow it
        # by accident — but here it must not propagate and skip/abort the
        # whole gate.
        if type(exc).__name__ == "Skipped":
            # Module-level importorskip: the module declares an optional
            # dependency this environment lacks (e.g. hypothesis).
            # Un-analyzable here, not broken — pytest skips it the same way.
            return []
        if not isinstance(exc, Exception):
            raise  # KeyboardInterrupt / SystemExit stay fatal
        if _optional_missing(exc):
            # A test module whose differential needs the JAX reference (or
            # the interop's grpc/protobuf) on a machine without it: the
            # same un-analyzable-here case as an importorskip.
            return []
        return [Finding(rel, 1, "import-error", f"cannot import {mod_name}: {exc}")]

    findings: List[Finding] = []
    scopes = _ScopeStack()

    def resolve(expr: ast.AST) -> Tuple[Optional[object], Optional[str]]:
        """(object, dotted-name) for Name / module-attribute chains bound at
        module level and unshadowed; (None, None) when not resolvable."""
        if isinstance(expr, ast.Name) and isinstance(expr.ctx, ast.Load):
            if scopes.shadowed(expr.id):
                return None, None
            if expr.id in vars(module):
                return vars(module)[expr.id], expr.id
            return None, None
        if isinstance(expr, ast.Attribute) and isinstance(expr.ctx, ast.Load):
            base, dotted = resolve(expr.value)
            if not isinstance(base, types.ModuleType):
                return None, None  # instance attrs are dynamic; modules aren't
            if getattr(base, "__getattr__", None) is not None:
                return None, None  # module-level __getattr__: unknowable
            if not hasattr(base, expr.attr):
                findings.append(
                    Finding(rel, expr.lineno, "missing-attribute",
                            f"module {dotted!r} has no attribute {expr.attr!r}")
                )
                return None, None
            return getattr(base, expr.attr), f"{dotted}.{expr.attr}"
        return None, None

    def visit(node: ast.AST) -> None:
        is_scope = isinstance(
            node,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef,
             ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp),
        )
        if is_scope:
            if isinstance(
                node,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef),
            ):
                # Class bodies execute like function bodies: a name bound
                # earlier in the body shadows the module level for later
                # body-level references. (For functions NESTED in the class
                # the class scope is not on the lookup chain, so treating it
                # as shadowing there only skips a check — never misjudges.)
                scopes.stack.append(_local_bindings(node))
            else:
                targets = set()
                for gen in node.generators:
                    for n in ast.walk(gen.target):
                        if isinstance(n, ast.Name):
                            targets.add(n.id)
                scopes.stack.append(targets)
        if isinstance(node, ast.Call):
            obj, dotted = resolve(node.func)
            if obj is not None:
                _check_one_call(node, obj, dotted, rel, findings)
        elif isinstance(node, ast.Attribute):
            resolve(node)  # existence check on bare module-attr reads
        for child in ast.iter_child_nodes(node):
            visit(child)
        if is_scope:
            scopes.stack.pop()

    visit(tree)
    # Attribute chains nest (resolve recurses), so the same missing
    # attribute can be recorded through both the Call and Attribute hooks.
    return sorted(set(findings), key=lambda f: (f.lineno, f.message))
