"""Check family 4: dead module-level definitions (tree-wide liveness)."""

from __future__ import annotations

import ast
import re
from typing import List, Tuple

from .core import Finding

_DEF_ALLOW_PREFIXES = ("test_", "Test", "pytest_", "__")
_DEF_ALLOW_NAMES = {"main", "entry", "dryrun_multichip"}  # external entry points
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def _collect_definitions(tree: ast.AST, rel: str):
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            yield node.name, rel, node.lineno
        # Simple module constants too (plain Name targets only: tuple
        # unpacking legitimately discards elements, so it is out of scope;
        # dunders like __all__ fall to the allowlist).
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    yield target.id, rel, node.lineno
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            yield node.target.id, rel, node.lineno


def _collect_references(tree: ast.AST) -> set:
    """Every way a module-level definition can be consumed: name loads,
    attribute accesses, function parameter names (pytest fixtures are used
    by naming them as parameters), ``getattr``/``setattr``/``hasattr``/
    ``delattr`` with a literal field name (dynamic lane access is still
    access — the dataflow family's dead-lane check and this one must
    never disagree on liveness), identifiers inside f-string fragments
    (a lane named in a debug label is consumed by whoever reads the
    label), and identifiers inside CODE-LOOKING string constants
    (multi-line or call-shaped — subprocess job scripts, ``python -c``
    payloads). Other single-word strings deliberately do NOT count: an
    ``__all__`` entry must not keep an otherwise-unreferenced export
    alive — re-export padding is exactly what this check exists to catch.

    A module-level definition's OWN subtree never contributes its own name:
    a dead recursive helper, a class naming itself in a method, or a
    constant whose initializer/mutation mentions itself must not keep
    itself alive.
    """

    def walk(node, self_name):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if node.id != self_name:
                refs.add(node.id)
        elif isinstance(node, ast.Attribute):
            if node.attr != self_name:
                refs.add(node.attr)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            a = node.args
            for arg in [*a.posonlyargs, *a.args, *a.kwonlyargs]:
                refs.add(arg.arg)
        elif isinstance(node, ast.Call):
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in ("getattr", "setattr", "hasattr", "delattr")
                and len(node.args) >= 2
                and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, str)
                and node.args[1].value != self_name
            ):
                refs.add(node.args[1].value)
        elif isinstance(node, ast.JoinedStr):
            for frag in node.values:
                if isinstance(frag, ast.Constant) and isinstance(frag.value, str):
                    refs.update(
                        w for w in _IDENT.findall(frag.value) if w != self_name
                    )
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if "\n" in node.value or "(" in node.value:
                refs.update(w for w in _IDENT.findall(node.value) if w != self_name)
        for child in ast.iter_child_nodes(node):
            walk(child, self_name)

    refs: set = set()
    for stmt in getattr(tree, "body", []):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            for child in ast.iter_child_nodes(stmt):
                walk(child, stmt.name)
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and isinstance(
            stmt.targets[0], ast.Name
        ):
            walk(stmt.value, stmt.targets[0].id)
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            walk(stmt.annotation, None)  # the type names ARE references
            if stmt.value is not None:
                walk(stmt.value, stmt.target.id)
        else:
            walk(stmt, None)
    return refs


def check_dead_definitions(
    contributions: "List[Tuple[ast.AST, str]]",
) -> List[Finding]:
    """Module-level functions/classes/constants referenced NOWHERE in the tree.

    Takes (tree, relpath) pairs for the WHOLE analyzed tree — liveness is
    only meaningful over the full root set, so run() skips this check when
    the CLI narrows the roots. Tree-wide, name-based (not resolution-based):
    a name collision anywhere keeps a definition alive, so every finding is
    a definition no file could be using. The repo's standard is that
    unconsumed code is deleted, not exported (the Mosaic watermark kernel
    precedent)."""
    defs: List[Tuple[str, str, int]] = []
    refs: set = set()
    for tree, rel in contributions:
        defs.extend(_collect_definitions(tree, rel))
        refs |= _collect_references(tree)
    findings = []
    for name, rel, lineno in defs:
        if name.startswith(_DEF_ALLOW_PREFIXES) or name in _DEF_ALLOW_NAMES:
            continue
        if name not in refs:
            findings.append(
                Finding(rel, lineno, "dead-definition",
                        f"module-level {name!r} is referenced nowhere in the tree")
            )
    return findings
