"""Check family 1: undefined names (symtable scope resolution).

Compiler-grade scope analysis via ``symtable``: every name a scope reads
through the global scope must be bound at module level (import/assign/def/
class), declared ``global`` and assigned in some function, or a builtin.
Catches typos in rarely-executed paths (the error branch that NameErrors
only when the error happens), which no test-coverage gate can promise to
reach.
"""

from __future__ import annotations

import ast
import builtins
import symtable
from pathlib import Path
from typing import List, Optional

from . import core
from .core import Finding

# Module-scope dunders the compiler binds implicitly.
_IMPLICIT_GLOBALS = {
    "__name__", "__file__", "__doc__", "__package__", "__spec__",
    "__loader__", "__builtins__", "__debug__", "__annotations__",
    "__path__", "__dict__", "__class__",
}


def _global_assigned_names(table: symtable.SymbolTable) -> set:
    """Names any nested scope both declares ``global`` and assigns — those
    are module-bound at runtime even if never assigned at module scope."""
    names = set()
    for sym in table.get_symbols():
        if sym.is_global() and sym.is_assigned():
            names.add(sym.get_name())
    for child in table.get_children():
        names |= _global_assigned_names(child)
    return names


def _undefined_in_table(
    table: symtable.SymbolTable,
    bound: set,
    rel: str,
    load_lines: dict,
    findings: List[Finding],
) -> None:
    for sym in table.get_symbols():
        if not (sym.is_global() and sym.is_referenced()):
            continue
        name = sym.get_name()
        if name in bound or hasattr(builtins, name) or name in _IMPLICIT_GLOBALS:
            continue
        # Point at the offending READ, not the enclosing def: the first
        # load site at or after the scope's start line (falling back to the
        # first in the file — scope start is a lower bound, good enough to
        # land inside the right function).
        scope_start = table.get_lineno()
        lines = load_lines.get(name, [])
        lineno = next((ln for ln in lines if ln >= scope_start),
                      lines[0] if lines else scope_start)
        findings.append(
            Finding(
                rel,
                lineno,
                "undefined-name",
                f"{name!r} (read in {table.get_type()} "
                f"{table.get_name()!r}) is bound nowhere at module scope "
                "and is not a builtin",
            )
        )
    for child in table.get_children():
        _undefined_in_table(child, bound, rel, load_lines, findings)


def check_undefined_names(
    path: Path,
    source: Optional[str] = None,
    tree: "Optional[ast.AST]" = None,
) -> List[Finding]:
    """Every name resolving through the global scope must exist there."""
    src = source if source is not None else path.read_text()
    rel = core.rel(path)
    if tree is None:
        tree = ast.parse(src, filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and any(
            a.name == "*" for a in node.names
        ):
            # A star import makes the global namespace statically unknowable;
            # flag the import itself rather than silently skipping the file.
            return [
                Finding(rel, node.lineno, "star-import",
                        "wildcard import defeats scope analysis")
            ]
    table = symtable.symtable(src, str(path), "exec")
    bound = {s.get_name() for s in table.get_symbols() if s.is_local()}
    bound |= _global_assigned_names(table)
    load_lines: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            load_lines.setdefault(node.id, []).append(node.lineno)
    for lines in load_lines.values():
        lines.sort()
    findings: List[Finding] = []
    _undefined_in_table(table, bound, rel, load_lines, findings)
    return findings
