"""Check family 11: run-ledger vocabulary discipline.

The bench run ledger (rapid_tpu_torch/utils/ledger.py) is only renderable because
its event names come from the registered ``LedgerEvent`` enum and its stage
names from the ``STAGE_NAMES`` registry — the exact discipline the flight
recorder's ``EventName`` rule enforces in tests/test_lint.py. A free-form
string would silently fork the vocabulary: perfview's stage timeline and the
watchdog's per-stage budgets would stop seeing the event.

Two checks, applied only to files that import ``rapid_tpu_torch.utils.ledger``
(so unrelated ``.emit()``/``.stage()`` methods elsewhere are never touched):

- ``ledger-event-name``: every ``*.emit(...)`` call names its event as
  ``LedgerEvent.<registered member>`` (or forwards an already-checked
  ``event`` parameter);
- ``ledger-stage-name``: every ``*.stage(...)`` call's name is a string
  literal found in ``STAGE_NAMES`` (parameterize stages via fields like
  ``n=``, never by minting names at runtime).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional

from . import core
from .core import Finding

#: Trees the discipline applies to (the ledger's writers live here).
LEDGER_PREFIXES = ("rapid_tpu_torch/", "chip_smoke.py", "mesh_smoke.py")


def _imports_ledger(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module and node.module.endswith("utils.ledger"):
                return True
        elif isinstance(node, ast.Import):
            if any(a.name.endswith("utils.ledger") for a in node.names):
                return True
    return False


def check_ledger(
    path: Path,
    source: Optional[str] = None,
    tree: "Optional[ast.AST]" = None,
) -> List[Finding]:
    rel = core.rel(path)
    posix = rel.replace("\\", "/")
    if not any(posix.startswith(p) for p in LEDGER_PREFIXES):
        return []
    src = source if source is not None else path.read_text()
    if tree is None:
        tree = ast.parse(src, filename=str(path))
    # In scope: importers of the ledger module, and the module itself (its
    # own internal emit calls follow the same discipline).
    if not (_imports_ledger(tree) or posix == "rapid_tpu_torch/utils/ledger.py"):
        return []

    # The registered vocabularies come from the runtime module itself (the
    # same never-drift rule as test_lint's EventName import).
    from rapid_tpu_torch.utils.ledger import STAGE_NAMES, LedgerEvent

    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr == "emit":
            arg = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "event"), None
            )
            ok = (
                isinstance(arg, ast.Attribute)
                and isinstance(arg.value, ast.Name)
                and arg.value.id == "LedgerEvent"
                and arg.attr in LedgerEvent.__members__
            )
            # Forwarding an already-validated parameter (a helper whose own
            # caller is checked) is fine — mirror of the recorder rule.
            forwards = isinstance(arg, ast.Name) and arg.id == "event"
            if not (ok or forwards):
                findings.append(Finding(
                    rel, node.lineno, "ledger-event-name",
                    "ledger emit() event must be a LedgerEvent member "
                    "(registered vocabulary; free-form names break perfview)",
                ))
        elif node.func.attr == "stage":
            arg = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "name"), None
            )
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                if arg.value not in STAGE_NAMES:
                    findings.append(Finding(
                        rel, node.lineno, "ledger-stage-name",
                        f"stage {arg.value!r} is not in the registered "
                        "STAGE_NAMES vocabulary (rapid_tpu_torch/utils/ledger.py)",
                    ))
            else:
                findings.append(Finding(
                    rel, node.lineno, "ledger-stage-name",
                    "ledger stage() name must be a string literal from "
                    "STAGE_NAMES (parameterize via fields, not the name)",
                ))
    return findings
