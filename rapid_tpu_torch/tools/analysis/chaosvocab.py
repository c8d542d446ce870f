"""Check family 14: chaos vocabulary discipline.

The chaos subsystem indexes on ONE closed vocabulary three ways: fault
event kinds (``rapid_tpu_torch/sim/faults.py`` ``ALL_KINDS``), scenario family
names (``rapid_tpu_torch/sim/fuzz.py`` ``FAMILIES``), and the CLI surface
(``tools/chaosrun.py`` ``run <family>`` choices, plus the tenancy fleet's
``ENGINE_FAMILIES``/``HIER_FAMILIES`` mix tables). A string that drifts in
any one of them used to fail at the worst possible moment — mid-scenario,
inside a fuzz round, as a raw KeyError. ``FaultEvent.__post_init__`` now
raises at construction (the runtime half, pinned in test_sim_faults); this
family is the static half:

- ``chaos-unknown-kind`` — a ``FaultEvent("<literal>", ...)`` construction
  whose kind is not in the registered ``ALL_KINDS``. Deliberate negative
  fixtures carry ``# chaos-kind-ok: <reason>`` on the line.
- ``chaos-family-drift`` — the registries disagree: a ``FAMILIES`` table
  key that does not match the generator function it maps to (the (name,
  function) pair is the replay contract — repro files and CLI args carry
  the KEY); an ``ENGINE_FAMILIES``/``HIER_FAMILIES``/``FLEET_FAMILIES``
  entry naming a family the fuzz registry does not export; or a
  ``chaosrun`` family argument whose ``choices=`` is not wired to the
  ``FAMILIES`` registry itself (a re-typed list would drift silently).

Applied only to files that touch the chaos surface (import
``rapid_tpu_torch.sim.faults``/``fuzz``, or define one of the tables), so
unrelated ``FaultEvent`` classes elsewhere are never touched. The kind and
family vocabularies come from the runtime modules themselves — the same
never-drift rule as the ledger family's ``STAGE_NAMES`` import.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import List, Optional

from . import core
from .core import Finding

#: Deliberate unknown-kind fixtures (e.g. the construction-raises pin in
#: test_sim_faults.py) opt out per line, reason required by convention.
_KIND_OK_RE = re.compile(r"#\s*chaos-kind-ok\b")

#: Trees the discipline applies to (chaos schedules are minted here).
_CHAOS_PREFIXES = (
    "rapid_tpu_torch/", "tests/test_torch_", "chip_smoke.py", "mesh_smoke.py",
)

#: Family-mix tables whose entries must exist in the fuzz registry.
_MIX_TABLES = ("ENGINE_FAMILIES", "HIER_FAMILIES", "FLEET_FAMILIES")


def _imports_chaos(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module and (
                node.module.endswith("sim.faults")
                or node.module.endswith("sim.fuzz")
                or node.module.endswith("sim")
            ):
                return True
        elif isinstance(node, ast.Import):
            if any(
                a.name.endswith("sim.faults") or a.name.endswith("sim.fuzz")
                for a in node.names
            ):
                return True
    return False


def _callee_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _kind_literal(node: ast.Call) -> Optional[ast.Constant]:
    arg = node.args[0] if node.args else next(
        (kw.value for kw in node.keywords if kw.arg == "kind"), None
    )
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg
    return None


def _check_event_kinds(
    rel: str, src_lines: List[str], tree: ast.AST
) -> List[Finding]:
    from rapid_tpu_torch.sim.faults import ALL_KINDS

    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and _callee_name(node.func) == "FaultEvent"
        ):
            continue
        arg = _kind_literal(node)
        if arg is None or arg.value in ALL_KINDS:
            continue
        line = (
            src_lines[node.lineno - 1] if node.lineno <= len(src_lines) else ""
        )
        if _KIND_OK_RE.search(line):
            continue
        findings.append(Finding(
            rel, node.lineno, "chaos-unknown-kind",
            f"FaultEvent kind {arg.value!r} is not in the registered "
            "vocabulary (rapid_tpu_torch/sim/faults.py ALL_KINDS); construction "
            "will raise ScheduleError at runtime",
        ))
    return findings


def _check_families_table(rel: str, tree: ast.AST) -> List[Finding]:
    """The ``FAMILIES = {"name": function, ...}`` registry: every key must
    match its generator function's name — the key is what repro files,
    ``chaosrun run``, and the fleet mix tables carry, and a renamed
    generator left under a stale key replays a DIFFERENT scenario than the
    name says."""
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if "FAMILIES" in targets and isinstance(node.value, ast.Dict):
            for key, value in zip(node.value.keys, node.value.values):
                if not (
                    isinstance(key, ast.Constant) and isinstance(key.value, str)
                ):
                    findings.append(Finding(
                        rel, node.lineno, "chaos-family-drift",
                        "FAMILIES keys must be string literals (the "
                        "replayable scenario vocabulary)",
                    ))
                    continue
                fn = value.id if isinstance(value, ast.Name) else None
                if fn is not None and fn != key.value:
                    findings.append(Finding(
                        rel, key.lineno, "chaos-family-drift",
                        f"FAMILIES key {key.value!r} maps to function "
                        f"{fn!r}; the key IS the replay contract — rename "
                        "one to match the other",
                    ))
        for table in set(targets) & set(_MIX_TABLES):
            entries = None
            if isinstance(node.value, (ast.Tuple, ast.List)):
                entries = node.value.elts
            if entries is None:
                continue
            from rapid_tpu_torch.sim.fuzz import FAMILIES as _RUNTIME_FAMILIES

            for elt in entries:
                if (
                    isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)
                    and elt.value not in _RUNTIME_FAMILIES
                ):
                    findings.append(Finding(
                        rel, elt.lineno, "chaos-family-drift",
                        f"{table} entry {elt.value!r} is not a registered "
                        "sim/fuzz.py family; the fleet compiler would "
                        "KeyError on it",
                    ))
    return findings


def _check_cli_choices(rel: str, tree: ast.AST) -> List[Finding]:
    """The ``add_argument("family", ...)`` call must wire ``choices=`` to
    the FAMILIES registry (an attribute or name ending in ``FAMILIES``
    somewhere in the expression) — a hand-maintained list of family names
    is exactly the drift this family exists to prevent."""
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and _callee_name(node.func) == "add_argument"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value in ("family", "--family")
        ):
            continue
        choices = next(
            (kw.value for kw in node.keywords if kw.arg == "choices"), None
        )
        wired = choices is not None and any(
            (isinstance(sub, ast.Attribute) and sub.attr == "FAMILIES")
            or (isinstance(sub, ast.Name) and sub.id == "FAMILIES")
            for sub in ast.walk(choices)
        )
        if not wired:
            findings.append(Finding(
                rel, node.lineno, "chaos-family-drift",
                "the family CLI argument must take choices= from the "
                "FAMILIES registry (sim/fuzz.py), not a re-typed list — "
                "a typo'd family must error with the real vocabulary",
            ))
    return findings


def check_chaosvocab(
    path: Path,
    source: Optional[str] = None,
    tree: "Optional[ast.AST]" = None,
) -> List[Finding]:
    rel = core.rel(path)
    posix = rel.replace("\\", "/")
    if not any(posix.startswith(p) for p in _CHAOS_PREFIXES):
        return []
    src = source if source is not None else path.read_text()
    # Cheap textual pre-gate before any parse/walk: files that never spell
    # a chaos surface cannot produce a finding (the tree sweep visits every
    # file in the prefixes — which is most of the repo).
    if not ("FaultEvent" in src or "FAMILIES" in src):
        return []
    if tree is None:
        tree = ast.parse(src, filename=str(path))
    defines_table = any(
        isinstance(node, ast.Assign)
        and any(
            isinstance(t, ast.Name) and t.id in (("FAMILIES",) + _MIX_TABLES)
            for t in node.targets
        )
        for node in ast.walk(tree)
    )
    if not (_imports_chaos(tree) or defines_table):
        return []
    findings = _check_event_kinds(rel, src.splitlines(), tree)
    findings.extend(_check_families_table(rel, tree))
    findings.extend(_check_cli_choices(rel, tree))
    return findings
