"""The port's AST style gate: the counterpart of ``tests/test_lint.py`` over
the port's roots (``rapid_tpu_torch``, ``tests/test_torch_*.py``,
``chip_smoke.py``, ``mesh_smoke.py``), with the port's own static tier
(``rapid_tpu_torch/tools/analysis``) for the root list and the ledger rule.

Checks: unused module imports, bare ``except:`` clauses, mutable default
arguments, and the observability rules over the port's library (its
packages less the command lines under ``examples/`` and ``tools/``, whose
job is to print): no bare ``print()``, every flight-recorder ``record()``
names an ``EventName`` member, every run-ledger ``emit()`` a
``LedgerEvent`` member; the clock-disciplined packages read no wall clock;
and the per-file families are clean over the library.
"""

from __future__ import annotations

import ast
import textwrap
from pathlib import Path

from rapid_tpu_torch.tools.analysis import core
from rapid_tpu_torch.tools.analysis.clocks import check_clock_injection
from rapid_tpu_torch.tools.analysis.ledger import check_ledger

REPO = Path(__file__).resolve().parent.parent

#: The port's command lines: printing is their job.
_CLI_PACKAGES = ("rapid_tpu_torch/examples/", "rapid_tpu_torch/tools/")


def _parse(path: Path):
    return ast.parse(path.read_text(), filename=str(path))


def _library():
    return [
        p for p in core.iter_files(("rapid_tpu_torch",))
        if not core.rel(p).startswith(_CLI_PACKAGES)
    ]


def test_no_unused_imports():
    offenders = []
    for path in core.iter_files():
        tree = _parse(path)
        imports = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    imports.append((node.lineno, alias.asname or alias.name.split(".")[0]))
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for alias in node.names:
                    if alias.name != "*":
                        imports.append((node.lineno, alias.asname or alias.name))
        used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        # A string EXACTLY equal to the name (an __all__ entry) is a use.
        exact_strings = {
            n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
        }
        offenders.extend(
            f"{core.rel(path)}:{lineno}: unused import {name!r}"
            for lineno, name in imports
            if name not in used and name not in exact_strings
        )
    assert not offenders, "\n".join(offenders)


def test_no_bare_except():
    offenders = [
        f"{core.rel(path)}:{node.lineno}: bare except"
        for path in core.iter_files()
        for node in ast.walk(_parse(path))
        if isinstance(node, ast.ExceptHandler) and node.type is None
    ]
    assert not offenders, "\n".join(offenders)


def test_library_has_no_bare_print():
    offenders = [
        f"{core.rel(path)}:{node.lineno}: bare print() — use logging / Metrics / FlightRecorder"
        for path in _library()
        for node in ast.walk(_parse(path))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
        and node.func.id == "print"
    ]
    assert not offenders, "\n".join(offenders)


def test_recorder_events_come_from_registered_enum():
    from rapid_tpu_torch.utils.flight_recorder import EventName

    offenders = []
    for path in _library():
        for node in ast.walk(_parse(path)):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("record", "_record")
            ):
                continue
            receiver = node.func.value
            receiver_name = getattr(receiver, "attr", getattr(receiver, "id", ""))
            if receiver_name.lower().endswith("event"):
                continue  # a CUDA event's record(stream), not the recorder
            name_arg = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "name"), None
            )
            ok = (
                isinstance(name_arg, ast.Attribute)
                and isinstance(name_arg.value, ast.Name)
                and name_arg.value.id == "EventName"
                and name_arg.attr in EventName.__members__
            )
            forwards = isinstance(name_arg, ast.Name) and name_arg.id == "name"
            if not (ok or forwards):
                offenders.append(f"{core.rel(path)}:{node.lineno}: record() event must be an "
                                 "EventName member")
    assert not offenders, "\n".join(offenders)


def test_ledger_events_come_from_registered_vocabulary():
    offenders = [
        str(f)
        for path in core.iter_files(("rapid_tpu_torch", "chip_smoke.py", "mesh_smoke.py"))
        for f in check_ledger(path)
    ]
    assert not offenders, "\n".join(offenders)


def test_clock_disciplined_packages_read_no_wall_clock():
    offenders = [
        str(f)
        for sub in ("protocol", "monitoring", "serving")
        for path in core.iter_files((f"rapid_tpu_torch/{sub}",))
        for f in check_clock_injection(path)
    ]
    assert not offenders, "\n".join(offenders)


def test_clock_injection_catches_both_spellings():
    src = textwrap.dedent(
        """
        import time
        from time import monotonic

        def deadline():
            return time.perf_counter() + monotonic()

        def allowed():
            return time.time()  # wall-clock-ok: log timestamp
        """
    )
    findings = check_clock_injection(REPO / "rapid_tpu_torch/serving/_probe.py", source=src)
    assert sorted(f.lineno for f in findings) == [3, 6]
    assert check_clock_injection(REPO / "rapid_tpu_torch/utils/_probe.py", source=src) == []


def test_library_sweep_is_clean_under_all_families():
    findings = core.run(("rapid_tpu_torch",))
    assert not findings, "\n".join(str(f) for f in findings)


def test_no_mutable_default_arguments():
    offenders = []
    for path in core.iter_files():
        for node in ast.walk(_parse(path)):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for default in [*node.args.defaults, *node.args.kw_defaults]:
                    if isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                        isinstance(default, ast.Call)
                        and isinstance(default.func, ast.Name)
                        and default.func.id in ("list", "dict", "set")
                    ):
                        offenders.append(
                            f"{core.rel(path)}:{node.lineno}: mutable default in {node.name}()"
                        )
    assert not offenders, "\n".join(offenders)
