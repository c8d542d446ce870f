"""No module of the benchmark imports JAX, the JAX package or its benchmark
script, top-level names compared whole; the reference imports nothing of
the program; and a run holds none of them once it ends."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from benchmark import core
from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "rapid_tpu", "bench"}
SOURCES = sorted((ROOT / "benchmark").rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "numpy", "benchmark"}
    assert "rapid_tpu_torch" not in path.read_text()


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rapid_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rapid_tpu.ops", sys)
    assert core.forbidden_modules() == ["rapid_tpu"]


def test_a_run_loads_none_of_them():
    """A whole tiny run in a fresh process, then its module table."""
    code = (
        "import sys; from benchmark.tests.conftest import tiny_plan, tiny_run; "
        "from benchmark import core; "
        "assert tiny_run(tiny_plan('paper1k.crash10'))[1]['correct']; "
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        f"set({sorted(FORBIDDEN)!r})))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
