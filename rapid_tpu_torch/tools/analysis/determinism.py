"""Check family 10: determinism discipline — no unseeded randomness.

The chaos-simulation subsystem's contract is that a whole run is a pure
function of one seed; that only holds if no library component silently
draws from entropy. Every randomness consumer in ``rapid_tpu_torch/`` must
either accept an injectable ``random.Random`` (the ``rng=`` seam gossip,
consensus jitter, and the broadcaster all expose) or construct one from a
deterministic identity-derived seed.

Caught spellings:

- ``random.Random()`` with no seed argument — an entropy-seeded instance;
- module-level draws (``random.random()``, ``random.choice(...)``,
  ``random.shuffle(...)``, ...) — they share the module's global
  entropy-seeded generator;
- ``from random import choice``-style imports of the module-level draw
  functions (the aliased call is the same global generator);
- ``numpy.random.default_rng()`` with no seed, and legacy module-level
  ``np.random.<draw>(...)`` calls.

A deliberate exception carries ``# unseeded-ok: <reason>`` on the
offending line (e.g. a public-API default where no identity exists to
derive a seed from and every in-library caller threads a seeded rng).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import List, Optional

from . import core
from .core import Finding

#: The tree this discipline applies to (posix-style relative prefix).
DETERMINISM_PREFIXES = ("rapid_tpu_torch/",)

#: Module-level draw functions of the stdlib ``random`` module (all share
#: the global entropy-seeded generator). ``Random``/``SystemRandom`` are
#: class names, caught separately; ``seed`` is included — re-seeding the
#: GLOBAL generator is still global mutable randomness state.
_MODULE_DRAWS = frozenset({
    "betavariate", "choice", "choices", "expovariate", "gammavariate",
    "gauss", "getrandbits", "lognormvariate", "normalvariate",
    "paretovariate", "randbytes", "randint", "random", "randrange",
    "sample", "seed", "shuffle", "triangular", "uniform",
    "vonmisesvariate", "weibullvariate",
})

_ALLOW_RE = re.compile(r"#\s*unseeded-ok:")

_GUIDANCE = (
    "thread an injectable seeded random.Random (or derive the seed from the "
    "component's identity); simulated runs must be pure functions of their seed"
)


def _is_numpy_random(value: ast.AST) -> bool:
    """``np.random`` / ``numpy.random`` attribute chains."""
    return (
        isinstance(value, ast.Attribute)
        and value.attr == "random"
        and isinstance(value.value, ast.Name)
        and value.value.id in ("np", "numpy")
    )


def check_determinism(
    path: Path,
    source: Optional[str] = None,
    tree: "Optional[ast.AST]" = None,
) -> List[Finding]:
    rel = core.rel(path)
    posix = rel.replace("\\", "/")
    if not any(posix.startswith(p) for p in DETERMINISM_PREFIXES):
        return []
    src = source if source is not None else path.read_text()
    if tree is None:
        tree = ast.parse(src, filename=str(path))
    lines = src.splitlines()

    def allowed(lineno: int) -> bool:
        line = lines[lineno - 1] if 0 < lineno <= len(lines) else ""
        return bool(_ALLOW_RE.search(line))

    findings: List[Finding] = []

    def report(lineno: int, what: str) -> None:
        if not allowed(lineno):
            findings.append(
                Finding(rel, lineno, "unseeded-random", f"{what} — {_GUIDANCE}")
            )

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            value = func.value
            if isinstance(value, ast.Name) and value.id == "random":
                if func.attr == "SystemRandom":
                    # Always a finding, seeded-looking or not: SystemRandom
                    # IGNORES its seed argument and draws OS entropy.
                    report(node.lineno, "random.SystemRandom() draws OS entropy "
                                        "(any seed argument is ignored)")
                elif func.attr == "Random":
                    if not node.args and not node.keywords:
                        report(node.lineno, "random.Random() without a seed")
                elif func.attr in _MODULE_DRAWS:
                    report(
                        node.lineno,
                        f"module-level random.{func.attr}() draws from the "
                        "global entropy-seeded generator",
                    )
            elif _is_numpy_random(value):
                if func.attr in ("default_rng", "RandomState"):
                    # Instance constructors: a finding only when unseeded.
                    if not node.args and not node.keywords:
                        report(node.lineno, f"np.random.{func.attr}() without a seed")
                elif func.attr not in ("Generator", "SeedSequence", "PCG64"):
                    report(
                        node.lineno,
                        f"module-level np.random.{func.attr}() draws from "
                        "numpy's global generator",
                    )
        elif isinstance(node, ast.ImportFrom) and node.module == "random":
            drawn = [a.name for a in node.names if a.name in _MODULE_DRAWS]
            if drawn:
                report(
                    node.lineno,
                    f"importing {', '.join(drawn)} from random aliases the "
                    "global entropy-seeded generator",
                )
    return findings
