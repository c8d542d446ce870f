"""Check family 3: clock-injection discipline.

No direct wall-clock reads in the timing-sensitive packages: every timing
consumer in ``rapid_tpu_torch/protocol/`` AND ``rapid_tpu_torch/monitoring/`` (failure
detectors are timing consumers too) AND ``rapid_tpu_torch/serving/`` (the
supervision tier's deadline/backoff decisions must replay under an injected
clock — a wall-clock read in the wedge-detection path would make every
fault drill nondeterministic) must go through the injected Clock
(utils/clock.py) / Metrics ``now_ms`` source, or simulated-time tests
silently measure wall time (and phase SLO histograms record garbage under
ManualClock).

Caught spellings: attribute access on the ``time`` module (``time.time``,
``time.time_ns``, ``time.monotonic``, ...), ``from time import
perf_counter``-style imports, and the datetime spellings
``datetime.datetime.now(...)`` / ``datetime.now(...)`` (the latter for
``from datetime import datetime``). A deliberate exception carries a
``# wall-clock-ok: <reason>`` comment on the offending line.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import List, Optional

from . import core
from .core import Finding

#: Wall-clock readers banned inside the clock-disciplined packages.
_BANNED_CLOCK_ATTRS = frozenset(
    {"time", "time_ns", "perf_counter", "perf_counter_ns",
     "monotonic", "monotonic_ns"}
)

#: The trees this discipline applies to (posix-style relative prefixes).
CLOCK_DISCIPLINE_PREFIXES = (
    "rapid_tpu_torch/protocol/",
    "rapid_tpu_torch/monitoring/",
    "rapid_tpu_torch/serving/",
)

_ALLOW_RE = re.compile(r"#\s*wall-clock-ok\b")

_GUIDANCE = "use the injected Clock / Metrics now_ms source"


def _is_datetime_now(node: ast.Attribute) -> bool:
    """``datetime.now`` (from-import spelling) or ``datetime.datetime.now``."""
    if node.attr != "now":
        return False
    value = node.value
    if isinstance(value, ast.Name) and value.id == "datetime":
        return True
    return (
        isinstance(value, ast.Attribute)
        and value.attr == "datetime"
        and isinstance(value.value, ast.Name)
        and value.value.id == "datetime"
    )


def check_clock_injection(
    path: Path,
    source: Optional[str] = None,
    tree: "Optional[ast.AST]" = None,
) -> List[Finding]:
    rel = core.rel(path)
    posix = rel.replace("\\", "/")
    if not any(posix.startswith(p) for p in CLOCK_DISCIPLINE_PREFIXES):
        return []
    src = source if source is not None else path.read_text()
    if tree is None:
        tree = ast.parse(src, filename=str(path))
    lines = src.splitlines()

    def allowed(lineno: int) -> bool:
        line = lines[lineno - 1] if 0 < lineno <= len(lines) else ""
        return bool(_ALLOW_RE.search(line))

    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            if (
                isinstance(node.value, ast.Name)
                and node.value.id == "time"
                and node.attr in _BANNED_CLOCK_ATTRS
            ):
                if not allowed(node.lineno):
                    findings.append(
                        Finding(rel, node.lineno, "clock-injection",
                                f"direct wall-clock read time.{node.attr} in a "
                                f"clock-disciplined package — {_GUIDANCE}")
                    )
            elif _is_datetime_now(node):
                if not allowed(node.lineno):
                    findings.append(
                        Finding(rel, node.lineno, "clock-injection",
                                "direct wall-clock read datetime.now in a "
                                f"clock-disciplined package — {_GUIDANCE}")
                    )
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            banned = [a.name for a in node.names if a.name in _BANNED_CLOCK_ATTRS]
            if banned and not allowed(node.lineno):
                findings.append(
                    Finding(rel, node.lineno, "clock-injection",
                            f"importing {', '.join(banned)} from time in a "
                            f"clock-disciplined package — {_GUIDANCE}")
                )
    return findings
