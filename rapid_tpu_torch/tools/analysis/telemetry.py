"""Check family 15: device telemetry plane discipline.

The telemetry plane (rapid_tpu_torch/models/state.py ``TelemetryLanes``) lives
on device and is fetched ONLY at declared host-sync boundaries — sync,
the stream driver's drain seam, fleet health scans, and the HLO audit.
An undeclared fetch is a blocking device round trip smuggled onto a hot
path, exactly the defect the sharding family's host-sync checks exist
for; the lanes get their own family because their fetch surface (the
``telemetry_digest`` jits) is narrower and checkable with zero false
positives.

Two checks:

- ``telemetry-unmarked-fetch`` (per file): every host materialization of
  the lanes — a call to ``telemetry_digest`` / ``fleet_telemetry_digest``,
  or ``np.asarray`` / ``np.array`` / ``jax.device_get`` over an
  expression that references telemetry lanes — must carry a
  ``# telemetry-fetch-ok: <why this is a sync boundary>`` marker on the
  call line or within the three lines above it.
- ``telemetry-lane-drift`` (full tree): the ``TelemetryLanes`` field set
  is mirrored here as a literal (wire_schema-style) and pinned against
  both the NamedTuple's declared fields and the ``TELEMETRY_LANE_SPECS``
  geometry table — adding a lane without updating every consumer
  (digest layout, partition rules, exposition vocabulary) fails the
  gate instead of silently dropping the lane from the digest.

The round-trace ring (ISSUE 17, ``TraceRing`` / ``TRACE_LANE_SPECS``)
rides the same family: its digest fetchers (``trace_digest`` /
``fleet_trace_digest``) and ``tr_*`` lane references fall under the same
``telemetry-unmarked-fetch`` marker discipline, and the ring's field set
gets its own analyzer mirror (``TRACE_LANE_FIELDS``) pinned by the same
``telemetry-lane-drift`` check — the ring is a refinement of the
telemetry plane, not a new observability channel with new rules.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Tuple

from . import core
from .core import Finding

#: Trees the fetch discipline applies to. Tests are exempt — a test
#: fetching the digest IS the boundary it is probing.
TELEMETRY_PREFIXES = ("rapid_tpu_torch/", "chip_smoke.py", "mesh_smoke.py")

#: The literal mirror of ``TelemetryLanes``'s fields, in declaration
#: order. Must match rapid_tpu_torch/models/state.py exactly — the gate pins
#: both directions, so this tuple is the analyzer-side half of the same
#: never-drift contract wire.lock.json plays for the codec mirrors.
TELEMETRY_LANE_FIELDS = (
    "tl_rounds",
    "tl_alerts",
    "tl_active",
    "tl_invalidated",
    "tl_proposals",
    "tl_tally_sum",
    "tl_fast_decisions",
    "tl_classic_decisions",
    "tl_conflict_rounds",
    "tl_undecided_hist",
)

#: The literal mirror of ``TraceRing``'s fields, in declaration order —
#: the nine per-round lanes, then the cursor pair. Pinned against both
#: the NamedTuple and ``TRACE_LANE_SPECS`` exactly like the telemetry
#: mirror above.
TRACE_LANE_FIELDS = (
    "tr_round",
    "tr_epoch",
    "tr_active",
    "tr_alerts",
    "tr_proposals",
    "tr_tally",
    "tr_path",
    "tr_conflict",
    "tr_undecided",
    "tr_cursor",
    "tr_wraps",
)

STATE_REL = "rapid_tpu_torch/models/state.py"
FETCH_MARKER = "telemetry-fetch-ok"
#: The marker may sit on the call line or this many lines above it (the
#: prose half of the comment typically wraps onto a second line).
MARKER_WINDOW = 3

#: The jitted digest entrypoints — calling one IS the device fetch.
_DIGEST_FETCHERS = frozenset({
    "telemetry_digest", "fleet_telemetry_digest",
    "trace_digest", "fleet_trace_digest",
})
#: Host materializers that become a lane fetch when fed lane references.
_MATERIALIZERS = frozenset({"asarray", "array", "device_get"})


def _callee_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _mentions_lanes(node: ast.AST) -> bool:
    """True if the expression references device telemetry lanes: an
    attribute or name spelled ``telem`` (the lanes pytree by convention)
    or ``trace_ring`` (the device ring by convention — bare ``trace`` is
    deliberately NOT matched: it names decoded host-side summaries), or
    any ``tl_*`` / ``tr_*`` lane field."""
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Attribute):
            name = sub.attr
        elif isinstance(sub, ast.Name):
            name = sub.id
        if name is not None and (
            name in ("telem", "trace_ring")
            or name.startswith("tl_")
            or name.startswith("tr_")
        ):
            return True
    return False


def _has_marker(lines: List[str], lineno: int) -> bool:
    lo = max(0, lineno - 1 - MARKER_WINDOW)
    return any(FETCH_MARKER in line for line in lines[lo:lineno])


def check_telemetry(
    path: Path,
    source: Optional[str] = None,
    tree: "Optional[ast.AST]" = None,
) -> List[Finding]:
    rel = core.rel(path)
    posix = rel.replace("\\", "/")
    if not any(posix.startswith(p) for p in TELEMETRY_PREFIXES):
        return []
    src = source if source is not None else path.read_text()
    if FETCH_MARKER not in src and "telem" not in src and "trace" not in src:
        return []  # cheap bail: nothing lane-shaped in this file
    if tree is None:
        tree = ast.parse(src, filename=str(path))
    lines = src.splitlines()
    findings: List[Finding] = []
    flagged: set = set()  # one finding per line — np.asarray(digest(...))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _callee_name(node.func)
        if name in _DIGEST_FETCHERS:
            fetch = True
        elif name in _MATERIALIZERS:
            fetch = any(_mentions_lanes(arg) for arg in node.args)
        else:
            fetch = False
        if fetch and node.lineno in flagged:
            continue
        if fetch and not _has_marker(lines, node.lineno):
            flagged.add(node.lineno)
            findings.append(Finding(
                rel, node.lineno, "telemetry-unmarked-fetch",
                "telemetry-lane fetch outside a declared boundary — a "
                "blocking device round trip; move it to a host-sync seam "
                "(sync / drain / health_scan) and annotate it with "
                "'# telemetry-fetch-ok: <why>'",
            ))
    return findings


def _class_fields(tree: ast.AST, name: str) -> Optional[Tuple[List[str], int]]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == name:
            fields = [
                stmt.target.id
                for stmt in node.body
                if isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
            ]
            return fields, node.lineno
    return None


def _spec_keys(
    tree: ast.AST, var_name: str = "TELEMETRY_LANE_SPECS"
) -> Optional[Tuple[List[str], int]]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target = node.target
        else:
            continue
        if not (isinstance(target, ast.Name) and target.id == var_name):
            continue
        if not isinstance(node.value, ast.Dict):
            return None
        keys = [
            k.value for k in node.value.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)
        ]
        return keys, node.lineno
    return None


#: (NamedTuple name, geometry-table name, analyzer mirror) — one row per
#: device observability plane pinned by ``check_lane_mirror``.
_LANE_MIRRORS = (
    ("TelemetryLanes", "TELEMETRY_LANE_SPECS", TELEMETRY_LANE_FIELDS),
    ("TraceRing", "TRACE_LANE_SPECS", TRACE_LANE_FIELDS),
)


def check_lane_mirror(trees: List[Tuple[ast.AST, str]]) -> List[Finding]:
    """Full-tree check: pin the analyzer's lane mirrors against the live
    ``TelemetryLanes`` / ``TraceRing`` declarations AND their
    ``*_LANE_SPECS`` geometry tables. Presence-gated on state.py being in
    the sweep, so retargeted test trees skip it."""
    state_tree = next((t for t, rel in trees if rel == STATE_REL), None)
    if state_tree is None:
        return []
    findings: List[Finding] = []
    for cls_name, spec_name, mirror_fields in _LANE_MIRRORS:
        mirror = list(mirror_fields)
        got = _class_fields(state_tree, cls_name)
        if got is None:
            findings.append(Finding(
                STATE_REL, 1, "telemetry-lane-drift",
                f"{cls_name} class not found — the analyzer's lane mirror "
                f"(rapid_tpu_torch/tools/analysis/telemetry.py) has nothing to pin against",
            ))
            continue
        fields, lineno = got
        if fields != mirror:
            findings.append(Finding(
                STATE_REL, lineno, "telemetry-lane-drift",
                f"{cls_name} fields {fields} do not match the analyzer "
                f"mirror {mirror} — update rapid_tpu_torch/tools/analysis/telemetry.py AND "
                f"every lane consumer (digest layout, partition rules, "
                f"exposition vocabulary) together",
            ))
        spec = _spec_keys(state_tree, spec_name)
        if spec is None:
            findings.append(Finding(
                STATE_REL, 1, "telemetry-lane-drift",
                f"{spec_name} literal dict not found in state.py — the "
                f"lane geometry table must stay a plain literal so the "
                f"gate can read it",
            ))
        else:
            keys, lineno = spec
            if keys != mirror:
                findings.append(Finding(
                    STATE_REL, lineno, "telemetry-lane-drift",
                    f"{spec_name} keys {keys} do not match the analyzer "
                    f"mirror {mirror} — the geometry table and the "
                    f"NamedTuple must list the same lanes in the same "
                    f"order",
                ))
    return findings
