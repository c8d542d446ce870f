"""Check family 13: engine sharding and host-sync discipline (source-level
lint), the port's counterpart of the JAX package's ``sharding`` family,
over ``rapid_tpu_torch/ops/``, ``models/``, ``parallel/``, ``tenancy/``
and ``serving/``:

- ``missing-partition-spec`` — every lane of the engine's state
  NamedTuples (``models/state.py``) must fullmatch a rule of
  ``parallel/mesh.py``'s ``PARTITION_RULES`` (first match wins, as
  ``mesh.match_partition_rules``); a rule matching no lane is a dead
  entry; a rule that names no mesh axis justifies the replication with
  ``# replicated-ok: <reason>`` on its spec line; a rule covering
  tenant-stacked lanes (``# [t`` shape comments) shards dimension 0 on the
  ``'tenant'`` axis. The explicit constructor tables (``*_shardings``
  keyword-per-leaf) are checked the same way. JAX's rules, unchanged.
- ``dtype-widening`` — arithmetic stored into a policy-narrowed lane
  (``models/state.NARROWABLE_LANES``) through ``_replace(...)`` or a state
  constructor without an explicit cast (``.to(...)``, ``.astype(...)``,
  ``_narrow.keep_bits``): torch promotes silently
  (``torch.where(m, int16_lane, int32_tensor)`` is int32), re-widening
  the lane. Hatch ``# widen-ok: <reason>``.
- ``host-sync-in-hot-path`` — a blocking read inside the hot set: the
  port's counterparts of the functions the JAX package jits
  (:data:`HOT_SET`, committed: the port runs eagerly, so there is no jit
  to find them by) and the ``*_impl`` round-body pieces. The spellings
  (:func:`blocking_read`): ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.synchronize()`` (``torch.cuda.synchronize``,
  ``Event.synchronize``), ``_host.read(...)``, and ``int()`` /
  ``float()`` / ``bool()`` of a resolvable ``torch.*`` call. Every read
  the eager engine branches on is a declared boundary: hatch
  ``# host-sync-ok: <reason>``, JAX's marker.
- ``host-sync-in-stream`` — the same spellings, plus an ``if`` / ``while``
  over a resolvable ``torch.*`` call, ANYWHERE in a serving module: a
  blocking read there stalls every enqueued wave behind it, so each one
  is a declared fetch boundary (``# host-sync-ok: <reason>``).

JAX's ``donation-mismatch`` and ``retrace-hazard`` have no torch meaning
(no jit application to donate through, no trace to repeat); README's
"Not ported, by design" says why.

``check_sharding`` is the per-file entry (prefix-gated; the lint corpus
keeps miniature state+table pairs in one module);
``check_partition_specs`` is the tree-mode entry that merges the real
state.py/mesh.py pair on full sweeps.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from . import core
from .core import Finding
from .sync_safety import (
    _HOST_VALUED, STREAM_PREFIXES, TensorScope, _after_cpu, _dotted, _import_aliases,
    lane_fields, scopes,
)

SHARDING_PREFIXES = (
    "rapid_tpu_torch/ops/",
    "rapid_tpu_torch/models/",
    "rapid_tpu_torch/parallel/",
    "rapid_tpu_torch/tenancy/",
)

#: The real files the tree-mode partition-spec check merges.
STATE_FILE = "rapid_tpu_torch/models/state.py"
MESH_FILE = "rapid_tpu_torch/parallel/mesh.py"

#: State-pytree classes and the sharding-table functions that must cover
#: their array leaves, by name (the engine convention).
_PYTREE_TABLES = {
    "EngineState": "state_shardings",
    "FaultInputs": "fault_shardings",
    "TenantKnobs": "knob_shardings",
    "TelemetryLanes": "telemetry_shardings",
    "TraceRing": "trace_shardings",
}

#: The hot set: port file -> {name the JAX package jits in the counterpart
#: module: the port functions that do its work}. The port runs eagerly,
#: so this list takes the place of JAX's jit applications; it is held
#: against the names JAX jits (read from JAX's syntax tree) by
#: tests/test_torch_staticcheck.py. ``_compute_round`` is the round body
#: every engine entry point runs.
HOT_SET: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "rapid_tpu_torch/models/virtual_cluster.py": {
        "engine_step_impl": ("engine_step", "_compute_round"),
        "engine_step_telem_impl": ("engine_step", "_compute_round"),
        "engine_step_trace_impl": ("engine_step", "_compute_round"),
        "run_to_decision_impl": ("run_to_decision",),
        "run_to_decision_telem_impl": ("run_to_decision",),
        "run_to_decision_trace_impl": ("run_to_decision",),
        "run_until_membership_impl": ("run_until_membership",),
        "run_until_membership_telem_impl": ("run_until_membership",),
        "run_until_membership_trace_impl": ("run_until_membership",),
        "sync_checksum_impl": ("sync_checksum",),
        "telemetry_digest_impl": ("telemetry_digest",),
        "trace_digest_impl": ("trace_digest",),
    },
    "rapid_tpu_torch/tenancy/fleet.py": {
        "fleet_step_impl": ("fleet_step",),
        "fleet_step_telem_impl": ("fleet_step",),
        "fleet_step_trace_impl": ("fleet_step",),
        "fleet_run_to_decision_impl": ("fleet_run_to_decision",),
        "fleet_run_to_decision_telem_impl": ("fleet_run_to_decision",),
        "fleet_run_to_decision_trace_impl": ("fleet_run_to_decision",),
        "fleet_wave_impl": ("fleet_wave",),
        "fleet_wave_telem_impl": ("fleet_wave",),
        "fleet_wave_trace_impl": ("fleet_wave",),
        "tenant_health_impl": ("tenant_health",),
    },
    "rapid_tpu_torch/ops/consensus.py": {
        "tally_candidates": ("tally_candidates",),
        "tally_sorted": ("tally_sorted",),
    },
    "rapid_tpu_torch/ops/cut_detection.py": {
        "process_alert_batch": ("process_alert_batch",),
    },
    "rapid_tpu_torch/ops/rings.py": {
        "predecessor_of_keys": ("predecessor_of_keys",),
        "ring_topology": ("ring_topology",),
    },
    "rapid_tpu_torch/ops/kernels.py": {
        "delivery_new_bits_pallas": ("delivery_new_bits",),
        "watermark_merge_classify_impl": ("watermark_merge_classify",),
    },
}

_HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})


def _comment_ok(source_lines: List[str], lineno: int, marker: str) -> bool:
    if 1 <= lineno <= len(source_lines):
        return marker in source_lines[lineno - 1]
    return False


# -- host-sync-in-hot-path / host-sync-in-stream -----------------------------


def _torch_call(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    if isinstance(node, ast.Call):
        dotted = _dotted(node.func, aliases) or ""
        if dotted.startswith("torch.") and not dotted.startswith(_HOST_VALUED):
            return dotted
    return None


def blocking_read(
    node: ast.Call, aliases: Dict[str, str], scope: TensorScope
) -> Optional[str]:
    """The blocking-read spelling of a call node — the one classifier both
    host-sync checks share, so the two can never disagree about what counts
    as a device->host sync. ``.item()`` / ``.tolist()`` count only on a
    tensor ``scope`` recognises (numpy has both). None = not a blocking
    read."""
    dotted = _dotted(node.func, aliases) or ""
    if dotted == "_host.read" or dotted.endswith("._host.read"):
        return "_host.read(...)"
    if isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_SYNC_METHODS:
        attr = node.func.attr
        if attr == "synchronize" or (
            not node.args
            and not _after_cpu(node)
            and (attr in ("cpu", "numpy") or scope.is_tensor(node.func.value))
        ):
            return f".{attr}()"
    if (
        isinstance(node.func, ast.Name)
        and node.func.id in ("int", "float", "bool")
        and node.args
    ):
        for sub in ast.walk(node.args[0]):
            inner = _torch_call(sub, aliases)
            if inner:
                return f"{node.func.id}({inner}(...)) (scalar fetch)"
    return None


def _branch_on_torch(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """An ``if`` / ``while`` / conditional expression whose test calls a
    resolvable ``torch.*`` function (``if torch.any(mask):``): the implicit
    ``bool()`` of a tensor, a blocking read."""
    if not isinstance(node, (ast.If, ast.While, ast.IfExp)):
        return None
    for sub in ast.walk(node.test):
        inner = _torch_call(sub, aliases)
        if inner:
            return f"a branch on {inner}(...) (implicit bool)"
    return None


def _walk_scope(fn: ast.AST):
    """A scope's nodes, without nested function or class bodies."""
    yield fn
    for child in ast.iter_child_nodes(fn):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            continue
        yield from _walk_scope(child)


def _scoped_nodes(tree: ast.AST, aliases: Dict[str, str], within=None):
    """(node, TensorScope, scope name) for every node of the module, or of
    the function nodes ``within`` and the functions nested in them."""
    lanes = lane_fields()
    roots = within if within is not None else [tree]
    seen: Set[int] = set()
    for root in roots:
        for fn, names in scopes(root):
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            is_fn = isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            scope = TensorScope(aliases, lanes, fn if is_fn else None)
            label = getattr(fn, "name", "<module>")
            for node in _walk_scope(fn):
                yield node, scope, label


def _hot_functions(tree: ast.AST, posix: str) -> List[ast.AST]:
    """The hot set's function nodes in this file: the module-level
    functions :data:`HOT_SET` commits for it, and every module-level
    ``*_impl`` function (the round-body pieces, JAX's traced-impl
    convention)."""
    wanted = {name for names in HOT_SET.get(posix, {}).values() for name in names}
    return [
        node for node in getattr(tree, "body", [])
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        and (node.name in wanted or node.name.endswith("_impl"))
    ]


def _check_host_sync(
    tree: ast.AST,
    aliases: Dict[str, str],
    posix: str,
    rel: str,
    source_lines: List[str],
    findings: List[Finding],
) -> None:
    hot = _hot_functions(tree, posix)
    for node, scope, label in _scoped_nodes(tree, aliases, within=hot):
        if not isinstance(node, ast.Call):
            continue
        what = blocking_read(node, aliases, scope)
        if what is None or _comment_ok(source_lines, node.lineno, "# host-sync-ok:"):
            continue
        findings.append(Finding(
            rel, node.lineno, "host-sync-in-hot-path",
            f"{what} inside hot {label!r}: a device->host sync in the "
            f"round's hot path — keep the value on the device "
            f"(torch.where, a select), or declare the boundary with "
            f"`# host-sync-ok: <reason>`",
        ))


def _check_stream_host_sync(
    tree: ast.AST,
    aliases: Dict[str, str],
    rel: str,
    source_lines: List[str],
    findings: List[Finding],
) -> None:
    """The streaming-pipeline variant: every blocking-read spelling in a
    serving module is a pipeline stall, so each one must be a declared
    fetch boundary — hatch ``# host-sync-ok: <reason>``."""
    for node, scope, _label in _scoped_nodes(tree, aliases):
        if isinstance(node, ast.Call):
            what, lineno = blocking_read(node, aliases, scope), node.lineno
        else:
            what = _branch_on_torch(node, aliases)
            lineno = getattr(getattr(node, "test", None), "lineno", 0)
        if what is None or _comment_ok(source_lines, lineno, "# host-sync-ok:"):
            continue
        findings.append(Finding(
            rel, lineno, "host-sync-in-stream",
            f"{what} in the streaming pipeline: a blocking read here "
            f"stalls every enqueued wave behind it — keep the pipeline "
            f"fetch-free (enqueue-only dispatches, device-resident "
            f"tickets), or declare the fetch boundary with "
            f"`# host-sync-ok: <reason>`",
        ))


# -- dtype-widening ----------------------------------------------------------

#: The engine lanes the compact policy stores below 32 bits — the LITERAL
#: mirror of ``rapid_tpu_torch/models/state.NARROWABLE_LANES`` (the analysis
#: imports no engine module here; the two sets are pinned equal by
#: tests/test_torch_staticcheck.py so they cannot drift).
NARROWED_LANES = frozenset({
    "ring_perm", "obs_idx", "subj_idx", "inval_obs", "cohort_of",
    "fd_count", "fd_hist", "fire_round", "report_bits",
    "cp_rnd_r", "cp_rnd_i", "cp_vrnd_r", "cp_vrnd_i", "cp_vval_src",
    "classic_epoch", "rounds_undecided",
})

#: Call shapes whose keywords are lane STORES: the NamedTuple ``_replace``
#: method and the state-pytree constructors themselves.
_STORE_CONSTRUCTORS = frozenset({"EngineState", "FaultInputs"})


#: The explicit casts a narrowed store may go through: JAX's ``.astype``,
#: torch's ``.to(dtype)``, and the port's ``_narrow.keep_bits``.
_CAST_CALLS = frozenset({"astype", "to", "keep_bits"})


def _binop_outside_astype(node: ast.AST, inside: bool = False) -> bool:
    """True when the expression contains a BinOp not enclosed by an
    explicit cast (:data:`_CAST_CALLS`) — arithmetic whose result dtype is
    promotion's choice, not the lane's. Comparisons and boolean ops are
    excluded (they produce bools, which no narrowed lane stores)."""
    if isinstance(node, ast.Call) and (
        (isinstance(node.func, ast.Attribute) and node.func.attr in _CAST_CALLS)
        or (isinstance(node.func, ast.Name) and node.func.id in _CAST_CALLS)
    ):
        inside = True
    if isinstance(node, ast.BinOp) and not inside:
        return True
    return any(
        _binop_outside_astype(child, inside) for child in ast.iter_child_nodes(node)
    )


def _check_dtype_widening(
    tree: ast.AST,
    rel: str,
    source_lines: List[str],
    findings: List[Finding],
) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        is_replace = (
            isinstance(node.func, ast.Attribute) and node.func.attr == "_replace"
        )
        is_ctor = (
            isinstance(node.func, ast.Name)
            and node.func.id in _STORE_CONSTRUCTORS
        )
        if not (is_replace or is_ctor):
            continue
        for kw in node.keywords:
            if kw.arg not in NARROWED_LANES:
                continue
            if not _binop_outside_astype(kw.value):
                continue
            if _comment_ok(source_lines, kw.value.lineno, "# widen-ok:"):
                continue
            findings.append(Finding(
                rel, kw.value.lineno, "dtype-widening",
                f"arithmetic stored into policy-narrowed lane {kw.arg!r} "
                f"without an explicit cast: type promotion re-widens the "
                f"lane to 32 bits the moment a wide operand appears — "
                f"accumulate in int32 and cast the store (`.to(lane.dtype)`, "
                f"`_narrow.keep_bits`), or justify with `# widen-ok: <reason>`",
            ))


# -- missing-partition-spec --------------------------------------------------

#: The regex rule table's module-level name (parallel/mesh.py).
RULES_NAME = "PARTITION_RULES"

#: The tenant batch axis (rapid_tpu_torch/parallel/mesh.TENANT_AXIS): a pytree
#: leaf whose shape annotation declares a leading ``[t`` dimension is a
#: TENANT-STACKED leaf, and its rule must shard dimension 0 on this axis —
#: an unmeshed tenant dimension replicates every tenant's state onto every
#: tenant's devices, the exact failure mode the fleet mesh exists to
#: prevent.
TENANT_AXIS_NAME = "tenant"
_TENANT_SHAPE_RE = re.compile(r"#\s*\[t[\],]")

#: A replication justification whose premise died with the 1-D mesh: the
#: cohort axis IS meshed now, so any surviving instance is a finding.
STALE_REPLICATION_REASON = "cohort axis is not meshed"


def _partition_rules(tree: ast.AST) -> Optional[Tuple[int, List[Dict[str, Any]]]]:
    """The module-level ``PARTITION_RULES`` tuple literal, parsed to
    (assignment lineno, [{pattern, meshed_axes, lineno, spec_lineno}]).
    None when the module declares no rule table. Only statically-resolvable
    (pattern-Constant, spec-Tuple) rules are kept — skip, don't guess."""
    for node in tree.body:
        value = None
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == RULES_NAME
        ):
            value = node.value
        elif (
            isinstance(node, ast.AnnAssign)
            and isinstance(node.target, ast.Name)
            and node.target.id == RULES_NAME
        ):
            value = node.value
        if not isinstance(value, ast.Tuple):
            continue
        rules: List[Dict[str, Any]] = []
        for elt in value.elts:
            if not (isinstance(elt, ast.Tuple) and len(elt.elts) == 2):
                continue
            pat, spec = elt.elts
            if not (isinstance(pat, ast.Constant) and isinstance(pat.value, str)):
                continue
            if not isinstance(spec, ast.Tuple):
                continue  # a computed spec: skip, don't guess
            meshed = sum(
                1
                for a in spec.elts
                if not (isinstance(a, ast.Constant) and a.value is None)
            )

            def _is_tenant_axis(node: ast.AST) -> bool:
                if isinstance(node, ast.Name):
                    return node.id == "TENANT_AXIS"
                return (
                    isinstance(node, ast.Constant)
                    and node.value == TENANT_AXIS_NAME
                )

            rules.append({
                "pattern": pat.value,
                "meshed_axes": meshed,
                "dim0_tenant": bool(spec.elts) and _is_tenant_axis(spec.elts[0]),
                "lineno": pat.lineno,
                "spec_lineno": spec.lineno,
            })
        return node.lineno, rules
    return None


def _stale_annotation_findings(rel: str, source_lines: List[str]) -> List[Finding]:
    return [
        Finding(
            rel, lineno, "missing-partition-spec",
            f"stale replication justification {STALE_REPLICATION_REASON!r}: "
            f"the cohort axis IS a mesh axis (2-D ('cohort', 'nodes') mesh) "
            f"— shard the leaf over it or state the real reason",
        )
        for lineno, line in enumerate(source_lines, 1)
        if STALE_REPLICATION_REASON in line
    ]


def _tenant_leaves(tree: ast.AST, source_lines: List[str]) -> Set[str]:
    """Field names of the module's state-pytree classes whose shape
    annotation comment declares a LEADING tenant dimension (``# [t]`` /
    ``# [t, ...]``) — the leaves the tenant-axis rule discipline covers."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef) and node.name in _PYTREE_TABLES):
            continue
        for stmt in node.body:
            if not (
                isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
            ):
                continue
            if 1 <= stmt.lineno <= len(source_lines) and _TENANT_SHAPE_RE.search(
                source_lines[stmt.lineno - 1]
            ):
                out.add(stmt.target.id)
    return out


def _rule_findings(
    fields_by_class: Dict[str, List[str]],
    assign_lineno: int,
    rules: List[Dict[str, Any]],
    rel: str,
    source_lines: List[str],
    tenant_leaves: Optional[Set[str]] = None,
) -> List[Finding]:
    """Coverage of the engine pytree leaves by the regex rule table: every
    leaf fullmatches a rule (first match wins, mirroring
    ``mesh.match_partition_rules``), no rule is dead, and a rule that
    replicates (names no mesh axis) justifies itself on its spec line."""
    findings: List[Finding] = []
    compiled: List[Optional["re.Pattern"]] = []
    for rule in rules:
        try:
            compiled.append(re.compile(rule["pattern"]))
        except re.error as exc:
            compiled.append(None)
            findings.append(Finding(
                rel, rule["lineno"], "missing-partition-spec",
                f"{RULES_NAME} rule {rule['pattern']!r} is not a valid "
                f"regex ({exc}) — it can cover nothing",
            ))
    all_fields = sorted({f for fields in fields_by_class.values() for f in fields})
    matched_fields: Dict[int, List[str]] = {}
    for field in all_fields:
        hit = None
        for idx, pattern in enumerate(compiled):
            if pattern is not None and pattern.fullmatch(field):
                hit = idx
                break
        if hit is None:
            findings.append(Finding(
                rel, assign_lineno, "missing-partition-spec",
                f"engine pytree leaf {field!r} matches no rule in "
                f"{RULES_NAME} — an uncovered leaf silently replicates "
                f"onto every device",
            ))
        else:
            matched_fields.setdefault(hit, []).append(field)
    for idx, rule in enumerate(rules):
        if compiled[idx] is None:
            continue
        fields = matched_fields.get(idx, [])
        if not fields:
            findings.append(Finding(
                rel, rule["lineno"], "missing-partition-spec",
                f"{RULES_NAME} rule {rule['pattern']!r} matches no engine "
                f"pytree leaf — dead table entry",
            ))
        elif rule["meshed_axes"] == 0 and not _comment_ok(
            source_lines, rule["spec_lineno"], "# replicated-ok:"
        ):
            findings.append(Finding(
                rel, rule["spec_lineno"], "missing-partition-spec",
                f"{RULES_NAME} rule {rule['pattern']!r} fully replicates "
                f"leaves {fields} without a `# replicated-ok: <reason>` "
                f"justification",
            ))
        stacked = sorted(set(fields) & (tenant_leaves or set()))
        if stacked and not rule["dim0_tenant"]:
            findings.append(Finding(
                rel, rule["spec_lineno"], "missing-partition-spec",
                f"{RULES_NAME} rule {rule['pattern']!r} covers "
                f"tenant-stacked leaves {stacked} ([t, ...] shape "
                f"annotation) but does not shard dimension 0 on the "
                f"'{TENANT_AXIS_NAME}' axis — an unmeshed tenant dimension "
                f"replicates every tenant's state onto every tenant's "
                f"devices",
            ))
    findings.extend(_stale_annotation_findings(rel, source_lines))
    return findings


def _pytree_array_fields(tree: ast.AST) -> Dict[str, List[str]]:
    """Array-leaf field names of each state-pytree NamedTuple present in
    the module (annotation mentions ``ndarray``)."""
    out: Dict[str, List[str]] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef) and node.name in _PYTREE_TABLES):
            continue
        fields = []
        for stmt in node.body:
            if not (
                isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
            ):
                continue
            ann = ast.dump(stmt.annotation)
            if "ndarray" in ann or "Array" in ann or "Tensor" in ann:
                fields.append(stmt.target.id)
        if fields:
            out[node.name] = fields
    return out


def _table_constructor_calls(
    tree: ast.AST,
) -> Dict[str, Tuple[ast.Call, int]]:
    """class name -> (the pytree constructor Call inside its sharding-table
    function, the function's lineno)."""
    out: Dict[str, Tuple[ast.Call, int]] = {}
    fn_for = {fn: cls for cls, fn in _PYTREE_TABLES.items()}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.FunctionDef) and node.name in fn_for):
            continue
        cls = fn_for[node.name]
        for sub in ast.walk(node):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Name)
                and sub.func.id == cls
                and sub.keywords
            ):
                out[cls] = (sub, node.lineno)
                break
    return out


def _partition_spec_findings(
    fields_by_class: Dict[str, List[str]],
    tables_tree: ast.AST,
    tables_rel: str,
    tables_source: str,
) -> List[Finding]:
    findings: List[Finding] = []
    source_lines = tables_source.splitlines()
    calls = _table_constructor_calls(tables_tree)
    for cls, fields in sorted(fields_by_class.items()):
        if cls not in calls:
            continue  # presence-gated: no table for this pytree here
        call, fn_lineno = calls[cls]
        declared = {kw.arg: kw.value for kw in call.keywords if kw.arg}
        table_fn = _PYTREE_TABLES[cls]
        for field in fields:
            if field not in declared:
                findings.append(Finding(
                    tables_rel, call.lineno, "missing-partition-spec",
                    f"{cls} array leaf {field!r} has no declared "
                    f"PartitionSpec in {table_fn}() — an undeclared leaf "
                    f"silently replicates onto every device",
                ))
                continue
            value = declared[field]
            if not (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id == "sh"
            ):
                continue  # a non-sh() spec: skip, don't guess
            has_axis = any(
                not (isinstance(a, ast.Constant) and a.value is None)
                for a in value.args
            )
            if not has_axis and not _comment_ok(
                source_lines, value.lineno, "# replicated-ok:"
            ):
                findings.append(Finding(
                    tables_rel, value.lineno, "missing-partition-spec",
                    f"{cls} leaf {field!r} is declared fully replicated "
                    f"(sh() with no axes) without a `# replicated-ok: "
                    f"<reason>` justification",
                ))
        for kw in call.keywords:
            if kw.arg and kw.arg not in fields:
                findings.append(Finding(
                    tables_rel, kw.value.lineno, "missing-partition-spec",
                    f"{table_fn}() declares a spec for {kw.arg!r}, which is "
                    f"not an array leaf of {cls} — dead table entry",
                ))
    findings.extend(_stale_annotation_findings(tables_rel, source_lines))
    return findings


# -- entry points ------------------------------------------------------------


def check_sharding(
    path: Path,
    source: Optional[str] = None,
    tree: "Optional[ast.AST]" = None,
) -> List[Finding]:
    """Per-file sharding lint (prefix-gated). The partition-spec section
    runs only when the file holds BOTH a state pytree and its sharding
    table (the corpus miniatures); the real split pair is merged by the
    tree-mode check."""
    rel = core.rel(path)
    posix = rel.replace("\\", "/")
    is_stream = any(posix.startswith(p) for p in STREAM_PREFIXES)
    if not is_stream and not any(posix.startswith(p) for p in SHARDING_PREFIXES):
        return []
    src = source if source is not None else path.read_text()
    if tree is None:
        tree = ast.parse(src, filename=str(path))
    aliases = _import_aliases(tree)
    source_lines = src.splitlines()
    findings: List[Finding] = []
    if is_stream:
        # Serving modules get the strict whole-module discipline (every
        # blocking read is a declared boundary) and none of the engine
        # checks — the pipeline is host code in front of the engine.
        _check_stream_host_sync(tree, aliases, rel, source_lines, findings)
        return sorted(set(findings), key=lambda f: (f.lineno, f.check, f.message))
    _check_host_sync(tree, aliases, posix, rel, source_lines, findings)
    _check_dtype_widening(tree, rel, source_lines, findings)
    fields = _pytree_array_fields(tree)
    rules = _partition_rules(tree)
    if fields and rules is not None:
        findings.extend(_rule_findings(
            fields, rules[0], rules[1], rel, source_lines,
            tenant_leaves=_tenant_leaves(tree, source_lines),
        ))
    elif fields and _table_constructor_calls(tree):
        findings.extend(_partition_spec_findings(fields, tree, rel, src))
    return sorted(set(findings), key=lambda f: (f.lineno, f.check, f.message))


def check_partition_specs(
    trees: Sequence[Tuple[ast.AST, str]]
) -> List[Finding]:
    """Tree-mode entry: merge the real state.py/mesh.py pair. Presence-
    gated on both files being part of the sweep (tests retargeting
    ``core.REPO`` at temporary trees skip silently)."""
    state_tree = mesh_tree = None
    for tree, rel in trees:
        posix = rel.replace("\\", "/")
        if posix == STATE_FILE:
            state_tree = tree
        elif posix == MESH_FILE:
            mesh_tree = tree
    if state_tree is None or mesh_tree is None:
        return []
    fields = _pytree_array_fields(state_tree)
    if not fields:
        return []
    mesh_path = core.REPO / MESH_FILE
    mesh_source = mesh_path.read_text()
    rules = _partition_rules(mesh_tree)
    if rules is not None:
        state_source = (core.REPO / STATE_FILE).read_text()
        return _rule_findings(
            fields, rules[0], rules[1], MESH_FILE, mesh_source.splitlines(),
            tenant_leaves=_tenant_leaves(state_tree, state_source.splitlines()),
        )
    return _partition_spec_findings(fields, mesh_tree, MESH_FILE, mesh_source)
