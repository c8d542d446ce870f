"""Driver, Finding model, and CLI of the port's static-analysis tier.

The port's counterpart of the JAX package's ``tools/analysis/core.py``,
pointed at the port's own source: the roots are ``rapid_tpu_torch``, the
port's tests (``tests/test_torch_*.py`` and their job helper
``tests/torch_mesh_jobs.py``), ``chip_smoke.py`` and ``mesh_smoke.py``.
The per-check modules each export a ``check_*`` function over one parsed
file; this module owns everything shared: the ``Finding`` record, the root
list (a root may be a glob pattern; one that matches nothing fails like a
missing root), file iteration (with the fixture-corpus exclusion), the
``run()`` driver that parses each file once and fans it out to every check,
and the CLI (``--json``/``--select``/``--ignore``/``--families`` and the
lock regenerators).

``REPO`` is read through this module at call time (``core.REPO``), never
imported by value, so tests can retarget the whole analysis at a temporary
tree with one monkeypatch.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
import types
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

REPO = Path(__file__).resolve().parent.parent.parent.parent

DEFAULT_ROOTS = (
    "rapid_tpu_torch",
    "tests/test_torch_*.py",
    "tests/torch_mesh_jobs.py",
    "chip_smoke.py",
    "mesh_smoke.py",
)

#: Subtrees holding fixture DATA, not code under analysis: the seeded lint
#: corpus (tests/data/lint_corpus/) exists to be defective, so sweeping it
#: into the gate would fail the build on purpose-built defects. Explicit
#: file roots bypass this (naming a corpus file on the CLI analyzes it).
EXCLUDED_SUBTREES = ("tests/data/",)

#: Mutating methods of the stdlib containers shared state lives in (the
#: concurrency analyzer's guarded-field mutation sites).
MUTATING_CONTAINER_METHODS = frozenset({
    "append", "extend", "insert", "add", "discard", "remove", "pop",
    "popitem", "clear", "update", "setdefault", "move_to_end", "appendleft",
    "popleft", "sort", "reverse",
})

#: Every check name any analyzer can emit — the vocabulary ``--select`` /
#: ``--ignore`` validate against (a typo'd filter must error, not silently
#: select nothing and report a green build).
ALL_CHECK_NAMES = frozenset({
    "syntax-error",
    "star-import",
    "undefined-name",
    "call-signature",
    "missing-attribute",
    "import-error",
    "clock-injection",
    "dead-definition",
    "guarded-by-annotation",
    "unguarded-mutation",
    "interleaving-hazard",
    "lock-reentrancy",
    # wire_schema family
    "missing-tag",
    "missing-encode-arm",
    "missing-decode-arm",
    "tag-reuse",
    "dead-arm",
    "field-number-drift",
    "wire-lock-drift",
    # dispatch family
    "unreachable-dispatch-arm",
    "shadowed-arm",
    "dispatch-return",
    # taskflow family
    "leaked-task",
    "swallowed-exception",
    "cancellation-swallow",
    "unawaited-coroutine",
    # determinism family
    "unseeded-random",
    # ledger family
    "ledger-event-name",
    "ledger-stage-name",
    # telemetry family
    "telemetry-lane-drift",
    "telemetry-unmarked-fetch",
    # sharding family
    "missing-partition-spec",
    "host-sync-in-hot-path",
    "host-sync-in-stream",
    "dtype-widening",
    # chaosvocab family
    "chaos-unknown-kind",
    "chaos-family-drift",
    # sync_safety family (the counterpart of JAX's trace_safety)
    "uncounted-host-read",
    "index-store-sync",
    "pageable-upload",
    "implicit-device",
    # device_program family (program facts vs program.lock.json)
    "program-collective-budget",
    "program-transfer-budget",
    "program-op-budget",
    "program-lanes-in-place",
    "program-memory-budget",
    "program-cross-tenant-collective",
    "program-quiescent-activity",
    "program-trace-cursor",
    "program-lock-drift",
    # cost_model family (fitted scaling classes vs cost.lock.json)
    "cost-unexplained",
    "cost-scaling-regression",
    "cost-superlinear",
    "cost-quiescent",
    "cost-lock-drift",
    # dataflow family (lane provenance vs dataflow.lock.json)
    "dataflow-observer-effect",
    "dataflow-cross-tenant",
    "dataflow-dense-op",
    "dataflow-dead-lane",
    "dataflow-lock-drift",
})

#: The check families, in documentation order — one (name, description)
#: per analyzer module, listed by ``staticcheck --families``.
FAMILIES = (
    ("names", "undefined names and star imports (symtable scope resolution)"),
    ("signatures", "call-site conformance against the real runtime callees"),
    ("deadcode", "tree-wide liveness of module-level definitions"),
    ("clocks", "clock-injection discipline: no wall-clock reads in "
               "protocol/monitoring/serving"),
    ("concurrency", "asyncio guarded-by discipline, interleaving hazards, "
                    "lock re-entrancy"),
    ("taskflow", "async failure paths: leaked tasks, swallowed exceptions, "
                 "cancellation, unawaited coroutines"),
    ("determinism", "no unseeded randomness in the library: simulated runs "
                    "are pure functions of their seed"),
    ("dispatch", "RapidRequest dispatch exhaustiveness, shadowed arms, "
                 "response return types"),
    ("wire_schema", "wire mirrors (types/codec/proto) cross-checked and "
                    "frozen in wire.lock.json"),
    ("ledger", "run-ledger vocabulary discipline: emit() events from "
               "LedgerEvent, stage() names from STAGE_NAMES"),
    ("chaosvocab", "chaos vocabulary discipline: FaultEvent kinds, scenario "
                   "FAMILIES, fleet mix tables, and the chaosrun CLI cannot "
                   "drift from the registered registries"),
    ("telemetry", "telemetry plane discipline: the TelemetryLanes / "
                  "TraceRing field sets mirrored into the analyzer, and "
                  "every host fetch of the lanes annotated as a declared "
                  "sync boundary (# telemetry-fetch-ok:)"),
    ("sharding", "partition-rule coverage of the state lanes, "
                 "dtype-widening on policy-narrowed lanes, and torch host "
                 "syncs in the hot set and the streaming pipeline "
                 "(# host-sync-ok:)"),
    ("sync_safety", "the trace_safety counterpart for eager torch: blocking "
                    "reads outside _host.read, stores through advanced "
                    "indexing, pageable uploads, tensors built with no "
                    "device (ops/models/tenancy/parallel/serving)"),
    ("device_program", "program facts of the 13 registered engine entry "
                       "points (aten ops, host reads/uploads/bytes, "
                       "collectives, lane bytes, lanes in place, the "
                       "telemetry and trace blocks) frozen in "
                       "program.lock.json"),
    ("cost_model", "scaling-law cost model: the registered entry points' "
                   "facts (lane bytes, bytes touched and allocated, aten "
                   "ops, host reads/uploads, delivery calls, collectives) "
                   "fitted across N/K/tenant geometry ladders to "
                   "O(1)/O(log N)/O(N)/O(N*K)/O(N^2) classes and frozen in "
                   "cost.lock.json with the quiescent round's cost"),
    ("dataflow", "dataflow provenance: per-storage taint over a dispatch "
                 "trace of every entry point (data and host-read control "
                 "edges), proving observer silence and fleet tenant "
                 "isolation, plus the sparse-opportunity map of mask-gated "
                 "dense operators of a quiescent round priced against the "
                 "cost lock, frozen in dataflow.lock.json"),
)


def union_member_names(value: "ast.AST") -> "Optional[List[str]]":
    """The member names of a ``Union[A, B, ...]`` annotation/value node, or
    None if the node is not a plain-Name Union subscript. Shared by the
    wire_schema and dispatch families so the two can never disagree about
    what counts as a union member (e.g. if types.py ever moves to PEP 604
    ``A | B`` spellings, both learn it in one place)."""
    if not (
        isinstance(value, ast.Subscript)
        and isinstance(value.value, ast.Name)
        and value.value.id == "Union"
    ):
        return None
    elts = value.slice.elts if isinstance(value.slice, ast.Tuple) else [value.slice]
    members = [e.id for e in elts if isinstance(e, ast.Name)]
    return members or None


@dataclass(frozen=True)
class Finding:
    path: str
    lineno: int
    check: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.lineno}: [{self.check}] {self.message}"

    def to_json(self) -> str:
        return json.dumps(
            {"path": self.path, "lineno": self.lineno, "check": self.check,
             "message": self.message}
        )


def rel(path: Path) -> str:
    try:
        return str(path.resolve().relative_to(REPO))
    except ValueError:
        return str(path)


def iter_files(roots: Sequence[str] = DEFAULT_ROOTS) -> Iterable[Path]:
    for root in roots:
        if any(ch in root for ch in "*?["):
            # A glob root (``tests/test_torch_*.py``): its matches are
            # explicit files, and a pattern matching nothing fails like a
            # missing root.
            base = REPO if not Path(root).is_absolute() else Path("/")
            matches = sorted(base.glob(root.lstrip("/")))
            if not matches:
                raise FileNotFoundError(f"staticcheck root matches nothing: {root}")
            yield from (m for m in matches if m.suffix == ".py")
            continue
        path = (REPO / root) if not Path(root).is_absolute() else Path(root)
        if path.is_file():
            yield path  # explicit file roots are never excluded
        elif path.is_dir():
            for sub in sorted(path.rglob("*.py")):
                posix = rel(sub).replace("\\", "/")
                if any(posix.startswith(ex) for ex in EXCLUDED_SUBTREES):
                    continue
                yield sub
        else:
            # A typo'd or since-renamed root must fail the gate, not
            # silently exempt that tree from analysis.
            raise FileNotFoundError(f"staticcheck root does not exist: {path}")


def run(roots: Sequence[str] = DEFAULT_ROOTS) -> List[Finding]:
    # The per-file check imports live here (not module top level) so the
    # CLI shim can import this module before sys.path is fully arranged.
    from . import (
        chaosvocab, clocks, concurrency, cost_model, dataflow, deadcode, determinism,
        device_program, dispatch, ledger, names, sharding, signatures, sync_safety,
        taskflow, telemetry, wire_schema,
    )

    per_file_checks = [
        names.check_undefined_names,
        signatures.check_call_signatures,
        clocks.check_clock_injection,
        concurrency.check_concurrency,
        sync_safety.check_sync_safety,
        dispatch.check_dispatch,
        taskflow.check_taskflow,
        determinism.check_determinism,
        ledger.check_ledger,
        telemetry.check_telemetry,
        sharding.check_sharding,
        chaosvocab.check_chaosvocab,
    ]
    full_tree = tuple(roots) == DEFAULT_ROOTS
    if not full_tree:
        # Narrowed invocations still get the intra-file wire checks (tag
        # reuse, dead arms, proto number reuse — presence-gated, so real
        # mirror files analyzed alone are silent). Full sweeps instead run
        # the merged three-file check below, which subsumes these; running
        # both would double-report any intra-file defect.
        per_file_checks.append(wire_schema.check_wire_schema)
    # Mirror pytest's rootdir behavior: test modules import suite-local
    # helpers both as `tests.helpers` and bare `helpers`. Insert at the
    # FRONT: `tools`/`tests` are common top-level names, and a foreign
    # package earlier on sys.path would shadow this repo's namespace
    # packages and produce spurious import-error findings.
    for entry in (str(REPO), str(REPO / "tests")):
        if entry in sys.path:
            sys.path.remove(entry)
        sys.path.insert(0, entry)
    _bind_tests_package()
    findings: List[Finding] = []
    trees: List[Tuple[ast.AST, str]] = []  # one parse per file, shared
    for path in iter_files(roots):
        src = path.read_text()
        try:
            tree = ast.parse(src, filename=str(path))
        except SyntaxError as exc:
            # One broken file must not abort the whole gate: report it as a
            # finding and keep analyzing the rest of the tree.
            findings.append(
                Finding(rel(path), exc.lineno or 1, "syntax-error",
                        f"cannot parse: {exc.msg}")
            )
            continue
        trees.append((tree, rel(path)))
        for check in per_file_checks:
            findings.extend(check(path, src, tree))
    if full_tree:
        # Liveness is only meaningful over the FULL tree: with narrowed CLI
        # roots, code consumed from outside the subset would be reported as
        # dead — so the check runs only on complete invocations. The wire
        # lockfile gate is likewise whole-surface: it merges the three
        # mirror files, which a narrowed root set may not all contain.
        findings.extend(deadcode.check_dead_definitions(trees))
        findings.extend(wire_schema.check_wire_lock(trees))
        # The merged partition-rule gate, the lane mirrors and the program
        # lock are whole-surface too: each presence-gates on the port's
        # real engine files, so retargeted test trees skip them (and never
        # pay the device_program family's collection).
        findings.extend(sharding.check_partition_specs(trees))
        findings.extend(telemetry.check_lane_mirror(trees))
        findings.extend(device_program.check_program_lock(trees))
        # The cost ladder's base point and the dataflow map's prices reuse
        # the program facts just collected (same process, same cache).
        findings.extend(cost_model.check_cost_lock(trees))
        findings.extend(dataflow.check_dataflow_lock(trees))
    return findings


def _bind_tests_package() -> None:
    """Make ``tests`` the repo's test directory, as pytest's rootdir does.
    The directory is a namespace package, and a regular package named
    ``tests`` anywhere on ``sys.path`` wins over a namespace portion (some
    installed distributions ship one); test modules that import
    ``tests.<module>`` would then fail as import errors that are not
    theirs."""
    tests_dir = REPO / "tests"
    if not tests_dir.is_dir() or (tests_dir / "__init__.py").exists():
        return
    current = sys.modules.get("tests")
    if current is not None and str(tests_dir) in list(getattr(current, "__path__", [])):
        return
    module = types.ModuleType("tests")
    module.__path__ = [str(tests_dir)]
    sys.modules["tests"] = module


def _check_name_set(parser: argparse.ArgumentParser, spec: str, flag: str) -> set:
    names = {n.strip() for n in spec.split(",") if n.strip()}
    unknown = names - ALL_CHECK_NAMES
    if unknown:
        parser.error(
            f"{flag}: unknown check name(s) {sorted(unknown)}; "
            f"valid: {', '.join(sorted(ALL_CHECK_NAMES))}"
        )
    return names


def _update(what: str, update) -> int:
    findings, lock_path = update()
    if findings:
        for f in findings:
            print(f)
        print(f"staticcheck: refusing to lock {what} the gate would "
              f"immediately fail — fix the findings above first")
        return 1
    print(f"wrote {lock_path}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="staticcheck",
        description="The port's static-analysis tier (see "
                    "rapid_tpu_torch/tools/analysis/).",
    )
    parser.add_argument("roots", nargs="*", help="files/dirs (default: the port's tree)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="one JSON object per finding per line")
    parser.add_argument("--select", default=None, metavar="CHECKS",
                        help="comma-separated check names to keep")
    parser.add_argument("--ignore", default=None, metavar="CHECKS",
                        help="comma-separated check names to drop")
    parser.add_argument("--families", action="store_true",
                        help="list the registered check families and exit")
    parser.add_argument("--update-wire-lock", action="store_true",
                        dest="update_wire_lock",
                        help="regenerate rapid_tpu_torch/tools/analysis/"
                             "wire.lock.json from the live schema mirrors "
                             "(refuses while the mirrors disagree with each "
                             "other)")
    parser.add_argument("--update-program-lock", action="store_true",
                        dest="update_program_lock",
                        help="rerun the registered engine entry points on the "
                             "CPU and regenerate rapid_tpu_torch/tools/"
                             "analysis/program.lock.json (refuses while the "
                             "wide/compact or trace-off/on differential "
                             "disagrees, a fleet collective crosses tenants, "
                             "or the quiescent soak counts activity)")
    parser.add_argument("--update-cost-lock", action="store_true",
                        dest="update_cost_lock",
                        help="rerun the cost ladder on the CPU and regenerate "
                             "rapid_tpu_torch/tools/analysis/cost.lock.json "
                             "(refuses while a fit is unexplained, a fact "
                             "exceeds its ceiling, or a differential disagrees)")
    parser.add_argument("--update-dataflow-lock", action="store_true",
                        dest="update_dataflow_lock",
                        help="retrace the entry points on the CPU and regenerate "
                             "rapid_tpu_torch/tools/analysis/dataflow.lock.json "
                             "(refuses while an observer or tenant proof fails, "
                             "a lane is dead, or the map's totals disagree with "
                             "the cost lock)")
    args = parser.parse_args(argv)
    if args.families:
        for name, description in FAMILIES:
            print(f"{name:<14} {description}")
        return 0
    if args.update_wire_lock:
        from . import wire_schema

        return _update("an inconsistent wire surface", wire_schema.update_wire_lock)
    if args.update_program_lock:
        from . import device_program

        return _update("a program-facts surface", device_program.update_program_lock)
    if args.update_cost_lock:
        from . import cost_model

        return _update("a scaling surface", cost_model.update_cost_lock)
    if args.update_dataflow_lock:
        from . import dataflow

        return _update("a provenance surface", dataflow.update_dataflow_lock)
    findings = run(args.roots or DEFAULT_ROOTS)
    if args.select:
        keep = _check_name_set(parser, args.select, "--select")
        findings = [f for f in findings if f.check in keep]
    if args.ignore:
        drop = _check_name_set(parser, args.ignore, "--ignore")
        findings = [f for f in findings if f.check not in drop]
    if args.as_json:
        for f in findings:
            print(f.to_json())
    else:
        for f in findings:
            print(f)
        print(f"staticcheck: {len(findings)} finding(s)")
    return 1 if findings else 0
