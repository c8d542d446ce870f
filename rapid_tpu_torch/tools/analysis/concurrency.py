"""Check family 5: asyncio concurrency discipline (guarded-by analysis).

The protocol core is serialized by a single ``asyncio.Lock`` "protocol
executor" (``MembershipService._lock``) and the transports by their own
locks; the correctness argument (atomic protocol state transitions feeding
Fast Paxos) rests on that discipline holding everywhere. This analyzer
verifies it statically, per class, over ``rapid_tpu_torch/protocol/`` and
``rapid_tpu_torch/messaging/``:

**Guard model.** A field's guard is learned two ways:

- explicitly, from a ``# guarded-by: <lock>`` comment on (or immediately
  above) the field's initializing assignment, where ``<lock>`` is either a
  same-class ``asyncio.Lock`` attribute or the literal ``event-loop``
  (meaning: protected by cooperative scheduling alone — mutations need no
  lock, but no read→await→write sequence may straddle an await);
- by majority inference: an unannotated field whose mutation sites are
  mostly (>= 2 sites, strictly more than the provably lock-free ones)
  under one ``async with self.<lock>`` is treated as guarded by it.

**Context model (CFG-lite).** Each method gets an entry lock-context via a
fixpoint over the intra-class call graph: public methods and dunders enter
provably lock-free (the event loop calls them directly); ``__init__`` is
single-threaded construction (exempt); a private method inherits the meet
of its intra-class call-site contexts; a method whose reference escapes as
a value (callback registration) — or that is never called intra-class — is
UNKNOWN. Statements inside ``async with self.<lock>`` are lock-held.
Following the staticcheck philosophy (conservative resolution, skip-don't-
guess), a finding is emitted only in *provably* lock-free contexts;
UNKNOWN suppresses, never convicts.

**Checks.**

- ``unguarded-mutation`` — a lock-guarded field mutated (assignment,
  augmented assignment, ``del``, subscript store, or a mutating container
  method call) in a provably lock-free context. A deliberate exception
  carries ``# unguarded-ok: <reason>`` on the line.
- ``interleaving-hazard`` — a guarded field read, then an ``await`` with
  the guard not held across it, then a dependent write: the classic
  check-then-act lost update (two lock acquisitions with an await between,
  or a lock-free ``self.f = await g(self.f)``).
- ``lock-reentrancy`` — ``await self.<m>(...)`` while a lock is held, where
  ``<m>`` (transitively) acquires the same lock: ``asyncio.Lock`` is not
  re-entrant, so this deadlocks the protocol executor.
- ``guarded-by-annotation`` — an annotation that binds to no assignment or
  names an unknown lock (a typo'd annotation must fail the gate, not
  silently guard nothing).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

from . import core
from .core import Finding

_MUTATORS = core.MUTATING_CONTAINER_METHODS

CONCURRENCY_PREFIXES = ("rapid_tpu_torch/protocol/", "rapid_tpu_torch/messaging/")

EVENT_LOOP_GUARD = "event-loop"

_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_-]*)")
_UNGUARDED_OK_RE = re.compile(r"#\s*unguarded-ok\b")

_INIT_METHODS = frozenset({"__init__", "__post_init__"})


class Ctx(NamedTuple):
    """Lock context: ``held`` is the set of self-lock names PROVABLY held;
    ``unknown`` means additional locks may be held (so "lock-free" cannot
    be proven and mutation findings are suppressed)."""

    held: frozenset
    unknown: bool


_FREE = Ctx(frozenset(), False)
_UNKNOWN = Ctx(frozenset(), True)
_INIT = "init"  # sentinel entry context for constructors


def _self_field(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _iter_no_nested(node: ast.AST):
    """Walk a subtree without descending into nested function scopes (their
    bodies execute at an unknowable later time and context)."""
    yield node
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield from _iter_no_nested(child)


def _target_mutations(stmt: ast.AST) -> List[Tuple[str, int]]:
    """(field, lineno) for ``self.<field>`` mutated via the TARGETS of one
    assignment/delete statement (plain, augmented, annotated, tuple,
    subscript-store)."""
    out: List[Tuple[str, int]] = []
    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        if isinstance(stmt, ast.AnnAssign) and stmt.value is None:
            return out  # bare annotation: no assignment happens
        targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
        for target in targets:
            elts = target.elts if isinstance(target, (ast.Tuple, ast.List)) else [target]
            for elt in elts:
                if isinstance(elt, ast.Starred):
                    elt = elt.value
                field = _self_field(elt)
                if field is None and isinstance(elt, ast.Subscript):
                    field = _self_field(elt.value)  # self.f[k] = v
                if field is not None:
                    out.append((field, elt.lineno))
    elif isinstance(stmt, ast.Delete):
        for target in stmt.targets:
            field = _self_field(target)
            if field is None and isinstance(target, ast.Subscript):
                field = _self_field(target.value)  # del self.f[k]
            if field is not None:
                out.append((field, target.lineno))
    return out


def _mutations_in(node: ast.AST) -> List[Tuple[str, int]]:
    """(field, lineno) for every ``self.<field>`` mutation form within
    ``node`` (nested function scopes excluded): assignment targets plus
    mutating container-method calls."""
    out: List[Tuple[str, int]] = []
    for cur in _iter_no_nested(node):
        if isinstance(cur, (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Delete)):
            out.extend(_target_mutations(cur))
        elif isinstance(cur, ast.Call) and isinstance(cur.func, ast.Attribute):
            if cur.func.attr in _MUTATORS:
                field = _self_field(cur.func.value)
                if field is not None:  # self.f.append(...)
                    out.append((field, cur.lineno))
    return out


def _reads_in(node: ast.AST) -> List[Tuple[str, int]]:
    """(field, lineno) for every ``self.<field>`` read (Load) within
    ``node``, plus augmented-assignment targets (read-modify-write)."""
    out: List[Tuple[str, int]] = []
    for cur in _iter_no_nested(node):
        if isinstance(cur, ast.Attribute) and isinstance(cur.ctx, ast.Load):
            field = _self_field(cur)
            if field is not None:
                out.append((field, cur.lineno))
        elif isinstance(cur, ast.AugAssign):
            field = _self_field(cur.target)
            if field is not None:
                out.append((field, cur.lineno))
    return out


def _has_await(node: ast.AST) -> bool:
    return any(isinstance(cur, ast.Await) for cur in _iter_no_nested(node))


class _Site(NamedTuple):
    lineno: int
    ctx: Ctx          # local context within the method (entry not applied)
    nested: bool      # inside a nested function scope


class _MethodEvents(NamedTuple):
    mutations: List[Tuple[str, _Site]]      # field -> site
    calls: List[Tuple[str, _Site]]          # self.<m>() call sites
    awaited_calls: List[Tuple[str, _Site]]  # await self.<m>(...) sites
    acquires: Set[str]                      # locks taken via async with


def _collect_events(method: ast.AST, locks: Set[str], methods: Set[str]) -> _MethodEvents:
    events = _MethodEvents([], [], [], set())

    def visit(node: ast.AST, held: frozenset, unknown: bool, nested: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            if node is not method:
                for child in ast.iter_child_nodes(node):
                    visit(child, held, unknown, True)
                return
        if isinstance(node, ast.AsyncWith):
            new_held = set(held)
            new_unknown = unknown
            for item in node.items:
                lock = _self_field(item.context_expr)
                if lock is not None and lock in locks:
                    new_held.add(lock)
                    if not nested:
                        events.acquires.add(lock)
                else:
                    # async with over something we can't prove is (not) a
                    # self-lock: anything may be held inside.
                    new_unknown = True
            for item in node.items:
                visit(item, held, unknown, nested)
            for child in node.body:
                visit(child, frozenset(new_held), new_unknown, nested)
            return
        ctx = Ctx(held, unknown)
        if isinstance(node, ast.Await) and isinstance(node.value, ast.Call):
            callee = _self_field(node.value.func)
            if callee is not None and callee in methods:
                events.awaited_calls.append((callee, _Site(node.lineno, ctx, nested)))
        if isinstance(node, ast.Call):
            callee = _self_field(node.func)
            if callee is not None and callee in methods:
                events.calls.append((callee, _Site(node.lineno, ctx, nested)))
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Delete)):
            # Targets only here: mutator CALLS inside the value expression
            # are recorded exactly once by the Call branch during descent.
            for field, lineno in _target_mutations(node):
                events.mutations.append((field, _Site(lineno, ctx, nested)))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATORS:
                field = _self_field(node.func.value)
                if field is not None:
                    events.mutations.append((field, _Site(node.lineno, ctx, nested)))
        for child in ast.iter_child_nodes(node):
            visit(child, held, unknown, nested)

    for child in ast.iter_child_nodes(method):
        visit(child, frozenset(), False, False)
    return events


def _escaped_methods(class_node: ast.ClassDef, methods: Set[str]) -> Set[str]:
    """Methods referenced as VALUES (``self.m`` not immediately called):
    callback registrations make their execution context unknowable."""
    escaped: Set[str] = set()

    def visit(node: ast.AST, call_func: Optional[ast.AST]) -> None:
        if isinstance(node, ast.Attribute) and node is not call_func:
            field = _self_field(node)
            if field in methods and isinstance(node.ctx, ast.Load):
                escaped.add(field)
        next_call_func = node.func if isinstance(node, ast.Call) else None
        for child in ast.iter_child_nodes(node):
            visit(child, next_call_func if child is next_call_func else None)

    visit(class_node, None)
    return escaped


def _meet(ctxs: List[Ctx]) -> Ctx:
    held = frozenset.intersection(*[c.held for c in ctxs])
    disagree = any(c.held != ctxs[0].held for c in ctxs)
    return Ctx(held, any(c.unknown for c in ctxs) or disagree)


def _combine(entry, local: _Site):
    """Absolute context of a site = method entry context + local regions."""
    if entry == _INIT:
        return _INIT if not local.nested else _UNKNOWN
    if local.nested:
        return _UNKNOWN
    return Ctx(entry.held | local.ctx.held, entry.unknown or local.ctx.unknown)


class _ClassAnalysis:
    def __init__(self, node: ast.ClassDef, rel: str, lines: List[str]) -> None:
        self.node = node
        self.rel = rel
        self.lines = lines
        self.findings: List[Finding] = []
        self.methods: Dict[str, ast.AST] = {
            stmt.name: stmt
            for stmt in node.body
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.locks = self._find_locks()
        self.guards = self._parse_annotations()  # field -> lock | event-loop
        self.events = {
            name: _collect_events(m, self.locks, set(self.methods))
            for name, m in self.methods.items()
        }
        self.entries = self._entry_contexts()
        self._infer_guards()

    # -- learning ------------------------------------------------------

    def _find_locks(self) -> Set[str]:
        locks: Set[str] = set()
        for cur in ast.walk(self.node):
            if isinstance(cur, ast.Assign) and isinstance(cur.value, ast.Call):
                func = cur.value.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr == "Lock"
                    and isinstance(func.value, ast.Name)
                    and func.value.id == "asyncio"
                ):
                    for target in cur.targets:
                        field = _self_field(target)
                        if field is not None:
                            locks.add(field)
        return locks

    def _parse_annotations(self) -> Dict[str, str]:
        # Field assignments by line range, for binding comments to fields.
        spans: List[Tuple[int, int, str]] = []
        for cur in ast.walk(self.node):
            if isinstance(cur, (ast.Assign, ast.AnnAssign)):
                targets = cur.targets if isinstance(cur, ast.Assign) else [cur.target]
                for target in targets:
                    field = _self_field(target)
                    if field is not None:
                        spans.append((cur.lineno, cur.end_lineno or cur.lineno, field))
        guards: Dict[str, str] = {}
        end = self.node.end_lineno or self.node.lineno
        for lineno in range(self.node.lineno, min(end, len(self.lines)) + 1):
            match = _GUARDED_BY_RE.search(self.lines[lineno - 1])
            if not match:
                continue
            lock = match.group(1)
            field = next(
                (f for lo, hi, f in spans if lo <= lineno <= hi), None
            ) or next(
                # comment-above form: binds to the statement starting next line
                (f for lo, hi, f in spans if lo == lineno + 1), None
            )
            if field is None:
                self.findings.append(
                    Finding(self.rel, lineno, "guarded-by-annotation",
                            "guarded-by comment binds to no self-attribute "
                            "assignment on (or below) this line")
                )
                continue
            if lock != EVENT_LOOP_GUARD and lock not in self.locks:
                self.findings.append(
                    Finding(self.rel, lineno, "guarded-by-annotation",
                            f"guarded-by names {lock!r}, which is not an "
                            f"asyncio.Lock attribute of {self.node.name} "
                            f"(known: {sorted(self.locks) or 'none'}, or "
                            f"{EVENT_LOOP_GUARD!r})")
                )
                continue
            guards[field] = lock
        return guards

    def _entry_contexts(self) -> Dict[str, object]:
        escaped = _escaped_methods(self.node, set(self.methods))
        call_sites: Dict[str, List[Tuple[str, _Site]]] = {m: [] for m in self.methods}
        for caller, events in self.events.items():
            for callee, site in events.calls:
                call_sites[callee].append((caller, site))
        entries: Dict[str, object] = {}
        for name in self.methods:
            if name in _INIT_METHODS:
                entries[name] = _INIT
            elif not name.startswith("_") or (
                name.startswith("__") and name.endswith("__")
            ):
                # Public methods and protocol dunders: the event loop (or
                # application code) calls them directly, holding nothing.
                entries[name] = _FREE
            elif name in escaped or not call_sites[name]:
                entries[name] = _UNKNOWN
        # Fixpoint over the remaining (private, intra-class-called) methods.
        for _ in range(len(self.methods) + 1):
            progressed = False
            for name in self.methods:
                if name in entries:
                    continue
                sites = call_sites[name]
                if any(caller not in entries for caller, _ in sites):
                    continue
                ctxs = [_combine(entries[caller], site) for caller, site in sites]
                non_init = [c for c in ctxs if c != _INIT]
                entries[name] = _meet(non_init) if non_init else _INIT
                progressed = True
            if not progressed:
                break
        for name in self.methods:
            entries.setdefault(name, _UNKNOWN)  # call-graph cycles
        return entries

    def _infer_guards(self) -> None:
        """Majority inference for unannotated fields: mostly-locked mutation
        patterns imply the discipline; the outliers are the findings."""
        if not self.locks:
            return
        per_field: Dict[str, Dict[str, int]] = {}
        free_count: Dict[str, int] = {}
        for name, events in self.events.items():
            for field, site in events.mutations:
                if field in self.guards:
                    continue
                ctx = _combine(self.entries[name], site)
                if ctx == _INIT or ctx == _UNKNOWN:
                    continue
                if ctx.held:
                    for lock in ctx.held:
                        per_field.setdefault(field, {}).setdefault(lock, 0)
                        per_field[field][lock] += 1
                elif not ctx.unknown:
                    free_count[field] = free_count.get(field, 0) + 1
        for field, by_lock in per_field.items():
            best = max(by_lock, key=by_lock.get)
            ties = [k for k, v in by_lock.items() if v == by_lock[best]]
            if len(ties) > 1:
                continue
            if by_lock[best] >= 2 and by_lock[best] > free_count.get(field, 0):
                self.guards[field] = best

    # -- checks --------------------------------------------------------

    def _allowlisted(self, lineno: int) -> bool:
        line = self.lines[lineno - 1] if 0 < lineno <= len(self.lines) else ""
        return bool(_UNGUARDED_OK_RE.search(line))

    def check_mutations(self) -> None:
        for name, events in self.events.items():
            for field, site in events.mutations:
                guard = self.guards.get(field)
                if guard is None or guard == EVENT_LOOP_GUARD:
                    continue
                ctx = _combine(self.entries[name], site)
                if ctx == _INIT or ctx == _UNKNOWN:
                    continue
                if guard in ctx.held or ctx.unknown:
                    continue
                if self._allowlisted(site.lineno):
                    continue
                self.findings.append(
                    Finding(self.rel, site.lineno, "unguarded-mutation",
                            f"{self.node.name}.{field} is guarded by "
                            f"{guard!r} but mutated here (in {name!r}) in a "
                            "provably lock-free context")
                )

    def check_reentrancy(self) -> None:
        may_acquire: Dict[str, Set[str]] = {
            name: set(events.acquires) for name, events in self.events.items()
        }
        for _ in range(len(self.methods)):
            changed = False
            for name, events in self.events.items():
                for callee, _site in events.awaited_calls:
                    extra = may_acquire.get(callee, set()) - may_acquire[name]
                    if extra:
                        may_acquire[name] |= extra
                        changed = True
            if not changed:
                break
        for name, events in self.events.items():
            entry = self.entries[name]
            entry_held = entry.held if isinstance(entry, Ctx) else frozenset()
            for callee, site in events.awaited_calls:
                if site.nested:
                    continue
                held = entry_held | site.ctx.held
                overlap = held & may_acquire.get(callee, set())
                if overlap:
                    lock = sorted(overlap)[0]
                    self.findings.append(
                        Finding(self.rel, site.lineno, "lock-reentrancy",
                                f"awaiting self.{callee}() while holding "
                                f"{lock!r}, which {callee!r} also acquires — "
                                "asyncio.Lock is not re-entrant; this "
                                "deadlocks")
                    )

    def check_interleaving(self) -> None:
        guarded = set(self.guards)
        if not guarded:
            return
        for name, method in self.methods.items():
            if not isinstance(method, ast.AsyncFunctionDef):
                continue
            if self.entries[name] != _FREE:
                # Entered with a lock (or unknowably): the caller's critical
                # section spans the awaits, so sequencing is its concern.
                continue
            flagged: set = set()
            for field in guarded:
                self._scan_field(
                    method.body, field, self.guards[field],
                    {"read": None, "hazard": None}, flagged,
                )

    def _flag_hazard(self, field: str, lineno: int, flagged: set) -> None:
        if (field, lineno) in flagged:
            return
        flagged.add((field, lineno))
        self.findings.append(
            Finding(self.rel, lineno, "interleaving-hazard",
                    f"{self.node.name}.{field} read before an await and "
                    "written after it without the guard held across — the "
                    "state can change during the await (lost update)")
        )

    def _shields(self, stmt: ast.AST, guard: str) -> bool:
        """Does this ``async with`` hold the FIELD'S OWN guard across its
        body? Only then do its internal awaits stop being hazards — an
        unrelated context manager (a timeout, another lock) yields to the
        event loop just the same. Event-loop-guarded fields have no lock
        that can shield them by definition."""
        if guard == EVENT_LOOP_GUARD or not isinstance(stmt, ast.AsyncWith):
            return False
        return any(
            _self_field(item.context_expr) == guard for item in stmt.items
        )

    def _expr_step(
        self, expr: ast.AST, field: str, state: dict, flagged: set,
        implicit_await: bool = False,
    ) -> None:
        """Advance the scan state over one straight-line expression/statement
        summary: flag pending hazards its writes consume, record its reads,
        and mark an awaited yield point after a live read."""
        reads = [ln for f, ln in _reads_in(expr) if f == field]
        writes = [ln for f, ln in _mutations_in(expr) if f == field]
        has_await = implicit_await or _has_await(expr)
        if has_await and reads and writes:
            # Same-statement hazard: self.f = await g(self.f) — the value
            # is read, the await yields, the store lands late.
            for lineno in writes:
                self._flag_hazard(field, lineno, flagged)
        for lineno in writes:
            if state["hazard"] is not None:
                self._flag_hazard(field, lineno, flagged)
        if reads:
            state["read"] = reads[-1]
        if has_await and state["read"] is not None:
            state["hazard"] = getattr(expr, "lineno", state["read"])

    def _scan_field(
        self, stmts, field: str, guard: str, state: dict, flagged: set
    ) -> None:
        """CFG-lite straight-line scan for ONE guarded field: sibling
        statements execute in order; ``if``/``while`` tests and ``for``
        iterables are straight-line with their siblings (the check-then-act
        read lives in the test), while branch/loop BODIES are scanned
        internally but stay opaque to the parent (a branch-resident read or
        await never convicts a sibling — skip-don't-guess)."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.AsyncWith, ast.With)):
                if self._shields(stmt, guard):
                    # The field's own lock is held across the body: internal
                    # awaits are not hazards — but state read here can still
                    # be stale-written in a LATER epoch, and writes here
                    # consume earlier hazards.
                    for lineno in (ln for f, ln in _mutations_in(stmt) if f == field):
                        if state["hazard"] is not None:
                            self._flag_hazard(field, lineno, flagged)
                    reads = [ln for f, ln in _reads_in(stmt) if f == field]
                    if reads:
                        state["read"] = reads[-1]
                else:
                    # Unrelated context manager: transparent. Entering an
                    # async with awaits __aenter__ — a yield point itself.
                    for item in stmt.items:
                        self._expr_step(
                            item.context_expr, field, state, flagged,
                            implicit_await=isinstance(stmt, ast.AsyncWith),
                        )
                    self._scan_field(stmt.body, field, guard, state, flagged)
                continue
            if isinstance(stmt, ast.Try):
                # try bodies execute unconditionally: scan inline (shared
                # state); handlers/orelse are conditional: fresh scans.
                self._scan_field(stmt.body, field, guard, state, flagged)
                for handler in stmt.handlers:
                    self._scan_field(
                        handler.body, field, guard,
                        {"read": None, "hazard": None}, flagged,
                    )
                self._scan_field(
                    stmt.orelse, field, guard,
                    {"read": None, "hazard": None}, flagged,
                )
                self._scan_field(stmt.finalbody, field, guard, state, flagged)
                continue
            header = None
            implicit_await = False
            if isinstance(stmt, (ast.If, ast.While)):
                header = stmt.test
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                header = stmt.iter
                # async-for awaits __anext__ between header and each body run
                implicit_await = isinstance(stmt, ast.AsyncFor)
            elif isinstance(stmt, ast.Match):
                header = stmt.subject
            if header is not None:
                self._expr_step(header, field, state, flagged, implicit_await)
                blocks = (
                    [case.body for case in stmt.cases]
                    if isinstance(stmt, ast.Match)
                    else [stmt.body, stmt.orelse]
                )
                for block in blocks:
                    self._scan_field(
                        block, field, guard,
                        {"read": None, "hazard": None}, flagged,
                    )
                continue
            self._expr_step(stmt, field, state, flagged)


def check_concurrency(
    path: Path,
    source: Optional[str] = None,
    tree: "Optional[ast.AST]" = None,
) -> List[Finding]:
    rel = core.rel(path)
    posix = rel.replace("\\", "/")
    if not any(posix.startswith(p) for p in CONCURRENCY_PREFIXES):
        return []
    src = source if source is not None else path.read_text()
    if tree is None:
        tree = ast.parse(src, filename=str(path))
    lines = src.splitlines()
    findings: List[Finding] = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            analysis = _ClassAnalysis(node, rel, lines)
            analysis.check_mutations()
            analysis.check_reentrancy()
            analysis.check_interleaving()
            findings.extend(analysis.findings)
    return sorted(set(findings), key=lambda f: (f.lineno, f.check, f.message))
