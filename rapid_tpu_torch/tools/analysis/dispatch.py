"""Check family 8: RapidRequest dispatch exhaustiveness.

The fourth hand-kept mirror of the wire schema is the service's dispatch
chain: ``MembershipService.handle_message`` routes every ``RapidRequest``
union member through an ``isinstance`` ladder (the analog of the
reference's protobuf ``oneof`` switch, ``MembershipService.java:174-196``).
Nothing but this analyzer keeps the ladder in sync with the union — a new
message type that never reaches a handler falls through to the trailing
``TypeError`` at runtime, on a peer's schedule, not at build time.

Checks, over any ``rapid_tpu_torch/protocol/`` class defining ``handle_message``:

- ``unreachable-dispatch-arm`` — a request-union member no arm matches
  (tuple aliases like ``CONSENSUS_TYPES`` are resolved through module
  assignments). Exhaustiveness is demanded only of ``async def``
  dispatchers — the transport-facing entry points a ``MessagingServer``
  forwards into; sync sub-dispatchers (``FastPaxos.handle_message``
  routes just the five consensus types behind a trailing ``raise``) are
  partial by design. Members handled by an outer layer on purpose are
  declared with a ``# dispatched-elsewhere: Name`` comment, validated
  against the union so a typo'd or stale exemption fails the gate.
- ``shadowed-arm`` — an arm whose every type was already matched by an
  earlier arm (an exact duplicate, or an earlier ``isinstance`` of a
  superclass): the body is dead code.
- ``dispatch-return`` — an arm resolvably returns something that is not a
  ``RapidResponse`` member. Resolution is conservative (skip-don't-guess):
  direct constructor calls and ``self._helper(...)`` calls are followed
  (through the helper's return annotation, or one level into its return
  statements); awaits, bare names, and foreign calls are left unjudged.

The unions come from the module itself when it defines them (the lint
corpus keeps miniatures in one file), else from ``rapid_tpu_torch/types.py``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import core
from .core import Finding

#: The tree this family applies to (posix-style relative prefixes).
DISPATCH_PREFIXES = ("rapid_tpu_torch/protocol/",)

_TYPES_REL = "rapid_tpu_torch/types.py"

_ELSEWHERE_RE = re.compile(
    r"#\s*dispatched-elsewhere:\s*([A-Za-z_][A-Za-z0-9_]*"
    r"(?:\s*,\s*[A-Za-z_][A-Za-z0-9_]*)*)"
)


def _union_from_module(tree: ast.AST, name: str) -> Optional[List[str]]:
    for node in ast.walk(tree):
        targets: List[str] = []
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            targets = [node.target.id]
        if name not in targets or node.value is None:
            continue
        members = core.union_member_names(node.value)
        if members:
            return members
    return None


def _load_unions(tree: ast.AST) -> Tuple[Optional[List[str]], Optional[List[str]], Optional[ast.AST]]:
    """(request union, response union, the tree they came from). Prefers the
    module's own definitions; falls back to rapid_tpu_torch/types.py."""
    req = _union_from_module(tree, "RapidRequest")
    resp = _union_from_module(tree, "RapidResponse")
    if req is not None and resp is not None:
        return req, resp, tree
    types_path = core.REPO / _TYPES_REL
    if not types_path.exists():
        return req, resp, None
    try:
        types_tree = ast.parse(types_path.read_text(), filename=str(types_path))
    except SyntaxError:
        return req, resp, None  # its own syntax-error finding covers this
    if req is None:
        req = _union_from_module(types_tree, "RapidRequest")
    if resp is None:
        resp = _union_from_module(types_tree, "RapidResponse")
    return req, resp, types_tree


def _tuple_aliases(tree: ast.AST) -> Dict[str, List[str]]:
    """Module-level ``NAME = (TypeA, TypeB, ...)`` assignments — the
    CONSENSUS_TYPES idiom the isinstance arms dispatch through."""
    aliases: Dict[str, List[str]] = {}
    for node in getattr(tree, "body", []):
        value = target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
            node.targets[0], ast.Name
        ):
            target, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            target, value = node.target.id, node.value
        if (
            target is not None
            and isinstance(value, ast.Tuple)
            and value.elts
            and all(isinstance(e, ast.Name) for e in value.elts)
        ):
            aliases[target] = [e.id for e in value.elts]
    return aliases


def _ancestors(class_defs: Dict[str, ast.ClassDef]) -> Dict[str, Set[str]]:
    """name -> transitive base-class names (Name bases only)."""
    direct = {
        name: {b.id for b in node.bases if isinstance(b, ast.Name)}
        for name, node in class_defs.items()
    }
    out: Dict[str, Set[str]] = {}

    def resolve(name: str, seen: Set[str]) -> Set[str]:
        if name in out:
            return out[name]
        if name in seen:
            return set()  # inheritance cycle: malformed input, stop
        seen.add(name)
        acc: Set[str] = set()
        for base in direct.get(name, ()):
            acc.add(base)
            acc |= resolve(base, seen)
        out[name] = acc
        return acc

    for name in direct:
        resolve(name, set())
    return out


def _isinstance_targets(
    test: ast.AST, param: str, aliases: Dict[str, List[str]]
) -> Optional[List[str]]:
    if not (
        isinstance(test, ast.Call)
        and isinstance(test.func, ast.Name)
        and test.func.id == "isinstance"
        and len(test.args) == 2
        and isinstance(test.args[0], ast.Name)
        and test.args[0].id == param
    ):
        return None
    target = test.args[1]
    names: List[str] = []
    elts = target.elts if isinstance(target, ast.Tuple) else [target]
    for elt in elts:
        if isinstance(elt, ast.Name):
            names.extend(aliases.get(elt.id, [elt.id]))
        else:
            return None  # dynamic second argument: must not be judged
    return names


def _collect_arms(
    fn: ast.AST, param: str, aliases: Dict[str, List[str]]
) -> List[Tuple[List[str], ast.If]]:
    """The isinstance ladder: top-level ``if``s of the function body plus
    their ``elif`` continuations, in evaluation order."""
    arms: List[Tuple[List[str], ast.If]] = []
    for stmt in fn.body:
        node = stmt
        while isinstance(node, ast.If):
            names = _isinstance_targets(node.test, param, aliases)
            if names is not None:
                arms.append((names, node))
            node = node.orelse[0] if (
                len(node.orelse) == 1 and isinstance(node.orelse[0], ast.If)
            ) else None
    return arms


def _returns_in(stmts: Sequence[ast.stmt]) -> List[ast.Return]:
    """Return statements belonging to these statements' own function —
    nested def/lambda bodies excluded."""
    out: List[ast.Return] = []

    def walk(node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        if isinstance(node, ast.Return):
            out.append(node)
        for child in ast.iter_child_nodes(node):
            walk(child)

    for stmt in stmts:
        walk(stmt)
    return out


class _ReturnResolver:
    """Conservative three-valued resolution of 'does this expression produce
    a RapidResponse member?': True / False / None (unknowable — skip)."""

    def __init__(
        self,
        resp_members: Set[str],
        known_non_response: Set[str],
        methods: Dict[str, ast.AST],
    ) -> None:
        self._resp = resp_members
        self._non_resp = known_non_response
        self._methods = methods

    def resolve(self, expr: Optional[ast.AST], depth: int = 0) -> Optional[bool]:
        if expr is None:
            return False  # a bare `return` hands None to the transport
        if isinstance(expr, ast.Call):
            func = expr.func
            if isinstance(func, ast.Name):
                if func.id in self._resp:
                    return True
                if func.id in self._non_resp:
                    return False
                return None
            if (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "self"
                and func.attr in self._methods
                and depth < 2
            ):
                return self._resolve_method(self._methods[func.attr], depth)
        return None

    def _resolve_method(self, method: ast.AST, depth: int) -> Optional[bool]:
        annotation = getattr(method, "returns", None)
        ann_name = None
        if isinstance(annotation, ast.Name):
            ann_name = annotation.id
        elif isinstance(annotation, ast.Constant) and isinstance(annotation.value, str):
            ann_name = annotation.value
        if ann_name is not None:
            if ann_name in self._resp:
                return True
            if ann_name in self._non_resp:
                return False
            return None  # Optional[...] strings, futures, ...: skip
        if annotation is not None:
            return None  # subscripted/attribute annotation: skip
        verdicts = [
            self.resolve(ret.value, depth + 1)
            for ret in _returns_in(method.body)
        ]
        if any(v is False for v in verdicts):
            return False
        if verdicts and all(v is True for v in verdicts):
            return True
        return None


def check_dispatch(
    path: Path,
    source: Optional[str] = None,
    tree: "Optional[ast.AST]" = None,
) -> List[Finding]:
    rel = core.rel(path)
    posix = rel.replace("\\", "/")
    if not any(posix.startswith(p) for p in DISPATCH_PREFIXES):
        return []
    src = source if source is not None else path.read_text()
    if tree is None:
        tree = ast.parse(src, filename=str(path))

    dispatchers = [
        (cls, method)
        for cls in ast.walk(tree)
        if isinstance(cls, ast.ClassDef)
        for method in cls.body
        if isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef))
        and method.name == "handle_message"
        and len(method.args.args) >= 2
    ]
    if not dispatchers:
        return []

    req_union, resp_union, union_tree = _load_unions(tree)
    if req_union is None or resp_union is None:
        return []  # no union to be exhaustive over: skip, don't guess

    aliases = _tuple_aliases(tree)
    class_defs = {
        node.name: node for node in ast.walk(tree) if isinstance(node, ast.ClassDef)
    }
    if union_tree is not None and union_tree is not tree:
        for node in ast.walk(union_tree):
            if isinstance(node, ast.ClassDef):
                class_defs.setdefault(node.name, node)
    ancestors = _ancestors(class_defs)

    findings: List[Finding] = []
    exempt: Set[str] = set()
    for match in _ELSEWHERE_RE.finditer(src):
        for name in re.split(r"\s*,\s*", match.group(1)):
            lineno = src[: match.start()].count("\n") + 1
            if name not in req_union:
                findings.append(Finding(
                    rel, lineno, "unreachable-dispatch-arm",
                    f"# dispatched-elsewhere names {name!r}, which is not a "
                    f"RapidRequest union member — stale or typo'd exemption",
                ))
            else:
                exempt.add(name)

    resp_members = set(resp_union)
    known_non_response = (set(req_union) | set(class_defs)) - resp_members

    for cls, method in dispatchers:
        param = method.args.args[1].arg
        arms = _collect_arms(method, param, aliases)
        methods = {
            m.name: m
            for m in cls.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        resolver = _ReturnResolver(resp_members, known_non_response, methods)

        def matched_by(member: str, covered: Set[str]) -> bool:
            return member in covered or bool(ancestors.get(member, set()) & covered)

        covered: Set[str] = set()
        for names, arm in arms:
            if names and all(matched_by(n, covered) for n in names):
                findings.append(Finding(
                    rel, arm.lineno, "shadowed-arm",
                    f"{cls.name}.{method.name}: isinstance arm for "
                    f"({', '.join(names)}) is dead — every type already "
                    f"matched by an earlier arm",
                ))
            for ret in _returns_in(arm.body):
                if resolver.resolve(ret.value) is False:
                    desc = ast.unparse(ret.value) if ret.value is not None else "None"
                    findings.append(Finding(
                        rel, ret.lineno, "dispatch-return",
                        f"{cls.name}.{method.name}: arm for "
                        f"({', '.join(names)}) returns {desc}, which is not "
                        f"a RapidResponse member",
                    ))
            covered.update(names)

        if not isinstance(method, ast.AsyncFunctionDef):
            # Sync handle_message = internal sub-dispatcher: shadowing and
            # return-type checks above apply, exhaustiveness does not.
            continue
        for member in req_union:
            if member in exempt:
                continue
            if not matched_by(member, covered):
                findings.append(Finding(
                    rel, method.lineno, "unreachable-dispatch-arm",
                    f"RapidRequest member {member} reaches no isinstance arm "
                    f"in {cls.name}.{method.name} — it falls through to the "
                    f"unidentified-request error; handle it or declare "
                    f"`# dispatched-elsewhere: {member}`",
                ))
    return findings
