"""Check family 7: wire-schema conformance across the four hand-kept mirrors.

The interop guarantee rests on byte-exact wire compatibility with the
reference IDL (``rapid/src/main/proto/rapid.proto``) — yet the message
schema lives in four hand-maintained mirrors: the ``RapidRequest`` /
``RapidResponse`` unions and their frozen dataclasses (``rapid_tpu_torch/
types.py``), the tag tables plus the ``isinstance`` encode arms and
``tag ==`` decode arms (``rapid_tpu_torch/messaging/codec.py``), the
``_field(name, number, ...)`` descriptors (``rapid_tpu_torch/interop/
proto_schema.py``), and the service dispatch chain (checked by the
``dispatch`` family). This module cross-checks the first three:

- every union member has exactly one tag, one encode arm, and one decode
  arm decoding that tag back to the same type (``missing-tag``,
  ``missing-encode-arm``, ``missing-decode-arm``);
- no tag value is used twice (``tag-reuse``), and no arm or tag exists
  for a type outside the union (``dead-arm``);
- every union member with a protobuf mirror covers its dataclass fields
  with proto fields, no field number is reused inside a message, and the
  proto envelope's field numbers agree with the native tags
  (``field-number-drift``).

The whole surface (tags, field numbers, dataclass field order) is frozen
into the committed lockfile ``rapid_tpu_torch/tools/analysis/wire.lock.json``. Any drift
fails the gate with a buf-style breaking-change message
(``wire-lock-drift``) until the developer regenerates via ``python
rapid_tpu_torch/tools/staticcheck.py --update-wire-lock`` — a wire-format change is an
explicit, reviewed act, never a silent side effect of a refactor.

``check_wire_schema`` runs the cross-check over a single module (the lint
corpus keeps miniature mirrors in one file); sections only apply when the
module defines the artifacts they need, so a file holding only a tag
table is checked for tag discipline and nothing else.
``check_wire_lock`` is the tree-mode entry the driver calls on full
sweeps: it merges the three real mirror files and adds the lock
comparison.
"""

from __future__ import annotations

import ast
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from . import core
from .core import Finding

#: The real mirror files merged on full-tree sweeps (posix-relative).
WIRE_FILES = (
    "rapid_tpu_torch/types.py",
    "rapid_tpu_torch/messaging/codec.py",
    "rapid_tpu_torch/interop/proto_schema.py",
)

#: The committed freeze of the wire surface, repo-relative.
LOCK_REL = "rapid_tpu_torch/tools/analysis/wire.lock.json"

#: Union members with no protobuf mirror by design: the gossip envelope is
#: a native-transport extension the reference never ships (types.py), so
#: the interop surface deliberately excludes it.
NATIVE_ONLY_MESSAGES = frozenset({"GossipMessage"})

#: Dataclass fields that ride only the native codec (optional trailing
#: trace context; on the interop path it travels as gRPC metadata instead).
NATIVE_ONLY_FIELDS = frozenset({"trace_id"})

#: snake_case -> camelCase exceptions where the reference IDL diverges from
#: mechanical conversion (rapid.proto uses the singular ``ringNumber`` for
#: the repeated field).
_PROTO_NAME_ALIASES = {"ring_numbers": "ringNumber"}

_SIDES = ("request", "response")

_UNION_NAMES = {"RapidRequest": "request", "RapidResponse": "response"}
_TAG_TABLE_NAMES = {"_REQUEST_TAGS": "request", "_RESPONSE_TAGS": "response"}
#: Encode functions per side, most-specific first (the public
#: ``encode_request`` is a caching wrapper with no arms of its own, so the
#: impl wins whenever both exist).
_ENCODE_FN_NAMES = {
    "request": ("_encode_request_impl", "encode_request"),
    "response": ("_encode_response_impl", "encode_response"),
}
_DECODE_FN_NAMES = {"request": "decode_request", "response": "decode_response"}

_REGEN_HINT = (
    "if this wire-format change is intentional, regenerate via "
    "`python -m rapid_tpu_torch.tools.staticcheck --update-wire-lock` and review the diff"
)


class _Loc:
    __slots__ = ("path", "lineno")

    def __init__(self, path: str, lineno: int) -> None:
        self.path = path
        self.lineno = lineno


class WireSurface:
    """Everything the mirrors say about the wire format, with source
    locations so findings point at the drifted artifact."""

    def __init__(self) -> None:
        self.unions: Dict[str, Optional[List[str]]] = {s: None for s in _SIDES}
        self.union_locs: Dict[str, _Loc] = {}
        self.dataclass_fields: Dict[str, List[str]] = {}
        self.class_locs: Dict[str, _Loc] = {}
        # side -> ordered (name, tag, loc) entries, duplicates preserved
        self.tags: Dict[str, Optional[List[Tuple[str, int, _Loc]]]] = {
            s: None for s in _SIDES
        }
        self.tag_table_locs: Dict[str, _Loc] = {}
        self.encode_arms: Dict[str, Optional[Dict[str, _Loc]]] = {
            s: None for s in _SIDES
        }
        self.encode_fn_locs: Dict[str, _Loc] = {}
        # side -> ordered (tag, constructed type name, loc)
        self.decode_arms: Dict[str, Optional[List[Tuple[int, str, _Loc]]]] = {
            s: None for s in _SIDES
        }
        self.decode_fn_locs: Dict[str, _Loc] = {}
        # proto message -> ordered (field name, number, loc)
        self.proto: Dict[str, List[Tuple[str, int, _Loc]]] = {}
        self.proto_locs: Dict[str, _Loc] = {}
        # Types whose decode arm constructs with zero arguments — proof of
        # fieldlessness local to the codec, for when the dataclasses are in
        # another file (the per-file check on codec.py alone).
        self.fieldless_decoded: set = set()

    def tag_map(self, side: str) -> Dict[str, int]:
        return {name: tag for name, tag, _ in (self.tags[side] or [])}

    def loc_of_tag(self, side: str, name: str) -> Optional[_Loc]:
        for entry_name, _, loc in self.tags[side] or []:
            if entry_name == name:
                return loc
        return None


def to_proto_field_name(field: str) -> str:
    """The proto spelling of a native dataclass field (camelCase with the
    reference's naming quirks)."""
    if field in _PROTO_NAME_ALIASES:
        return _PROTO_NAME_ALIASES[field]
    head, *rest = field.split("_")
    return head + "".join(part.title() for part in rest)


def _envelope_field_name(member: str) -> str:
    return member[0].lower() + member[1:]


# -- extraction -------------------------------------------------------------


def _is_dataclass_decorated(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if isinstance(target, ast.Name) and target.id == "dataclass":
            return True
        if isinstance(target, ast.Attribute) and target.attr == "dataclass":
            return True
    return False


def _extract_tag_table(value: ast.AST, rel: str) -> Optional[List[Tuple[str, int, _Loc]]]:
    if not isinstance(value, ast.Dict):
        return None
    entries = []
    for key, val in zip(value.keys, value.values):
        if (
            isinstance(key, ast.Name)
            and isinstance(val, ast.Constant)
            and isinstance(val.value, int)
        ):
            entries.append((key.id, val.value, _Loc(rel, key.lineno)))
    return entries


def _encode_arms(fn: ast.AST, rel: str) -> Dict[str, _Loc]:
    args = fn.args.args
    if not args:
        return {}
    param = args[0].arg
    arms: Dict[str, _Loc] = {}
    for node in ast.walk(fn):
        if not (
            isinstance(node, ast.If)
            and isinstance(node.test, ast.Call)
            and isinstance(node.test.func, ast.Name)
            and node.test.func.id == "isinstance"
            and len(node.test.args) == 2
            and isinstance(node.test.args[0], ast.Name)
            and node.test.args[0].id == param
        ):
            continue
        target = node.test.args[1]
        names = (
            [e.id for e in target.elts if isinstance(e, ast.Name)]
            if isinstance(target, ast.Tuple)
            else [target.id] if isinstance(target, ast.Name) else []
        )
        for name in names:
            arms.setdefault(name, _Loc(rel, node.lineno))
    return arms


def _constructed_type(branch_body: Sequence[ast.stmt]) -> Optional[Tuple[str, int, bool]]:
    """The message type a decode branch builds — the Call bound to ``out``
    (the codec idiom) or returned directly — plus whether the constructor
    takes zero arguments (a fieldless message)."""
    for stmt in branch_body:
        for node in ast.walk(stmt):
            call = None
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "out" for t in node.targets
            ):
                call = node.value
            elif (
                isinstance(node, ast.AnnAssign)
                and isinstance(node.target, ast.Name)
                and node.target.id == "out"
            ):
                call = node.value
            elif isinstance(node, ast.Return):
                call = node.value
            if isinstance(call, ast.Call) and isinstance(call.func, ast.Name):
                fieldless = not call.args and not call.keywords
                return call.func.id, node.lineno, fieldless
    return None


def _decode_arms(
    fn: ast.AST, rel: str, surface: WireSurface
) -> List[Tuple[int, str, _Loc]]:
    arms = []
    for node in ast.walk(fn):
        if not (
            isinstance(node, ast.If)
            and isinstance(node.test, ast.Compare)
            and isinstance(node.test.left, ast.Name)
            and len(node.test.ops) == 1
            and isinstance(node.test.ops[0], ast.Eq)
            and len(node.test.comparators) == 1
            and isinstance(node.test.comparators[0], ast.Constant)
            and isinstance(node.test.comparators[0].value, int)
        ):
            continue
        built = _constructed_type(node.body)
        if built is not None:
            arms.append(
                (node.test.comparators[0].value, built[0], _Loc(rel, node.lineno))
            )
            if built[2]:
                surface.fieldless_decoded.add(built[0])
    return arms


def _extract_proto(tree: ast.AST, rel: str, surface: WireSurface) -> None:
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "_msg"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            continue
        name = node.args[0].value
        fields = []
        for arg in node.args[1:]:
            if (
                isinstance(arg, ast.Call)
                and isinstance(arg.func, ast.Name)
                and arg.func.id == "_field"
                and len(arg.args) >= 2
                and isinstance(arg.args[0], ast.Constant)
                and isinstance(arg.args[1], ast.Constant)
                and isinstance(arg.args[1].value, int)
            ):
                fields.append((arg.args[0].value, arg.args[1].value, _Loc(rel, arg.lineno)))
        surface.proto[name] = fields
        surface.proto_locs[name] = _Loc(rel, node.lineno)


def extract_surface(trees: Sequence[Tuple[ast.AST, str]]) -> WireSurface:
    """Pull the wire surface out of (tree, relpath) pairs — the three real
    mirror files on tree sweeps, or one corpus module holding miniatures."""
    surface = WireSurface()
    # side -> candidate fn name -> (fn node, relpath)
    encode_fns: Dict[str, Dict[str, Tuple[ast.AST, str]]] = {s: {} for s in _SIDES}
    for tree, rel in trees:
        _extract_proto(tree, rel, surface)
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and _is_dataclass_decorated(node):
                fields = [
                    stmt.target.id
                    for stmt in node.body
                    if isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)
                ]
                surface.dataclass_fields[node.name] = fields
                surface.class_locs[node.name] = _Loc(rel, node.lineno)
            elif (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
            ) or (
                isinstance(node, ast.AnnAssign)
                and isinstance(node.target, ast.Name)
                and node.value is not None
            ):
                target = (
                    node.target.id if isinstance(node, ast.AnnAssign)
                    else node.targets[0].id
                )
                if target in _UNION_NAMES:
                    members = core.union_member_names(node.value)
                    if members:
                        side = _UNION_NAMES[target]
                        surface.unions[side] = members
                        surface.union_locs[side] = _Loc(rel, node.lineno)
                elif target in _TAG_TABLE_NAMES:
                    entries = _extract_tag_table(node.value, rel)
                    if entries is not None:
                        side = _TAG_TABLE_NAMES[target]
                        surface.tags[side] = entries
                        surface.tag_table_locs[side] = _Loc(rel, node.lineno)
            elif isinstance(node, ast.FunctionDef):
                for side in _SIDES:
                    if node.name in _ENCODE_FN_NAMES[side]:
                        encode_fns[side][node.name] = (node, rel)
                    if node.name == _DECODE_FN_NAMES[side]:
                        surface.decode_arms[side] = _decode_arms(node, rel, surface)
                        surface.decode_fn_locs[side] = _Loc(rel, node.lineno)
    for side in _SIDES:
        for candidate in _ENCODE_FN_NAMES[side]:
            if candidate in encode_fns[side]:
                fn, fn_rel = encode_fns[side][candidate]
                surface.encode_arms[side] = _encode_arms(fn, fn_rel)
                surface.encode_fn_locs[side] = _Loc(fn_rel, fn.lineno)
                break
    return surface


# -- cross-check ------------------------------------------------------------


def _find(loc: Optional[_Loc], check: str, message: str) -> Finding:
    loc = loc or _Loc(LOCK_REL, 1)
    return Finding(loc.path, loc.lineno, check, message)


def cross_check(surface: WireSurface) -> List[Finding]:
    findings: List[Finding] = []
    for side in _SIDES:
        findings.extend(_check_side(surface, side))
    findings.extend(_check_proto(surface))
    return findings


def _check_side(surface: WireSurface, side: str) -> List[Finding]:
    findings: List[Finding] = []
    union = surface.unions[side]
    tags = surface.tags[side]
    tag_map = surface.tag_map(side)

    if tags is not None:
        seen: Dict[int, str] = {}
        for name, tag, loc in tags:
            if tag in seen:
                findings.append(_find(
                    loc, "tag-reuse",
                    f"{side} tag {tag} assigned to both {seen[tag]} and {name}",
                ))
            else:
                seen[tag] = name

    if union is not None and tags is not None:
        for member in union:
            if member not in tag_map:
                findings.append(_find(
                    surface.tag_table_locs.get(side), "missing-tag",
                    f"{side} union member {member} has no entry in the "
                    f"{side} tag table",
                ))
        for name, _, loc in tags:
            if name not in union:
                findings.append(_find(
                    loc, "dead-arm",
                    f"{side} tag table entry for {name}, which is not a "
                    f"{side} union member",
                ))

    enc = surface.encode_arms[side]
    if tags is not None and enc is not None:
        for name, _, _ in tags:
            fieldless = (
                surface.dataclass_fields.get(name) == []
                or name in surface.fieldless_decoded
            )
            if name not in enc and not fieldless:
                # Fieldless messages (Response, ConsensusResponse) encode as
                # a bare tag: no isinstance arm is needed or present. Proof
                # of fieldlessness is the empty dataclass (types.py) or the
                # zero-argument decode constructor (codec.py standalone).
                findings.append(_find(
                    surface.encode_fn_locs.get(side), "missing-encode-arm",
                    f"{side} type {name} is tagged but has no isinstance "
                    f"encode arm",
                ))
        for name, loc in enc.items():
            if name not in tag_map:
                findings.append(_find(
                    loc, "dead-arm",
                    f"encode arm for {name}, which has no {side} tag "
                    f"(unreachable: the tag lookup raises first)",
                ))

    dec = surface.decode_arms[side]
    if tags is not None and dec is not None:
        decoded = {tag: (name, loc) for tag, name, loc in dec}
        for name, tag, _ in tags:
            if tag not in decoded:
                findings.append(_find(
                    surface.decode_fn_locs.get(side), "missing-decode-arm",
                    f"{side} tag {tag} ({name}) has no decode arm — frames "
                    f"of this type raise instead of decoding",
                ))
            elif decoded[tag][0] != name:
                findings.append(_find(
                    decoded[tag][1], "missing-decode-arm",
                    f"{side} tag {tag} decodes to {decoded[tag][0]} but the "
                    f"tag table assigns it to {name}",
                ))
        for tag, name, loc in dec:
            if tag not in {t for _, t, _ in tags}:
                findings.append(_find(
                    loc, "dead-arm",
                    f"decode arm for {side} tag {tag} ({name}), which no "
                    f"type in the tag table uses",
                ))
    return findings


def _check_proto(surface: WireSurface) -> List[Finding]:
    findings: List[Finding] = []
    for msg, fields in surface.proto.items():
        seen: Dict[int, str] = {}
        for fname, number, loc in fields:
            if number in seen:
                findings.append(_find(
                    loc, "field-number-drift",
                    f"proto message {msg} reuses field number {number} "
                    f"({seen[number]} and {fname})",
                ))
            else:
                seen[number] = fname
    if not surface.proto:
        return findings
    for side, envelope in (("request", "RapidRequest"), ("response", "RapidResponse")):
        union = surface.unions[side]
        if union is None:
            continue
        for member in union:
            if member in NATIVE_ONLY_MESSAGES:
                continue
            if member not in surface.proto:
                findings.append(_find(
                    surface.union_locs.get(side), "field-number-drift",
                    f"{side} union member {member} has no proto message "
                    f"mirror in the interop schema",
                ))
                continue
            proto_fields = {fname for fname, _, _ in surface.proto[member]}
            for field in surface.dataclass_fields.get(member, []):
                if field in NATIVE_ONLY_FIELDS:
                    continue
                if to_proto_field_name(field) not in proto_fields:
                    findings.append(_find(
                        surface.proto_locs.get(member), "field-number-drift",
                        f"proto message {member} has no field covering "
                        f"dataclass field {field!r} "
                        f"(expected {to_proto_field_name(field)!r})",
                    ))
        # The oneof envelope's field numbers double as the native tags in
        # the reference IDL; drift between them is a silent interop break.
        env_fields = {
            fname: (number, loc) for fname, number, loc in surface.proto.get(envelope, [])
        }
        for member, tag in surface.tag_map(side).items():
            if member in NATIVE_ONLY_MESSAGES:
                continue
            entry = env_fields.get(_envelope_field_name(member))
            if entry is not None and entry[0] != tag:
                findings.append(_find(
                    entry[1], "field-number-drift",
                    f"{envelope} envelope field {_envelope_field_name(member)} "
                    f"is number {entry[0]} but the native {side} tag is {tag}",
                ))
    return findings


# -- per-file entry (lint corpus + narrowed CLI roots) ----------------------


def check_wire_schema(
    path: Path,
    source: Optional[str] = None,
    tree: "Optional[ast.AST]" = None,
) -> List[Finding]:
    """Cross-check the wire mirrors present in ONE module. Sections gate on
    artifact presence, so real mirror files analyzed alone (union but no
    tags, tags but no union) produce no spurious findings — the merged
    tree-mode check owns the cross-file obligations."""
    src = source if source is not None else path.read_text()
    if tree is None:
        tree = ast.parse(src, filename=str(path))
    return cross_check(extract_surface([(tree, core.rel(path))]))


# -- tree mode: merged mirrors + the lockfile gate --------------------------


def surface_to_lock(surface: WireSurface) -> Dict[str, object]:
    """The canonical freeze of the surface: tags, dataclass field order for
    every union member, and every proto field number."""
    fields: Dict[str, List[str]] = {}
    for side in _SIDES:
        for member in surface.unions[side] or []:
            if member in surface.dataclass_fields:
                fields[member] = list(surface.dataclass_fields[member])
    return {
        "request_tags": surface.tag_map("request"),
        "response_tags": surface.tag_map("response"),
        "fields": fields,
        "proto": {
            msg: {fname: number for fname, number, _ in entries}
            for msg, entries in surface.proto.items()
        },
    }


def compare_lock(surface: WireSurface, locked: Dict[str, object]) -> List[Finding]:
    """Buf-style breaking-change report: every difference between the live
    surface and the committed lock, each naming the drifted message type."""
    current = surface_to_lock(surface)
    findings: List[Finding] = []

    def drift(loc: Optional[_Loc], message: str) -> None:
        findings.append(_find(loc, "wire-lock-drift", f"{message} — {_REGEN_HINT}"))

    for side in _SIDES:
        key = f"{side}_tags"
        cur: Dict[str, int] = current[key]  # type: ignore[assignment]
        old: Dict[str, int] = locked.get(key, {})  # type: ignore[assignment]
        for name in sorted(set(cur) | set(old)):
            if name not in old:
                drift(surface.loc_of_tag(side, name),
                      f"{side} message {name} added since the wire lock "
                      f"(tag {cur[name]})")
            elif name not in cur:
                drift(surface.tag_table_locs.get(side),
                      f"{side} message {name} removed since the wire lock "
                      f"(was tag {old[name]})")
            elif cur[name] != old[name]:
                drift(surface.loc_of_tag(side, name),
                      f"{side} message {name} renumbered: tag "
                      f"{old[name]} -> {cur[name]}")
    cur_fields: Dict[str, List[str]] = current["fields"]  # type: ignore[assignment]
    old_fields: Dict[str, List[str]] = locked.get("fields", {})  # type: ignore[assignment]
    for name in sorted(set(cur_fields) | set(old_fields)):
        if name not in old_fields:
            drift(surface.class_locs.get(name),
                  f"message {name} has no field-order entry in the wire lock")
        elif name not in cur_fields:
            drift(None, f"message {name} vanished from the unions but is "
                        f"still in the wire lock")
        elif cur_fields[name] != old_fields[name]:
            drift(surface.class_locs.get(name),
                  f"message {name} dataclass field order changed: "
                  f"{old_fields[name]} -> {cur_fields[name]} (the native "
                  f"codec serializes fields positionally)")
    cur_proto: Dict[str, Dict[str, int]] = current["proto"]  # type: ignore[assignment]
    old_proto: Dict[str, Dict[str, int]] = locked.get("proto", {})  # type: ignore[assignment]
    for msg in sorted(set(cur_proto) | set(old_proto)):
        if msg not in old_proto:
            drift(surface.proto_locs.get(msg),
                  f"proto message {msg} added since the wire lock")
            continue
        if msg not in cur_proto:
            drift(None, f"proto message {msg} removed since the wire lock")
            continue
        for fname in sorted(set(cur_proto[msg]) | set(old_proto[msg])):
            if fname not in old_proto[msg]:
                drift(surface.proto_locs.get(msg),
                      f"proto message {msg} gained field {fname} "
                      f"(number {cur_proto[msg][fname]}) since the wire lock")
            elif fname not in cur_proto[msg]:
                drift(surface.proto_locs.get(msg),
                      f"proto message {msg} lost field {fname} "
                      f"(was number {old_proto[msg][fname]})")
            elif cur_proto[msg][fname] != old_proto[msg][fname]:
                drift(surface.proto_locs.get(msg),
                      f"proto message {msg} field {fname} renumbered: "
                      f"{old_proto[msg][fname]} -> {cur_proto[msg][fname]}")
    return findings


def _wire_trees(trees: Sequence[Tuple[ast.AST, str]]):
    wanted = {f: None for f in WIRE_FILES}
    for tree, rel in trees:
        posix = rel.replace("\\", "/")
        if posix in wanted:
            wanted[posix] = tree
    if any(tree is None for tree in wanted.values()):
        return None  # not this repo's tree (tests retarget REPO) — skip
    return [(tree, rel) for rel, tree in wanted.items()]


def check_wire_lock(trees: Sequence[Tuple[ast.AST, str]]) -> List[Finding]:
    """Tree-mode gate: merge the three mirror files, cross-check them
    against each other, then against the committed lock."""
    selected = _wire_trees(trees)
    if selected is None:
        return []
    surface = extract_surface(selected)
    findings = cross_check(surface)
    lock_path = core.REPO / LOCK_REL
    if not lock_path.exists():
        findings.append(Finding(
            LOCK_REL, 1, "wire-lock-drift",
            f"wire lockfile missing — generate it via "
            f"`python -m rapid_tpu_torch.tools.staticcheck --update-wire-lock`",
        ))
        return findings
    try:
        locked = json.loads(lock_path.read_text())
    except json.JSONDecodeError as exc:
        findings.append(Finding(
            LOCK_REL, 1, "wire-lock-drift",
            f"wire lockfile is not valid JSON ({exc.msg}) — regenerate via "
            f"`python -m rapid_tpu_torch.tools.staticcheck --update-wire-lock`",
        ))
        return findings
    findings.extend(compare_lock(surface, locked))
    return findings


def update_wire_lock() -> Tuple[List[Finding], Optional[Path]]:
    """Regenerate the lockfile from the live mirrors. Refuses (returning the
    findings) while the mirrors disagree with each other — an inconsistent
    surface must be fixed, not frozen."""
    trees = []
    for rel in WIRE_FILES:
        path = core.REPO / rel
        trees.append((ast.parse(path.read_text(), filename=str(path)), rel))
    surface = extract_surface(trees)
    findings = cross_check(surface)
    if findings:
        return findings, None
    lock_path = core.REPO / LOCK_REL
    payload = {
        "_comment": (
            "Frozen wire surface: native codec tags, dataclass field order, "
            "and interop proto field numbers. Generated by `python "
            "rapid_tpu_torch/tools/staticcheck.py --update-wire-lock`; do not edit by hand — "
            "any drift from the live mirrors fails the staticcheck gate."
        ),
        **surface_to_lock(surface),
    }
    lock_path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return [], lock_path
