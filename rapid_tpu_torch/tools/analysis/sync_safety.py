"""Check family 14: host-sync safety of the eager engine (the counterpart
of the JAX package's ``trace_safety``).

JAX's ``trace_safety`` guards what a traced program must not do: a Python
side effect runs once per trace, a traced branch raises on first use. The
port traces nothing — its engine runs eagerly, and the hazard that takes
the place of an impure trace is a call that makes the host wait for the
card where nobody counted or meant it. Each check below is one of the
hazards first found by hand on the card (``torch.cuda.set_sync_debug_mode
("error")``), now visible in the syntax tree, over the engine modules
(``ops/``, ``models/``, ``tenancy/``, ``parallel/``, ``serving/``,
``protocol/device_*``):

- ``uncounted-host-read`` — a blocking read that ``_host.read`` does not
  count: ``.cpu()`` / ``.numpy()``, ``.item()`` / ``.tolist()`` on a
  tensor, ``int()`` / ``float()`` / ``bool()`` of a tensor, and an
  ``if`` / ``while`` / ``assert`` whose test is a tensor. The engine's
  reads all go through ``_host.read`` so that they are counted per round;
  hatch ``# host-read-ok: <reason>`` (or JAX's ``# host-sync-ok:``, which
  declares the same boundary).
- ``index-store-sync`` — a store through advanced indexing of a Python
  scalar (``t[idx] = True``: the scalar is copied from pageable memory)
  or through a mask (``t[mask] = v``: the mask becomes indices with a
  ``nonzero`` that waits). The fix is ``index_fill_`` / ``index_copy_`` /
  ``torch.where``; hatch ``# index-store-ok: <reason>``.
- ``pageable-upload`` — a host array uploaded outside ``_host.upload`` on
  a streaming path (``serving/`` and the engine methods the stream driver
  calls, :data:`STREAM_METHODS`): ``torch.from_numpy(a).to(dev)``,
  ``torch.tensor(a, device=dev)``, ``.cuda()``. A pageable copy waits for
  all the work queued before it; hatch ``# upload-ok: <reason>``.
- ``implicit-device`` — a tensor constructor with no ``device=`` (it lands
  on torch's CPU default), or a function's ``device=None`` parameter
  handed to a constructor without ``models/state.resolve_device`` (the
  port's entry points default to the card and never fall back); hatch
  ``# device-ok: <reason>``. Pinned host buffers (``pin_memory=True``)
  and constructors moved at once (``torch.tensor(x).to(dev)``) pass.

A tensor is recognised only where the syntax shows one (conservative,
skip-don't-guess, as the JAX family): a ``torch.*`` call that makes a
tensor, an engine lane (``state.alive``: a field of the state NamedTuples
in ``models/state.py``), a parameter annotated ``torch.Tensor``, a local
name bound only to such values, and method chains, subscripts and
arithmetic over them.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set

from . import core
from .core import Finding

SYNC_SAFETY_PREFIXES = (
    "rapid_tpu_torch/ops/",
    "rapid_tpu_torch/models/",
    "rapid_tpu_torch/tenancy/",
    "rapid_tpu_torch/parallel/",
    "rapid_tpu_torch/serving/",
    "rapid_tpu_torch/protocol/device_",
)

#: The streaming pipeline: every upload here must go through
#: ``_host.upload`` (and, in ``sharding``, every blocking read is a
#: declared fetch boundary).
STREAM_PREFIXES = ("rapid_tpu_torch/serving/",)

#: Engine methods the streaming driver calls between its enqueued waves
#: (``serving/stream.py``: crash, joins, the stream step and their
#: helpers), by file: their uploads are on the streaming path too.
STREAM_METHODS = {
    "rapid_tpu_torch/models/virtual_cluster.py": frozenset({
        "_slot_index", "_set_crashed", "crash", "revive", "_stamp_fired_edges",
        "inject_join_wave", "_step", "stream_step",
    }),
    "rapid_tpu_torch/tenancy/fleet.py": frozenset({
        "_slot_index", "crash", "inject_join_wave", "stream_wave",
    }),
}

#: The state NamedTuples whose fields are engine lanes.
LANE_CLASSES = ("EngineState", "FaultInputs", "TelemetryLanes", "TraceRing", "StepEvents")
STATE_REL = "rapid_tpu_torch/models/state.py"

#: ``torch.*`` calls that return host values, never a tensor.
_HOST_VALUED = (
    "torch.cuda.", "torch.distributed.", "torch.backends.", "torch.version",
    "torch.iinfo", "torch.finfo", "torch.is_", "torch.get_", "torch.device",
    "torch.Size", "torch.dtype", "torch.result_type", "torch.promote_types",
    "torch.can_cast", "torch.numel", "torch.set_", "torch.manual_seed",
    "torch.use_deterministic", "torch.are_", "torch.no_grad", "torch.inference_mode",
    "torch.Generator", "torch.profiler", "torch.utils", "torch.testing",
)

#: Tensor methods that return host values (their results are not tensors).
_HOST_METHODS = frozenset({
    "item", "tolist", "numpy", "dim", "size", "numel", "element_size",
    "data_ptr", "is_contiguous", "untyped_storage", "stride", "nbytes",
    "get_device", "is_pinned",
})

_CONSTRUCTORS = frozenset({
    "zeros", "ones", "full", "empty", "arange", "tensor", "as_tensor", "eye",
    "rand", "randint", "randn", "linspace", "randperm",
})

_CASTS = frozenset({"int", "float", "bool"})

_MARKERS = {
    "uncounted-host-read": "# host-read-ok:",
    "index-store-sync": "# index-store-ok:",
    "pageable-upload": "# upload-ok:",
    "implicit-device": "# device-ok:",
}

_LANE_CACHE: Dict[str, Set[str]] = {}


def _import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Module-level name -> dotted runtime path, for resolving ``torch``
    spellings through whatever aliases the file uses."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                aliases[alias.asname or alias.name.split(".")[0]] = (
                    alias.name if alias.asname else alias.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                if alias.name != "*":
                    aliases[alias.asname or alias.name] = f"{node.module}.{alias.name}"
    return aliases


def _dotted(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    if isinstance(node, ast.Name):
        return aliases.get(node.id, node.id)
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value, aliases)
        return f"{base}.{node.attr}" if base else None
    return None


def lane_fields() -> Set[str]:
    """Field names of the engine's lane NamedTuples, read from the port's
    ``models/state.py`` under ``core.REPO`` (empty when the tree has none,
    as a retargeted test tree)."""
    key = str(core.REPO)
    if key not in _LANE_CACHE:
        fields: Set[str] = set()
        path = core.REPO / STATE_REL
        if path.exists():
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, ast.ClassDef) and node.name in LANE_CLASSES:
                    fields.update(
                        s.target.id for s in node.body
                        if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)
                    )
        _LANE_CACHE[key] = fields
    return _LANE_CACHE[key]


def torch_call(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """The dotted name of a ``torch.*`` call that makes a tensor, else None."""
    if not isinstance(node, ast.Call):
        return None
    dotted = _dotted(node.func, aliases) or ""
    if not dotted.startswith("torch.") or dotted.startswith(_HOST_VALUED):
        return None
    return dotted


class TensorScope:
    """Which expressions of one function are tensors, as far as the syntax
    shows: see the module docstring. ``names`` holds the locals and
    parameters known to be tensors."""

    def __init__(self, aliases: Dict[str, str], lanes: Set[str], fn: Optional[ast.AST] = None):
        self.aliases, self.lanes = aliases, lanes
        self.names: Set[str] = set()
        self.unknown_roots: Set[str] = set()
        if fn is not None:
            self._learn(fn)

    def _learn(self, fn: ast.AST) -> None:
        args = fn.args
        for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
            if a.annotation is not None and (
                _dotted(a.annotation, self.aliases) or ""
            ).endswith("Tensor"):
                self.names.add(a.arg)
        bound: Dict[str, List[ast.AST]] = {}
        for node in _walk_no_nested(fn):
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        bound.setdefault(target.id, []).append(node.value)
                    elif isinstance(target, (ast.Tuple, ast.List)):
                        for elt in target.elts:
                            if isinstance(elt, ast.Name):
                                bound.setdefault(elt.id, []).append(None)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and isinstance(
                node.target, ast.Name
            ):
                bound.setdefault(node.target.id, []).append(node.value)
            elif isinstance(node, (ast.For, ast.comprehension)):
                for elt in ast.walk(node.target):
                    if isinstance(elt, ast.Name):
                        bound.setdefault(elt.id, []).append(None)
            elif isinstance(node, ast.withitem) and node.optional_vars is not None:
                for elt in ast.walk(node.optional_vars):
                    if isinstance(elt, ast.Name):
                        bound.setdefault(elt.id, []).append(None)
        # A local is a tensor only if every binding is one; iterate to a
        # fixpoint so chains of locals resolve.
        changed = True
        while changed:
            changed = False
            for name, values in bound.items():
                if name in self.names:
                    continue
                if values and all(v is not None and self.is_tensor(v) for v in values):
                    self.names.add(name)
                    changed = True
        # A parameter rebound to a non-tensor is no longer known.
        for name, values in bound.items():
            if name in self.names and any(v is None or not self.is_tensor(v) for v in values):
                self.names.discard(name)
        # A local bound to a call that is not a tensor (``s = map_lanes(np_of,
        # tree)``) may hold host copies of the lanes: its lane attributes
        # are not known to be tensors.
        self.unknown_roots = {
            name for name, values in bound.items()
            if name not in self.names
            and any(v is None or (isinstance(v, ast.Call) and not self.is_tensor(v)) for v in values)
        }

    def is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in ("T", "mT"):
                return self.is_tensor(node.value)
            root = node.value
            while isinstance(root, (ast.Attribute, ast.Subscript)):
                root = root.value
            if isinstance(root, ast.Name) and root.id in self.unknown_roots:
                return False
            return node.attr in self.lanes
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.Call):
            if torch_call(node, self.aliases):
                return True
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr not in _HOST_METHODS:
                return self.is_tensor(func.value)
            return False
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return not isinstance(node.op, ast.Not) and self.is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return False
            return self.is_tensor(node.left) or any(self.is_tensor(c) for c in node.comparators)
        return False

    def is_mask(self, node: ast.AST) -> bool:
        """A boolean tensor by construction: a comparison, ``~``, ``&`` or
        ``|`` over a tensor."""
        if isinstance(node, ast.Compare):
            return self.is_tensor(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd, ast.BitOr)):
            return self.is_mask(node.left) or self.is_mask(node.right)
        return False


def _walk_no_nested(node: ast.AST):
    """Walk a function body without descending into nested function or
    class scopes (they get their own scope)."""
    yield node
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            continue
        yield from _walk_no_nested(child)


def scopes(tree: ast.AST):
    """(function node or None for module level, enclosing qualname parts)
    for every scope of the module."""
    def visit(node, names):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, names + [child.name]
                yield from visit(child, names + [child.name])
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, names + [child.name])
            else:
                yield from visit(child, names)

    yield tree, []
    yield from visit(tree, [])


def _after_cpu(node: ast.Call) -> bool:
    """``x.cpu().numpy()``: the ``.numpy()`` of a ``.cpu()`` is the same
    read, reported once."""
    receiver = node.func.value
    return (
        node.func.attr == "numpy"
        and isinstance(receiver, ast.Call)
        and isinstance(receiver.func, ast.Attribute)
        and receiver.func.attr == "cpu"
    )


def _is_python_scalar(node: ast.AST, fn: Optional[ast.AST]) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (bool, int, float)) and node.value is not None
    if isinstance(node, ast.UnaryOp) and isinstance(node.operand, ast.Constant):
        return _is_python_scalar(node.operand, fn)
    if isinstance(node, ast.Name) and fn is not None and not isinstance(fn, ast.Module):
        args = fn.args
        for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
            if a.arg == node.id and isinstance(a.annotation, ast.Name):
                return a.annotation.id in ("bool", "int", "float")
    return False


def _device_kw(call: ast.Call) -> Optional[ast.keyword]:
    return next((kw for kw in call.keywords if kw.arg == "device"), None)


def _is_cpu(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and node.args:
        return _is_cpu(node.args[0]) and (
            isinstance(node.func, ast.Attribute) and node.func.attr == "device"
        )
    return False


def _dtype_like(node: ast.AST, aliases: Dict[str, str]) -> bool:
    dotted = _dotted(node, aliases) or ""
    return dotted.startswith("torch.") and not dotted.startswith("torch.device")


class _Checker:
    def __init__(self, rel: str, src: str, tree: ast.AST):
        self.rel, self.tree = rel, tree
        self.lines = src.splitlines()
        self.aliases = _import_aliases(tree)
        self.lanes = lane_fields()
        self.findings: List[Finding] = []
        self.seen: Set[tuple] = set()
        posix = rel.replace("\\", "/")
        self.stream_file = any(posix.startswith(p) for p in STREAM_PREFIXES)
        self.stream_methods = STREAM_METHODS.get(posix, frozenset())
        # Constructors moved at once (``torch.tensor(x).to(dev)``) name
        # their device in the ``.to``: implicit-device passes them.
        self.moved = {
            id(node.func.value) for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("to", "cuda")
            and isinstance(node.func.value, ast.Call)
        }

    def report(self, node: ast.AST, check: str, message: str) -> None:
        lineno = node.lineno
        key = (lineno, check, message)
        if key in self.seen:
            return
        line = self.lines[lineno - 1] if 0 < lineno <= len(self.lines) else ""
        if _MARKERS[check] in line or (
            check == "uncounted-host-read" and "# host-sync-ok:" in line
        ):
            return
        self.seen.add(key)
        self.findings.append(Finding(self.rel, lineno, check, message))

    def run(self) -> List[Finding]:
        for fn, names in scopes(self.tree):
            scope = TensorScope(
                self.aliases, self.lanes, fn if not isinstance(fn, ast.Module) else None
            )
            streaming = self.stream_file or bool(set(names) & self.stream_methods)
            label = ".".join(names) or "<module>"
            for node in _walk_no_nested(fn):
                self._reads(node, scope, label)
                self._stores(node, scope, fn, label)
                self._device(node, fn, label)
                if streaming:
                    self._uploads(node, label)
        return sorted(self.findings, key=lambda f: (f.lineno, f.check, f.message))

    # -- uncounted-host-read --------------------------------------------------

    def _reads(self, node: ast.AST, scope: TensorScope, label: str) -> None:
        what = None
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in ("cpu", "numpy") and not node.args and not _after_cpu(node):
                what = f".{attr}()"
            elif attr in ("item", "tolist") and not node.args and scope.is_tensor(node.func.value):
                what = f".{attr}() of a tensor"
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in _CASTS
            and len(node.args) == 1
            and scope.is_tensor(node.args[0])
        ):
            what = f"{node.func.id}() of a tensor"
        elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)) and scope.is_tensor(
            node.test
        ):
            what = "a branch on a tensor"
            node = node.test
        if what:
            self.report(
                node, "uncounted-host-read",
                f"{what} in {label!r}: a blocking device->host read that "
                f"_host.read does not count — read through _host.read (counted "
                f"per round), keep the value on the device, or justify with "
                f"`# host-read-ok: <reason>`",
            )

    # -- index-store-sync ------------------------------------------------------

    def _stores(self, node: ast.AST, scope: TensorScope, fn, label: str) -> None:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AugAssign):
            targets, value = [node.target], None
        else:
            return
        for target in targets:
            if not (isinstance(target, ast.Subscript) and scope.is_tensor(target.value)):
                continue
            index = target.slice
            parts = index.elts if isinstance(index, ast.Tuple) else [index]
            if any(scope.is_mask(p) or (
                isinstance(p, ast.Name) and p.id in scope.names and _bound_to_mask(fn, p.id, scope)
            ) for p in parts):
                self.report(
                    target, "index-store-sync",
                    f"store through a boolean mask in {label!r}: the mask "
                    f"becomes indices with a nonzero() that waits for the "
                    f"card — use torch.where, or justify with "
                    f"`# index-store-ok: <reason>`",
                )
            elif (
                value is not None
                and _is_python_scalar(value, fn)
                and any(scope.is_tensor(p) for p in parts)
            ):
                self.report(
                    target, "index-store-sync",
                    f"Python scalar stored through advanced indexing in "
                    f"{label!r}: the scalar is copied from pageable memory, "
                    f"which waits for the card — use index_fill_, or "
                    f"justify with `# index-store-ok: <reason>`",
                )

    # -- pageable-upload -------------------------------------------------------

    def _uploads(self, node: ast.AST, label: str) -> None:
        if not isinstance(node, ast.Call):
            return
        what = None
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "cuda":
            what = ".cuda()"
        elif isinstance(func, ast.Attribute) and func.attr == "to":
            receiver = func.value
            maker = (
                _dotted(receiver.func, self.aliases)
                if isinstance(receiver, ast.Call) else None
            )
            target = node.args[0] if node.args else (
                _device_kw(node).value if _device_kw(node) else None
            )
            if (
                maker in ("torch.from_numpy", "torch.tensor", "torch.as_tensor")
                and target is not None
                and not _is_cpu(target)
                and not _dtype_like(target, self.aliases)
            ):
                what = f"{maker}(...).to(...)"
        else:
            dotted = _dotted(func, self.aliases)
            kw = _device_kw(node)
            if (
                dotted in ("torch.tensor", "torch.as_tensor")
                and kw is not None
                and not _is_cpu(kw.value)
                and not (isinstance(kw.value, ast.Constant) and kw.value.value is None)
            ):
                what = f"{dotted}(..., device=...)"
        if what:
            self.report(
                node, "pageable-upload",
                f"{what} in {label!r} on the streaming path: a copy from "
                f"pageable memory waits for all the work queued before it — "
                f"upload through _host.upload (pinned, non-blocking), or "
                f"justify with `# upload-ok: <reason>`",
            )

    # -- implicit-device -------------------------------------------------------

    def _device(self, node: ast.AST, fn, label: str) -> None:
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func, self.aliases) or ""
            if not (dotted.startswith("torch.") and dotted.split(".", 1)[1] in _CONSTRUCTORS):
                return
            if _device_kw(node) is not None or any(
                kw.arg == "pin_memory" for kw in node.keywords
            ):
                return
            if id(node) in self.moved:
                return
            self.report(
                node, "implicit-device",
                f"{dotted}(...) with no device= in {label!r}: the tensor "
                f"lands on torch's CPU default, not the engine's device — "
                f"pass device=, or justify with `# device-ok: <reason>`",
            )
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is fn:
            self._device_param(node, label)

    def _device_param(self, fn, label: str) -> None:
        args = fn.args
        positional = [*args.posonlyargs, *args.args]
        defaults = dict(zip([a.arg for a in positional[len(positional) - len(args.defaults):]],
                            args.defaults))
        defaults.update({a.arg: d for a, d in zip(args.kwonlyargs, args.kw_defaults) if d})
        default = defaults.get("device")
        if not (isinstance(default, ast.Constant) and default.value is None):
            return
        resolved = False
        uses: List[ast.Call] = []
        for node in _walk_no_nested(fn):
            if isinstance(node, ast.Call):
                dotted = _dotted(node.func, self.aliases) or ""
                if dotted.endswith("resolve_device"):
                    resolved = True
                kw = _device_kw(node)
                if (
                    kw is not None
                    and isinstance(kw.value, ast.Name)
                    and kw.value.id == "device"
                    and dotted.startswith("torch.")
                    and dotted.split(".", 1)[1] in _CONSTRUCTORS
                ):
                    uses.append(node)
        if uses and not resolved:
            self.report(
                uses[0], "implicit-device",
                f"{label!r} hands its device=None default to a tensor "
                f"constructor without resolve_device: a call that names no "
                f"device lands on the CPU instead of the card — resolve it "
                f"(models/state.resolve_device), or justify with "
                f"`# device-ok: <reason>`",
            )


def _bound_to_mask(fn, name: str, scope: TensorScope) -> bool:
    """True when every binding of local ``name`` in ``fn`` is a mask."""
    if fn is None or isinstance(fn, ast.Module):
        return False
    values = [
        n.value for n in _walk_no_nested(fn)
        if isinstance(n, ast.Assign)
        and any(isinstance(t, ast.Name) and t.id == name for t in n.targets)
    ]
    return bool(values) and all(scope.is_mask(v) for v in values)


def check_sync_safety(
    path: Path,
    source: Optional[str] = None,
    tree: "Optional[ast.AST]" = None,
) -> List[Finding]:
    rel = core.rel(path)
    posix = rel.replace("\\", "/")
    if not any(posix.startswith(p) for p in SYNC_SAFETY_PREFIXES):
        return []
    src = source if source is not None else path.read_text()
    if tree is None:
        tree = ast.parse(src, filename=str(path))
    return _Checker(rel, src, tree).run()
