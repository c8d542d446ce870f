"""Check family 17: dataflow provenance of the port's engine entry points
(the counterpart of the JAX package's ``dataflow`` family), frozen in
``dataflow.lock.json``.

JAX traces each entry point to its closed jaxpr and propagates per-lane
taint over it. The port has no jaxpr: it traces one eager call of each
registered entry point (``device_program.registry`` plus the meshless
fleet step) under a ``TorchDispatchMode`` and propagates taint over the
aten operators as they run, on the inputs and outputs the registry labels
(``state.alive``, ``telem.tl_enq``, ... : the containers' JAX names).

The tracer keeps taint per **storage**, not per tensor object, since views
share storage: an operator's fresh outputs take the union of its inputs'
taint, and an output in an input's storage (an in-place operator
``add_`` / ``index_fill_`` / ``copy_``, a view) unions it into that
storage. A lane returned in its input's storage (the program lock's
``lanes_in_place``) therefore keeps its own slot: the counterpart of
JAX's per-slot carry rule, so donation never fabricates an edge.
Control dependence: JAX taints a ``cond``'s outputs with its predicate;
the eager port branches on the host, and every branch is a counted read
(``_host.read``), so a read's taint becomes a *control* taint on every
operator dispatched after it in that call. Data and control edges are
kept apart in the lock. The delivery kernel is one opaque node: on a card
it is a ctypes call dispatch never sees, on the CPU its plain version, so
the tracer takes ``models.virtual_cluster.delivery_new_bits`` whole, with
its declared relation (blocked, age, epoch -> out; tenant axis 0 kept),
and the CPU trace and the card trace are the same relation. An eager
trace sees only the branches that ran, so each entry point is traced on
the churned audit cluster and on its quiescent soak (the quiescent audit
cluster, the round loops capped at ``QUIESCENT_SOAK_ROUNDS``), and the
relations are united.

Checks, under JAX's names:

``dataflow-observer-effect``
    No telemetry (``tl_*``) or trace-ring (``tr_*``) lane reaches any
    ``state.*`` or ``events.*`` lane, by data or by control.
``dataflow-cross-tenant``
    A tenant-axis interpretation over the fleet entry points: which
    dimension of every tensor is the tenant axis, through views and
    permutes. Elementwise operators keep it (aligned by broadcasting);
    reductions, gathers and index operators along it, and unknown
    operators, give ``mixed``. The port writes vmap out as an explicit
    leading axis, so the rules see it directly. Host reads that reduce
    over tenants are control, not data, and are exempt, as JAX exempts
    while-predicates; a data output that mixes tenants is a finding.
``dataflow-dense-op``
    The sparse-opportunity map: operators of a quiescent ``step`` round
    over a full-N operand all of whose consumers are selects (``where``,
    or ``&`` / ``*`` by a bool mask) whose mask's taint holds an
    activity/alert/freeze lane (``GATING_LANE_FIELDS``), keyed by source
    location (the first frame in ``rapid_tpu_torch/`` outside ``tools/``)
    and priced by aten operators and bytes touched against the cost
    lock's ``quiescent_round_cost``. The map's totals must equal the cost
    lock's (two locks, one round). JAX's coverage floor is 90% of the
    frozen collective bytes; the eager round's waste is launches, not
    collectives, and most of its operators feed outputs directly, so the
    port's floor is the coverage measured when the lock was made, rounded
    down to 5 points, and stored in the lock: a change that un-gates a
    dense operator fails it.
``dataflow-dead-lane``
    State lanes written by some entry point that influence no non-state
    output, transitively, and that no host code names (the ``deadcode``
    family's reference collector): the two liveness families agree.
``dataflow-lock-drift``
    The committed lock no longer matches the live trace, per block.

The relations and the proofs are the same on every device and torch
release; the opportunity map's prices are compared only under the torch
release the lock records (aten decompositions move them), and off it the
map's totals are held against the live cost block instead. ``python -m
rapid_tpu_torch.tools.staticcheck --update-dataflow-lock`` regenerates
the lock byte-identically and refuses while any proof fails.

``check_dataflow`` is the per-file corpus mode: a module declaring
``DATAFLOW_AUDIT_PROGRAMS`` (name -> ``{"build": zero-arg callable
returning a registry-shaped spec, "checks": subset of ("observer-effect",
"cross-tenant", "dense-op"), optional "tenants" / "dense_n"}``) is traced
and checked, each finding at the program's dict-key line.
"""

from __future__ import annotations

import ast
import json
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import core, device_program
from .core import Finding

DATAFLOW_LOCK_REL = "rapid_tpu_torch/tools/analysis/dataflow.lock.json"

_REGEN_HINT = (
    "rerun `python -m rapid_tpu_torch.tools.staticcheck --update-dataflow-lock` "
    "after reviewing the influence change"
)

#: Rounds of the quiescent soak (the program lock's).
QUIESCENT_SOAK_ROUNDS = device_program.QUIESCENT_SOAK_ROUNDS

#: Containers whose fields become lane-label prefixes (JAX's names).
_CONTAINER_PREFIX = {
    "EngineState": "state",
    "TelemetryLanes": "telem",
    "TraceRing": "trace",
    "FaultInputs": "faults",
    "StepEvents": "events",
}

_OBSERVER_CONTAINERS = ("telem", "trace")
_OBSERVER_FIELDS = ("tl_", "tr_")
_SUBJECT_CONTAINERS = ("state", "events")

#: Activity/alert/freeze masks (JAX's): a dense operator counts as
#: mask-gated when the mask deciding whether its result is used derives
#: from one of these lanes.
GATING_LANE_FIELDS = frozenset({
    "alive", "crashed", "probe_fail", "rx_block",
    "fd_fired", "fd_count", "fd_hist", "fire_round",
    "report_bits", "seen_down", "released", "announced",
    "prop_mask", "join_pending", "vote_valid", "retired",
    "rounds_undecided", "decided", "round_idx",
})

#: The opportunity map's entry point and the cost lock's block it prices.
OPPORTUNITY_ENTRYPOINT = "step"

#: Fleet entry points the tenant-axis interpretation covers.
FLEET_ENTRYPOINTS = ("fleet3d_step", "fleet3d_wave", "fleet_step")

_MIXED = "mixed"


# ---------------------------------------------------------------------------
# lane labels
# ---------------------------------------------------------------------------


def lane_labels(tree: Any, role: str = "in") -> List[Tuple[str, Any]]:
    """``(label, tensor)`` for every tensor of ``tree``, JAX's labels: a
    NamedTuple container contributes its prefix (``state.alive``),
    positional nesting its index, a bare tensor ``<role><i>``; the values
    of a dict (the registry's lane trees) are labelled as positional
    arguments. ``None`` and non-tensors contribute nothing."""
    import torch

    out: List[Tuple[str, Any]] = []

    def walk(node: Any, path: str, fallback: str) -> None:
        if node is None:
            return
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            name = _CONTAINER_PREFIX.get(type(node).__name__, type(node).__name__.lower())
            base = f"{path}.{name}" if path else name
            for field in node._fields:
                walk(getattr(node, field), f"{base}.{field}", f"{base}.{field}")
            return
        if isinstance(node, (tuple, list)):
            for i, item in enumerate(node):
                walk(item, f"{path}[{i}]" if path else "", f"{fallback}[{i}]")
            return
        if isinstance(node, torch.Tensor):
            out.append((path or fallback, node))

    if isinstance(tree, dict):
        tree = tuple(tree[key] for key in tree)
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        for i, arg in enumerate(tree):
            walk(arg, "", f"{role}{i}")
    else:
        walk(tree, "", f"{role}0")
    return out


def _field_of(label: str) -> str:
    return label.rsplit(".", 1)[-1]


def _container_of(label: str) -> str:
    return label.split(".", 1)[0] if "." in label else ""


def _is_observer_lane(label: str) -> bool:
    return _container_of(label) in _OBSERVER_CONTAINERS or _field_of(label).startswith(
        _OBSERVER_FIELDS)


def _is_subject_lane(label: str) -> bool:
    return _container_of(label) in _SUBJECT_CONTAINERS and not _field_of(label).startswith(
        _OBSERVER_FIELDS)


def _is_gating_lane(label: str) -> bool:
    return _field_of(label) in GATING_LANE_FIELDS


# ---------------------------------------------------------------------------
# tenant-axis rules over aten operators
# ---------------------------------------------------------------------------

#: Operators whose output dims are their broadcast operands' dims.
_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "floor_divide", "pow", "neg",
    "abs", "sign", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "__and__", "__or__", "__xor__", "__lshift__", "__rshift__", "__ilshift__", "__irshift__",
    "bitwise_left_shift", "bitwise_right_shift", "logical_and", "logical_or", "logical_xor",
    "logical_not", "eq", "ne", "lt", "le", "gt", "ge", "where", "clamp", "clamp_min",
    "clamp_max", "minimum", "maximum", "masked_fill", "fill", "zero", "_to_copy", "to",
    "clone", "alias", "detach", "copy", "contiguous", "lift_fresh", "lift_fresh_copy",
    "_conj", "resolve_conj", "resolve_neg", "expand_as",
})
#: Operators that make data from nothing: no tenant axis.
_CREATION = frozenset({
    "arange", "full", "zeros", "ones", "empty", "empty_strided", "scalar_tensor",
    "zeros_like", "ones_like", "empty_like", "full_like", "new_zeros", "new_ones",
    "new_empty", "new_full", "new_empty_strided", "linspace", "eye",
})
_REDUCTIONS = frozenset({
    "sum", "mean", "prod", "any", "all", "amax", "amin", "max", "min", "argmax", "argmin",
    "count_nonzero", "logsumexp", "nansum", "std", "var",
})
_SCANS = frozenset({"cumsum", "cumprod", "cummax", "cummin", "logcumsumexp"})
_ALONG = frozenset({"sort", "argsort", "topk", "kthvalue", "median", "mode", "msort"})


def _norm(dim: int, ndim: int) -> int:
    return dim + ndim if dim < 0 else dim


def _unify(axes: Sequence[Any]) -> Any:
    """None (uniform) / int (the tenant dim) / 'mixed' join."""
    seen = {a for a in axes if a is not None}
    if not seen:
        return None
    if _MIXED in seen or len(seen) > 1:
        return _MIXED
    return seen.pop()


def _aligned(axis: Any, ndim: int, out_ndim: int) -> Any:
    if axis is None or axis == _MIXED:
        return axis
    return axis + out_ndim - ndim


def _shift_removed(axis: int, removed: Sequence[int]) -> Any:
    if axis in removed:
        return _MIXED
    return axis - sum(1 for d in removed if d < axis)


def _reshape_axis(axis: int, shape: Sequence[int], new_shape: Sequence[int]) -> Any:
    """JAX's reshape rule: the tenant dim survives when the dims before it
    and its own size come out whole."""
    prefix = 1
    for d in range(axis):
        prefix *= shape[d]
    running = 1
    for e, size in enumerate(new_shape):
        if running == prefix and size == shape[axis]:
            return e
        running *= size
    return _MIXED


def axis_rule(name: str, overload: str, args: Sequence[Any], kwargs: Dict[str, Any],
              axis_of, outs: Sequence[Any]) -> Tuple[Any, bool]:
    """The tenant axis of an operator's outputs (one for all of them), and
    whether the rule knew the operator. ``axis_of(t)`` reads an input's
    axis."""
    import torch

    tensors = [(a, axis_of(a)) for a in device_program.tensor_leaves((args, kwargs))]
    if all(ax is None for _, ax in tensors):
        return None, True
    base = name[:-1] if name.endswith("_") and not name.endswith("__") else name
    self_t = args[0] if args and isinstance(args[0], torch.Tensor) else None
    self_ax = axis_of(self_t) if self_t is not None else None
    ndim = self_t.dim() if self_t is not None else 0
    out_ndim = outs[0].dim() if outs else 0

    def arg(i: int, key: str, default=None):
        if len(args) > i:
            return args[i]
        return kwargs.get(key, default)

    if base in _CREATION:
        return None, True
    if base in _ELEMENTWISE:
        return _unify([_aligned(ax, t.dim(), out_ndim) for t, ax in tensors]), True
    if base in ("view", "_unsafe_view", "reshape"):
        if self_ax in (None, _MIXED):
            return self_ax, True
        return _reshape_axis(self_ax, list(self_t.shape), list(outs[0].shape)), True
    if self_ax == _MIXED:
        return _MIXED, True
    if base in ("expand", "broadcast_to"):
        return _aligned(self_ax, ndim, out_ndim), True
    if base == "unsqueeze":
        if self_ax is None:
            return None, True
        dim = _norm(arg(1, "dim"), ndim + 1)
        return self_ax + (1 if dim <= self_ax else 0), True
    if base == "squeeze":
        if self_ax is None:
            return None, True
        if overload == "default":
            removed = [d for d in range(ndim) if self_t.shape[d] == 1]
        else:
            dims = arg(1, "dim")
            dims = dims if isinstance(dims, (list, tuple)) else [dims]
            removed = [_norm(d, ndim) for d in dims if self_t.shape[_norm(d, ndim)] == 1]
        return _shift_removed(self_ax, removed), True
    if base == "permute":
        if self_ax is None:
            return None, True
        dims = [_norm(d, ndim) for d in arg(1, "dims")]
        return dims.index(self_ax), True
    if base == "transpose":
        if self_ax is None:
            return None, True
        d0, d1 = _norm(arg(1, "dim0"), ndim), _norm(arg(2, "dim1"), ndim)
        return {d0: d1, d1: d0}.get(self_ax, self_ax), True
    if base in ("t", "numpy_T"):
        return (None if self_ax is None else ndim - 1 - self_ax), True
    if base in ("select", "unbind"):
        if self_ax is None:
            return None, True
        dim = _norm(arg(1, "dim", 0), ndim)
        return _shift_removed(self_ax, [dim]), True
    if base in ("slice", "narrow"):
        if self_ax is None:
            return None, True
        dim = _norm(arg(1, "dim", 0), ndim)
        if dim != self_ax:
            return self_ax, True
        return (self_ax if outs[0].shape[dim] == self_t.shape[dim] else _MIXED), True
    if base in ("split", "split_with_sizes", "chunk", "tensor_split"):
        if self_ax is None:
            return None, True
        dim = _norm(arg(2, "dim", 0), ndim)
        return (_MIXED if dim == self_ax else self_ax), True
    if base in ("flip", "roll"):
        if self_ax is None:
            return None, True
        dims = arg(1, "dims") if base == "flip" else arg(2, "dims", [])
        dims = [_norm(d, ndim) for d in (dims if isinstance(dims, (list, tuple)) else [dims])]
        return (_MIXED if self_ax in dims or not dims else self_ax), True
    if base in _REDUCTIONS:
        dims = arg(1, "dim")
        dims = [] if dims is None else dims if isinstance(dims, (list, tuple)) else [dims]
        if self_ax is None:
            return None, True
        dims = [_norm(d, ndim) for d in dims]
        if not dims or self_ax in dims:  # no dims: the whole tensor
            return _MIXED, True
        keep = arg(2, "keepdim", False)
        return (self_ax if keep else _shift_removed(self_ax, dims)), True
    if base in _SCANS or base in _ALONG:
        if self_ax is None:
            return None, True
        dim = _norm(arg(1, "dim", -1) if base != "topk" else arg(2, "dim", -1), ndim)
        return (_MIXED if dim == self_ax else self_ax), True
    if base in ("cat", "concat", "concatenate", "stack"):
        seq = arg(0, "tensors")
        axes = [axis_of(t) for t in seq]
        ranks = {t.dim() for t in seq}
        if len(ranks) != 1:
            return _unify(axes) if _unify(axes) in (None,) else _MIXED, True
        ax = _unify(axes)
        if ax in (None, _MIXED):
            return ax, True
        r = ranks.pop()
        if base == "stack":
            dim = _norm(arg(1, "dim", 0), r + 1)
            return ax + (1 if dim <= ax else 0), True
        dim = _norm(arg(1, "dim", 0), r)
        return (_MIXED if dim == ax else ax), True
    if base == "gather":
        dim = _norm(arg(1, "dim"), ndim)
        idx_ax = axis_of(arg(2, "index"))
        ax = _unify([self_ax, idx_ax])
        return (_MIXED if ax == dim else ax), True
    if base in ("scatter", "scatter_add", "scatter_reduce", "index_add", "index_copy",
                "index_fill", "index_select"):
        dim = _norm(arg(1, "dim"), ndim)
        ax = _unify([ax for _, ax in tensors])
        if base in ("index_add", "index_copy", "index_fill", "index_select") and \
                axis_of(arg(2, "index")) is not None:
            return _MIXED, True
        return (_MIXED if ax == dim else ax), True
    if base in ("index", "index_put", "_index_put_impl"):
        indices = arg(1, "indices")
        idx = [(i, t) for i, t in enumerate(indices) if t is not None]
        if any(axis_of(t) is not None for _, t in idx):
            return _MIXED, True
        if self_ax is None:
            values = arg(2, "values")
            return (None if values is None or axis_of(values) is None else _MIXED), True
        if any(i <= self_ax for i, _ in idx):
            return _MIXED, True
        if base != "index":
            values = arg(2, "values")
            if values is not None and axis_of(values) is not None:
                return _MIXED, True
        return self_ax, True
    if name in ("allreduce_", "allgather_", "allgather_into_tensor_coalesced_",
                "_allgather_base_", "broadcast_", "reduce_scatter_"):
        # The collectives' groups are the program lock's concern (no group
        # spans tenant blocks, frozen at zero); each keeps its tenant dim.
        return _unify([ax for _, ax in tensors]), True
    return _MIXED, False


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


def _plain(t):
    return device_program.plain_tensor(t)


def _key(t) -> int:
    return device_program.storage_key(_plain(t))


_HERE = os.path.dirname(os.path.abspath(__file__))
_PACKAGE = os.path.dirname(os.path.dirname(_HERE))
_TOOLS = os.path.join(_PACKAGE, "tools")
_REPO_ROOT = os.path.dirname(_PACKAGE)


def source_of_frame() -> str:
    """``path:line (function)`` of the first frame in ``rapid_tpu_torch/``
    outside ``tools/`` on the caller's stack, or ``?``."""
    frame = sys._getframe(1)
    while frame is not None:
        path = frame.f_code.co_filename
        if path.startswith(_PACKAGE) and not path.startswith(_TOOLS):
            rel = os.path.relpath(path, _REPO_ROOT).replace(os.sep, "/")
            return f"{rel}:{frame.f_lineno} ({frame.f_code.co_name})"
        frame = frame.f_back
    return "?"


class Tracer:
    """One traced call: per-storage data and control taint (bitmasks over
    the input labels), the tenant axis of every tensor when ``tenants``,
    and with ``record`` an operator record per dispatch for the
    opportunity map."""

    def __init__(self, labels: List[str], tenants: int = 0, record: bool = False):
        from torch.utils.weak import WeakTensorKeyDictionary

        self.labels = labels
        self.tenants = tenants
        self.record = record
        self.data: Dict[int, int] = {}
        self.ctrl: Dict[int, int] = {}
        self.ctrl_now = 0
        self.axes = WeakTensorKeyDictionary()
        self.mixed_storages: set = set()
        self.fallbacks: List[str] = []
        self.opaque = 0
        self.aten_ops = 0
        self.bytes_touched = 0
        self.records: List[Dict[str, Any]] = []
        self.segs: Dict[int, Dict[str, Any]] = {}
        self.version: Dict[int, int] = {}
        self.view_taint = WeakTensorKeyDictionary()
        # tensor -> (record, output position): weak, since holding the
        # traced tensors would change what the engine dispatches.
        self.token = WeakTensorKeyDictionary()
        self.read_tokens: set = set()

    # -- inputs and reads --------------------------------------------------

    def seed(self, pairs: List[Tuple[str, Any]]) -> None:
        for i, (_label, t) in enumerate(pairs):
            k = _key(t)
            self.data[k] = self.data.get(k, 0) | (1 << i)
            if self.tenants:
                # A DTensor lane's axis is its local tensor's: the round body
                # computes on the local tensors.
                self.axes[_plain(t)] = 0 if t.dim() >= 1 and t.shape[0] == self.tenants else None

    def taint(self, t) -> Tuple[int, int]:
        """(data, control) of ``t``: a narrowed view's own, else its
        storage's."""
        p = _plain(t)
        k = device_program.storage_key(p)
        own = self.view_taint.get(p)
        if own is not None and own[2] == self.version.get(k, 0):
            return own[0], own[1]
        return self.data.get(k, 0), self.ctrl.get(k, 0)

    # -- packed lanes ----------------------------------------------------------
    #
    # The sharded round packs lanes into one buffer for a collective
    # (``torch.cat`` / ``torch.stack``, then an all-reduce or all-gather,
    # then slices), so per-storage taint alone would join the packed lanes.
    # A storage made by packing keeps its segments along the packed dim
    # while it keeps its layout; elementwise copies and the collectives
    # carry them, and a slice or select along that dim takes only the
    # segments it covers. Anything else falls back to the storage's taint.

    def _seg(self, p) -> Optional[Dict[str, Any]]:
        k = device_program.storage_key(p)
        seg = self.segs.get(k)
        if (seg is not None and seg["version"] == self.version.get(k, 0)
                and tuple(p.shape) == seg["shape"] and tuple(p.stride()) == seg["stride"]
                and p.storage_offset() == 0):
            return seg
        return None

    def _set_seg(self, p, dim: int, bounds: List[Tuple[int, int, int, int]]) -> None:
        k = device_program.storage_key(p)
        if len({(d, c) for _, _, d, c in bounds}) <= 1:
            self.segs.pop(k, None)
            return
        self.segs[k] = {"dim": dim, "bounds": bounds, "shape": tuple(p.shape),
                        "stride": tuple(p.stride()), "version": self.version.get(k, 0)}

    def _narrow(self, seg, lo: int, hi: int, out) -> None:
        data = ctrl = 0
        for a, b, d, c in seg["bounds"]:
            if a < hi and lo < b:
                data, ctrl = data | d, ctrl | c
        k = device_program.storage_key(out)
        self.view_taint[out] = (data, ctrl, self.version.get(k, 0))

    def _packing(self, name, args, pins, pouts, pre, fresh) -> None:
        """The segment rules (``pre``: each input's segments before the
        operator; ``fresh``: the outputs in new storages)."""
        import torch

        if name in ("cat", "concat", "concatenate") and fresh:
            seq = [_plain(t) for t in args[0]]
            out = pouts[0]
            dim = _norm(args[1] if len(args) > 1 else 0, out.dim())
            bounds, offset = [], 0
            segs = [pre.get(id(t)) for t in seq]
            others = {(seg["dim"], tuple((a, b) for a, b, _, _ in seg["bounds"]))
                      for seg in segs if seg is not None}
            if all(seg is not None for seg in segs) and len(others) == 1 and \
                    next(iter(others))[0] != dim:
                # Parts packed alike, joined along another dim (a gather).
                odim = next(iter(others))[0]
                merged = []
                for i, (a, b, _, _) in enumerate(segs[0]["bounds"]):
                    d = c = 0
                    for seg in segs:
                        d, c = d | seg["bounds"][i][2], c | seg["bounds"][i][3]
                    merged.append((a, b, d, c | self.ctrl_now))
                self._set_seg(out, odim, merged)
                return
            for t, seg in zip(seq, segs):
                size = t.shape[dim] if t.dim() else 1
                if seg is not None and seg["dim"] == dim:
                    bounds += [(a + offset, b + offset, d, c | self.ctrl_now)
                               for a, b, d, c in seg["bounds"]]
                elif size:
                    d, c = self.taint(t)
                    bounds.append((offset, offset + size, d, c | self.ctrl_now))
                offset += size
            self._set_seg(out, dim, bounds)
        elif name == "stack" and fresh:
            seq = [_plain(t) for t in args[0]]
            out = pouts[0]
            dim = _norm(args[1] if len(args) > 1 else 0, out.dim())
            self._set_seg(out, dim, [(i, i + 1, *self._with_now(self.taint(t)))
                                     for i, t in enumerate(seq)])
        elif name in ("allreduce_", "broadcast_"):
            for t in args[0]:
                p = _plain(t)
                if pre.get(id(p)) is not None:
                    seg = pre[id(p)]
                    self._set_seg(p, seg["dim"], seg["bounds"])
        elif name == "allgather_":
            for outs_j, src in zip(zip(*args[0]) if args[0] and isinstance(args[0][0], list)
                                   else [args[0]], args[1]):
                seg = pre.get(id(_plain(src)))
                for t in (outs_j if isinstance(outs_j, (list, tuple)) else [outs_j]):
                    p = _plain(t)
                    if seg is not None and tuple(p.shape) == seg["shape"]:
                        self._set_seg(p, seg["dim"], seg["bounds"])
        elif name == "copy_" and len(pins) >= 2:
            dst, src = pins[0], pins[1]
            seg = pre.get(id(src))
            whole = (dst.is_contiguous() and dst.storage_offset() == 0
                     and dst.numel() * dst.element_size() == dst.untyped_storage().nbytes())
            if seg is not None and whole and tuple(dst.shape) == seg["shape"]:
                self._set_seg(dst, seg["dim"], seg["bounds"])
        elif name in _ELEMENTWISE and len(fresh) == 1:
            out = fresh[0]
            carried = [p for p in pins if pre.get(id(p)) is not None
                       and tuple(p.shape) == tuple(out.shape)]
            if len(carried) == 1:
                seg = pre[id(carried[0])]
                d_rest = c_rest = 0
                for p in pins:
                    if p is not carried[0]:
                        d, c = self.taint(p)
                        d_rest, c_rest = d_rest | d, c_rest | c
                self._set_seg(out, seg["dim"], [(a, b, d | d_rest, c | c_rest | self.ctrl_now)
                                                for a, b, d, c in seg["bounds"]])
        elif name in ("slice", "narrow", "select", "unbind") and pins:
            src = pins[0]
            seg = pre.get(id(src))
            dim = _norm(args[1] if len(args) > 1 else 0, src.dim())
            if seg is not None and dim == seg["dim"]:
                size = src.shape[dim]
                if name == "unbind":
                    for i, out in enumerate(pouts):
                        self._narrow(seg, i, i + 1, out)
                    return
                if name == "select":
                    i = _norm(args[2], size)
                    self._narrow(seg, i, i + 1, pouts[0])
                    return
                if name == "narrow":
                    lo = _norm(args[2], size)
                    hi = lo + args[3]
                else:
                    lo = args[2] if len(args) > 2 and args[2] is not None else 0
                    hi = args[3] if len(args) > 3 and args[3] is not None else size
                    lo, hi = max(_norm(min(lo, size), size), 0), max(_norm(min(hi, size), size), 0)
                self._narrow(seg, lo, hi, pouts[0])
                return
        # A view of a narrowed view keeps the narrowing.
        own = self.view_taint.get(pins[0]) if pins and not fresh else None
        if own is not None and own[2] == self.version.get(device_program.storage_key(pins[0]), 0):
            for out in pouts:
                self.view_taint[out] = own

    def _with_now(self, taint: Tuple[int, int]) -> Tuple[int, int]:
        return taint[0], taint[1] | self.ctrl_now

    def on_read(self, t) -> None:
        data, ctrl = self.taint(t)
        self.ctrl_now |= data | ctrl
        if self.record and self.token.get(t) is not None:
            self.read_tokens.add(self.token.get(t))

    def axis_of(self, t) -> Any:
        if t is None:
            return None
        if _key(t) in self.mixed_storages:
            return _MIXED
        return self.axes.get(_plain(t))

    # -- operators -----------------------------------------------------------

    def on_op(self, func, args, kwargs, out) -> None:
        ins = device_program.tensor_leaves((args, kwargs))
        outs = device_program.tensor_leaves(out)
        mutated = []
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                value = args[i] if i < len(args) else kwargs.get(a.name)
                mutated.extend(device_program.tensor_leaves(value))
        outs = outs + [t for t in mutated if all(t is not o for o in outs)]
        self.aten_ops += 1
        pins, pouts = [_plain(t) for t in ins], [_plain(t) for t in outs]
        nbytes = sum(map(device_program.tensor_bytes, pins)) + sum(
            map(device_program.tensor_bytes, pouts))
        self.bytes_touched += nbytes
        if self.opaque:
            return
        name = func.overloadpacket.__name__
        in_keys = {device_program.storage_key(t) for t in pins}
        pre = {id(t): self._seg(t) for t in pins}
        data = ctrl = 0
        sources = pins
        if name == "where" and len(pins) == 3 and pins[1] is pins[2]:
            # where(m, a, a) is a: the mask decides nothing (a tenant's view
            # change selected over lanes it leaves as they are).
            sources = pins[1:2]
        for t in sources:
            d, c = self.taint(t)
            data, ctrl = data | d, ctrl | c
        ctrl |= self.ctrl_now
        written = {device_program.storage_key(_plain(t)) for t in mutated}
        fresh = []
        for t in pouts:
            k = device_program.storage_key(t)
            if k in in_keys:
                self.data[k] = self.data.get(k, 0) | data
                self.ctrl[k] = self.ctrl.get(k, 0) | ctrl
            else:
                self.data[k], self.ctrl[k] = data, ctrl
                self.mixed_storages.discard(k)
                fresh.append(t)
                written.add(k)
        for k in written:
            self.version[k] = self.version.get(k, 0) + 1
        self._packing(name, args, pins, pouts, pre, fresh)
        if self.tenants:
            axis, known = axis_rule(name, func._overloadname, args, kwargs, self.axis_of, outs)
            if not known:
                self.fallbacks.append(name)
            for t in pouts:
                self.axes[t] = axis
                if axis == _MIXED and device_program.storage_key(_plain(t)) in in_keys:
                    self.mixed_storages.add(device_program.storage_key(_plain(t)))
        if self.record:
            self._record(f"{func.overloadpacket.__name__}.{func._overloadname}", ins, outs, nbytes)

    def _record(self, op: str, ins, outs, nbytes: int, opaque: bool = False) -> None:
        """One operator of the opportunity map's def-use graph (``opaque``:
        the delivery kernel's node, never a dense candidate)."""
        import torch

        index = len(self.records)
        srcs = [self.token.get(t) for t in ins]
        for src in srcs:
            if src is not None:
                self.records[src[0]]["uses"].append(index)
        self.records.append({
            "op": op,
            "name": op.split(".", 1)[0],
            "source": source_of_frame(),
            "elems": max((t.numel() for t in ins + outs), default=0),
            "bytes": nbytes,
            "ins": srcs,
            "in_taint": [self.taint(t)[0] | self.taint(t)[1] for t in ins],
            "in_bool": [t.dtype == torch.bool for t in ins],
            "outs": [(index, pos) for pos in range(len(outs))],
            "uses": [],
            "opaque": opaque,
        })
        for pos, t in enumerate(outs):
            self.token[t] = (index, pos)


def _mode(tracer: Tracer):
    from torch.utils._python_dispatch import TorchDispatchMode

    class Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.overloadpacket.__name__ == "_local_scalar_dense":
                tracer.on_read(args[0])
            tracer.on_op(func, args, kwargs, out)
            return out

    return Trace()


def _delivery_relation(tracer: Tracer, real):
    """The delivery kernel as one opaque node: its operators counted, not
    traced; its output takes blocked, age and epoch's taint and keeps the
    tenant axis of its inputs (axis 0 of a fleet's ``[t, ...]`` lanes)."""

    def delivery(blocked, age, epoch, *params, **tile):
        ins = (blocked, age, epoch)
        data = ctrl = 0
        for t in ins:
            d, c = tracer.taint(t)
            data, ctrl = data | d, ctrl | c
        tracer.opaque += 1
        try:
            out = real(blocked, age, epoch, *params, **tile)
        finally:
            tracer.opaque -= 1
        k = _key(out)
        tracer.data[k], tracer.ctrl[k] = data, ctrl | tracer.ctrl_now
        tracer.mixed_storages.discard(k)
        if tracer.tenants:
            axes = {tracer.axis_of(t) for t in ins}
            tracer.axes[_plain(out)] = _unify(list(axes)) if axes <= {0, None} else _MIXED
        if tracer.record:
            tracer._record("delivery_new_bits", list(ins), [out], 0, opaque=True)
        return out

    return delivery


def _dealias(inputs: Dict[str, Any]) -> None:
    """Give every input lane a storage of its own (in ``inputs``, which the
    call reads): lanes that share one (a fresh cluster's ``inval_obs`` is
    its ``obs_idx``) would share one taint, an edge neither lane has."""
    import torch

    seen: set = set()
    for name, tree in list(inputs.items()):
        if tree is None:
            continue
        lanes = []
        for lane in tree:
            if isinstance(lane, torch.Tensor) and _key(lane) in seen:
                lane = lane.clone()
            if isinstance(lane, torch.Tensor):
                seen.add(_key(lane))
            lanes.append(lane)
        if any(a is not b for a, b in zip(lanes, tree)):
            inputs[name] = type(tree)(*lanes)


def trace_call(spec: Dict[str, Any], tenants: int = 0, record: bool = False) -> Dict[str, Any]:
    """Trace one call of a registry-shaped spec. Returns the input and
    output labels, each output's data and control label sets, with
    ``tenants`` each output's tenant axis and the rules' fallbacks, with
    ``record`` the operator records, and the call's aten-operator and
    byte totals."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.models import virtual_cluster

    _dealias(spec["inputs"])
    pairs = lane_labels(spec["inputs"])
    if spec.get("knobs") is not None:
        pairs += lane_labels(spec["knobs"], "knobs")
    labels = [label for label, _ in pairs]
    tracer = Tracer(labels, tenants, record)
    tracer.seed(pairs)
    real_read, real_delivery = _host.read, virtual_cluster.delivery_new_bits

    def read(t, site):
        tracer.on_read(t)
        return real_read(t, site)

    read.count = real_read.count
    _host.read = read
    virtual_cluster.delivery_new_bits = _delivery_relation(tracer, real_delivery)
    try:
        with _mode(tracer):
            result = spec["call"]()
    finally:
        real_read.count = read.count
        _host.read = real_read
        virtual_cluster.delivery_new_bits = real_delivery
    out_pairs = lane_labels(result, "out")

    def names(mask: int) -> List[str]:
        return sorted(labels[i] for i in range(len(labels)) if mask >> i & 1)

    data, control, axes = {}, {}, {}
    for label, t in out_pairs:
        d, c = tracer.taint(t)
        data[label], control[label] = names(d), names(c & ~d)
        if tenants:
            axes[label] = tracer.axis_of(t)
    return {"in_labels": labels, "out_labels": [label for label, _ in out_pairs],
            "data": data, "control": control, "axes": axes,
            "fallbacks": sorted(set(tracer.fallbacks)), "tracer": tracer,
            "out_tokens": {tracer.token.get(t) for _, t in out_pairs} - {None},
            "aten_ops": tracer.aten_ops,
            "bytes_touched": tracer.bytes_touched}


def union_relations(*traces: Dict[str, Any]) -> Dict[str, Dict[str, List[str]]]:
    """The data and control relations of several traces of one entry
    point, united label by label."""
    out: Dict[str, Dict[str, List[str]]] = {"data": {}, "control": {}}
    for kind in ("data", "control"):
        for trace in traces:
            for label, sources in trace[kind].items():
                out[kind][label] = sorted(set(out[kind].get(label, [])) | set(sources))
    for label, sources in out["control"].items():
        out["control"][label] = sorted(set(sources) - set(out["data"].get(label, [])))
    return out


# ---------------------------------------------------------------------------
# proofs
# ---------------------------------------------------------------------------


def observer_effect_findings(name: str, relation: Dict[str, Dict[str, List[str]]],
                             loc: Tuple[str, int]) -> List[Finding]:
    path, lineno = loc
    findings = []
    for out_label in sorted(relation["data"]):
        if not _is_subject_lane(out_label):
            continue
        for kind in ("data", "control"):
            leaks = [s for s in relation[kind].get(out_label, []) if _is_observer_lane(s)]
            if leaks:
                findings.append(Finding(
                    path, lineno, "dataflow-observer-effect",
                    f"{name}: observer lane(s) {', '.join(leaks)} influence subject lane "
                    f"{out_label} by {kind} — telemetry and the trace ring must be "
                    f"write-only planes; an observer that perturbs the engine invalidates "
                    f"every trace it records",
                ))
    return findings


def cross_tenant_findings(name: str, axes: Dict[str, Any], fallbacks: List[str],
                          loc: Tuple[str, int]) -> List[Finding]:
    path, lineno = loc
    findings = []
    for out_label in sorted(axes):
        if axes[out_label] == _MIXED:
            findings.append(Finding(
                path, lineno, "dataflow-cross-tenant",
                f"{name}: output lane {out_label} mixes tenants — an influence edge "
                f"crosses the fleet's tenant axis"
                + (f" (conservatively, via unhandled operator(s) {', '.join(fallbacks)})"
                   if fallbacks else ""),
            ))
    return findings


def _gate_of_use(use: Dict[str, Any], value: Any, labels: List[str]) -> Optional[set]:
    """The gating lanes of one consumer when it is a select of ``value``
    (a case of ``where``, or an operand of ``&`` / ``*`` beside a bool
    mask) whose mask's taint holds a gating lane; None otherwise."""
    ins = use["ins"]
    if use.get("opaque"):
        return None
    if use["name"] == "where" and len(ins) >= 3:
        if ins[0] == value or value not in ins[1:3]:
            return None
        masks = [0]
    elif use["name"] in ("bitwise_and", "logical_and", "mul", "__and__") and len(ins) == 2:
        if ins.count(value) != 1:
            return None
        masks = [1 - ins.index(value)]
        if not use["in_bool"][masks[0]]:
            return None
    else:
        return None
    gates = {labels[i] for m in masks for i in range(len(labels))
             if use["in_taint"][m] >> i & 1 and _is_gating_lane(labels[i])}
    return gates or None


def opportunity_map(trace: Dict[str, Any], dense_n: int) -> Dict[str, Any]:
    """The gated dense operators of one traced quiescent round, keyed by
    source location and priced by aten operators and bytes touched
    against the round's totals."""
    tracer: Tracer = trace["tracer"]
    labels = trace["in_labels"]
    escaping = trace["out_tokens"] | tracer.read_tokens
    buckets: Dict[str, Dict[str, Any]] = {}
    for rec in tracer.records:
        if rec.get("opaque") or rec["elems"] < dense_n:
            continue
        gates: set = set()
        gated = bool(rec["uses"])
        for value in rec["outs"]:
            if value in escaping:
                gated = False
                break
            for use in rec["uses"]:
                if value not in tracer.records[use]["ins"]:
                    continue
                g = _gate_of_use(tracer.records[use], value, labels)
                if g is None:
                    gated = False
                    break
                gates |= g
            if not gated:
                break
        if not gated or not gates:
            continue
        slot = buckets.setdefault(rec["source"], {"aten_ops": 0, "bytes_touched": 0,
                                                  "ops": {}, "gated_by": set()})
        slot["aten_ops"] += 1
        slot["bytes_touched"] += rec["bytes"]
        slot["ops"][rec["op"]] = slot["ops"].get(rec["op"], 0) + 1
        slot["gated_by"] |= gates
    total_ops, total_bytes = trace["aten_ops"], trace["bytes_touched"]
    claimed_ops = sum(b["aten_ops"] for b in buckets.values())
    claimed_bytes = sum(b["bytes_touched"] for b in buckets.values())
    entries = [
        {"source": source, "aten_ops": b["aten_ops"], "bytes_touched": b["bytes_touched"],
         "ops": dict(sorted(b["ops"].items())), "gated_by": sorted(b["gated_by"])}
        for source, b in sorted(buckets.items(), key=lambda kv: (-kv[1]["aten_ops"], kv[0]))
    ]
    return {
        "entrypoint": OPPORTUNITY_ENTRYPOINT,
        "total_aten_ops": total_ops,
        "total_bytes_touched": total_bytes,
        "claimed_aten_ops": claimed_ops,
        "claimed_bytes_touched": claimed_bytes,
        "coverage_pct": {
            "aten_ops": round(100.0 * claimed_ops / total_ops, 2) if total_ops else 0.0,
            "bytes_touched": round(100.0 * claimed_bytes / total_bytes, 2) if total_bytes else 0.0,
        },
        "dense_gated": entries,
    }


def coverage_floor(coverage: Dict[str, float]) -> Dict[str, int]:
    """The measured coverage rounded down to 5 points."""
    return {key: int(value // 5) * 5 for key, value in coverage.items()}


def coverage_findings(opportunity: Dict[str, Any], floor: Optional[Dict[str, int]],
                      quiescent: Optional[Dict[str, Any]], what: str,
                      loc: Tuple[str, int]) -> List[Finding]:
    """The map must price the round the cost lock froze (two locks, one
    round: its totals equal ``quiescent``'s aten ops and bytes touched) and
    keep its coverage at or above ``floor``."""
    path, lineno = loc
    findings = []
    if quiescent is not None:
        for mine, theirs in (("total_aten_ops", "aten_ops"),
                             ("total_bytes_touched", "bytes_touched")):
            if opportunity.get(mine) != quiescent.get(theirs):
                findings.append(Finding(
                    path, lineno, "dataflow-dense-op",
                    f"sparse-opportunity total {mine} ({opportunity.get(mine)}) does not "
                    f"match {what} quiescent_round_cost {OPPORTUNITY_ENTRYPOINT} {theirs} "
                    f"({quiescent.get(theirs)}) — refreeze the cost lock first, then this one",
                ))
    for key, value in sorted((floor or {}).items()):
        got = opportunity.get("coverage_pct", {}).get(key, 0.0)
        if got < value:
            findings.append(Finding(
                path, lineno, "dataflow-dense-op",
                f"sparse-opportunity map covers only {got}% of the quiescent round's "
                f"{key} (floor {value}%) — a dense operator the map cannot attribute to a "
                f"mask gate is not provably sparsifiable",
            ))
    return findings


def carry_only_lanes(relations: Dict[str, Dict[str, Dict[str, List[str]]]]) -> List[str]:
    """State lanes written by some entry point but unreachable, through
    the transitive relation, from any non-state output (JAX's rule, over
    data and control edges)."""
    written: set = set()
    edges: Dict[str, set] = {}
    live_now: set = set()
    for rel in relations.values():
        for out_label in rel["data"]:
            sources = set(rel["data"][out_label]) | set(rel["control"].get(out_label, []))
            if out_label.startswith("state."):
                if sorted(sources) != [out_label]:
                    written.add(out_label)
                for src in sources:
                    if src.startswith("state."):
                        edges.setdefault(src, set()).add(out_label)
            else:
                live_now |= {src for src in sources if src.startswith("state.")}
    reverse: Dict[str, set] = {}
    for src, dsts in edges.items():
        for dst in dsts:
            reverse.setdefault(dst, set()).add(src)
    live, frontier = set(live_now), list(live_now)
    while frontier:
        lane = frontier.pop()
        for src in reverse.get(lane, ()):
            if src not in live:
                live.add(src)
                frontier.append(src)
    return sorted(written - live)


def _tree_reference_names() -> set:
    """Every identifier the port's tree consumes, per the ``deadcode``
    family's reference collector."""
    from . import deadcode

    names: set = set()
    for path in core.iter_files():
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except (SyntaxError, OSError):
            continue
        names |= deadcode._collect_references(tree)
    return names


# ---------------------------------------------------------------------------
# collection + lock
# ---------------------------------------------------------------------------


def entry_specs(device, churn: bool = True) -> Dict[str, Any]:
    """name -> builder of every traced entry point: the registry's 13 and
    the meshless fleet step at the audit shape. ``churn=False`` is the
    quiescent soak (loops capped at QUIESCENT_SOAK_ROUNDS)."""
    from .cost_model import fleet_spec

    rounds = None if churn else QUIESCENT_SOAK_ROUNDS
    builders = dict(device_program.registry(device, churn=churn, rounds=rounds))
    builders["fleet_step"] = lambda: fleet_spec(device, device_program.AUDIT_TENANTS,
                                                n=device_program.AUDIT_N, churn=churn)
    return builders


def trace_entry(name: str, *builds) -> Tuple[Dict[str, Any], List[Dict]]:
    """One entry point traced once per builder (its churned call and its
    quiescent soak), the relations united."""
    tenants = device_program.AUDIT_TENANTS if name in FLEET_ENTRYPOINTS else 0
    traces = [trace_call(build(), tenants) for build in builds]
    return union_relations(*traces), traces


_DATAFLOW_CACHE: Dict[str, Tuple[Dict[str, Any], List[Finding]]] = {}


def collect_dataflow(device: str = "cpu", force: bool = False
                     ) -> Tuple[Dict[str, Any], List[Finding]]:
    """Trace every entry point on ``device`` (churned and quiescent), run
    the proofs and build the lock payload, once per process and device.
    The findings here are the proofs' (observer, tenant, dead lane); the
    map's coverage and totals are checked against the locks by
    :func:`check_lock_against`."""
    import torch

    if device in _DATAFLOW_CACHE and not force:
        return _DATAFLOW_CACHE[device]
    dev = torch.device(device)
    loc = (DATAFLOW_LOCK_REL, 1)
    findings: List[Finding] = []
    relations: Dict[str, Dict[str, Dict[str, List[str]]]] = {}
    tenant_isolation: Dict[str, Any] = {}
    with device_program.one_rank_group(dev.type):
        churned, quiet = entry_specs(dev, churn=True), entry_specs(dev, churn=False)
        for name in sorted(churned):
            relation, traces = trace_entry(name, churned[name], quiet[name])
            relations[name] = relation
            findings.extend(observer_effect_findings(name, relation, loc))
            if name in FLEET_ENTRYPOINTS:
                axes = {label: _unify([t["axes"].get(label) for t in traces])
                        for label in traces[0]["axes"]}
                fallbacks = sorted({f for t in traces for f in t["fallbacks"]})
                findings.extend(cross_tenant_findings(name, axes, fallbacks, loc))
                tenant_isolation[name] = {
                    "proven": not any(a == _MIXED for a in axes.values()),
                    "mixed_outputs": sorted(lbl for lbl, a in axes.items() if a == _MIXED),
                    "axis_rule_fallbacks": fallbacks,
                }
        quiet_round = trace_call(
            device_program.registry(dev, churn=False)[OPPORTUNITY_ENTRYPOINT](), record=True)
    opportunity = opportunity_map(quiet_round, device_program.AUDIT_N)
    carry_only = carry_only_lanes(relations)
    referenced = _tree_reference_names()
    for lane in carry_only:
        if _field_of(lane) not in referenced:
            findings.append(Finding(
                loc[0], loc[1], "dataflow-dead-lane",
                f"state lane {lane} is written by the engine but influences no output in "
                f"any traced entry point, and no host code references it by name — dead "
                f"weight in the state",
            ))
    payload = {
        "_comment": (
            "Lane-level dataflow provenance of the port's engine entry points, traced "
            "(one eager call each, churned and quiescent, under a TorchDispatchMode) on "
            "the CPU: per entry point the output lane -> input lane relation by data and "
            "by control (host-read branches), the observer-silence and tenant-isolation "
            "proofs, and the sparse-opportunity map of a quiescent step round (dense "
            "mask-gated operators by source location, priced by aten operators and bytes "
            "against cost.lock.json's quiescent_round_cost). Generated by `python -m "
            "rapid_tpu_torch.tools.staticcheck --update-dataflow-lock`; do not edit by hand."
        ),
        "entrypoints": {
            name: {"data": rel["data"], "control": rel["control"],
                   "observer_silent": not observer_effect_findings(name, rel, loc)}
            for name, rel in sorted(relations.items())
        },
        "tenant_isolation": tenant_isolation,
        "opportunity_map": opportunity,
        "carry_only_lanes": carry_only,
        "torch_release": device_program.torch_release(),
    }
    _DATAFLOW_CACHE[device] = (payload, findings)
    return payload, findings


#: Blocks compared only under the lock's torch release.
RELEASE_BLOCKS = ("opportunity_map", "torch_release")


def _canonical(payload: Dict[str, Any]) -> Dict[str, Any]:
    slim = {k: v for k, v in payload.items() if k not in ("_comment", "coverage_floor_pct")}
    return json.loads(json.dumps(slim, sort_keys=True))


def _cost_quiescent(release: str) -> Tuple[Optional[Dict[str, Any]], str]:
    """The quiescent block the map's totals answer to: the cost lock's when
    it was made under ``release``, else the live one."""
    from . import cost_model

    locked, _ = cost_model.read_lock()
    if locked is not None and locked.get("torch_release") == release:
        return locked.get("quiescent_round_cost", {}).get(OPPORTUNITY_ENTRYPOINT), "the cost lock's"
    return cost_model.collect_quiescent_cost("cpu").get(OPPORTUNITY_ENTRYPOINT), "the live"


def read_lock() -> Tuple[Optional[Dict[str, Any]], List[Finding]]:
    lock_path = core.REPO / DATAFLOW_LOCK_REL
    if not lock_path.exists():
        return None, [Finding(
            DATAFLOW_LOCK_REL, 1, "dataflow-lock-drift",
            "dataflow lockfile missing — generate it via `python -m "
            "rapid_tpu_torch.tools.staticcheck --update-dataflow-lock`",
        )]
    try:
        return json.loads(lock_path.read_text()), []
    except json.JSONDecodeError as exc:
        return None, [Finding(
            DATAFLOW_LOCK_REL, 1, "dataflow-lock-drift",
            f"dataflow lockfile is not valid JSON ({exc.msg}) — {_REGEN_HINT}",
        )]


def check_lock_against(locked: Dict[str, Any], device: str = "cpu") -> List[Finding]:
    """The live trace on ``device`` against ``locked``, block by block (the
    opportunity map only on the CPU under the lock's torch release), plus
    the proofs and the map's coverage floor and totals."""
    payload, findings = collect_dataflow(device)
    findings = list(findings)
    release = device == "cpu" and locked.get("torch_release") == payload["torch_release"]
    live, committed = _canonical(payload), _canonical(locked)
    for key in sorted(set(live) | set(committed)):
        if not release and key in RELEASE_BLOCKS:
            continue
        if live.get(key) != committed.get(key):
            findings.append(Finding(
                DATAFLOW_LOCK_REL, 1, "dataflow-lock-drift",
                f"{key!r} block drifted from the committed dataflow lock — {_REGEN_HINT}",
            ))
    if device == "cpu":
        quiescent, what = _cost_quiescent(payload["torch_release"])
        floor = locked.get("coverage_floor_pct") if release else None
        findings.extend(coverage_findings(payload["opportunity_map"], floor, quiescent, what,
                                          (DATAFLOW_LOCK_REL, 1)))
    return findings


def check_dataflow_lock(trees: Sequence[Tuple[ast.AST, str]]) -> List[Finding]:
    """Tree-mode gate: trace the entry points (once per process), run the
    proofs and compare with the committed lock. Presence-gated on the
    engine sources, as the program and cost locks are."""
    rels = {rel.replace("\\", "/") for _, rel in trees}
    if not all(src in rels for src in device_program.REGISTRY_SOURCES):
        return []
    locked, findings = read_lock()
    if locked is None:
        return findings
    return check_lock_against(locked, "cpu")


def update_dataflow_lock() -> Tuple[List[Finding], Optional[Path]]:
    """Regenerate the dataflow lockfile from a fresh CPU trace, with the
    coverage floor at the measured coverage rounded down to 5 points.
    Refuses while any proof fails or the map's totals disagree with the
    cost lock. Byte-identical when nothing changed."""
    payload, findings = collect_dataflow("cpu", force=True)
    quiescent, what = _cost_quiescent(payload["torch_release"])
    findings = list(findings) + coverage_findings(
        payload["opportunity_map"], None, quiescent, what, (DATAFLOW_LOCK_REL, 1))
    if findings:
        return [Finding(f.path, f.lineno, f.check, f"refusing to freeze: {f.message}")
                for f in findings], None
    lock_path = core.REPO / DATAFLOW_LOCK_REL
    out = dict(payload, coverage_floor_pct=coverage_floor(
        payload["opportunity_map"]["coverage_pct"]))
    lock_path.write_text(json.dumps(out, indent=2, sort_keys=True) + "\n")
    return [], lock_path


# ---------------------------------------------------------------------------
# per-file corpus mode
# ---------------------------------------------------------------------------


def check_dataflow(path: Path, source: Optional[str] = None,
                   tree: Optional[ast.AST] = None) -> List[Finding]:
    """Corpus mode: execute a module that declares
    ``DATAFLOW_AUDIT_PROGRAMS`` and run the requested proofs over each
    traced program, each finding at the program's dict-key line. Files
    without the marker are skipped; a broken probe is a finding."""
    from .cost_model import _program_key_linenos

    rel = core.rel(Path(path))
    if source is None:
        try:
            source = Path(path).read_text()
        except OSError:
            return []
    if "DATAFLOW_AUDIT_PROGRAMS" not in source:
        return []
    if tree is None:
        try:
            tree = ast.parse(source, filename=str(path))
        except SyntaxError:
            return []
    linenos = _program_key_linenos(tree, "DATAFLOW_AUDIT_PROGRAMS")
    namespace: Dict[str, Any] = {"__name__": f"_dataflow_corpus_{Path(path).stem}"}
    try:
        exec(compile(source, str(path), "exec"), namespace)  # noqa: S102
    except Exception as exc:  # noqa: BLE001 — a broken probe is a finding
        return [Finding(rel, 1, "dataflow-lock-drift",
                        f"dataflow audit module failed to execute: {exc!r}")]
    programs = namespace.get("DATAFLOW_AUDIT_PROGRAMS")
    if not isinstance(programs, dict):
        return []
    findings: List[Finding] = []
    for name in sorted(programs):
        cfg = programs[name]
        loc = (rel, linenos.get(name, 1))
        checks = tuple(cfg.get("checks", ()))
        tenants = int(cfg.get("tenants", 0)) if "cross-tenant" in checks else 0
        try:
            trace = trace_call(cfg["build"](), tenants, record="dense-op" in checks)
        except Exception as exc:  # noqa: BLE001
            findings.append(Finding(rel, loc[1], "dataflow-lock-drift",
                                    f"{name}: audit program failed to trace: {exc!r}"))
            continue
        if "observer-effect" in checks:
            findings.extend(observer_effect_findings(name, union_relations(trace), loc))
        if "cross-tenant" in checks:
            findings.extend(cross_tenant_findings(name, trace["axes"], trace["fallbacks"], loc))
        if "dense-op" in checks:
            opp = opportunity_map(trace, int(cfg.get("dense_n", 1)))
            for bucket in opp["dense_gated"]:
                findings.append(Finding(
                    rel, loc[1], "dataflow-dense-op",
                    f"{name}: dense {', '.join(bucket['ops'])} at {bucket['source']} is "
                    f"provably gated by {', '.join(bucket['gated_by'])} yet computes over "
                    f"the full lane — a sparse-opportunity candidate",
                ))
    return sorted(set(findings), key=lambda f: (f.lineno, f.check, f.message))
