"""The collective context: where the sharded round body communicates.

The JAX package shards the engine by handing ``jax.jit`` its in-shardings
and letting XLA's SPMD partitioner insert the collectives. PyTorch has no
partitioner that understands this round body and a hand-written kernel,
so the port says where each collective goes. Every function of the round
body takes an optional ``ctx``: ``None`` is the single-device engine,
exactly; a :class:`CollectiveContext` makes each rank compute on its local
``[.., n/dn]`` and ``[c/dc, ..]`` slices and call the collectives below on
the mesh's axis groups at the points where the single-device code reduces
or gathers over a sharded axis.

Wire dtypes: gloo takes no int16 or uint32 and NCCL no bool, so a bool goes
as uint8 (an any is a max, an all a min), an int8 or int16 lane as int32,
and a uint32 lane is already its int32 bit pattern
(:mod:`rapid_tpu_torch._u32`). Results come back at the input's dtype.

An axis the mesh does not carry is not communicated over: the 1-D
``('nodes',)`` mesh replicates the cohort dimension, as the JAX package's
does. An axis of size 1 still communicates, so a one-rank mesh runs the
program a larger mesh runs.

Every collective is recorded (:attr:`CollectiveContext.log`): kind, wire
dtype, local shape, payload bytes, the group's ranks, a label naming the
point, the round it ran in and its site, one of ``prologue`` (before the
loop), ``hot-loop`` (every round, unconditionally), ``hot-loop-cond`` (in
a gated branch of a round) and ``cond`` (a gated branch outside a loop),
the meanings of the JAX package's ``hlo_facts.classify_location``.
:mod:`rapid_tpu_torch.parallel.collective_facts` audits the log.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

NODE_AXIS = "nodes"
COHORT_AXIS = "cohort"
TENANT_AXIS = "tenant"

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    if x.dtype in (torch.int8, torch.int16):
        return x.to(torch.int32)
    return x.contiguous()


def classify_location(in_loop: bool, gated: bool) -> str:
    """prologue / hot-loop / hot-loop-cond / cond: a collective's site from
    whether it ran inside a driver's round loop and inside a gated branch
    (the JAX package reads the same two facts off the op's name scope)."""
    if in_loop:
        return "hot-loop-cond" if gated else "hot-loop"
    return "cond" if gated else "prologue"


class CollectiveContext:
    """One rank's view of a mesh for the round body: its local geometry
    (``n_local`` / ``slot_offset`` on the ``'nodes'`` axis, ``c_local`` /
    ``cohort_offset`` on ``'cohort'``), the axis groups, and the collective
    log.

    ``n`` / ``c`` are the cluster's slot and cohort counts (each must
    divide its axis); ``fleet`` marks a tenant-stacked fleet, whose every
    lane is split over ``'tenant'`` too."""

    def __init__(self, mesh, n: int, c: int, fleet: bool = False):
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        coord = mesh.get_coordinate()
        self.sizes: Dict[str, int] = {name: mesh.size(i) for i, name in enumerate(names)}
        self.index: Dict[str, int] = {name: coord[i] for i, name in enumerate(names)}
        self.groups = {name: mesh.get_group(name) for name in names}
        self.ranks = {name: dist.get_process_group_ranks(g) for name, g in self.groups.items()}
        self.n, self.c, self.fleet = n, c, fleet
        dn, dc = self.size(NODE_AXIS), self.size(COHORT_AXIS)
        self.n_local, self.c_local = n // dn, c // dc
        self.slot_offset = self.index.get(NODE_AXIS, 0) * self.n_local
        self.cohort_offset = self.index.get(COHORT_AXIS, 0) * self.c_local
        self.log: List[dict] = []
        self.round = -1
        self._in_loop = False
        self._gated = 0

    def size(self, axis: str) -> int:
        """The axis's size, 1 for an axis the mesh does not carry."""
        return self.sizes.get(axis, 1)

    # -- sites ----------------------------------------------------------

    def begin_round(self) -> None:
        self.round += 1

    @contextlib.contextmanager
    def loop(self):
        """The body of a driver's round loop."""
        prev, self._in_loop = self._in_loop, True
        try:
            yield
        finally:
            self._in_loop = prev

    @contextlib.contextmanager
    def gate(self):
        """A branch the single-device engine takes only when its gate is
        set (the JAX package's ``lax.cond``)."""
        self._gated += 1
        try:
            yield
        finally:
            self._gated -= 1

    def _log_collective(self, kind, op, axis, wire, nbytes, logical, label):
        self.log.append({
            "round": self.round, "kind": kind, "op": op, "axis": axis,
            "dtype": str(wire.dtype).replace("torch.", ""), "shape": tuple(wire.shape),
            "bytes": nbytes, "logical_bytes": logical, "ranks": list(self.ranks[axis]),
            "site": classify_location(self._in_loop, self._gated > 0), "label": label,
        })

    def _scale(self, sharded: Sequence[str]) -> int:
        """How many times the payload's local slice the global payload is:
        the sizes of the axes its own dimensions are split over (the tenant
        axis always, for a fleet)."""
        scale = self.size(TENANT_AXIS) if self.fleet else 1
        for axis in sharded:
            scale *= self.size(axis)
        return scale

    # -- collectives ----------------------------------------------------

    def _reduce(self, x, op, axes, label, sharded):
        present = [a for a in axes if a in self.groups]
        if not present:
            return x
        wire = _to_wire(x).reshape(x.shape or (1,)).clone()  # 0-d: a [1] on the wire
        for axis in present:
            dist.all_reduce(wire, op=_OPS[op], group=self.groups[axis])
            nbytes = wire.numel() * wire.element_size()
            self._log_collective("all-reduce", op, axis, wire, nbytes, nbytes * self._scale(sharded), label)
        return wire.reshape(x.shape).to(x.dtype)

    def sum(self, x, axes, label, sharded=()):
        """``x`` summed over ``axes`` (each a separate all-reduce)."""
        return self._reduce(x, "sum", axes, label, sharded)

    def max(self, x, axes, label, sharded=()):
        """``x``'s maximum over ``axes``; on bools, any."""
        return self._reduce(x, "max", axes, label, sharded)

    def min(self, x, axes, label, sharded=()):
        """``x``'s minimum over ``axes``; on bools, all."""
        return self._reduce(x, "min", axes, label, sharded)

    def gather(self, x, axis, label, sharded=(), logical_bytes=None):
        """The local slices of ``x`` along its last dimension, concatenated
        in mesh order over ``axis`` (one all-gather). ``logical_bytes``:
        the whole payload of this rank's tenants, where it is not the
        gathered bytes times the ``sharded`` axes' sizes (packed words)."""
        if axis not in self.groups:
            return x
        wire = _to_wire(x)
        parts = [torch.empty_like(wire) for _ in range(self.sizes[axis])]
        dist.all_gather(parts, wire, group=self.groups[axis])
        out = torch.cat(parts, -1)
        nbytes = out.numel() * out.element_size()
        logical = nbytes * self._scale(sharded) if logical_bytes is None \
            else logical_bytes * self._scale(())
        self._log_collective("all-gather", None, axis, wire, nbytes, logical, label)
        return out.to(x.dtype)

    def assemble_cohorts(self, x, label):
        """The whole ``[.., c]`` lane from each rank's ``[.., c_local]``
        slice, as an all-reduce (a sum where each rank fills only its own
        cohorts), so that an unconditional assembly in the hot loop stays
        reduce-class."""
        if COHORT_AXIS not in self.groups:
            return x
        wire = _to_wire(x)
        full = torch.zeros(wire.shape[:-1] + (self.c,), dtype=wire.dtype, device=wire.device)
        full[..., self.cohort_offset:self.cohort_offset + self.c_local] = wire
        return self.sum(full, (COHORT_AXIS,), label).to(x.dtype)
