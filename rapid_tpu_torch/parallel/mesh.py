"""Device-mesh sharding for the virtual-cluster engine (port of
``rapid_tpu/parallel/mesh.py``).

Two scale axes, one rule table, as in the JAX package: every per-slot lane
splits on its N dimension over the ``'nodes'`` mesh axis, every
cohort-dimensioned lane on its C dimension over ``'cohort'``, and a
tenant-stacked fleet on its leading ``[t]`` axis over ``'tenant'``.
:data:`PARTITION_RULES` (a copy of the JAX table) gives each lane its
spec; an axis the mesh does not carry replicates, and a lane no rule
matches raises.

PyTorch's idiom for what ``jax.jit(in_shardings=...)`` does, split in two:

- mesh and placements: :func:`make_mesh` builds a
  ``torch.distributed.device_mesh.DeviceMesh`` with the JAX mesh's axis
  names, ``state_shardings(mesh)`` returns an ``EngineState`` of placement
  tuples (``Shard(d)`` / ``Replicate()`` per mesh dimension), and
  :func:`shard_pytree` returns DTensors built with ``DTensor.from_local``
  from each rank's own slice of identical host values: the
  multi-controller contract of ``make_array_from_callback``, with no
  communication to place a leaf;
- the round: explicit SPMD. The ``make_sharded_*`` entry points unwrap the
  DTensors, run the port's one round body on the local shards with a
  :class:`~rapid_tpu_torch.parallel.collectives.CollectiveContext` (which
  issues the all-reduces and all-gathers at the points where the
  single-device engine reduces or gathers over a sharded axis), and wrap
  the state again under its input placements. DTensor's own op dispatch is
  not used for the round: it has no strategy for the delivery kernel's
  ctypes launch, nor a safe one for the uint32-as-int32 bit operations.

Every entry point returns a callable whose ``context`` attribute is the
rank's collective context; its ``log`` records every collective the calls
issued (:mod:`rapid_tpu_torch.parallel.collective_facts` audits it). A
step's ``decided`` attribute is its last call's decision as a host bool
(the round read it to branch, so it costs no read), as
``VirtualCluster.last_decided``.

The mesh runs on CUDA (one NCCL rank per card) unless the caller passes
``device_type="cpu"`` (gloo); asking for CUDA without a card raises.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from rapid_tpu_torch.models.state import (
    EngineConfig,
    EngineState,
    FaultInputs,
    StepEvents,
    TelemetryLanes,
    TraceRing,
)
from rapid_tpu_torch.models.virtual_cluster import engine_step, run_until_membership
from rapid_tpu_torch.parallel.collectives import (
    COHORT_AXIS,
    NODE_AXIS,
    TENANT_AXIS,
    CollectiveContext,
)

#: Spec tuples are PartitionSpec entries by position: an axis name, or None
#: (that tensor dimension is not meshed). Empty tuple = fully replicated.
Spec = Tuple[Optional[str], ...]


class ShardingShapeError(ValueError):
    """A lane's shape does not divide the mesh axes it shards over. Raised
    by :func:`shard_pytree` with the leaf and axis named."""


#: A copy of ``rapid_tpu.parallel.mesh.PARTITION_RULES`` (pinned equal by
#: ``tests/test_torch_parallel.py``): regexes over the engine's lane names,
#: first ``re.fullmatch`` wins.
PARTITION_RULES: Tuple[Tuple[str, Spec], ...] = (
    # [k, n] ring/key/topology tables: slots on the last axis.
    (r"key_hi|key_lo|ring_perm|obs_idx|subj_idx|inval_obs", (None, NODE_AXIS)),
    # [n, k] per-edge failure-detector state: slots on the first axis.
    (r"fd_count|fd_hist|fd_fired|fire_round|probe_fail", (NODE_AXIS, None)),
    # [c] cohort lanes (watermark flags + proposal-id lanes).
    (r"seen_down|announced|prop_hi|prop_lo", (COHORT_AXIS,)),
    # [c, n] cohort-by-slot watermark/delivery state: both axes meshed.
    (r"report_bits|released|prop_mask|rx_block", (COHORT_AXIS, NODE_AXIS)),
    # [n] per-slot lanes (identity, membership, votes, classic-Paxos
    # acceptor state, fault masks).
    (
        r"id_hi|id_lo|alive|join_pending|cohort_of|vote_hi|vote_lo"
        r"|vote_valid|cp_rnd_r|cp_rnd_i|cp_vrnd_r|cp_vrnd_i|cp_vval_src"
        r"|retired|crashed",
        (NODE_AXIS,),
    ),
    (
        r"config_epoch|config_hi|config_lo|n_members|rounds_undecided"
        r"|classic_epoch|round_idx",
        (),  # replicated-ok: per-configuration scalar lanes
    ),
    # Telemetry plane: the [c, n] masks shard like the watermark state they
    # observe; the [c] proposal counter rides the cohort axis.
    (r"tl_active|tl_invalidated", (COHORT_AXIS, NODE_AXIS)),
    (r"tl_proposals", (COHORT_AXIS,)),
    (
        r"tl_rounds|tl_alerts|tl_tally_sum|tl_fast_decisions"
        r"|tl_classic_decisions|tl_conflict_rounds|tl_undecided_hist",
        (),  # replicated-ok: per-engine scalar counters + the 8-bucket histogram
    ),
    # Round-trace ring: per-round scalar records over the [R] ring axis.
    (
        r"tr_round|tr_epoch|tr_active|tr_alerts|tr_proposals|tr_tally"
        r"|tr_path|tr_conflict|tr_undecided|tr_cursor|tr_wraps",
        (),  # replicated-ok: [R]-ring per-round scalar records + cursor/wrap counters
    ),
)

#: The events a step returns: the winner mask is per slot, the proposal
#: lanes per cohort, the rest replicated scalars.
_EVENT_SPECS: Dict[str, Spec] = {
    "winner_mask": (NODE_AXIS,),
    "proposals_announced": (COHORT_AXIS,),
    "prop_hi": (COHORT_AXIS,),
    "prop_lo": (COHORT_AXIS,),
}


def make_mesh(
    devices: Optional[Sequence[int]] = None,
    shape: Optional[Tuple[int, ...]] = None,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """The engine mesh over the ranks of the default process group
    (``parallel/multihost.initialize_multihost``): 1-D ``('nodes',)`` by
    default, 2-D ``('cohort', 'nodes')`` for ``shape=(cohort, nodes)``,
    3-D ``('tenant', 'cohort', 'nodes')`` for ``shape=(tenant, cohort,
    nodes)``. ``devices``: the global ranks, in mesh order (default every
    rank); the shape's product must equal their count. On ``cuda`` unless
    ``device_type="cpu"``."""
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was asked for but no card is available "
                           "(pass device_type='cpu')")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost.initialize_multihost first")
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if shape is None:
        return DeviceMesh(device_type, torch.tensor(ranks), mesh_dim_names=(NODE_AXIS,))  # device-ok: DeviceMesh takes its ranks as a host tensor
    if len(shape) == 2:
        axis_names: Tuple[str, ...] = (COHORT_AXIS, NODE_AXIS)
    elif len(shape) == 3:
        axis_names = (TENANT_AXIS, COHORT_AXIS, NODE_AXIS)
    else:
        raise ValueError(
            f"mesh shape must be (cohort, nodes) or (tenant, cohort, nodes), got {shape}"
        )
    if any(d < 1 for d in shape):
        raise ValueError(f"mesh shape must be positive, got {shape}")
    total = 1
    for d in shape:
        total *= d
    if total != len(ranks):
        raise ValueError(f"mesh shape {shape} needs {total} devices, got {len(ranks)}")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape), mesh_dim_names=axis_names)  # device-ok: DeviceMesh takes its ranks as a host tensor


def match_partition_rules(
    rules: Sequence[Tuple[str, Spec]], fields: Sequence[str]
) -> Dict[str, Spec]:
    """field name -> spec via the first rule whose regex fullmatches. Raises
    on an uncovered field: a new lane must be placed in the table before
    it can shard."""
    out: Dict[str, Spec] = {}
    for name in fields:
        for pattern, spec in rules:
            if re.fullmatch(pattern, name):
                out[name] = spec
                break
        else:
            raise ValueError(
                f"no partition rule matches engine leaf {name!r} — add it "
                f"to rapid_tpu_torch.parallel.mesh.PARTITION_RULES"
            )
    return out


def _resolve_spec(spec: Spec, mesh: DeviceMesh) -> tuple:
    """A rule spec as placements on ``mesh``, one per mesh dimension:
    ``Shard(d)`` where tensor dimension ``d`` carries that axis,
    ``Replicate()`` elsewhere (axes the spec names but the mesh lacks
    replicate, as the JAX package's do)."""
    dims = {axis: d for d, axis in enumerate(spec) if axis is not None}
    return tuple(
        Shard(dims[name]) if name in dims else Replicate() for name in mesh.mesh_dim_names
    )


def _shardings_for(cls, mesh: DeviceMesh, lead: Spec = ()):
    specs = match_partition_rules(PARTITION_RULES, cls._fields)
    return cls(**{field: _resolve_spec(lead + specs[field], mesh) for field in cls._fields})


def state_shardings(mesh: DeviceMesh) -> EngineState:
    """An EngineState of placement tuples from :data:`PARTITION_RULES`."""
    return _shardings_for(EngineState, mesh)


def fault_shardings(mesh: DeviceMesh) -> FaultInputs:
    return _shardings_for(FaultInputs, mesh)


def telemetry_shardings(mesh: DeviceMesh) -> TelemetryLanes:
    """Placements for the telemetry lanes (the ``tl_`` rules)."""
    return _shardings_for(TelemetryLanes, mesh)


def trace_shardings(mesh: DeviceMesh) -> TraceRing:
    """Placements for the round-trace ring (the ``tr_`` rules: every lane
    replicates)."""
    return _shardings_for(TraceRing, mesh)


def fleet_state_shardings(mesh: DeviceMesh) -> EngineState:
    """Placements for a tenant-STACKED EngineState: the same rules with the
    leading ``[t]`` axis on ``'tenant'``."""
    return _shardings_for(EngineState, mesh, (TENANT_AXIS,))


def fleet_fault_shardings(mesh: DeviceMesh) -> FaultInputs:
    return _shardings_for(FaultInputs, mesh, (TENANT_AXIS,))


def fleet_telemetry_shardings(mesh: DeviceMesh) -> TelemetryLanes:
    return _shardings_for(TelemetryLanes, mesh, (TENANT_AXIS,))


def fleet_trace_shardings(mesh: DeviceMesh) -> TraceRing:
    return _shardings_for(TraceRing, mesh, (TENANT_AXIS,))


def _event_shardings(mesh: DeviceMesh, lead: Spec = ()) -> StepEvents:
    return StepEvents(**{
        field: _resolve_spec(lead + _EVENT_SPECS.get(field, ()), mesh)
        for field in StepEvents._fields
    })


def pad_to_multiple(value: int, multiple: int) -> int:
    """Smallest count >= ``value`` divisible by ``multiple`` — size N slots
    (or C cohorts, or T tenants) so they divide a mesh axis."""
    if multiple < 1 or value < 0:
        raise ValueError(f"pad_to_multiple({value}, {multiple})")
    return ((value + multiple - 1) // multiple) * multiple


def _validate_leaf(label: str, shape: Tuple[int, ...], placements, mesh: DeviceMesh) -> None:
    split: Dict[int, list] = {}
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            split.setdefault(p.dim, []).append(i)
    for dim, mesh_dims in sorted(split.items()):
        names = [mesh.mesh_dim_names[i] for i in mesh_dims]
        size = 1
        for i in mesh_dims:
            size *= mesh.size(i)
        if dim >= len(shape) or shape[dim] % size:
            got = shape[dim] if dim < len(shape) else "<missing>"
            raise ShardingShapeError(
                f"leaf {label} shape {tuple(shape)}: dimension {dim} "
                f"(= {got}) does not divide mesh axis {'*'.join(names)} "
                f"(size {size}) — pad it to pad_to_multiple({got}, {size}) "
                f"slots (see rapid_tpu_torch.parallel.mesh.pad_to_multiple)"
            )


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _local_slice(x: torch.Tensor, placements, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of the whole lane ``x`` under ``placements``."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            size = x.shape[p.dim] // mesh.size(i)
            x = x.narrow(p.dim, coord[i] * size, size)
    return x


def _placements(spec_or_placements, mesh: DeviceMesh) -> tuple:
    """Placements from a placement tuple, or from a spec tuple (axis names
    by tensor dimension) resolved against ``mesh``."""
    items = tuple(spec_or_placements)
    if all(isinstance(p, (Shard, Replicate)) for p in items) and len(items) == mesh.ndim:
        return items
    return _resolve_spec(items, mesh)


def shard_pytree(tree, shardings, mesh: Optional[DeviceMesh] = None):
    """Place host-computed lanes onto a mesh — single-process or global
    (multi-controller). Every rank passes identical whole lanes (the same
    seeds); each leaf becomes a DTensor of this rank's block, moved to the
    mesh's device, with no communication. ``shardings`` holds, per leaf,
    a placement tuple or a spec tuple (an axis name or None per tensor
    dimension). Every leaf is validated first: its shape must divide the
    mesh axes it shards over, else :class:`ShardingShapeError` names the
    leaf and the axis (packed ``[n/8]`` lanes included). ``None`` (a plane
    that is off) stays ``None``."""
    if tree is None:
        return None
    if mesh is None:
        raise ShardingShapeError(
            f"placing a {type(tree).__name__}: placements need an explicit mesh= argument"
        )
    device = _mesh_device(mesh)
    leaves = [x.to_local() if isinstance(x, DTensor) else x for x in tree]
    placements = [_placements(spec, mesh) for spec in shardings]
    for name, x, p in zip(type(tree)._fields, leaves, placements):
        _validate_leaf(f"{type(tree).__name__}.{name}", tuple(x.shape), p, mesh)
    return type(tree)(*(
        DTensor.from_local(_local_slice(x, p, mesh).to(device).contiguous(), mesh, p,
                           run_check=False, shape=x.shape, stride=_contiguous_stride(x.shape))
        for x, p in zip(leaves, placements)
    ))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def shard_state(state: EngineState, mesh: DeviceMesh) -> EngineState:
    """Place an existing (host/single-device) state onto the mesh."""
    return shard_pytree(state, state_shardings(mesh), mesh=mesh)


def shard_faults(faults: FaultInputs, mesh: DeviceMesh) -> FaultInputs:
    return shard_pytree(faults, fault_shardings(mesh), mesh=mesh)


def shard_fleet_state(state: EngineState, mesh: DeviceMesh) -> EngineState:
    """Place a tenant-stacked state onto a ``('tenant', 'cohort', 'nodes')``
    mesh; a tenant count that does not divide the tenant axis raises
    :class:`ShardingShapeError` naming ``pad_to_multiple``."""
    return shard_pytree(state, fleet_state_shardings(mesh), mesh=mesh)


def shard_fleet_faults(faults: FaultInputs, mesh: DeviceMesh) -> FaultInputs:
    return shard_pytree(faults, fleet_fault_shardings(mesh), mesh=mesh)


def local_tree(tree, shardings=None, mesh: Optional[DeviceMesh] = None):
    """This rank's blocks of a tree: a DTensor leaf's local tensor, or (with
    ``shardings`` and ``mesh``) the rank's block of a whole tensor."""
    if tree is None:
        return None
    out = []
    for i, x in enumerate(tree):
        if isinstance(x, DTensor):
            out.append(x.to_local())
        elif shardings is not None:
            out.append(_local_slice(x, _placements(shardings[i], mesh), mesh).contiguous())
        else:
            out.append(x)
    return type(tree)(*out)


def wrap_tree(tree, shardings, mesh: DeviceMesh):
    """Local blocks as DTensors under ``shardings`` (no communication)."""
    if tree is None:
        return None
    return type(tree)(*(
        DTensor.from_local(x, mesh, _placements(p, mesh), run_check=False)
        for x, p in zip(tree, shardings)
    ))


def full_pytree(tree):
    """Every DTensor leaf gathered whole on every rank (the host view JAX
    gives ``np.asarray`` of a global array), with the wire dtypes of
    :mod:`~rapid_tpu_torch.parallel.collectives` (gloo takes no int16).
    Plain tensors pass through."""
    if tree is None:
        return None
    out = []
    for x in tree:
        if not isinstance(x, DTensor):
            out.append(x)
            continue
        local, mesh = x.to_local(), x.device_mesh
        wire = local.to(torch.int32) if local.dtype in (torch.int8, torch.int16, torch.bool) \
            else local
        for i, p in reversed(list(enumerate(x.placements))):
            if isinstance(p, Shard):
                group = mesh.get_group(i)
                parts = [torch.empty_like(wire) for _ in range(mesh.size(i))]
                dist.all_gather(parts, wire.contiguous(), group=group)
                wire = torch.cat(parts, p.dim)
        out.append(wire.to(local.dtype))
    return type(tree)(*out)


def _context(cfg: EngineConfig, mesh: DeviceMesh, fleet: bool = False):
    for axis, count in ((NODE_AXIS, cfg.n), (COHORT_AXIS, cfg.c)):
        if axis in mesh.mesh_dim_names and count % mesh.size(mesh.mesh_dim_names.index(axis)):
            raise ShardingShapeError(
                f"{'n' if axis == NODE_AXIS else 'c'} = {count} does not divide mesh axis "
                f"{axis} — pad it (rapid_tpu_torch.parallel.mesh.pad_to_multiple)"
            )
    return CollectiveContext(mesh, cfg.n, cfg.c, fleet)


def _scalar(x) -> int:
    if isinstance(x, DTensor):
        x = x.to_local()
    return int(x)


def make_sharded_step(cfg: EngineConfig, mesh: DeviceMesh):
    """The engine step over ``mesh`` (1-D or 2-D): ``step(state, faults) ->
    (state, events)``, state and faults as placed by :func:`shard_state` /
    :func:`shard_faults` (or whole lanes, identical on every rank), the
    state returned under its input placements, the events placed by their
    own (winner mask on ``'nodes'``, proposal lanes on ``'cohort'``)."""
    st_sh, ft_sh = state_shardings(mesh), fault_shardings(mesh)
    ctx = _context(cfg, mesh)

    def step(state, faults):
        new, events, step.decided, _, _ = engine_step(
            cfg, local_tree(state, st_sh, mesh), local_tree(faults, ft_sh, mesh), ctx=ctx
        )
        return wrap_tree(new, st_sh, mesh), wrap_tree(events, _event_shardings(mesh), mesh)

    step.context, step.decided = ctx, False
    return step


def _sizes(sizes, max_cuts: int) -> Tuple[int, ...]:
    """The JAX wave's ``[max_cuts]`` sizes: -1 beyond the committed cuts."""
    return tuple(sizes) + (-1,) * (max_cuts - len(sizes))


def make_sharded_wave(cfg: EngineConfig, mesh: DeviceMesh, max_cuts: int = 8):
    """The whole-wave convergence loop over ``mesh``: ``wave(state, faults,
    target, max_steps, min_cuts) -> (state, steps, cuts, resolved,
    sizes)``, with ``sizes`` the ``max_cuts`` memberships after each cut
    (-1 beyond ``cuts``), as the JAX wave returns them; the view change
    and the edge masks' rebuild run gated inside the loop."""
    st_sh, ft_sh = state_shardings(mesh), fault_shardings(mesh)
    ctx = _context(cfg, mesh)

    def wave(state, faults, target, max_steps, min_cuts):
        new, steps, cuts, resolved, sizes, _, _ = run_until_membership(
            cfg, local_tree(state, st_sh, mesh), local_tree(faults, ft_sh, mesh),
            _scalar(target), _scalar(max_steps), max_cuts, _scalar(min_cuts), ctx=ctx,
        )
        return wrap_tree(new, st_sh, mesh), steps, cuts, resolved, _sizes(sizes, max_cuts)

    wave.context = ctx
    return wave


def make_sharded_step_telem(cfg: EngineConfig, mesh: DeviceMesh):
    """:func:`make_sharded_step` with the telemetry lanes riding along:
    ``step(state, telem, faults) -> (state, telem, events)``. The lanes
    shard by :func:`telemetry_shardings` and add no collective to a
    round."""
    st_sh, ft_sh, tl_sh = state_shardings(mesh), fault_shardings(mesh), telemetry_shardings(mesh)
    ctx = _context(cfg, mesh)

    def step(state, telem, faults):
        new, events, step.decided, telem, _ = engine_step(
            cfg, local_tree(state, st_sh, mesh), local_tree(faults, ft_sh, mesh),
            local_tree(telem, tl_sh, mesh), ctx=ctx,
        )
        return (wrap_tree(new, st_sh, mesh), wrap_tree(telem, tl_sh, mesh),
                wrap_tree(events, _event_shardings(mesh), mesh))

    step.context, step.decided = ctx, False
    return step


def make_sharded_step_trace(cfg: EngineConfig, mesh: DeviceMesh):
    """:func:`make_sharded_step_telem` with the round-trace ring riding
    along: ``step(state, telem, trace, faults) -> (state, telem, trace,
    events)``. The ring replicates (:func:`trace_shardings`); its two
    counts per round are reduced over the mesh."""
    st_sh, ft_sh = state_shardings(mesh), fault_shardings(mesh)
    tl_sh, tr_sh = telemetry_shardings(mesh), trace_shardings(mesh)
    ctx = _context(cfg, mesh)

    def step(state, telem, trace, faults):
        new, events, step.decided, telem, trace = engine_step(
            cfg, local_tree(state, st_sh, mesh), local_tree(faults, ft_sh, mesh),
            local_tree(telem, tl_sh, mesh), local_tree(trace, tr_sh, mesh), ctx=ctx,
        )
        return (wrap_tree(new, st_sh, mesh), wrap_tree(telem, tl_sh, mesh),
                wrap_tree(trace, tr_sh, mesh), wrap_tree(events, _event_shardings(mesh), mesh))

    step.context, step.decided = ctx, False
    return step


def make_sharded_wave_telem(cfg: EngineConfig, mesh: DeviceMesh, max_cuts: int = 8):
    """:func:`make_sharded_wave` with the telemetry lanes in the loop:
    ``wave(state, telem, faults, target, max_steps, min_cuts) -> (state,
    telem, steps, cuts, resolved, sizes)``."""
    st_sh, ft_sh, tl_sh = state_shardings(mesh), fault_shardings(mesh), telemetry_shardings(mesh)
    ctx = _context(cfg, mesh)

    def wave(state, telem, faults, target, max_steps, min_cuts):
        new, steps, cuts, resolved, sizes, telem, _ = run_until_membership(
            cfg, local_tree(state, st_sh, mesh), local_tree(faults, ft_sh, mesh),
            _scalar(target), _scalar(max_steps), max_cuts, _scalar(min_cuts),
            local_tree(telem, tl_sh, mesh), ctx=ctx,
        )
        return (wrap_tree(new, st_sh, mesh), wrap_tree(telem, tl_sh, mesh), steps, cuts,
                resolved, _sizes(sizes, max_cuts))

    wave.context = ctx
    return wave
