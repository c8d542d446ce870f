"""The tenant fleet: B independent virtual clusters stepped together, one
round of the engine for every tenant per call (port of
``rapid_tpu/tenancy/fleet.py`` with its telemetry and trace twins and its
serving seams, ``stream_step`` and ``stream_crash``, and the mesh entry
points :func:`make_fleet_step` / :func:`make_fleet_wave`).

The JAX package vmaps its engine over a leading tenant axis. Here the round
body itself works on ``[t, ...]`` lanes (``models/virtual_cluster.py``),
and the per-tenant protocol knobs (:class:`TenantKnobs`: H/L watermarks,
failure threshold, classic-fallback delay) ride the config as ``[t]``
tensors. Each tenant's results are bit-identical to a separate
``VirtualCluster`` run (``tests/test_torch_fleet.py``).

What vmap does to the single cluster's control flow, the port writes out:

- the ``lax.cond`` gates of the classic attempt and the view change become
  per-tenant selects: the branch is computed for every tenant and kept
  where that tenant's gate is set. Implicit invalidation is computed for
  every tenant too, and needs no select: where its gate is clear it adds
  no bit;
- :func:`fleet_wave` is LOCKSTEP, as in JAX: exactly ``max_steps``
  iterations, one round per tenant each, the view change select-applied
  and finished or quarantined tenants frozen through the ``done`` lane. The
  loop's only predicate is a counter, so it makes no host read: the results
  come back in one packed read after it. On a mesh (:func:`make_fleet_wave`)
  it stays so, since "is any tenant still active" would be a collective
  across the tenant axis;
- on one device, :meth:`TenantFleet.run_until_membership` runs the wave's
  iterations in chunks of :data:`WAVE_GRAPH_CHUNK` (:class:`WaveGraphs`)
  and stops once a counted read before a chunk finds no tenant active
  (from the third chunk on, the read before the chunk still on the card,
  so that the host launches a chunk while the card computes the last). A
  frozen tenant's iteration gives back its own lanes, so the results are
  the whole lockstep wave's, bit for bit. On a card each chunk replays
  from a captured CUDA graph: the same ops on static copies of the wave's
  inputs, without the host issuing each of the round's ~850 operations.
  The chunks run eagerly where a replay could not be the eager wave: off a
  card, inside the port's own ``profiling.trace()`` (whose spans are
  Python), or with a wrapper on a seam of the round;
- :func:`fleet_run_to_decision` is the batched while: tenants that decided
  stop and keep their state, with one read of "any tenant still running"
  per round (the single-device driver).

With ``telemetry`` (and ``trace``) on, every driver carries per-tenant
plane lanes ``[t, ...]`` beside the state and gates them with the state's
own mask: every tenant in :func:`fleet_step`, ``running`` in
:func:`fleet_run_to_decision`, ``active`` in :func:`fleet_wave` (a coasting
or quarantined tenant records nothing). Each tenant's lanes equal its own
single cluster's.

A fleet of compact clusters (``compact=1``, one of the fleet-static fields)
stacks and runs through the same functions unchanged: every lane keeps its policy
dtype, and at a few thousand slots the index lanes are int16.

On a card the delivery kernel runs once per round for all tenants.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rapid_tpu_torch import _host, _u32
from rapid_tpu_torch.models import virtual_cluster
from rapid_tpu_torch.models.state import (
    ROUND_ENVELOPE,
    EngineConfig,
    EngineState,
    FaultInputs,
    StepEvents,
    TelemetryLanes,
    TraceRing,
    initial_telemetry,
    initial_trace,
    map_lanes,
    select_lanes,
    stack_lanes,
)
from rapid_tpu_torch.models.virtual_cluster import (
    VirtualCluster,
    _compute_round,
    _edge_masks,
    _gate,
    _loop,
    apply_view_change_impl,
)
from rapid_tpu_torch.models.virtual_cluster import telemetry_digest as fleet_telemetry_digest
from rapid_tpu_torch.models.virtual_cluster import trace_digest as fleet_trace_digest
from rapid_tpu_torch.ops import kernels
from rapid_tpu_torch.parallel.collectives import TENANT_AXIS
from rapid_tpu_torch.parallel.mesh import (
    _context,
    _event_shardings,
    _resolve_spec,
    fleet_fault_shardings,
    fleet_state_shardings,
    local_tree,
    match_partition_rules,
    wrap_tree,
)
from rapid_tpu_torch.utils import engine_telemetry, exposition, profiling
from rapid_tpu_torch.utils.dispatch import DispatchSeam
from rapid_tpu_torch.utils.health import NodeHealth
from rapid_tpu_torch.utils.metrics import Metrics

# The span of the lockstep loops' per-tenant select (``profiling.span``).
profiling.register("fleet_select")

#: The EngineConfig fields that vary per tenant, as :class:`TenantKnobs`
#: lanes. Every other field must be identical across a fleet's tenants, so
#: the static set is derived, not enumerated: a field added to EngineConfig
#: later is fleet-static by default and fails closed in
#: :meth:`TenantFleet.from_clusters`.
KNOB_FIELDS = ("h", "l", "fd_threshold", "fallback_rounds")

FLEET_STATIC_FIELDS = tuple(f for f in EngineConfig._fields if f not in KNOB_FIELDS)


class TenantKnobs(NamedTuple):
    """Per-tenant protocol knobs as ``[t]`` int32 tensors."""

    h: torch.Tensor  # high watermark
    l: torch.Tensor  # low watermark
    fd_threshold: torch.Tensor  # failed windows before alerting
    fallback_rounds: torch.Tensor  # classic-Paxos recovery delay

    @staticmethod
    def from_configs(cfgs: Sequence[EngineConfig], device) -> "TenantKnobs":
        return TenantKnobs(
            *(
                torch.tensor([getattr(c, f) for c in cfgs], dtype=torch.int32, device=device)
                for f in KNOB_FIELDS
            )
        )


def _tenant_cfg(cfg: EngineConfig, knobs: TenantKnobs) -> EngineConfig:
    """The shared static geometry with the per-tenant knob lanes woven in.
    The round body uses every knob only in comparisons, broadcast against
    the lanes it compares (``ops.kernels.per_batch``), which is the same
    arithmetic as a single cluster's Python int."""
    return cfg._replace(**knobs._asdict())


def initial_fleet_telemetry(cfg: EngineConfig, tenants: int, device) -> TelemetryLanes:
    """All-zero telemetry lanes for ``tenants`` clusters, ``[t, ...]``."""
    return initial_telemetry(cfg, device, tenants)


def initial_fleet_trace(cfg: EngineConfig, tenants: int, device) -> TraceRing:
    """All-zero trace rings for ``tenants`` clusters, ``[t, ...]``."""
    return initial_trace(cfg, device, tenants)


def fleet_step(
    cfg: EngineConfig,
    state: EngineState,
    faults: FaultInputs,
    knobs: TenantKnobs,
    telem: Optional[TelemetryLanes] = None,
    trace: Optional[TraceRing] = None,
    ctx=None,
):
    """One protocol round for every tenant, with each decided tenant's view
    change applied. Returns ``(state, events, telem, trace)``: events
    stacked (``[t]`` scalars, ``[t, n]`` winner masks), and every tenant's
    plane lanes advanced (``None`` where none were given), quarantined
    tenants included, as the JAX fleet's batched step does. ``ctx``: this
    rank's shard of a ``('tenant', 'cohort', 'nodes')`` mesh
    (:func:`make_fleet_step`)."""
    tcfg = _tenant_cfg(cfg, knobs)
    round_state, decided, winner, events, telem, trace = _compute_round(
        tcfg, state, faults, select=True, telem=telem, trace=trace, ctx=ctx
    )
    with _gate(ctx), profiling.span("view_change"):
        committed = apply_view_change_impl(tcfg, round_state, winner, ctx)
    return select_lanes(decided, committed, round_state), events, telem, trace


def fleet_run_to_decision(
    cfg: EngineConfig,
    state: EngineState,
    faults: FaultInputs,
    knobs: TenantKnobs,
    max_steps: int,
    telem: Optional[TelemetryLanes] = None,
    trace: Optional[TraceRing] = None,
):
    """Every tenant rounds to its own first view change (the batched while
    of ``run_to_decision``): a tenant that decided, or spent
    ``max_steps``, stops stepping and keeps its state and plane lanes, and
    the view changes apply per tenant after the loop. One host read per
    round. Returns ``(state, steps[t], decided[t], winner[t, n], telem,
    trace)``."""
    tcfg = _tenant_cfg(cfg, knobs)
    t, n = state.alive.shape
    dev = state.alive.device
    edge_masks = _edge_masks(tcfg, state, faults)
    steps = torch.zeros((t,), dtype=torch.int32, device=dev)
    decided = torch.zeros((t,), dtype=torch.bool, device=dev)
    winner = torch.zeros((t, n), dtype=torch.bool, device=dev)
    while True:
        running = ~decided & (steps < max_steps)
        if not _host.read(running.any(), "fleet_decision_predicate"):  # host-sync-ok: the decision loop's predicate (JAX's while_loop condition)
            break
        round_state, now, won, _, round_telem, round_trace = _compute_round(
            tcfg, state, faults, edge_masks, select=True, telem=telem, trace=trace
        )
        with profiling.span("fleet_select"):
            state = select_lanes(running, round_state, state)
            telem = select_lanes(running, round_telem, telem)
            trace = select_lanes(running, round_trace, trace)
            steps = steps + running.to(torch.int32)
            decided = torch.where(running, now, decided)
            winner = torch.where(running[:, None], won, winner)
    with profiling.span("view_change"):
        committed = apply_view_change_impl(tcfg, state, winner)
    return select_lanes(decided, committed, state), steps, decided, winner, telem, trace


class _WaveInputs(NamedTuple):
    """What every lockstep iteration of one wave reads and none changes."""

    tcfg: EngineConfig  # the fleet's config with its knob lanes woven in
    faults: FaultInputs
    target: torch.Tensor  # [t] int32
    min_cuts: torch.Tensor  # [t] int32
    max_steps: int
    slots: torch.Tensor  # [max_cuts] int32: 0, 1, ...


class _WaveCarry(NamedTuple):
    """What one lockstep iteration of :func:`fleet_wave` hands the next."""

    state: EngineState
    telem: Optional[TelemetryLanes]
    trace: Optional[TraceRing]
    steps: torch.Tensor  # [t] int32: rounds each tenant stepped
    cuts: torch.Tensor  # [t] int32: view changes each tenant committed
    sizes: torch.Tensor  # [t, max_cuts] int32: members after each cut, -1 beyond
    done: torch.Tensor  # [t] bool: frozen (resolved, out of cuts, or quarantined)


def _wave_inputs(cfg, faults, knobs, target, max_steps, max_cuts, min_cuts) -> _WaveInputs:
    slots = torch.arange(max_cuts, dtype=torch.int32, device=target.device)
    return _WaveInputs(_tenant_cfg(cfg, knobs), faults, target, min_cuts, max_steps, slots)


def _wave_start(state, telem, trace, inputs: _WaveInputs) -> _WaveCarry:
    t = state.alive.shape[0]
    dev = state.alive.device
    # The equal-churn trap guard, as the nested loop's entry condition:
    # already-at-target resolves vacuously only when no cuts are demanded.
    done = (state.n_members == inputs.target) & (inputs.min_cuts <= 0)
    return _WaveCarry(
        state, telem, trace,
        torch.zeros((t,), dtype=torch.int32, device=dev),
        torch.zeros((t,), dtype=torch.int32, device=dev),
        torch.full((t, inputs.slots.shape[0]), -1, dtype=torch.int32, device=dev),
        done,
    )


def _active(inputs: _WaveInputs, carry: _WaveCarry) -> torch.Tensor:
    """[t] bool: the tenants the next iteration steps."""
    return ~carry.done & (carry.steps < inputs.max_steps)


def _wave_iteration(inputs: _WaveInputs, carry: _WaveCarry, ctx=None) -> _WaveCarry:
    """One lockstep iteration: a round for every tenant, the view change
    select-applied, and the tenants that stepped, committed or finished
    accounted; frozen tenants keep their lanes."""
    tcfg, faults, target, min_cuts, max_steps, slots = inputs
    state, telem, trace, steps, cuts, sizes, done = carry
    active = _active(inputs, carry)
    with _loop(ctx):
        round_state, decided, winner, _, round_telem, round_trace = _compute_round(
            tcfg, state, faults, select=True, telem=telem, trace=trace, ctx=ctx
        )
        with _gate(ctx), profiling.span("view_change"):
            committed = apply_view_change_impl(tcfg, round_state, winner, ctx)
    with profiling.span("fleet_select"):
        commit = active & decided
        state = select_lanes(commit, committed, select_lanes(active, round_state, state))
        telem = select_lanes(active, round_telem, telem)
        trace = select_lanes(active, round_trace, trace)
        steps = steps + active.to(torch.int32)
        # sizes[cuts] = members where a cut committed; a slot past max_cuts
        # matches no column, so that write is dropped, as JAX drops it.
        slot = (slots == cuts[:, None]) & commit[:, None]
        sizes = torch.where(slot, state.n_members[:, None], sizes)
        cuts = cuts + commit.to(torch.int32)
        resolved = (state.n_members == target) & (cuts >= min_cuts)
        done = done | (commit & resolved) | (cuts >= slots.shape[0])
    return _WaveCarry(state, telem, trace, steps, cuts, sizes, done)


def _wave_results(inputs: _WaveInputs, carry: _WaveCarry):
    resolved = (carry.state.n_members == inputs.target) & (carry.cuts >= inputs.min_cuts)
    return (carry.state, carry.steps, carry.cuts, resolved, carry.sizes, carry.telem,
            carry.trace)


def fleet_wave(
    cfg: EngineConfig,
    state: EngineState,
    faults: FaultInputs,
    knobs: TenantKnobs,
    target: torch.Tensor,
    max_steps: int,
    max_cuts: int,
    min_cuts: torch.Tensor,
    telem: Optional[TelemetryLanes] = None,
    trace: Optional[TraceRing] = None,
    ctx=None,
):
    """The fleet's whole-wave loop: every tenant runs convergences through
    as many view changes as it needs to reach its own ``target`` membership
    with at least its own ``min_cuts`` cuts. LOCKSTEP (module docstring):
    ``max_steps`` iterations of one round per tenant, the view change
    select-applied and finished tenants frozen in place, with no host read.
    Per tenant the same ``_compute_round`` / ``apply_view_change_impl``
    sequence runs on the same values as the single cluster's nested loop.
    The plane lanes are frozen with the state, by the same ``active`` mask.

    ``target`` and ``min_cuts`` are ``[t]`` int32 on the state's device.
    Returns ``(state, steps[t], cuts[t], resolved[t], sizes[t, max_cuts],
    telem, trace)`` as device tensors, ``sizes`` -1 beyond each tenant's
    cuts. ``ctx``: this rank's shard of a mesh (:func:`make_fleet_wave`);
    the loop's predicate stays the replicated counter.
    :meth:`WaveGraphs.wave` gives the same results in chunks that stop once
    no tenant is active."""
    inputs = _wave_inputs(cfg, faults, knobs, target, max_steps, max_cuts, min_cuts)
    carry = _wave_start(state, telem, trace, inputs)
    for _ in range(max_steps):
        carry = _wave_iteration(inputs, carry, ctx)
    return _wave_results(inputs, carry)


#: Lockstep iterations in one chunk of a single-device wave, and in one
#: captured CUDA graph of it (96 = 12 x 8).
WAVE_GRAPH_CHUNK = 8


def _chunked_wave(inputs: _WaveInputs, carry: _WaveCarry, replay=None):
    """The wave's ``max_steps`` iterations as parts, chunks of
    :data:`WAVE_GRAPH_CHUNK` and an eager rest, stopped once a counted read
    before a part finds no tenant active: every later iteration would give
    each tenant back its own lanes. The host waits for the reads before the
    first two parts. From the third part on it launches each part on the
    read before the part still on the card, so that the card computes one
    part while the host launches the next, at the cost of at most one part
    that changes nothing. ``replay``, where given, advances a carry by a
    chunk and returns it (a captured graph's), else a chunk runs eagerly.
    Returns the carry and the iterations run."""
    chunks, rest = divmod(inputs.max_steps, WAVE_GRAPH_CHUNK)
    ran, active = 0, []
    for i, size in enumerate([WAVE_GRAPH_CHUNK] * chunks + [rest] * bool(rest)):
        active.append(_host.read_later(_active(inputs, carry).any(), "fleet_wave_active"))
        if not active[i - 1 if i >= 2 else i]():  # host-sync-ok: the single-device wave's exit, once a part
            break
        if replay is not None and size == WAVE_GRAPH_CHUNK:
            carry = replay(carry)
        else:
            for _ in range(size):
                carry = _wave_iteration(inputs, carry)
        ran += size
    return carry, ran


#: The round's module-level seams as the package defines them. A replay
#: runs no Python, so a wrapper put on a seam (a spy, a bound's sum) would
#: see no call of it: a wave with one in place runs eagerly.
_ROUND_SEAMS = (virtual_cluster.delivery_new_bits, virtual_cluster._cohort_cut_detection)


def _clone(tree):
    """A copy of a lane, of a tree of lanes, or None."""
    return tree.clone() if isinstance(tree, torch.Tensor) else map_lanes(torch.clone, tree)


def _lanes(*trees) -> list:
    """Every tensor of ``trees`` (named tuples of lanes, tensors or None)."""
    out = []
    for tree in trees:
        if isinstance(tree, torch.Tensor):
            out.append(tree)
        elif tree is not None:
            out.extend(_lanes(*tree))
    return out


def _copy_into(dst: list, src: list) -> None:
    for d, s in zip(dst, src, strict=True):
        d.copy_(s)


def _layout(*trees) -> tuple:
    """What a captured graph is bound to: each lane's shape, dtype and
    device, and which planes are on."""
    return tuple(
        None if tree is None else tuple((tuple(x.shape), x.dtype, x.device) for x in _lanes(tree))
        for tree in trees
    )


class _WaveChunk:
    """One wave's inputs and carry held in static buffers, and
    :data:`WAVE_GRAPH_CHUNK` lockstep iterations over them, captured as one
    CUDA graph that ends by copying the advanced carry back into its
    buffers: each replay advances the carry by a chunk. Until
    :meth:`capture`, a replay runs the chunk as Python, on any device (the
    CPU tests' way in)."""

    def __init__(self, cfg, state, faults, knobs, target, max_steps, max_cuts, min_cuts, telem,
                 trace):
        self.knobs = _clone(knobs)
        self.inputs = _wave_inputs(cfg, _clone(faults), self.knobs, target.clone(), max_steps,
                                   max_cuts, min_cuts.clone())
        self.carry = _wave_start(_clone(state), _clone(telem), _clone(trace), self.inputs)
        self.graph = None
        self.launches = 0  # delivery launches in one replay, as the capture counted them

    def load(self, state, faults, knobs, target, min_cuts, telem, trace) -> None:
        """Copy one wave's inputs and its starting carry into the buffers."""
        start = _wave_start(state, telem, trace, self.inputs._replace(target=target,
                                                                       min_cuts=min_cuts))
        _copy_into(_lanes(self.carry, self.inputs.faults, self.knobs, self.inputs.target,
                          self.inputs.min_cuts),
                   _lanes(start, faults, knobs, target, min_cuts))

    def _chunk(self) -> None:
        carry = self.carry
        for _ in range(WAVE_GRAPH_CHUNK):
            carry = _wave_iteration(self.inputs, carry)
        _copy_into(_lanes(self.carry), _lanes(carry))

    def capture(self) -> None:
        dev = self.carry.steps.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # One iteration runs first, on scratch copies, so that every
            # kernel is loaded before the capture; the carry stays as loaded.
            _wave_iteration(self.inputs, _WaveCarry(*map(_clone, self.carry)))
        self.graph = torch.cuda.CUDAGraph()
        launches = kernels.delivery_new_bits.launches
        with torch.cuda.graph(self.graph, stream=side):
            self._chunk()
        # The capture recorded these launches and ran none: each replay runs them.
        self.launches = kernels.delivery_new_bits.launches - launches
        kernels.delivery_new_bits.launches = launches

    def replay(self) -> _WaveCarry:
        """Advance the carry by a chunk, and return it."""
        if self.graph is None:
            self._chunk()
        else:
            self.graph.replay()
            kernels.delivery_new_bits.launches += self.launches
        return self.carry


class WaveGraphs:
    """A fleet's captured wave chunks, one per layout of the wave's inputs
    (:data:`WAVE_GRAPH_CHUNK` iterations each). A :class:`TenantFleet`
    holds one, so the graphs and their memory pools go with the fleet.
    ``_direct`` (tests only) builds each chunk's static buffers without
    capturing it, and runs it as Python, on any device."""

    def __init__(self, _direct: bool = False) -> None:
        self._direct = _direct
        self._chunks: dict = {}

    def admits(self, state: EngineState) -> bool:
        """True when a single-device wave over ``state`` may replay: on a
        card, outside the port's own ``profiling.trace()`` (whose spans are
        Python) and with no wrapper on a seam of the round."""
        return (
            (state.alive.device.type == "cuda" or self._direct)
            and not profiling.recording()
            and virtual_cluster.delivery_new_bits is _ROUND_SEAMS[0]
            and virtual_cluster._cohort_cut_detection is _ROUND_SEAMS[1]
        )

    def wave(self, cfg, state, faults, knobs, target, max_steps, max_cuts, min_cuts, telem=None,
             trace=None):
        """:func:`fleet_wave`'s results, whether a replay gave them, and the
        iterations run, which stop once no tenant is active
        (:func:`_chunked_wave`). Where :meth:`admits` allows and a chunk
        fits in ``max_steps``, the first chunk copies the inputs into the
        chunk's buffers (capturing its graph the first time), each chunk is
        a replay, the rest of the iterations run eagerly, and the results
        come back as copies, so that no lane the caller holds is a buffer
        of the graph. Anywhere else the chunks run eagerly."""
        inputs = _wave_inputs(cfg, faults, knobs, target, max_steps, max_cuts, min_cuts)
        start = _wave_start(state, telem, trace, inputs)
        if max_steps < WAVE_GRAPH_CHUNK or not self.admits(state):
            carry, ran = _chunked_wave(inputs, start)
            return _wave_results(inputs, carry), False, ran
        key = (cfg, max_steps, max_cuts, _layout(state, faults, knobs, telem, trace))
        chunk = self._chunks.get(key)

        def replay(carry):
            nonlocal chunk
            if chunk is None:
                chunk = self._chunks[key] = _WaveChunk(
                    cfg, state, faults, knobs, target, max_steps, max_cuts, min_cuts, telem, trace)
                if not self._direct:
                    chunk.capture()
            elif carry is not chunk.carry:
                chunk.load(state, faults, knobs, target, min_cuts, telem, trace)
            return chunk.replay()

        carry, ran = _chunked_wave(inputs, start, replay)
        return tuple(map(_clone, _wave_results(inputs, carry))), ran >= WAVE_GRAPH_CHUNK, ran


#: Partition rules for the knob lanes, in the ``parallel/mesh.py`` table
#: style (a copy of the JAX fleet's): every knob is a ``[t]`` lane on
#: ``'tenant'``.
PARTITION_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"h|l|fd_threshold|fallback_rounds", (TENANT_AXIS,)),
)


def knob_shardings(mesh) -> TenantKnobs:
    """Placements for the knob lanes from :data:`PARTITION_RULES` (on
    ``'tenant'``; replicated on a mesh without the axis)."""
    specs = match_partition_rules(PARTITION_RULES, TenantKnobs._fields)
    return TenantKnobs(**{f: _resolve_spec(specs[f], mesh) for f in TenantKnobs._fields})


def make_fleet_step(cfg: EngineConfig, mesh):
    """:func:`fleet_step` over a ``('tenant', 'cohort', 'nodes')`` mesh:
    ``step(state, faults, knobs) -> (state, events)``, the state returned
    under its input placements (``fleet_state_shardings``). No collective
    spans the tenant axis: each rank's groups lie within its tenant block."""
    st_sh, ft_sh = fleet_state_shardings(mesh), fleet_fault_shardings(mesh)
    kn_sh, ev_sh = knob_shardings(mesh), _event_shardings(mesh, (TENANT_AXIS,))
    ctx = _context(cfg, mesh, fleet=True)

    def step(state, faults, knobs):
        new, events, _, _ = fleet_step(
            cfg, local_tree(state, st_sh, mesh), local_tree(faults, ft_sh, mesh),
            local_tree(knobs, kn_sh, mesh), ctx=ctx,
        )
        return wrap_tree(new, st_sh, mesh), wrap_tree(events, ev_sh, mesh)

    step.context = ctx
    return step


def make_fleet_wave(cfg: EngineConfig, mesh, max_cuts: int = 8):
    """The lockstep :func:`fleet_wave` over the mesh: ``wave(state, faults,
    knobs, target, max_steps, min_cuts) -> (state, steps, cuts, resolved,
    sizes)``. ``target`` / ``min_cuts`` are ``[t]`` lanes on ``'tenant'``
    (DTensors, or whole tensors alike on every rank); ``max_steps``, an
    int, is the loop's only predicate, so no collective carries the tenant
    axis. The ``[t]`` results come back as DTensors on ``'tenant'``."""
    st_sh, ft_sh = fleet_state_shardings(mesh), fleet_fault_shardings(mesh)
    kn_sh, lane = knob_shardings(mesh), _resolve_spec((TENANT_AXIS,), mesh)
    ctx = _context(cfg, mesh, fleet=True)

    def wave(state, faults, knobs, target, max_steps, min_cuts):
        target, min_cuts = local_tree(_Lanes(target, min_cuts), (lane, lane), mesh)
        new, steps, cuts, resolved, sizes, _, _ = fleet_wave(
            cfg, local_tree(state, st_sh, mesh), local_tree(faults, ft_sh, mesh),
            local_tree(knobs, kn_sh, mesh), target, int(max_steps), max_cuts, min_cuts, ctx=ctx,
        )
        out = wrap_tree(_Results(steps, cuts, resolved, sizes), (lane,) * 4, mesh)
        return (wrap_tree(new, st_sh, mesh), *out)

    wave.context = ctx
    return wave


class _Lanes(NamedTuple):
    target: torch.Tensor
    min_cuts: torch.Tensor


class _Results(NamedTuple):
    steps: torch.Tensor
    cuts: torch.Tensor
    resolved: torch.Tensor
    sizes: torch.Tensor


def tenant_health(cfg: EngineConfig, state: EngineState) -> torch.Tensor:
    """The cheap device-side health reduction: one ``[t]`` bool lane, True
    where the tenant's state satisfies the protocol invariants:

    - ``n_members`` equals the alive population and sits in ``[0, n]``;
    - no slot is alive and retired at once;
    - the per-configuration counters (round_idx, rounds_undecided,
      classic_epoch, promised classic ranks, config_epoch) are
      non-negative, and under the compact layout round_idx is within
      ``ROUND_ENVELOPE`` (past it the narrow fire-round sentinel no longer
      tells fired edges from unfired ones)."""
    ok = state.n_members == state.alive.sum(-1, dtype=torch.int32)
    ok &= (state.n_members >= 0) & (state.n_members <= cfg.n)
    ok &= ~(state.alive & state.retired).any(-1)
    ok &= state.round_idx >= 0
    ok &= state.rounds_undecided >= 0
    ok &= state.classic_epoch >= 0
    ok &= (state.cp_rnd_r >= 0).all(-1)
    ok &= state.config_epoch >= 0
    if cfg.compact:
        ok &= state.round_idx <= ROUND_ENVELOPE
    return ok


def _np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()  # host-read-ok: the fleet's host reports and scans, outside any round


class TenantFleet(DispatchSeam):
    """Host driver over the batched engine: owns the stacked state, fault
    masks and per-tenant knobs, and a ``metrics`` registry charged as the
    JAX fleet charges its own.

    A fleet is built by stacking ordinary per-tenant ``VirtualCluster``
    builds (:meth:`from_clusters`): every injection (crash, join wave,
    rx-block, cohort assignment) stays the single-cluster API, run per
    tenant before stacking. Runs where its clusters run (CUDA unless they
    were built with another device)."""

    def __init__(
        self, cfg: EngineConfig, state: EngineState, faults: FaultInputs, knobs: TenantKnobs
    ) -> None:
        b = int(knobs.h.shape[0])
        for leaf in (*state, *faults, *knobs):
            if tuple(leaf.shape[:1]) != (b,):
                raise ValueError(
                    f"fleet lanes must share the leading tenant axis ({b}); "
                    f"got a lane of shape {tuple(leaf.shape)}"
                )
        self.cfg = cfg
        self.state = state
        self.faults = faults
        self.knobs = knobs
        self.b = b
        self.device = state.alive.device
        self.metrics = Metrics()
        # The wave's captured CUDA graphs, released with the fleet.
        self._wave_graphs = WaveGraphs()
        # Attached by serving.StreamDriver and serving.supervisor.Supervisor.
        self.stream = None
        self.recovery = None
        # Pinned host buffers of uploads in flight (see VirtualCluster).
        self._staged: list = []
        # tenant -> raw frozen membership captured at quarantine time (the
        # per-tenant freeze-lane inputs; see quarantine()).
        self._quarantined: dict = {}
        # Per-tenant telemetry plane and trace ring (None when off), with
        # the host caches zero-minted here and refreshed only by sync() and
        # health_scan().
        self.telem = initial_fleet_telemetry(cfg, b, self.device) if cfg.telemetry else None
        self.trace_ring = initial_fleet_trace(cfg, b, self.device) if cfg.trace else None
        self._activity = (
            [engine_telemetry.zero_activity_summary(cfg.n, cfg.c) for _ in range(b)]
            if cfg.telemetry else None
        )
        self._trace = (
            [engine_telemetry.zero_trace_summary(cfg.trace) for _ in range(b)]
            if cfg.trace else None
        )
        engine_telemetry.install()

    # -- construction ---------------------------------------------------

    @classmethod
    def from_clusters(cls, clusters: Sequence[VirtualCluster]) -> "TenantFleet":
        """Stack B prepared single-tenant clusters into one fleet. The
        static geometry (slot count, rings, cohorts, delivery model) must
        match across tenants; the per-tenant knobs (H/L, fd_threshold,
        fallback delay) may differ freely and ride :class:`TenantKnobs`."""
        if not clusters:
            raise ValueError("a fleet needs at least one tenant")
        cfgs = [vc.cfg for vc in clusters]
        base = cfgs[0]
        for i, cfg in enumerate(cfgs[1:], start=1):
            diffs = [
                f"{f}: {getattr(base, f)!r} != {getattr(cfg, f)!r}"
                for f in FLEET_STATIC_FIELDS
                if getattr(base, f) != getattr(cfg, f)
            ]
            if diffs:
                raise ValueError(
                    f"tenant {i} differs from tenant 0 in fleet-static "
                    f"config fields ({'; '.join(diffs)}) — these shape "
                    f"the one round body every tenant runs; only the "
                    f"TenantKnobs fields may vary per tenant"
                )
        for i, cfg in enumerate(cfgs):
            if not 1 <= cfg.l <= cfg.h <= cfg.k:
                raise ValueError(
                    f"tenant {i}: watermarks must satisfy 1 <= L <= H <= K, "
                    f"got L={cfg.l} H={cfg.h} K={cfg.k}"
                )
            if cfg.fd_window and cfg.fd_threshold > cfg.fd_window:
                raise ValueError(
                    f"tenant {i}: fd_threshold ({cfg.fd_threshold}) cannot "
                    f"exceed fd_window ({cfg.fd_window})"
                )
        fleet = cls(
            base,
            stack_lanes([vc.state for vc in clusters]),
            stack_lanes([vc.faults for vc in clusters]),
            TenantKnobs.from_configs(cfgs, clusters[0].device),
        )
        # The JAX fleet charges the stacked state's upload (each cluster
        # charged its own builds to its own registry), so this one does too.
        fleet._account_h2d(*fleet.state)
        # Each tenant's plane lanes come along: a fleet stacked mid-run
        # keeps its tenants' activity and round history.
        if base.telemetry:
            fleet.telem = stack_lanes([vc.telem for vc in clusters])
            fleet._account_h2d(*fleet.telem)
        if base.trace:
            fleet.trace_ring = stack_lanes([vc.trace_ring for vc in clusters])
            fleet._account_h2d(*fleet.trace_ring)
        return fleet

    @classmethod
    def create(
        cls,
        tenants: int,
        n_members: int,
        n_slots: Optional[int] = None,
        k: int = 10,
        cohorts: int = 2,
        seeds: Optional[Sequence[int]] = None,
        knobs: Optional[Sequence[Tuple[int, int, int]]] = None,
        **engine_kwargs,
    ) -> "TenantFleet":
        """Synthetic fleet: B independent synthetic clusters (independent
        identity seeds), round-robin cohorts, optional per-tenant
        ``(h, l, fd_threshold)`` knob triples. ``engine_kwargs`` go to
        ``VirtualCluster.create`` (``device`` among them)."""
        if seeds is None:
            seeds = list(range(tenants))
        if len(seeds) != tenants:
            raise ValueError(f"need {tenants} seeds, got {len(seeds)}")
        if knobs is not None and len(knobs) != tenants:
            raise ValueError(f"need {tenants} knob triples, got {len(knobs)}")
        clusters = []
        for i in range(tenants):
            h, l, fd = knobs[i] if knobs is not None else (9, 4, 3)
            vc = VirtualCluster.create(
                n_members, n_slots=n_slots, k=k, h=h, l=l, cohorts=cohorts,
                fd_threshold=fd, seed=seeds[i], **engine_kwargs,
            )
            vc.assign_cohorts_roundrobin()
            clusters.append(vc)
        return cls.from_clusters(clusters)

    # -- execution ------------------------------------------------------

    def step(self) -> StepEvents:
        """One protocol round for every tenant; the stacked events stay on
        the device (reading them is the caller's choice)."""
        return self._step("fleet_step")

    def stream_step(self) -> StepEvents:
        """One round for every tenant queued for the streaming pipeline:
        :meth:`step` timed under the ``stream_enqueue`` phase (the fleet's
        round makes no read either way)."""
        return self._step("stream_enqueue")

    def _step(self, phase: str) -> StepEvents:
        self.metrics.inc("engine_tenant_rounds", self.b)
        with self._dispatch(phase) as record:
            self.state, events, self.telem, self.trace_ring = fleet_step(
                self.cfg, self.state, self.faults, self.knobs, self.telem, self.trace_ring
            )
            record.rounds = 1
            record.tenant_rounds_active = record.tenant_rounds_computed = self.b
        return events

    def stream_crash(self, pairs) -> None:
        """Crash ``(tenant, slot)`` pairs mid-stream: one scatter onto the
        stacked crash mask on the device. Only the ``[m, 2]`` int32 pairs
        cross to the device, without waiting for the queued rounds
        (:func:`_host.upload`). Bounds are checked on the host first."""
        arr = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
        if arr.size and (
            arr[:, 0].min() < 0 or arr[:, 0].max() >= self.b
            or arr[:, 1].min() < 0 or arr[:, 1].max() >= self.cfg.n
        ):
            raise IndexError(
                f"(tenant, slot) pairs out of range [0, {self.b}) x "
                f"[0, {self.cfg.n}): {arr.tolist()}"
            )
        self._account_h2d(arr)
        idx = _host.upload(arr, self.device, self._staged).to(torch.int64)
        flat = idx[:, 0] * self.cfg.n + idx[:, 1]
        crashed = self.faults.crashed.flatten().index_fill(0, flat, True)
        self.faults = self.faults._replace(crashed=crashed.view(self.b, self.cfg.n))

    def run_to_decision(self, max_steps: int = 64):
        """Every tenant runs to its own first view change; returns
        ``(rounds[t], decided[t], winner[t, n] on the device, members[t])``
        with one packed read of the observations."""
        with self._dispatch("fleet_decision") as record:
            self.state, steps, decided, winner, self.telem, self.trace_ring = fleet_run_to_decision(
                self.cfg, self.state, self.faults, self.knobs, max_steps, self.telem,
                self.trace_ring,
            )
            obs = np.asarray(
                _host.read(torch.stack([steps, decided.to(torch.int32), self.state.n_members]),
                           "fleet_decision_observation"),
                dtype=np.int32,
            )
            # The loop runs until its slowest tenant stops, every tenant each time.
            record.rounds = int(obs[0].max(initial=0))
            record.tenant_rounds_active = int(obs[0].sum())
            record.tenant_rounds_computed = self.b * record.rounds
        self._account_d2h(obs.nbytes)
        self._staged.clear()
        rounds, was_decided = obs[0], obs[1].astype(bool)
        self.metrics.inc("engine_tenant_rounds", int(rounds.sum()))
        self.metrics.inc("engine_tenant_cuts", int(was_decided.sum()))
        return rounds, was_decided, winner, obs[2]

    def run_until_membership(self, targets, max_steps: int = 192, max_cuts: int = 8, min_cuts=0):
        """The fleet wave: every tenant resolves its own churn, through its
        own number of view changes, to its own target membership, in one
        lockstep loop that stops once no tenant is active
        (:meth:`WaveGraphs.wave`). ``targets``/``min_cuts`` broadcast from
        scalars or give one value per tenant. Returns ``(rounds[t], cuts[t],
        resolved[t], sizes[t, max_cuts])`` as host arrays, from one packed
        read after the loop."""
        targets = np.broadcast_to(np.asarray(targets, dtype=np.int32), (self.b,)).copy()
        min_cuts = np.broadcast_to(np.asarray(min_cuts, dtype=np.int32), (self.b,)).copy()
        # Quarantined tenants ride the wave FROZEN: their target lane is
        # pinned to the raw membership captured at quarantine time and
        # min_cuts to 0, so the lockstep loop's done lane is True from
        # iteration 0 and the tenant's state never changes. The captured
        # value may be garbage (that is WHY the tenant was quarantined), so
        # the range check below applies only to the serving lanes.
        serving = np.ones(self.b, dtype=bool)
        for t, frozen_members in self._quarantined.items():
            targets[t] = frozen_members
            min_cuts[t] = 0
            serving[t] = False
        bad = targets[serving]
        if bad.size and (bad.min() < 0 or bad.max() > self.cfg.n):
            raise ValueError(f"targets must be in [0, {self.cfg.n}]: {targets.tolist()}")
        self._account_h2d(targets, min_cuts)
        with self._dispatch("fleet_wave") as record:
            out, record.graphed, record.rounds = self._wave_graphs.wave(
                self.cfg, self.state, self.faults, self.knobs,
                torch.from_numpy(targets).to(self.device), int(max_steps), int(max_cuts),
                torch.from_numpy(min_cuts).to(self.device), self.telem, self.trace_ring,
            )
            self.state, steps, cuts, resolved, sizes, self.telem, self.trace_ring = out
            obs = np.asarray(
                _host.read(torch.cat([steps, cuts, resolved.to(torch.int32), sizes.reshape(-1)]),
                           "fleet_wave_observation"),
                dtype=np.int32,
            )
            # Every iteration the wave ran computed a round for every tenant.
            record.tenant_rounds_active = int(obs[: self.b].sum())
            record.tenant_rounds_computed = self.b * record.rounds
        self._account_d2h(obs.nbytes)
        self._staged.clear()
        b = self.b
        rounds, n_cuts = obs[:b], obs[b : 2 * b]
        self.metrics.inc("engine_tenant_rounds", int(rounds.sum()))
        self.metrics.inc("engine_tenant_cuts", int(n_cuts.sum()))
        return rounds, n_cuts, obs[2 * b : 3 * b].astype(bool), obs[3 * b :].reshape(b, max_cuts)

    def sync(self) -> None:
        """Wait for all queued work on the fleet's device, then refresh the
        plane caches (:attr:`activity`, :attr:`tenant_activity`,
        :attr:`tenant_trace`)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._staged.clear()
        self._refresh_activity()

    def _refresh_activity(self) -> None:
        """Fetch the stacked digests, one counted read each (``[t, 18]``,
        and ``[t, 2 + 9R]`` for the rings), and decode every tenant's."""
        if self.telem is not None:
            # telemetry-fetch-ok: host-sync boundary — the caller is already
            # paying a blocking device round trip here.
            digest = fleet_telemetry_digest(self.telem)
            self._account_d2h(digest.nbytes)
            digests = _host.read(digest, "telemetry_digest")
            self._activity = [
                engine_telemetry.activity_summary(d, self.cfg.n, self.cfg.c) for d in digests
            ]
        if self.trace_ring is not None:
            # telemetry-fetch-ok: same host-sync boundary — one stacked
            # [t, 2 + 9R] digest fetch decodes every tenant's ring.
            digest = fleet_trace_digest(self.trace_ring)
            self._account_d2h(digest.nbytes)
            digests = _host.read(digest, "trace_digest")
            self._trace = [engine_telemetry.trace_summary(d, self.cfg.trace) for d in digests]

    @property
    def activity(self) -> Optional[dict]:
        """The fleet-wide activity rollup of the last refresh (counters
        summed, peaks maxed over tenants), or None with the plane off."""
        if self._activity is None:
            return None
        return engine_telemetry.aggregate_activity(self._activity, self.cfg.n, self.cfg.c)

    @property
    def tenant_activity(self) -> Optional[List[dict]]:
        """Per-tenant activity summaries (copies) of the last refresh, or
        None with the plane off."""
        return None if self._activity is None else [dict(a) for a in self._activity]

    @property
    def tenant_trace(self) -> Optional[List[dict]]:
        """Per-tenant decoded rings (copies, records included) of the last
        refresh, or None with the ring off."""
        if self._trace is None:
            return None
        return [{**tr, "records": [dict(r) for r in tr["records"]]} for tr in self._trace]

    # -- health & quarantine ----------------------------------------------

    def health_scan(self) -> np.ndarray:
        """Run the device-side health reduction (:func:`tenant_health`) over
        every tenant and read the ``[t]`` result once; returns the POISONED
        mask (True = invariants violated). Refreshes the plane caches, as
        :meth:`sync` does."""
        with self._dispatch("health_scan"):
            ok = _np(tenant_health(self.cfg, self.state))
        self._account_d2h(ok.nbytes)
        self._refresh_activity()
        return ~ok

    def tenant_health_report(self, t: int) -> List[str]:
        """Host-side diagnosis of ONE tenant: the named violations behind a
        health_scan hit. Mirrors :func:`tenant_health` check for check, so
        the two cannot disagree on a poisoned tenant."""
        if not 0 <= t < self.b:
            raise IndexError(f"tenant index {t} out of range [0, {self.b})")
        s = map_lanes(_np, self.tenant_state(t))
        self._account_d2h(s.alive.nbytes + 4)
        violations: List[str] = []
        alive = int(np.sum(s.alive))
        members = int(s.n_members)
        if members != alive:
            violations.append(f"tenant {t}: n_members={members} != alive population {alive}")
        if not 0 <= members <= self.cfg.n:
            violations.append(f"tenant {t}: n_members={members} outside [0, {self.cfg.n}]")
        if bool(np.any(s.alive & s.retired)):
            violations.append(f"tenant {t}: slot(s) simultaneously alive and retired")
        for lane in ("round_idx", "rounds_undecided", "classic_epoch"):
            value = int(getattr(s, lane))
            if value < 0:
                violations.append(f"tenant {t}: {lane}={value} negative")
        if int(np.min(s.cp_rnd_r)) < 0:
            violations.append(f"tenant {t}: negative promised classic rank")
        if int(s.config_epoch) < 0:
            violations.append(f"tenant {t}: config_epoch={int(s.config_epoch)} negative")
        if self.cfg.compact and int(s.round_idx) > ROUND_ENVELOPE:
            violations.append(
                f"tenant {t}: round_idx={int(s.round_idx)} past the compact "
                f"envelope {ROUND_ENVELOPE} (validate_envelope tripwire)"
            )
        return violations

    def quarantine(self, tenants: Sequence[int]) -> None:
        """Quarantine tenants: capture each one's raw membership (one
        ``[t]`` read, shared) and pin its wave freeze lanes to it, so the
        lockstep wave's ``done`` lane holds the tenant bit-frozen from
        iteration 0 with no effect on the other tenants. :meth:`step` has
        no freeze lane and keeps running a quarantined tenant's rounds,
        harmlessly to the others. Idempotent per tenant; never reversible
        within a fleet's lifetime."""
        members = _np(self.state.n_members)
        self._account_d2h(members.nbytes)
        for t in tenants:
            t = int(t)
            if not 0 <= t < self.b:
                raise IndexError(f"tenant index {t} out of range [0, {self.b})")
            if t not in self._quarantined:
                self._quarantined[t] = int(members[t])
                self.metrics.inc("engine_tenant_quarantines")

    @property
    def quarantined(self) -> Tuple[int, ...]:
        """The quarantined tenant indices, sorted."""
        return tuple(sorted(self._quarantined))

    # -- observers ------------------------------------------------------

    def tenant_state(self, i: int) -> EngineState:
        """Tenant ``i``'s state (views of the stacked lanes)."""
        if not 0 <= i < self.b:
            raise IndexError(f"tenant index {i} out of range [0, {self.b})")
        return map_lanes(lambda x: x[i], self.state)

    def membership_sizes(self) -> np.ndarray:
        out = np.asarray(_host.read(self.state.n_members, "observer"), dtype=np.int32)
        self._account_d2h(out.nbytes)
        return out

    def config_ids(self) -> List[int]:
        """Per-tenant 64-bit configuration ids, one packed read."""
        obs = _u32.to_numpy(torch.stack([self.state.config_hi, self.state.config_lo]))
        self._account_d2h(obs.nbytes)
        return [(int(h) << 32) | int(l) for h, l in zip(*obs)]

    def config_epochs(self) -> np.ndarray:
        out = _np(self.state.config_epoch)
        self._account_d2h(out.nbytes)
        return out

    def health(self) -> NodeHealth:
        """Fleet-wide health in the host vocabulary: PROPOSING while any
        tenant has churn in flight, STABLE otherwise (one reduction over
        every tenant, read once: 4 bytes)."""
        pending = _host.read(
            (self.state.alive & self.faults.crashed).sum(dtype=torch.int32)
            + self.state.join_pending.sum(dtype=torch.int32),
            "health",
        )
        self._account_d2h(4)
        return NodeHealth.PROPOSING if pending else NodeHealth.STABLE

    # -- observability (utils/exposition.py schema) ---------------------

    def telemetry_snapshot(self) -> dict:
        """The fleet's unified telemetry snapshot: the single cluster's
        schema plus the ``tenancy`` block (tenant count, per-dispatch tenant
        throughput, quarantine census), the pooled ``activity`` with its
        per-tenant ``tenant_activity`` (the plane on), ``tenant_trace`` (the
        ring on), ``stream`` and ``recovery`` exactly when the JAX fleet's
        carry them. The plane sections are the host caches of the last
        refresh."""
        counters = self.metrics.counters
        dispatches = counters.get("engine_dispatches", 0)
        tenant_rounds = counters.get("engine_tenant_rounds", 0)
        return {
            "node": f"tenant-fleet/{self.b}x{self.cfg.n}",
            "membership_size": int(self.membership_sizes().sum()),
            "health": self.health().value,
            "metrics": self.metrics.summary(),
            "engine": {
                "n": self.cfg.n,
                "cohorts": self.cfg.c,
                "use_pallas": self.cfg.use_pallas,
                "compile": engine_telemetry.compile_snapshot(),
                "memory": engine_telemetry.device_memory_snapshot(self.device),
                "tenancy": {
                    "tenants": self.b,
                    "tenant_rounds_total": int(tenant_rounds),
                    "tenant_cuts_total": int(counters.get("engine_tenant_cuts", 0)),
                    "tenant_rounds_per_dispatch": round(
                        tenant_rounds / dispatches, 3
                    ) if dispatches else 0.0,
                    "quarantined": len(self._quarantined),
                },
                **(
                    {"activity": self.activity, "tenant_activity": self.tenant_activity}
                    if self._activity is not None
                    else {}
                ),
                **({"tenant_trace": self.tenant_trace} if self._trace is not None else {}),
                **({"stream": self.stream.snapshot()} if self.stream is not None else {}),
                **({"recovery": self.recovery.snapshot()} if self.recovery is not None else {}),
            },
            "transport": {},
            "recorder": None,
        }

    def prometheus_text(self) -> str:
        return exposition.prometheus_text(self.telemetry_snapshot())
