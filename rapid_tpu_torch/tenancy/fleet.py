"""The tenant fleet: B independent virtual clusters stepped together, one
round of the engine for every tenant per call (port of
``rapid_tpu/tenancy/fleet.py`` with its telemetry and trace twins; the
sharded mesh entry points and the serving seams are not ported).

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
  come back in one packed read after it;
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
    apply_view_change_impl,
)
from rapid_tpu_torch.models.virtual_cluster import telemetry_digest as fleet_telemetry_digest
from rapid_tpu_torch.models.virtual_cluster import trace_digest as fleet_trace_digest
from rapid_tpu_torch.utils import engine_telemetry

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
):
    """One protocol round for every tenant, with each decided tenant's view
    change applied. Returns ``(state, events, telem, trace)``: events
    stacked (``[t]`` scalars, ``[t, n]`` winner masks), and every tenant's
    plane lanes advanced (``None`` where none were given), quarantined
    tenants included, as the JAX fleet's batched step does."""
    tcfg = _tenant_cfg(cfg, knobs)
    round_state, decided, winner, events, telem, trace = _compute_round(
        tcfg, state, faults, select=True, telem=telem, trace=trace
    )
    committed = apply_view_change_impl(tcfg, round_state, winner)
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
        if not _host.read(running.any()):
            break
        round_state, now, won, _, round_telem, round_trace = _compute_round(
            tcfg, state, faults, edge_masks, select=True, telem=telem, trace=trace
        )
        state = select_lanes(running, round_state, state)
        telem = select_lanes(running, round_telem, telem)
        trace = select_lanes(running, round_trace, trace)
        steps = steps + running.to(torch.int32)
        decided = torch.where(running, now, decided)
        winner = torch.where(running[:, None], won, winner)
    committed = apply_view_change_impl(tcfg, state, winner)
    return select_lanes(decided, committed, state), steps, decided, winner, telem, trace


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
    cuts."""
    tcfg = _tenant_cfg(cfg, knobs)
    t = state.alive.shape[0]
    dev = state.alive.device
    steps = torch.zeros((t,), dtype=torch.int32, device=dev)
    cuts = torch.zeros((t,), dtype=torch.int32, device=dev)
    sizes = torch.full((t, max_cuts), -1, dtype=torch.int32, device=dev)
    slots = torch.arange(max_cuts, dtype=torch.int32, device=dev)
    # The equal-churn trap guard, as the nested loop's entry condition:
    # already-at-target resolves vacuously only when no cuts are demanded.
    done = (state.n_members == target) & (min_cuts <= 0)
    for _ in range(max_steps):
        active = ~done & (steps < max_steps)
        round_state, decided, winner, _, round_telem, round_trace = _compute_round(
            tcfg, state, faults, select=True, telem=telem, trace=trace
        )
        committed = apply_view_change_impl(tcfg, round_state, winner)
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
        done = done | (commit & resolved) | (cuts >= max_cuts)
    resolved = (state.n_members == target) & (cuts >= min_cuts)
    return state, steps, cuts, resolved, sizes, telem, trace


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
    return x.cpu().numpy()


class TenantFleet:
    """Host driver over the batched engine: owns the stacked state, fault
    masks and per-tenant knobs.

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
        # Each tenant's plane lanes come along: a fleet stacked mid-run
        # keeps its tenants' activity and round history.
        if base.telemetry:
            fleet.telem = stack_lanes([vc.telem for vc in clusters])
        if base.trace:
            fleet.trace_ring = stack_lanes([vc.trace_ring for vc in clusters])
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
        self.state, events, self.telem, self.trace_ring = fleet_step(
            self.cfg, self.state, self.faults, self.knobs, self.telem, self.trace_ring
        )
        return events

    def run_to_decision(self, max_steps: int = 64):
        """Every tenant runs to its own first view change; returns
        ``(rounds[t], decided[t], winner[t, n] on the device, members[t])``
        with one packed read of the observations."""
        self.state, steps, decided, winner, self.telem, self.trace_ring = fleet_run_to_decision(
            self.cfg, self.state, self.faults, self.knobs, max_steps, self.telem, self.trace_ring
        )
        obs = np.asarray(
            _host.read(torch.stack([steps, decided.to(torch.int32), self.state.n_members]))
        )
        return obs[0], obs[1].astype(bool), winner, obs[2]

    def run_until_membership(self, targets, max_steps: int = 192, max_cuts: int = 8, min_cuts=0):
        """The fleet wave: every tenant resolves its own churn, through its
        own number of view changes, to its own target membership, in one
        lockstep loop. ``targets``/``min_cuts`` broadcast from scalars or
        give one value per tenant. Returns ``(rounds[t], cuts[t],
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
        self.state, steps, cuts, resolved, sizes, self.telem, self.trace_ring = fleet_wave(
            self.cfg, self.state, self.faults, self.knobs,
            torch.from_numpy(targets).to(self.device), int(max_steps), int(max_cuts),
            torch.from_numpy(min_cuts).to(self.device), self.telem, self.trace_ring,
        )
        obs = np.asarray(
            _host.read(torch.cat([steps, cuts, resolved.to(torch.int32), sizes.reshape(-1)]))
        )
        b = self.b
        return obs[:b], obs[b : 2 * b], obs[2 * b : 3 * b].astype(bool), obs[3 * b :].reshape(
            b, max_cuts
        )

    def sync(self) -> None:
        """Wait for all queued work on the fleet's device, then refresh the
        plane caches (:attr:`activity`, :attr:`tenant_activity`,
        :attr:`tenant_trace`)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._refresh_activity()

    def _refresh_activity(self) -> None:
        """Fetch the stacked digests, one counted read each (``[t, 18]``,
        and ``[t, 2 + 9R]`` for the rings), and decode every tenant's."""
        if self.telem is not None:
            digests = _host.read(fleet_telemetry_digest(self.telem))
            self._activity = [
                engine_telemetry.activity_summary(d, self.cfg.n, self.cfg.c) for d in digests
            ]
        if self.trace_ring is not None:
            digests = _host.read(fleet_trace_digest(self.trace_ring))
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
        poisoned = ~_np(tenant_health(self.cfg, self.state))
        self._refresh_activity()
        return poisoned

    def tenant_health_report(self, t: int) -> List[str]:
        """Host-side diagnosis of ONE tenant: the named violations behind a
        health_scan hit. Mirrors :func:`tenant_health` check for check, so
        the two cannot disagree on a poisoned tenant."""
        if not 0 <= t < self.b:
            raise IndexError(f"tenant index {t} out of range [0, {self.b})")
        s = map_lanes(_np, self.tenant_state(t))
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
        for t in tenants:
            t = int(t)
            if not 0 <= t < self.b:
                raise IndexError(f"tenant index {t} out of range [0, {self.b})")
            self._quarantined.setdefault(t, int(members[t]))

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
        return _np(self.state.n_members)

    def config_ids(self) -> List[int]:
        """Per-tenant 64-bit configuration ids, one packed read."""
        hi, lo = _u32.to_numpy(torch.stack([self.state.config_hi, self.state.config_lo]))
        return [(int(h) << 32) | int(l) for h, l in zip(hi, lo)]

    def config_epochs(self) -> np.ndarray:
        return _np(self.state.config_epoch)
