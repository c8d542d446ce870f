"""A whole Rapid-style cluster of N virtual endpoints as one device program
per round (port of ``rapid_tpu/models/virtual_cluster.py``, single cluster,
in the wide or the compact layout, with the device telemetry plane and the
round-trace ring).

One round, for every virtual node at once: probe tick -> edge alerts ->
cohort delivery -> watermark cut detection -> fast-round votes -> quorum
tally -> classic fallback when due. A decided round is followed by the view
change.

The round body works on lanes with a leading tenant axis ``[t, ...]``: a
single cluster runs it at ``t = 1`` (its state gains the axis on the way in
and loses it on the way out), a fleet (:mod:`rapid_tpu_torch.tenancy`) at
its tenant count, with the per-tenant knobs (``h``, ``l``,
``fd_threshold``, ``fallback_rounds``) as ``[t]`` tensors in the config.

The JAX engine keeps its loops and ``lax.cond`` gates on the device. Here
the loops are Python loops, and each gate becomes one of two things:

- a device-side select where both branches are cheap and the result is the
  same: alert delivery is always computed (by the CUDA kernel on a card) and
  zeroed when ``need_delivery`` is false;
- for the single cluster, a host branch on one counted read
  (:func:`rapid_tpu_torch._host.read`) where the branch is expensive and
  rare: implicit invalidation, the classic attempt and the view change. A
  fleet computes them for every tenant instead (``select=True``) and keeps
  each tenant's result where its gate is set, as ``jax.vmap`` turns the
  conds into selects, so its round makes no read.

A single-cluster round therefore makes two reads in the common case: the
invalidation gate and the packed (fast decision, fallback due) pair. A
round whose fallback is due makes a third. That is the batch round
(:meth:`VirtualCluster.step`). The streaming pipeline's round
(:meth:`VirtualCluster.stream_step`, :func:`engine_stream_step`) is the
fleet's body at ``t = 1``: every gate a select, the view change
select-applied, no read at all, so a wave of rounds queues on the card
without waiting for it.

With ``telemetry=True`` (and ``trace=R``) the drivers carry
:class:`~rapid_tpu_torch.models.state.TelemetryLanes` (and
:class:`~rapid_tpu_torch.models.state.TraceRing`) through every round. The
round writes them and never branches on them, so results are the same with
the planes on or off, and no read is added: the lanes reach the host only
through :meth:`VirtualCluster.sync`.

Under ``compact=1`` every lane is stored at its policy dtype
(``models/state.compaction_policy``) and the round stores every result at
the dtype of the lane it replaces, as the JAX package does: torch promotes
silently (``torch.where(m, int16_lane, int32_tensor)`` is int32), so every
store of an int32 value into a narrow lane casts explicitly, and the
bitmask lanes go through :mod:`rapid_tpu_torch._narrow`. The delivery
kernel still emits uint32 words; they are narrowed into the report lane.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rapid_tpu_torch import _host, _narrow, _u32
from rapid_tpu_torch.models.state import (
    TELEMETRY_BUCKETS,
    EngineConfig,
    EngineState,
    FaultInputs,
    StepEvents,
    TelemetryLanes,
    TraceRing,
    compaction_policy,
    initial_state,
    initial_telemetry,
    initial_trace,
    lane_storage,
    map_lanes,
    resolve_device,
    select_lanes,
    validate_config,
)
from rapid_tpu_torch.ops.consensus import tally_candidates, undecided_log2_bucket
from rapid_tpu_torch.ops.cut_detection import cohort_watermark_pass, telemetry_cut_masks
from rapid_tpu_torch.ops.hashing import masked_set_hash
from rapid_tpu_torch.ops.kernels import delivery_new_bits, per_batch, popcount32
from rapid_tpu_torch.ops.rings import (
    endpoint_ring_keys,
    predecessor_of_keys,
    ring_topology_from_perm,
)
from rapid_tpu_torch.utils import engine_telemetry, exposition, profiling
from rapid_tpu_torch.utils.dispatch import DispatchSeam
from rapid_tpu_torch.utils.health import NodeHealth
from rapid_tpu_torch.utils.metrics import Metrics

# The mesh axes a sharded round communicates over (``parallel/mesh.py``).
_NODES, _COHORT = ("nodes",), ("cohort",)

# The spans of a round and its phases, as :func:`_compute_round` numbers
# them, and of a view change (``profiling.span``).
profiling.register(
    "round", "edge_masks", "fd_tick", "delivery", "cut_detection", "votes", "tally",
    "classic", "commit", "planes", "view_change",
)


def cohort_words(c: int) -> int:
    """uint32 words needed to carry one bit per receiver cohort."""
    return (c + 31) // 32


def _one(tree):
    """One cluster's lanes as a fleet of one (a leading axis of 1); ``None``
    stays ``None``."""
    return map_lanes(lambda x: x.unsqueeze(0), tree)


def _only(tree):
    """The lanes of a fleet of one, without the tenant axis."""
    return map_lanes(lambda x: x.squeeze(0), tree)


def _take(lane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``lane[i, idx[i]]`` for every tenant i: the single cluster's
    ``lane[idx]`` over the last axis of ``[t, m]`` lanes with ``[t, ...]``
    indices, clamped into range (JAX clamps; torch would raise, or assert
    on a card)."""
    at = idx.clamp(0, lane.shape[-1] - 1).to(torch.int64)
    return torch.gather(lane, 1, at.reshape(at.shape[0], -1)).view(at.shape)


def _local(cfg: EngineConfig, ctx):
    """``(n, c, slot_offset, cohort_offset)`` of the lanes the round body
    holds: the whole cluster's without a collective context, this rank's
    shard with one (:mod:`rapid_tpu_torch.parallel.collectives`)."""
    if ctx is None:
        return cfg.n, cfg.c, 0, 0
    return ctx.n_local, ctx.c_local, ctx.slot_offset, ctx.cohort_offset


def _gate(ctx):
    """The context of a gated branch (the JAX engine's ``lax.cond``):
    collectives issued in it are logged at a gated site."""
    return contextlib.nullcontext() if ctx is None else ctx.gate()


def _loop(ctx):
    """The context of one iteration of a driver's round loop."""
    return contextlib.nullcontext() if ctx is None else ctx.loop()


@profiling.spanned("edge_masks")
def _edge_masks(cfg: EngineConfig, state: EngineState, faults: FaultInputs, ctx=None):
    """Per-edge observer masks: ``(observer_active[t, n, k],
    blocked_rows[t, w*k, n])``. ``blocked_rows`` packs "cohort c cannot
    hear the observer of edge (subject, ring)" over cohorts: row ``wi*k +
    ring``, bit j = cohort ``32*wi + j``. Fixed between view changes, so
    loops compute it once per configuration.

    Sharded (``ctx``): observers are global slots on any shard, so the
    packed words of this rank's cohorts and the active lane are gathered
    over ``'nodes'`` once (the prologue gather the JAX package's XLA hoists
    out of the loop); the rows pack this rank's cohorts."""
    n, k = cfg.n, cfg.k
    n_l, c_l, _, _ = _local(cfg, ctx)
    t = state.alive.shape[0]
    w = cohort_words(c_l)
    dev = state.alive.device
    obs = state.obs_idx  # [t, k, n]: observer of (ring, subject)
    at = obs.clamp(0, n - 1).to(torch.int64)
    active = state.alive & ~faults.crashed

    shifts = torch.arange(c_l, dtype=torch.int64, device=dev) % 32
    cohort_bits = faults.rx_block.to(torch.int64) << shifts[:, None]  # [t, c, n]
    words = _u32.narrow(
        torch.stack([cohort_bits[:, 32 * wi : 32 * (wi + 1)].sum(1) for wi in range(w)], 1)
    )  # [t, w, n]
    if ctx is not None:
        # Priced as the unsharded rows (the whole cluster's words and the
        # active lane), so the payload class does not depend on the mesh.
        rows = ctx.gather(
            torch.cat([words, active[:, None].to(torch.int32)], 1), _NODES[0], "edge masks",
            logical_bytes=4 * (cohort_words(cfg.c) + 1) * n * t,
        )
        words, active = rows[:, :w], rows[:, w] != 0
    observed = (obs >= 0) & torch.gather(active, 1, at.view(t, k * n_l)).view(t, k, n_l)
    observer_active = observed.transpose(1, 2).contiguous()  # [t, n, k]
    blocked_rows = torch.gather(words, 2, at.view(t, 1, k * n_l).expand(t, w, k * n_l))
    return observer_active, blocked_rows.view(t, w * k, n_l)


def _fd_tick(cfg: EngineConfig, state: EngineState, faults: FaultInputs, observer_active):
    """Every observer probes its subjects; edges past the failure threshold
    fire one DOWN alert. Counter mode (``fd_window == 0``) or the windowed
    policy (a bit-history per edge, at the history lane's own width)."""
    alive = state.alive[:, :, None]
    subject_down = faults.crashed[:, :, None] | faults.probe_fail
    probe_failed = observer_active & subject_down & alive
    threshold = per_batch(cfg.fd_threshold, state.fd_count)
    if cfg.fd_window:
        probed = observer_active & alive
        fd_count = torch.where(probed, state.fd_count + 1, state.fd_count)
        window_mask = (1 << cfg.fd_window) - 1
        shifted = ((_narrow.unsigned(state.fd_hist) << 1) | probe_failed) & window_mask
        fd_hist = torch.where(probed, _narrow.keep_bits(shifted, state.fd_hist.dtype), state.fd_hist)
        past_threshold = (popcount32(fd_hist) >= threshold) & (fd_count >= cfg.fd_window)
    else:
        fd_count = torch.where(probe_failed, state.fd_count + 1, state.fd_count)
        fd_hist = state.fd_hist
        past_threshold = fd_count >= threshold
    fire = past_threshold & ~state.fd_fired & alive
    return fd_count, fd_hist, state.fd_fired | fire, fire


def _deliver_alerts(cfg: EngineConfig, state: EngineState, fire_round, blocked_rows, ctx=None):
    """Per-cohort delivered alert bitmasks ``[t, c, n]`` at the report
    lane's dtype: one launch of the delivery kernel for every tenant on a
    card, its plain version on the CPU. Ages are int32 whatever the fire
    round's dtype (an unfired edge's sentinel age stays negative), and the
    kernel's uint32 words are narrowed on store. Sharded, the launch covers
    this rank's shard, its draws salted by global slot and cohort. A block
    of the launch covers ``cfg.pallas_lanes`` slots (the Pallas lane
    tile); every width gives the same words."""
    _, c_l, slot_offset, cohort_offset = _local(cfg, ctx)
    offsets = () if ctx is None else (slot_offset, cohort_offset)
    age_kn = (state.round_idx[:, None, None] - fire_round.transpose(1, 2).to(torch.int32)).contiguous()
    words = delivery_new_bits(
        blocked_rows, age_kn, state.config_epoch, cfg.k, c_l,
        cfg.delivery_spread, cfg.delivery_prob_permille, *offsets, lanes=cfg.pallas_lanes,
    )
    return _narrow.keep_bits(words, state.report_bits.dtype)


def _cohort_cut_detection(cfg: EngineConfig, state: EngineState, new_bits, heard_down,
                          select: bool = False, ctx=None):
    """The engine's cut-detection seam (the JAX package's
    ``_cohort_cut_detection``): C independent watermark detectors over the
    ``[t, c, n]`` lanes, through
    :func:`~rapid_tpu_torch.ops.cut_detection.cohort_watermark_pass`; this
    wrapper only adapts the state. ``select`` and ``ctx`` are the pass's:
    ``select=True`` computes the implicit-invalidation pass with no host
    read, ``ctx`` runs it on a rank's shard."""
    return cohort_watermark_pass(
        state.report_bits, new_bits, state.seen_down, state.released, state.announced,
        state.alive | state.join_pending, state.inval_obs, heard_down, cfg.h, cfg.l, cfg.k,
        select=select, ctx=ctx,
    )


def _rotation_seed_w(epoch_w: torch.Tensor, j: int) -> torch.Tensor:
    """Per-racer hash-stream seed for coordinator rotation (widened)."""
    return _u32.add(_u32.mul(epoch_w, 0x9E3779B1), (0x5BD1E995 * (j + 1)) & _u32.MASK)


def _classic_attempt(cfg: EngineConfig, state: EngineState, faults: FaultInputs, announced, cp,
                     ctx=None):
    """One classic-Paxos attempt per tenant with
    ``cfg.concurrent_coordinators`` rank-ordered racers
    (Paxos.java:93-238). Returns the acceptor lanes, the ``[t]`` decided
    flags and the winning cohorts (``[t]`` int32, -1 if none). Every value
    stays defined for a tenant whose attempt is not due (no active member,
    nothing announced), so a fleet can compute it for all and select.
    ``announced`` is the whole ``[t, c]`` lane.

    Sharded (``ctx``): the active ranks continue across the node shards
    (one gather of the shards' counts), each coordinator is the first hit
    of its rank on any shard (a min over global slots), and its column and
    cohort row of the receive blocks come from the shards that hold them;
    every count and maximum over the acceptors is reduced over
    ``'nodes'``."""
    cp_rnd_r, cp_rnd_i, cp_vrnd_r, cp_vrnd_i, cp_vval_src = cp
    t, n_l = state.alive.shape
    n, c = cfg.n, cfg.c
    _, c_l, slot_offset, cohort_offset = _local(cfg, ctx)
    dev = state.alive.device
    active = state.alive & ~faults.crashed
    n_active = active.sum(-1, dtype=torch.int32)
    majority = state.n_members // 2 + 1
    round_num = (2 + state.classic_epoch)[:, None]
    cohort_ids = torch.arange(c, dtype=torch.int32, device=dev)
    active_rank = torch.cumsum(active, -1, dtype=torch.int32)
    if ctx is not None:
        counts = ctx.gather(n_active[:, None], _NODES[0], "classic active counts")  # [t, dn]
        n_active = counts.sum(-1, dtype=torch.int32)
        before = counts[:, : ctx.index.get(_NODES[0], 0)].sum(-1, dtype=torch.int32)
        active_rank = active_rank + before[:, None]

    def rank_gt(ar, ai, br, bi):
        return (ar > br) | ((ar == br) & (ai > bi))

    hits = []
    epoch_w = _u32.widen(state.classic_epoch.to(torch.int32))
    for j in range(cfg.concurrent_coordinators):
        pick = _u32.mix32_w(_rotation_seed_w(epoch_w, j))
        target = torch.where(n_active > 0, pick % n_active.clamp(min=1).to(torch.int64) + 1, 1)
        hits.append(active & (active_rank == target[:, None]))
    coords = [torch.argmax(hit.to(torch.int32), -1) for hit in hits]
    if ctx is not None:
        # The lowest global slot holding the rank (argmax's first hit; slot
        # 0, as argmax gives, where no shard holds it).
        offers = torch.stack([
            torch.where(hit.any(-1), coord + slot_offset, n) for hit, coord in zip(hits, coords)
        ])
        first = ctx.min(offers, _NODES, "classic coordinators")
        coords = list(torch.where(first >= n, 0, first))

    valid = []
    for j, coord in enumerate(coords):
        v = torch.ones((t,), dtype=torch.bool, device=dev)
        for prev in coords[:j]:
            v = v & (coord != prev)
        valid.append(v[:, None])

    per = []
    for coord, v in zip(coords, valid):
        if ctx is None:
            coord_cohort = _take(state.cohort_of, coord)  # [t]
            # rx_block[cohort_of[i], coord] and rx_block[coord_cohort, i], per tenant.
            coord_col = coord[:, None, None].expand(t, c, 1)
            rx_from_coord = torch.gather(faults.rx_block, 2, coord_col)[:, :, 0]  # [t, c]
            coord_row = coord_cohort.clamp(0, c - 1).to(torch.int64)[:, None, None].expand(t, 1, n)
            coord_blocked = torch.gather(faults.rx_block, 1, coord_row)[:, 0]
        else:
            # The coordinator's cohort and receive column from its node
            # shard, its cohort's receive row from that cohort's shard.
            local = coord - slot_offset
            mine = (local >= 0) & (local < n_l)
            at = local.clamp(0, n_l - 1)
            col = torch.gather(faults.rx_block, 2, at[:, None, None].expand(t, c_l, 1))[:, :, 0]
            column = torch.cat([
                torch.where(mine, _take(state.cohort_of, at).to(torch.int32), -1)[:, None],
                (col & mine[:, None]).to(torch.int32),
            ], 1)
            column = ctx.max(column, _NODES, "classic coordinator column", sharded=_COHORT)
            coord_cohort = column[:, 0]
            rx_from_coord = ctx.assemble_cohorts(column[:, 1:] != 0, "classic coordinator column")
            row_at = coord_cohort.clamp(0, c - 1).to(torch.int64) - cohort_offset
            holds = (row_at >= 0) & (row_at < c_l)
            row_at = row_at.clamp(0, c_l - 1)[:, None, None].expand(t, 1, n_l)
            coord_blocked = torch.gather(faults.rx_block, 1, row_at)[:, 0] & holds[:, None]
            coord_blocked = ctx.max(coord_blocked, _COHORT, "classic coordinator row",
                                    sharded=_NODES)
        hears_coord = active & v & ~_take(rx_from_coord, state.cohort_of)
        coord_hears = active & v & ~coord_blocked
        coord_i = coord[:, None]
        promise = hears_coord & rank_gt(round_num, coord_i, cp_rnd_r, cp_rnd_i)
        q1 = promise & coord_hears
        voters = q1 & (cp_vval_src >= 0)
        mv_r = torch.where(voters, cp_vrnd_r, -1).amax(-1)
        if ctx is not None:
            mv_r = ctx.max(mv_r, _NODES, "classic highest vote round")
        mv_r = mv_r[:, None]
        mv_i = torch.where(voters & (cp_vrnd_r == mv_r), cp_vrnd_i, -1).amax(-1)
        if ctx is not None:
            mv_i = ctx.max(mv_i, _NODES, "classic highest vote rank")
        mv_i = mv_i[:, None]
        at_max = voters & (cp_vrnd_r == mv_r) & (cp_vrnd_i == mv_i)
        max_counts = (at_max[:, None, :] & (cp_vval_src[:, None, :] == cohort_ids[:, None])).sum(
            -1, dtype=torch.int32
        )  # [t, c]
        q1_count = q1.sum(-1, dtype=torch.int32)
        if ctx is not None:
            both = ctx.sum(torch.cat([max_counts, q1_count[:, None]], 1), _NODES,
                           "classic phase-1 counts")
            max_counts, q1_count = both[:, :-1], both[:, -1]
        phase1_ok = q1_count >= majority
        chosen = torch.where(
            (max_counts > 0).any(-1),
            torch.argmax(max_counts, -1),
            torch.where(announced.any(-1), torch.argmax(announced.to(torch.int32), -1), -1),
        ).to(torch.int32)
        per.append((coord_i, hears_coord, promise, phase1_ok, chosen))

    # An acceptor's rnd after every phase1a is the max rank it heard.
    rnd1_r, rnd1_i = cp_rnd_r, cp_rnd_i
    for coord_i, _, promise, _, _ in per:
        bump = promise & rank_gt(round_num, coord_i, rnd1_r, rnd1_i)
        rnd1_r = torch.where(bump, round_num, rnd1_r)
        rnd1_i = torch.where(bump, coord_i.to(rnd1_i.dtype), rnd1_i)

    acc_r, acc_i, acc_src = cp_vrnd_r, cp_vrnd_i, cp_vval_src
    fb_decided = torch.zeros((t,), dtype=torch.bool, device=dev)
    chosen_winner = torch.full((t,), -1, dtype=torch.int32, device=dev)
    any_touch = torch.zeros((t, n_l), dtype=torch.bool, device=dev)
    for coord_i, hears_coord, promise, phase1_ok, chosen in per:
        proposing = phase1_ok & (chosen >= 0)
        can_accept = (
            proposing[:, None] & hears_coord & (rnd1_r == round_num) & (rnd1_i == coord_i)
        )
        accept_count = can_accept.sum(-1, dtype=torch.int32)
        if ctx is not None:
            accept_count = ctx.sum(accept_count, _NODES, "classic accept count")
        won = proposing & (accept_count >= majority)
        fb_decided = fb_decided | won
        chosen_winner = torch.where(won, chosen, chosen_winner)
        acc_r = torch.where(can_accept, round_num, acc_r)
        acc_i = torch.where(can_accept, coord_i.to(acc_i.dtype), acc_i)
        acc_src = torch.where(can_accept, chosen[:, None].to(acc_src.dtype), acc_src)
        any_touch = any_touch | promise | can_accept

    return (
        torch.where(any_touch, rnd1_r, cp_rnd_r),
        torch.where(any_touch, rnd1_i, cp_rnd_i),
        acc_r,
        acc_i,
        acc_src,
        fb_decided,
        chosen_winner,
    )


@profiling.spanned("round")
def _compute_round(
    cfg: EngineConfig,
    state: EngineState,
    faults: FaultInputs,
    edge_masks=None,
    select: bool = False,
    telem: Optional[TelemetryLanes] = None,
    trace: Optional[TraceRing] = None,
    ctx=None,
):
    """One protocol round for every tenant of ``[t, ...]`` lanes, WITHOUT
    the view change: returns ``(state, decided, winner_mask, events, telem,
    trace)``: the round-advanced state, whether it decided, the decided
    cuts ``[t, n]``, the round's events (``[t]`` scalars) and the plane
    lanes advanced by this round (``None`` where none were given, and then
    the round launches nothing for them).

    ``select=False`` (the single cluster, ``t = 1``): the invalidation and
    classic-attempt gates are host branches on counted reads, and
    ``decided`` is a host bool. ``select=True`` (a fleet): both are
    computed for every tenant (the attempt kept where it is due), no read
    is made, and ``decided`` is the ``[t]`` bool tensor. The planes add no
    read either way.

    ``ctx`` (a :class:`~rapid_tpu_torch.parallel.collectives.CollectiveContext`)
    runs the round on this rank's shard of a mesh: every reduction over a
    sharded axis becomes an all-reduce on that axis's group, the ``[c]``
    proposal lanes are assembled whole for the votes, and every host branch
    reads a value all ranks hold, so all ranks take it together. The
    results are the unsharded round's, bit for bit, shard by shard."""
    c = cfg.c
    _, c_l, _, cohort_offset = _local(cfg, ctx)
    t = state.alive.shape[0]
    dev = state.alive.device
    if ctx is not None:
        ctx.begin_round()
    if edge_masks is None:
        edge_masks = _edge_masks(cfg, state, faults, ctx)
    observer_active, blocked_rows = edge_masks

    # 1. Failure-detector tick.
    with profiling.span("fd_tick"):
        fd_count, fd_hist, fd_fired, fire = _fd_tick(cfg, state, faults, observer_active)
        fire_round = torch.where(
            fire, state.round_idx[:, None, None].to(state.fire_round.dtype), state.fire_round
        )
        alerts_emitted = fire.flatten(1).sum(-1, dtype=torch.int32)

    # 2. Delivery, zeroed once every fired alert has matured (the JAX
    #    version skips the work with lax.cond; the select gives the same
    #    bits, since matured alerts are already merged into report_bits).
    with profiling.span("delivery"):
        last_fired = torch.where(fd_fired, fire_round, -1).flatten(1).amax(-1).to(torch.int32)
        any_fired = fd_fired.flatten(1).any(-1)
        if ctx is not None:
            alerts_emitted = ctx.sum(alerts_emitted, _NODES, "alerts emitted")
            gate = ctx.max(torch.stack([last_fired, any_fired.to(torch.int32)]), _NODES,
                           "delivery gate")
            last_fired, any_fired = gate[0], gate[1] != 0
        need_delivery = any_fired & (state.round_idx <= last_fired + cfg.delivery_spread)
        delivered = _deliver_alerts(cfg, state, fire_round, blocked_rows, ctx)
        new_bits = torch.where(need_delivery[:, None, None], delivered, 0)
        heard_down = ((new_bits != 0) & state.alive[:, None, :]).any(-1)
        if ctx is not None:
            heard_down = ctx.max(heard_down, _NODES, "heard down", sharded=_COHORT)

    # 3. Cut detection per cohort.
    with profiling.span("cut_detection"):
        report_bits, released, announced, seen_down, proposed_now, prop_masks = (
            _cohort_cut_detection(cfg, state, new_bits, heard_down, select=select, ctx=ctx)
        )
        prop_hi_new, prop_lo_new = masked_set_hash(
            state.id_hi[:, None, :], state.id_lo[:, None, :], prop_masks, ctx, _COHORT
        )
        prop_hi = torch.where(proposed_now, prop_hi_new, state.prop_hi)
        prop_lo = torch.where(proposed_now, prop_lo_new, state.prop_lo)
        prop_mask = torch.where(proposed_now[:, :, None], prop_masks, state.prop_mask)

    # 4. Fast-round votes, once per member per configuration. Every member
    #    reads its cohort's proposal, so a sharded round assembles the whole
    #    [c] lanes first.
    with profiling.span("votes"):
        all_announced, all_prop_hi, all_prop_lo = announced, prop_hi, prop_lo
        if ctx is not None:
            lanes = ctx.assemble_cohorts(
                torch.stack([announced.to(torch.int32), prop_hi, prop_lo]), "proposal lanes"
            )
            all_announced, all_prop_hi, all_prop_lo = lanes[0] != 0, lanes[1], lanes[2]
        cohort = state.cohort_of.clamp(0, c - 1).to(torch.int64)  # JAX clamps its gathers
        can_vote = state.alive & ~faults.crashed & ~state.vote_valid & all_announced.gather(1, cohort)
        vote_hi = torch.where(can_vote, all_prop_hi.gather(1, cohort), state.vote_hi)
        vote_lo = torch.where(can_vote, all_prop_lo.gather(1, cohort), state.vote_lo)
        vote_valid = state.vote_valid | can_vote

    # 5. Quorum tally.
    with profiling.span("tally"):
        tally = tally_candidates(
            vote_hi, vote_lo, vote_valid, all_prop_hi, all_prop_lo, all_announced, state.n_members,
            ctx=ctx,
        )
        fast_decided = tally.decided

        # 5a. A fast-round vote primes the classic acceptor state at rank (1, 1).
        prime = can_vote & (state.cp_rnd_r < 1)
        cp = (
            torch.where(prime, 1, state.cp_rnd_r),
            torch.where(prime, 1, state.cp_rnd_i),
            torch.where(prime, 1, state.cp_vrnd_r),
            torch.where(prime, 1, state.cp_vrnd_i),
            torch.where(prime, state.cohort_of, state.cp_vval_src),
        )
        stalled = all_announced.any(-1) & ~fast_decided
        rounds_undecided = torch.where(stalled, state.rounds_undecided + 1, state.rounds_undecided)
        fallback_due = (rounds_undecided >= cfg.fallback_rounds) & stalled

    # 5b. Classic fallback: a host branch for the single cluster (it is rare
    #     and costs a few [c, n] passes), a per-tenant select in a fleet.
    with profiling.span("classic"):
        if select:
            with _gate(ctx):
                *attempt, fb_decided, chosen = _classic_attempt(
                    cfg, state, faults, all_announced, cp, ctx
                )
            cp = tuple(torch.where(fallback_due[:, None], a, b) for a, b in zip(attempt, cp))
            fb_decided = fallback_due & fb_decided
            chosen = torch.where(fallback_due, chosen, -1)
        else:
            # The eager round's branch point (JAX's lax.cond predicate), read once a round.
            fast_host, fallback_host = _host.read(torch.stack([fast_decided, fallback_due]).view(-1), "branch_point")  # host-sync-ok: branch point
            if fallback_host:
                with _gate(ctx):
                    *cp, fb_decided, chosen = _classic_attempt(
                        cfg, state, faults, all_announced, cp, ctx
                    )
            else:
                fb_decided = torch.zeros((t,), dtype=torch.bool, device=dev)
                chosen = torch.full((t,), -1, dtype=torch.int32, device=dev)
        classic_epoch = torch.where(fallback_due, state.classic_epoch + 1, state.classic_epoch)
        cp_rnd_r, cp_rnd_i, cp_vrnd_r, cp_vrnd_i, cp_vval_src = cp

    # 6. The decision, the winning cut and the round's new state.
    with profiling.span("commit"):
        decided = fast_decided | fb_decided
        if select:
            decided_out = decided
        else:
            decided_out = fast_host or (fallback_host and _host.read(fb_decided.view(-1), "classic_outcome")[0])  # host-sync-ok: the classic attempt's outcome, read only in a round that ran it
        winner_cohort = torch.where(
            fast_decided,
            torch.argmax(
                (
                    all_announced
                    & (all_prop_hi == tally.winner_hi[:, None])
                    & (all_prop_lo == tally.winner_lo[:, None])
                ).to(torch.int32),
                -1,
            ),
            chosen.clamp(min=0),
        )
        cohort_ids = torch.arange(c_l, dtype=torch.int64, device=dev) + cohort_offset
        in_winner = (prop_mask & (cohort_ids == winner_cohort[:, None])[:, :, None]).any(1)
        if ctx is not None and (select or decided_out):
            # The winning cohort's row lies on one cohort shard (an undecided
            # single cluster's mask is all false whatever the rows hold).
            with _gate(ctx):
                in_winner = ctx.max(in_winner, _COHORT, "winner mask", sharded=_NODES)
        winner_mask = decided[:, None] & in_winner

        round_state = state._replace(
            fd_count=fd_count,
            fd_hist=fd_hist,
            fd_fired=fd_fired,
            fire_round=fire_round,
            round_idx=state.round_idx + 1,
            report_bits=report_bits,
            seen_down=seen_down,
            released=released,
            announced=announced,
            prop_mask=prop_mask,
            prop_hi=prop_hi,
            prop_lo=prop_lo,
            vote_hi=vote_hi,
            vote_lo=vote_lo,
            vote_valid=vote_valid,
            rounds_undecided=rounds_undecided,
            cp_rnd_r=cp_rnd_r,
            cp_rnd_i=cp_rnd_i,
            cp_vrnd_r=cp_vrnd_r,
            cp_vrnd_i=cp_vrnd_i,
            cp_vval_src=cp_vval_src,
            classic_epoch=classic_epoch,
        )
        events = StepEvents(
            decided=decided,
            fast_decided=fast_decided,
            winner_mask=winner_mask,
            proposals_announced=proposed_now,
            alerts_emitted=alerts_emitted,
            total_votes=tally.total_votes,
            max_votes=tally.max_count,
            prop_hi=prop_hi,
            prop_lo=prop_lo,
        )
    if telem is None:
        return round_state, decided_out, winner_mask, events, None, None

    with profiling.span("planes"):
        # Device telemetry plane: written here, never read by the round. The
        # scalars reuse what the round computed (``stalled`` is the conflict
        # flag: announced and no fast decision).
        active, invalidated = telemetry_cut_masks(
            state.report_bits, new_bits, report_bits, state.alive | state.join_pending, cfg.h, cfg.l
        )
        tally_at_decision = torch.where(decided, tally.max_count, 0)
        bins = torch.arange(TELEMETRY_BUCKETS, dtype=torch.int32, device=dev)
        bucket = undecided_log2_bucket(rounds_undecided, TELEMETRY_BUCKETS)
        telem = TelemetryLanes(
            tl_rounds=telem.tl_rounds + 1,
            tl_alerts=telem.tl_alerts + alerts_emitted,
            tl_active=telem.tl_active + active,
            tl_invalidated=telem.tl_invalidated + invalidated,
            tl_proposals=telem.tl_proposals + proposed_now,
            tl_tally_sum=telem.tl_tally_sum + tally_at_decision,
            tl_fast_decisions=telem.tl_fast_decisions + fast_decided,
            tl_classic_decisions=telem.tl_classic_decisions + fb_decided,
            tl_conflict_rounds=telem.tl_conflict_rounds + stalled,
            tl_undecided_hist=telem.tl_undecided_hist
            + ((bins == bucket[:, None]) & decided[:, None]),
        )
        if trace is None:
            return round_state, decided_out, winner_mask, events, telem, None

        # Round-trace ring: one record into slot cursor % R, as a one-hot select
        # (no host index). The round and epoch stamps are the values the round
        # started with; the undecided count is the updated one, as in JAX.
        slot = trace.tr_cursor % cfg.trace
        at = (torch.arange(cfg.trace, dtype=torch.int32, device=dev) == slot[:, None])

        def put(lane, value):
            return torch.where(at, value[:, None], lane)

        active_count = active.flatten(1).sum(-1, dtype=torch.int32)
        proposals = proposed_now.sum(-1, dtype=torch.int32)
        if ctx is not None:
            counts = ctx.sum(torch.stack([ctx.sum(active_count, _NODES, "trace active"), proposals]),
                             _COHORT, "trace counts")
            active_count, proposals = counts[0], counts[1]
        trace = TraceRing(
            tr_round=put(trace.tr_round, state.round_idx),
            tr_epoch=put(trace.tr_epoch, state.config_epoch),
            tr_active=put(trace.tr_active, active_count),
            tr_alerts=put(trace.tr_alerts, alerts_emitted),
            tr_proposals=put(trace.tr_proposals, proposals),
            tr_tally=put(trace.tr_tally, tally_at_decision),
            tr_path=put(trace.tr_path, fb_decided.to(torch.int32) * 2 + fast_decided),
            tr_conflict=put(trace.tr_conflict, stalled.to(torch.int32)),
            tr_undecided=put(trace.tr_undecided, rounds_undecided.to(torch.int32)),
            tr_cursor=trace.tr_cursor + 1,
            tr_wraps=trace.tr_wraps + (slot == cfg.trace - 1),
        )
        return round_state, decided_out, winner_mask, events, telem, trace


def apply_view_change_impl(cfg: EngineConfig, state: EngineState, winner_mask,
                           ctx=None) -> EngineState:
    """Commit each tenant's decided cut (``winner_mask [t, n]``): flip
    membership, re-derive ring topology, reset the per-configuration
    state, every lane at ``cfg``'s policy dtype. Joiners not in the cut
    stay pending with their fired UP edges re-stamped to round 0. Sharded
    (``ctx``), the rings are re-derived across the node shards
    (:func:`~rapid_tpu_torch.ops.rings.ring_topology_from_perm`) and the
    membership hash and count are reduced over ``'nodes'``."""
    n, c = _local(cfg, ctx)[:2]  # this rank's slots and cohorts
    k = cfg.k
    t = state.alive.shape[0]
    dev = state.alive.device
    st = lane_storage(cfg)
    alive2 = state.alive ^ winner_mask
    topo = ring_topology_from_perm(state.ring_perm, alive2, ctx)
    config_hi, config_lo = masked_set_hash(state.id_hi, state.id_lo, alive2, ctx)
    n_members = alive2.sum(-1, dtype=torch.int32)
    if ctx is not None:
        n_members = ctx.sum(n_members, _NODES, "view-change membership count")
    still_pending = state.join_pending & ~winner_mask
    fd_fired2 = state.fd_fired & still_pending[:, :, None]

    def zeros(field, shape):
        return torch.zeros((t,) + shape, dtype=st[field], device=dev)

    obs_idx = topo.obs_idx.to(st["obs_idx"])
    return state._replace(
        alive=alive2,
        retired=state.retired | (winner_mask & state.alive),
        obs_idx=torch.where(still_pending[:, None, :], state.obs_idx, obs_idx),
        subj_idx=topo.subj_idx.to(st["subj_idx"]),
        inval_obs=torch.where(still_pending[:, None, :], state.inval_obs, obs_idx),
        config_epoch=state.config_epoch + 1,
        config_hi=config_hi,
        config_lo=config_lo,
        n_members=n_members,
        fd_count=zeros("fd_count", (n, k)),
        fd_hist=zeros("fd_hist", (n, k)),
        fd_fired=fd_fired2,
        fire_round=torch.where(fd_fired2, 0, compaction_policy(cfg).fire_never).to(st["fire_round"]),
        join_pending=still_pending,
        report_bits=zeros("report_bits", (c, n)),
        seen_down=zeros("seen_down", (c,)),
        released=zeros("released", (c, n)),
        announced=zeros("announced", (c,)),
        prop_mask=zeros("prop_mask", (c, n)),
        prop_hi=zeros("prop_hi", (c,)),
        prop_lo=zeros("prop_lo", (c,)),
        vote_hi=zeros("vote_hi", (n,)),
        vote_lo=zeros("vote_lo", (n,)),
        vote_valid=zeros("vote_valid", (n,)),
        rounds_undecided=zeros("rounds_undecided", ()),
        cp_rnd_r=zeros("cp_rnd_r", (n,)),
        cp_rnd_i=zeros("cp_rnd_i", (n,)),
        cp_vrnd_r=zeros("cp_vrnd_r", (n,)),
        cp_vrnd_i=zeros("cp_vrnd_i", (n,)),
        cp_vval_src=torch.full((t, n), -1, dtype=st["cp_vval_src"], device=dev),
        classic_epoch=zeros("classic_epoch", ()),
        round_idx=zeros("round_idx", ()),
    )


def engine_step(
    cfg: EngineConfig,
    state: EngineState,
    faults: FaultInputs,
    telem: Optional[TelemetryLanes] = None,
    trace: Optional[TraceRing] = None,
    ctx=None,
):
    """One cluster's full round including the view change when it decided.
    Returns (state, events, decided, telem, trace); the plane lanes are
    ``None`` where none were given. Covers the JAX package's
    ``engine_step``, ``engine_step_telem`` and ``engine_step_trace``, and
    with ``ctx`` their sharded twins (``parallel/mesh.py``)."""
    round_state, decided, winner_mask, events, telem, trace = _compute_round(
        cfg, _one(state), _one(faults), telem=_one(telem), trace=_one(trace), ctx=ctx
    )
    if decided:
        with _gate(ctx), profiling.span("view_change"):
            round_state = apply_view_change_impl(cfg, round_state, winner_mask, ctx)
    return _only(round_state), _only(events), decided, _only(telem), _only(trace)


def engine_stream_step(
    cfg: EngineConfig,
    state: EngineState,
    faults: FaultInputs,
    telem: Optional[TelemetryLanes] = None,
    trace: Optional[TraceRing] = None,
):
    """One cluster's full round with no host read: the tenant fleet's
    ``fleet_step`` body at ``t = 1``. The invalidation pass and the classic
    attempt are computed and kept where their gates are set, and the view
    change is computed and kept where the round decided, so the results
    equal :func:`engine_step`'s lane for lane. Returns (state, events,
    telem, trace) with ``events.decided`` a 0-d bool on the state's
    device. Covers the JAX package's ``engine_step`` as its ``stream_step``
    dispatches it."""
    round_state, decided, winner_mask, events, telem, trace = _compute_round(
        cfg, _one(state), _one(faults), select=True, telem=_one(telem), trace=_one(trace)
    )
    with profiling.span("view_change"):
        committed = apply_view_change_impl(cfg, round_state, winner_mask)
    state = select_lanes(decided, committed, round_state)
    return _only(state), _only(events), _only(telem), _only(trace)


def run_to_decision(
    cfg: EngineConfig,
    state: EngineState,
    faults: FaultInputs,
    max_steps: int,
    telem: Optional[TelemetryLanes] = None,
    trace: Optional[TraceRing] = None,
    ctx=None,
):
    """One cluster's rounds until a view change commits or ``max_steps`` run
    out. Returns (state, steps, decided, winner_mask, telem, trace). Covers
    the JAX package's ``run_to_decision`` and its ``_telem`` / ``_trace``
    twins, and with ``ctx`` a sharded run of this rank's shard."""
    state, faults, telem, trace = _one(state), _one(faults), _one(telem), _one(trace)
    edge_masks = _edge_masks(cfg, state, faults, ctx)
    steps, decided = 0, False
    winner = torch.zeros((1, _local(cfg, ctx)[0]), dtype=torch.bool, device=state.alive.device)
    while not decided and steps < max_steps:
        with _loop(ctx):
            state, decided, winner, _, telem, trace = _compute_round(
                cfg, state, faults, edge_masks, telem=telem, trace=trace, ctx=ctx
            )
        steps += 1
    if decided:
        with _gate(ctx), profiling.span("view_change"):
            state = apply_view_change_impl(cfg, state, winner, ctx)
    return _only(state), steps, decided, winner[0], _only(telem), _only(trace)


def run_until_membership(
    cfg: EngineConfig,
    state: EngineState,
    faults: FaultInputs,
    target: int,
    max_steps: int,
    max_cuts: int,
    min_cuts: int,
    telem: Optional[TelemetryLanes] = None,
    trace: Optional[TraceRing] = None,
    ctx=None,
):
    """One cluster's rounds through several view changes until the
    membership reaches ``target`` with at least ``min_cuts`` committed
    cuts, the step or cut budget runs out, or a convergence stalls
    undecided. Returns (state, total_steps, cuts, resolved, sizes, telem,
    trace) where ``sizes[i]`` is the membership after the i-th cut. The
    plane lanes accumulate across the view changes. Covers the JAX
    package's ``run_until_membership`` and its ``_telem`` / ``_trace``
    twins, and with ``ctx`` a sharded run of this rank's shard (the view
    change and the edge masks' rebuild gated inside the loop, as in the
    JAX wave)."""
    state, faults, telem, trace = _one(state), _one(faults), _one(telem), _one(trace)
    edge_masks = _edge_masks(cfg, state, faults, ctx)
    members = _host.read(state.n_members, "membership_predicate")[0]  # host-sync-ok: the wave loop's predicate (JAX's while_loop condition)
    steps, cuts, stalled, sizes = 0, 0, False, []
    while not (
        (members == target and cuts >= min_cuts)
        or stalled
        or steps >= max_steps
        or cuts >= max_cuts
    ):
        decided = False
        while not decided and steps < max_steps:
            with _loop(ctx):
                state, decided, winner, _, telem, trace = _compute_round(
                    cfg, state, faults, edge_masks, telem=telem, trace=trace, ctx=ctx
                )
            steps += 1
        if decided:
            with _loop(ctx), _gate(ctx), profiling.span("view_change"):
                state = apply_view_change_impl(cfg, state, winner, ctx)
                edge_masks = _edge_masks(cfg, state, faults, ctx)
            members = _host.read(state.n_members, "membership_predicate")[0]  # host-sync-ok: the wave loop's predicate after a cut
            sizes.append(members)
            cuts += 1
        stalled = not decided
    resolved = members == target and cuts >= min_cuts
    return _only(state), steps, cuts, resolved, sizes, _only(telem), _only(trace)


def telemetry_digest(telem: TelemetryLanes) -> torch.Tensor:
    """``[t, ...]`` telemetry lanes reduced to ``[t, 18]`` int32: the
    ``engine_telemetry.TELEMETRY_DIGEST_FIELDS`` scalars, then the
    rounds-undecided histogram. One cluster is ``t = 1``. Covers the JAX
    package's ``telemetry_digest`` and the fleet's vmap of it."""
    active = telem.tl_active.flatten(1)
    return torch.cat([
        torch.stack([
            telem.tl_rounds,
            telem.tl_alerts,
            active.sum(-1, dtype=torch.int32),
            active.amax(-1),
            telem.tl_invalidated.flatten(1).sum(-1, dtype=torch.int32),
            telem.tl_proposals.sum(-1, dtype=torch.int32),
            telem.tl_tally_sum,
            telem.tl_fast_decisions,
            telem.tl_classic_decisions,
            telem.tl_conflict_rounds,
        ], -1),
        telem.tl_undecided_hist,
    ], -1)


def trace_digest(trace: TraceRing) -> torch.Tensor:
    """``[t, ...]`` trace rings packed into ``[t, 2 + 9R]`` int32:
    ``[tr_cursor, tr_wraps]``, then the nine ``[R]`` lanes in
    ``engine_telemetry.TRACE_RECORD_FIELDS`` order. Covers the JAX
    package's ``trace_digest`` and the fleet's vmap of it."""
    return torch.cat([torch.stack([trace.tr_cursor, trace.tr_wraps], -1), *trace[:9]], -1)


def sync_checksum(state: EngineState, faults: FaultInputs) -> torch.Tensor:
    """One cluster's checksum over its state and fault lanes, as the JAX
    package's ``sync_checksum`` computes it (every sum wraps modulo 2**32):
    a 0-d int64 tensor holding the uint32 value. A stored uint32 lane sums
    as its int32 bit patterns: each differs from its unsigned value by a
    multiple of 2**32, so the sums agree modulo 2**32. The report lane sums
    by its own width (a narrow one's bits are not a multiple of 2**32
    away), the signed index and counter lanes by value."""
    total = sum(
        lane.sum(dtype=torch.int64)
        for lane in (
            state.key_hi, state.key_lo, state.id_hi, state.id_lo, state.obs_idx,
            state.fd_count, state.alive, faults.crashed, faults.probe_fail,
        )
    )
    return (total + _narrow.unsigned(state.report_bits).sum()) & _u32.MASK


class VirtualCluster(DispatchSeam):
    """Host driver around the engine: owns the state, injects faults and
    join waves, and runs rounds until convergence. Runs on CUDA unless
    ``device`` names another device.

    Its ``metrics`` registry carries the JAX driver's counters and
    per-phase dispatch timers, charged at the same seams with the same
    bytes (:class:`~rapid_tpu_torch.utils.dispatch.DispatchSeam`)."""

    def __init__(self, cfg: EngineConfig, state: EngineState):
        validate_config(cfg)
        self.cfg = cfg
        self.state = state
        self.device = state.alive.device
        self.faults = FaultInputs.none(cfg, self.device)
        self.last_decided = False
        self.metrics = Metrics()
        # Attached by serving.StreamDriver and serving.supervisor.Supervisor
        # (None: no stream, no supervision).
        self.stream = None
        self.recovery = None
        # Pinned host buffers of uploads still in flight (_host.upload). A
        # stream wave takes them with its ticket; every entry point that
        # waits for the device releases the rest.
        self._staged: list = []
        # Device telemetry plane and trace ring (None when off). The host
        # keeps decoded caches, zero-minted here and refreshed only by
        # sync(), so reading them never touches the device.
        self.telem = initial_telemetry(cfg, self.device) if cfg.telemetry else None
        self.trace_ring = initial_trace(cfg, self.device) if cfg.trace else None
        self._activity = (
            engine_telemetry.zero_activity_summary(cfg.n, cfg.c) if cfg.telemetry else None
        )
        self._trace = engine_telemetry.zero_trace_summary(cfg.trace) if cfg.trace else None
        engine_telemetry.install()

    # -- construction ---------------------------------------------------

    @classmethod
    def create(
        cls,
        n_members: int,
        n_slots: Optional[int] = None,
        k: int = 10,
        h: int = 9,
        l: int = 4,
        cohorts: int = 2,
        fd_threshold: int = 3,
        seed: int = 0,
        use_pallas: bool = False,
        fallback_rounds: int = 8,
        delivery_spread: int = 0,
        concurrent_coordinators: int = 1,
        fd_window: int = 0,
        delivery_prob_permille: int = 1000,
        pallas_lanes: int = 128,
        compact: bool = False,
        telemetry: bool = False,
        trace: int = 0,
        device=None,
    ) -> "VirtualCluster":
        """Synthetic cluster with random 64-bit slot identities, drawn from
        numpy with the JAX package's seeds, so both packages build the same
        state. ``compact=True`` stores the state at the config's narrow
        dtypes (``models/state.compaction_policy``): the same protocol, bit
        for bit, in fewer bytes per member. ``telemetry=True`` carries the
        device telemetry plane and ``trace=R`` (with telemetry) the ring of
        the last R rounds; read them through :meth:`sync` and
        :attr:`activity` / :attr:`trace`."""
        n = n_slots if n_slots is not None else n_members
        if n < n_members:
            raise ValueError(f"n_slots ({n}) < n_members ({n_members})")
        rng = np.random.default_rng(seed)
        key_hi = rng.integers(0, 2**32, size=(k, n), dtype=np.uint32)
        key_lo = rng.integers(0, 2**32, size=(k, n), dtype=np.uint32)
        return cls._build(
            key_hi, key_lo, rng, n_members, device,
            n=n, k=k, h=h, l=l, c=cohorts, fd_threshold=fd_threshold,
            use_pallas=use_pallas, fallback_rounds=fallback_rounds,
            delivery_spread=delivery_spread,
            concurrent_coordinators=concurrent_coordinators,
            fd_window=fd_window,
            delivery_prob_permille=delivery_prob_permille,
            pallas_lanes=pallas_lanes,
            compact=int(compact),
            telemetry=int(telemetry),
            trace=int(trace),
        )

    @classmethod
    def from_endpoints(
        cls,
        endpoints: Sequence,
        n_slots: Optional[int] = None,
        k: int = 10,
        h: int = 9,
        l: int = 4,
        cohorts: int = 2,
        fd_threshold: int = 3,
        use_pallas: bool = False,
        fallback_rounds: int = 8,
        delivery_spread: int = 0,
        concurrent_coordinators: int = 1,
        fd_window: int = 0,
        delivery_prob_permille: int = 1000,
        pallas_lanes: int = 128,
        n_members: Optional[int] = None,
        topology: str = "native",
        compact: bool = False,
        telemetry: bool = False,
        trace: int = 0,
        device=None,
    ) -> "VirtualCluster":
        """A cluster of real endpoints (objects with ``.hostname`` and
        ``.port``) with the host view's ring keys
        (``ops.rings.endpoint_ring_keys``), so the engine's rings are the
        host view's, bit for bit. The first ``n_members`` endpoints (default
        all) start as members; the rest are keyed slots reserved for a later
        :meth:`inject_join_wave`, which admits them where the host view
        would. Slots past the endpoints carry zero keys. Identity lanes are
        drawn from ``default_rng(1234)``, as the JAX package draws them.
        Only the native topology is accepted."""
        if n_members is None:
            n_members = len(endpoints)
        if not 0 < n_members <= len(endpoints):
            raise ValueError(f"n_members must be in [1, {len(endpoints)}], got {n_members}")
        n = n_slots if n_slots is not None else len(endpoints)
        key_hi = np.zeros((k, n), dtype=np.uint32)
        key_lo = np.zeros((k, n), dtype=np.uint32)
        key_hi[:, : len(endpoints)], key_lo[:, : len(endpoints)] = endpoint_ring_keys(
            endpoints, k, topology=topology
        )
        return cls._build(
            key_hi, key_lo, np.random.default_rng(1234), n_members, device,
            n=n, k=k, h=h, l=l, c=cohorts, fd_threshold=fd_threshold,
            use_pallas=use_pallas, fallback_rounds=fallback_rounds,
            delivery_spread=delivery_spread,
            concurrent_coordinators=concurrent_coordinators,
            fd_window=fd_window,
            delivery_prob_permille=delivery_prob_permille,
            pallas_lanes=pallas_lanes,
            compact=int(compact),
            telemetry=int(telemetry),
            trace=int(trace),
        )

    @classmethod
    def _build(cls, key_hi, key_lo, rng, n_members, device, **config) -> "VirtualCluster":
        """The cluster of ring keys ``key_hi``/``key_lo`` (numpy uint32
        ``[k, n]``) with identity lanes drawn next from ``rng`` and the
        first ``n_members`` slots alive, on ``device``."""
        cfg = EngineConfig(**config)
        validate_config(cfg)
        dev = resolve_device(device)
        n = cfg.n
        id_hi = rng.integers(0, 2**32, size=(n,), dtype=np.uint32)
        id_lo = rng.integers(0, 2**32, size=(n,), dtype=np.uint32)
        alive = np.zeros((n,), dtype=bool)
        alive[:n_members] = True
        state = initial_state(
            cfg,
            _u32.from_numpy(key_hi, dev),
            _u32.from_numpy(key_lo, dev),
            _u32.from_numpy(id_hi, dev),
            _u32.from_numpy(id_lo, dev),
            torch.from_numpy(alive).to(dev),
        )
        cluster = cls(cfg, state)
        cluster._account_h2d(key_hi, key_lo, id_hi, id_lo, alive)
        return cluster

    # -- fault & membership injection ----------------------------------

    def _slot_index(self, slots: Sequence[int]) -> torch.Tensor:
        """Bounds-checked slot indices on the device (torch would raise on a
        bad index on the CPU and assert on a card; this names the slots).
        They upload as int32, as the JAX package's do (and are charged so),
        without waiting for the queued work (:func:`_host.upload`), and
        widen to int64 for indexing on the device."""
        arr = np.asarray(slots, dtype=np.int32).reshape(-1)
        if arr.size and (arr.min() < 0 or arr.max() >= self.cfg.n):
            raise IndexError(
                f"slot indices out of range [0, {self.cfg.n}): "
                f"{arr[(arr < 0) | (arr >= self.cfg.n)].tolist()}"
            )
        self._account_h2d(arr)
        return _host.upload(arr, self.device, self._staged).to(torch.int64)

    # The injections below store with index_fill / index_copy: on a card,
    # ``lane[idx] = python_scalar`` synchronizes the stream (the scalar is
    # copied to the device first), which would stall every queued wave.

    def _set_crashed(self, idx: torch.Tensor, value: bool) -> None:
        self.faults = self.faults._replace(crashed=self.faults.crashed.index_fill(0, idx, value))

    def crash(self, slots: Sequence[int]) -> None:
        """Crash-stop the given slots (unresponsive until revived)."""
        self._set_crashed(self._slot_index(slots), True)

    def revive(self, slots: Sequence[int]) -> None:
        self._set_crashed(self._slot_index(slots), False)

    def _stamp_fired_edges(self, idx: torch.Tensor, edge_mask: torch.Tensor) -> None:
        """Mark (slot, ring) edges ``[j, k]`` as fired at the current round
        (at the fire-round lane's dtype, the policy's sentinel elsewhere);
        the round body then applies rx-blocks and delivery delays."""
        state = self.state
        rdt = state.fire_round.dtype
        fire_never = compaction_policy(self.cfg).fire_never
        stamped = torch.where(edge_mask, state.round_idx.to(rdt), fire_never).to(rdt)
        self.state = state._replace(
            fd_fired=state.fd_fired.index_copy(0, idx, edge_mask),
            fire_round=state.fire_round.index_copy(0, idx, stamped),
        )

    def initiate_leave(self, slots: Sequence[int]) -> None:
        """Graceful batched leave: each leaver broadcasts its own departure
        on every ring (it becomes its own column's observer) and stops
        responding."""
        idx = self._slot_index(slots)
        obs_idx = self.state.obs_idx.clone()
        obs_idx[:, idx] = idx.to(obs_idx.dtype)[None, :].expand(self.cfg.k, -1)
        self.state = self.state._replace(obs_idx=obs_idx)
        leaving = np.ones((len(idx), self.cfg.k), dtype=bool)
        self._account_h2d(leaving)
        self._stamp_fired_edges(idx, torch.from_numpy(leaving).to(self.device))
        self._set_crashed(idx, True)

    def set_flaky_edges(self, probe_fail: np.ndarray) -> None:
        """Arbitrary per-(subject, ring) probe failures."""
        arr = np.array(probe_fail, dtype=bool)
        self._account_h2d(arr)
        self.faults = self.faults._replace(probe_fail=torch.from_numpy(arr).to(self.device))

    def stagger_fd_counts(self, rng: np.random.Generator, spread_rounds: int) -> None:
        """Randomize per-edge detection latency (negative initial counters
        at the counter dtype), drawn from ``rng`` exactly as the JAX package
        draws them. A spread the counter dtype cannot hold raises."""
        cdt = np.dtype(compaction_policy(self.cfg).counter)
        if spread_rounds >= np.iinfo(cdt).max:
            raise ValueError(
                f"spread_rounds {spread_rounds} exceeds the fd_count "
                f"envelope of the {cdt.name} compaction policy"
            )
        offsets = rng.integers(0, spread_rounds + 1, size=(self.cfg.n, self.cfg.k))
        narrowed = (-offsets).astype(cdt)
        self._account_h2d(narrowed)
        self.state = self.state._replace(fd_count=torch.from_numpy(narrowed).to(self.device))

    def inject_join_wave(self, slots: Sequence[int], check_admissible: bool = True) -> None:
        """Admit a batch of joiners: their gatekeepers (alive ring
        predecessors) become their observers and fire UP alerts on every
        ring, delivered like DOWN alerts. Current members, pending joiners
        and retired slots are refused (one read of ``[j]`` bools).

        ``check_admissible=False`` skips that read: the streaming pipeline's
        spelling, whose driver keeps the slot lifecycle on the host. Then
        the wave makes no read and no synchronizing call."""
        slots = np.asarray(slots)
        state = self.state
        idx = self._slot_index(slots)
        if check_admissible:
            bad = np.asarray(_host.read((state.alive | state.join_pending | state.retired)[idx],
                                        "join_admissibility"))
            self._account_d2h(bad.nbytes)
            if bad.any():
                raise ValueError(
                    f"slots not admissible as joiners (member/pending/retired): "
                    f"{slots[bad].tolist()}"
                )
        pred = predecessor_of_keys(
            state.key_hi, state.key_lo, state.alive,
            state.key_hi[:, idx], state.key_lo[:, idx], perm=state.ring_perm,
        )  # [k, j]
        self.state = state._replace(
            join_pending=state.join_pending.index_fill(0, idx, True),
            obs_idx=state.obs_idx.index_copy(1, idx, pred.to(state.obs_idx.dtype)),
            inval_obs=state.inval_obs.index_copy(1, idx, pred.to(state.inval_obs.dtype)),
        )
        self._stamp_fired_edges(idx, (pred >= 0).T.contiguous())

    def assign_cohorts(self, cohort_of: np.ndarray) -> None:
        """Set every slot's receiver cohort (stored at the cohort dtype)."""
        cdt = np.dtype(compaction_policy(self.cfg).cohort)
        arr = np.array(cohort_of, dtype=cdt)
        self._account_h2d(arr)
        self.state = self.state._replace(cohort_of=torch.from_numpy(arr).to(self.device))

    def assign_cohorts_roundrobin(self) -> None:
        """Spread the N slots evenly over the C receiver cohorts."""
        self.assign_cohorts(np.arange(self.cfg.n, dtype=np.int32) % self.cfg.c)

    def set_rx_block(self, rx_block: np.ndarray) -> None:
        """Change per-cohort receive blocking and re-stamp every fired edge
        to the current round, so alerts redeliver to newly-hearing cohorts."""
        arr = np.array(rx_block, dtype=bool)
        self._account_h2d(arr)
        self.faults = self.faults._replace(rx_block=torch.from_numpy(arr).to(self.device))
        self.state = self.state._replace(
            fire_round=torch.where(
                self.state.fd_fired,
                self.state.round_idx.to(self.state.fire_round.dtype),
                self.state.fire_round,
            )
        )

    # -- execution ------------------------------------------------------

    def _step(self, phase: str) -> StepEvents:
        """The one body of both round spellings: the batch round
        (``step``, host branches, :attr:`last_decided` a host bool) and the
        streaming pipeline's (``stream_enqueue``, no read, the events left
        on the device)."""
        self.metrics.inc("engine_steps")
        self.metrics.inc("engine_convergence_steps")
        with self._dispatch(phase) as record:
            record.rounds = 1
            if phase == "stream_enqueue":
                self.state, events, self.telem, self.trace_ring = engine_stream_step(
                    self.cfg, self.state, self.faults, self.telem, self.trace_ring
                )
            else:
                self.state, events, self.last_decided, self.telem, self.trace_ring = engine_step(
                    self.cfg, self.state, self.faults, self.telem, self.trace_ring
                )
                self._staged.clear()  # its reads waited for every upload
        return events

    def step(self) -> StepEvents:
        """One round (and the view change if it decided)."""
        return self._step("step")

    def stream_step(self) -> StepEvents:
        """One round queued for the streaming pipeline
        (:mod:`rapid_tpu_torch.serving`): the same protocol as :meth:`step`,
        lane for lane, timed under the ``stream_enqueue`` phase, with no
        host read and no synchronizing call, so it returns as soon as the
        round's kernels are queued. The returned events stay on the
        device."""
        return self._step("stream_enqueue")

    def sync(self) -> int:
        """Wait for the cluster's queued work and return the JAX package's
        checksum of the state and faults (one counted read). With the
        telemetry plane on, then refresh :attr:`activity` and :attr:`trace`
        (:meth:`_refresh_activity`)."""
        with self._dispatch("sync"):
            checksum = _host.read(sync_checksum(self.state, self.faults), "sync_checksum")
        self._account_d2h(4)
        self._staged.clear()
        self._refresh_activity()
        return checksum

    def _refresh_activity(self) -> None:
        """Fetch the telemetry digest, and the ring's, in one counted read
        each and decode them into the host caches. Called only where the
        host already waits for the device (:meth:`sync`, a stream's
        drain)."""
        if self.telem is not None:
            # telemetry-fetch-ok: sync barrier — the driver is already paying a
            # blocking device round trip here.
            digest = telemetry_digest(_one(self.telem))[0]
            self._account_d2h(digest.nbytes)
            self._activity = engine_telemetry.activity_summary(
                _host.read(digest, "telemetry_digest"), self.cfg.n, self.cfg.c
            )
        if self.trace_ring is not None:
            # telemetry-fetch-ok: sync barrier — same blocking round trip.
            digest = trace_digest(_one(self.trace_ring))[0]
            self._account_d2h(digest.nbytes)
            self._trace = engine_telemetry.trace_summary(_host.read(digest, "trace_digest"),
                                                         self.cfg.trace)

    @property
    def activity(self) -> Optional[dict]:
        """The activity summary decoded at the last :meth:`sync` (a copy;
        all zero before the first), or None with the plane off."""
        return dict(self._activity) if self._activity is not None else None

    @property
    def trace(self) -> Optional[dict]:
        """The ring decoded at the last :meth:`sync` (a copy, ``records``
        oldest to newest with global round ordinals ``seq``), or None with
        the ring off."""
        if self._trace is None:
            return None
        return {**self._trace, "records": [dict(r) for r in self._trace["records"]]}

    def run_until_converged(self, max_steps: int = 64) -> Tuple[int, Optional[StepEvents]]:
        """Rounds until a view change commits; returns (rounds, events)."""
        for round_idx in range(max_steps):
            events = self.step()
            if self.last_decided:
                return round_idx + 1, events
        return max_steps, None

    def run_to_decision(self, max_steps: int = 64) -> Tuple[int, bool, torch.Tensor, int]:
        """Rounds until a view change commits; returns (rounds, decided,
        winner_mask, n_members)."""
        with self._dispatch("run_to_decision") as record:
            self.state, steps, decided, winner, self.telem, self.trace_ring = run_to_decision(
                self.cfg, self.state, self.faults, max_steps, self.telem, self.trace_ring
            )
            members = _host.read(self.state.n_members, "decision_observation")
            record.rounds = steps
        # The JAX driver's packed observation: 4 bytes, 8 past 2**22 slots.
        self._account_d2h(4 if self.cfg.n < (1 << 22) else 8)
        self._staged.clear()
        self.metrics.inc("engine_convergence_steps", steps)
        if decided:
            self.metrics.inc("engine_cuts_committed")
        return steps, decided, winner, members

    def run_until_membership(
        self, target: int, max_steps: int = 192, max_cuts: int = 8, min_cuts: int = 0
    ) -> Tuple[int, int, bool, Tuple[int, ...]]:
        """Convergences with view changes between them until the membership
        reaches ``target``; returns (rounds, cuts, resolved, sizes)."""
        if not 0 <= target <= self.cfg.n:
            raise ValueError(f"target must be in [0, {self.cfg.n}]: {target}")
        with self._dispatch("run_until_membership") as record:
            self.state, steps, cuts, resolved, sizes, self.telem, self.trace_ring = (
                run_until_membership(
                    self.cfg, self.state, self.faults, target, max_steps, max_cuts, min_cuts,
                    self.telem, self.trace_ring,
                )
            )
            record.rounds = steps
        # The JAX driver's observation: (steps, cuts, resolved, sizes[max_cuts]) int32.
        self._account_d2h(4 * (3 + max_cuts))
        self._staged.clear()
        self.metrics.inc("engine_convergence_steps", steps)
        self.metrics.inc("engine_cuts_committed", cuts)
        return steps, cuts, resolved, tuple(sizes)

    def timed_convergence(self, max_steps: int = 64) -> Tuple[int, float]:
        """(rounds, wall_ms) of one :meth:`run_until_converged`, the card
        synchronized before the clock stops (callers run one throwaway
        convergence first, as for the JAX package's compile)."""
        start = time.perf_counter()
        rounds, events = self.run_until_converged(max_steps)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed_ms = (time.perf_counter() - start) * 1000.0
        if events is None:
            raise AssertionError("did not converge")
        return rounds, elapsed_ms

    # -- observers ------------------------------------------------------

    @property
    def membership_size(self) -> int:
        self._account_d2h(4)
        return _host.read(self.state.n_members, "observer")

    @property
    def alive_mask(self) -> np.ndarray:
        mask = np.array(_host.read(self.state.alive, "observer"), dtype=bool)
        self._account_d2h(mask.nbytes)
        return mask

    @property
    def config_epoch(self) -> int:
        self._account_d2h(4)
        return _host.read(self.state.config_epoch, "observer")

    @property
    def config_id(self) -> int:
        self._account_d2h(8)
        hi, lo = _host.read(
            _u32.widen(torch.stack([self.state.config_hi, self.state.config_lo])), "observer")
        return (hi << 32) | lo

    # -- observability (utils/exposition.py schema) ---------------------

    def health(self) -> NodeHealth:
        """Cluster-wide health of the N virtual members in the host
        vocabulary: PROPOSING while churn is in flight (a crashed slot still
        alive, or a join wave not yet admitted), STABLE otherwise. One
        device reduction, read once (4 bytes, as the JAX driver charges)."""
        pending = _host.read(
            (self.state.alive & self.faults.crashed).sum(dtype=torch.int32)
            + self.state.join_pending.sum(dtype=torch.int32),
            "health",
        )
        self._account_d2h(4)
        return NodeHealth.PROPOSING if pending else NodeHealth.STABLE

    def telemetry_snapshot(self) -> dict:
        """The engine's unified telemetry snapshot, the JAX driver's keys
        and sections: the ``engine`` section carries the build capture
        (``compile``), the device memory gauges of this cluster's device
        (``memory``), and exactly when JAX's would, ``stream`` (a
        ``StreamDriver`` attached), ``recovery`` (a ``Supervisor``
        attached), ``activity`` (the plane on) and ``trace`` (the ring on).
        The plane sections are the host caches of the last :meth:`sync`: a
        scrape never reads the lanes. The reads it does make (config id,
        membership, health, epoch) are charged as JAX charges them; each
        waits for the card, so scrape between a stream's waves."""
        return {
            "node": f"virtual-cluster/{self.cfg.n}",
            "configuration_id": self.config_id,
            "membership_size": self.membership_size,
            "health": self.health().value,
            "config_epoch": self.config_epoch,
            "metrics": self.metrics.summary(),
            "engine": {
                "n": self.cfg.n,
                "cohorts": self.cfg.c,
                "use_pallas": self.cfg.use_pallas,
                "compile": engine_telemetry.compile_snapshot(),
                "memory": engine_telemetry.device_memory_snapshot(self.device),
                **({"stream": self.stream.snapshot()} if self.stream is not None else {}),
                **({"recovery": self.recovery.snapshot()} if self.recovery is not None else {}),
                **({"activity": dict(self._activity)} if self._activity is not None else {}),
                **({"trace": self.trace} if self._trace is not None else {}),
            },
            "transport": {},
            "recorder": None,
        }

    def prometheus_text(self) -> str:
        return exposition.prometheus_text(self.telemetry_snapshot())
