"""A whole Rapid-style cluster of N virtual endpoints as one device program
per round (port of ``rapid_tpu/models/virtual_cluster.py``, single cluster,
telemetry and trace planes not ported).

One round, for every virtual node at once: probe tick -> edge alerts ->
cohort delivery -> watermark cut detection -> fast-round votes -> quorum
tally -> classic fallback when due. A decided round is followed by the view
change.

The JAX engine keeps its loops and ``lax.cond`` gates on the device. Here
the loops are Python loops, and each gate becomes one of two things:

- a device-side select where both branches are cheap and the result is the
  same: alert delivery is always computed (by the CUDA kernel on a card) and
  zeroed when ``need_delivery`` is false;
- a host branch on one counted read (:func:`rapid_tpu_torch._host.read`)
  where the branch is expensive and rare: implicit invalidation, the
  classic attempt and the view change.

A round therefore makes two reads in the common case: the invalidation gate
and the packed (fast decision, fallback due) pair. A round whose fallback is
due makes a third.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rapid_tpu_torch import _host, _u32
from rapid_tpu_torch.models.state import (
    FIRE_NEVER,
    EngineConfig,
    EngineState,
    FaultInputs,
    StepEvents,
    initial_state,
    resolve_device,
    validate_config,
)
from rapid_tpu_torch.ops.consensus import tally_candidates
from rapid_tpu_torch.ops.cut_detection import cohort_watermark_pass
from rapid_tpu_torch.ops.hashing import masked_set_hash
from rapid_tpu_torch.ops.kernels import delivery_new_bits, popcount32
from rapid_tpu_torch.ops.rings import predecessor_of_keys, ring_topology_from_perm


def cohort_words(c: int) -> int:
    """uint32 words needed to carry one bit per receiver cohort."""
    return (c + 31) // 32


def _edge_masks(cfg: EngineConfig, state: EngineState, faults: FaultInputs):
    """Per-edge observer masks: ``(observer_active[n, k], blocked_rows[w*k,
    n])``. ``blocked_rows`` packs "cohort c cannot hear the observer of edge
    (subject, ring)" over cohorts: row ``wi*k + ring``, bit j = cohort
    ``32*wi + j``. Fixed between view changes, so loops compute it once per
    configuration."""
    n, k, c = cfg.n, cfg.k, cfg.c
    w = cohort_words(c)
    obs = state.obs_idx.T  # [n, k]
    obs_clamped = obs.clamp(0, n - 1).to(torch.int64)
    active = state.alive & ~faults.crashed
    observer_active = (obs >= 0) & active[obs_clamped]

    rxb = torch.zeros((w * 32, n), dtype=torch.int64, device=obs.device)
    rxb[:c] = faults.rx_block.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=obs.device)
    words = _u32.narrow((rxb.view(w, 32, n) << shifts[None, :, None]).sum(1))  # [w, n]
    blocked_rows = words[:, obs_clamped.T].reshape(w * k, n)
    return observer_active, blocked_rows


def _fd_tick(cfg: EngineConfig, state: EngineState, faults: FaultInputs, observer_active):
    """Every observer probes its subjects; edges past the failure threshold
    fire one DOWN alert. Counter mode (``fd_window == 0``) or the windowed
    policy (a uint32 bit-history per edge)."""
    subject_down = faults.crashed[:, None] | faults.probe_fail
    probe_failed = observer_active & subject_down & state.alive[:, None]
    if cfg.fd_window:
        probed = observer_active & state.alive[:, None]
        fd_count = torch.where(probed, state.fd_count + 1, state.fd_count)
        window_mask = (1 << cfg.fd_window) - 1
        shifted = ((_u32.widen(state.fd_hist) << 1) | probe_failed.to(torch.int64)) & window_mask
        fd_hist = torch.where(probed, _u32.narrow(shifted), state.fd_hist)
        past_threshold = (popcount32(fd_hist) >= cfg.fd_threshold) & (fd_count >= cfg.fd_window)
    else:
        fd_count = torch.where(probe_failed, state.fd_count + 1, state.fd_count)
        fd_hist = state.fd_hist
        past_threshold = fd_count >= cfg.fd_threshold
    fire = past_threshold & ~state.fd_fired & state.alive[:, None]
    return fd_count, fd_hist, state.fd_fired | fire, fire


def _deliver_alerts(cfg: EngineConfig, state: EngineState, fire_round, blocked_rows):
    """Per-cohort delivered alert bitmasks ``[c, n]``: the delivery kernel
    on a card, its plain version on the CPU."""
    age_kn = (state.round_idx - fire_round.T).contiguous()
    return delivery_new_bits(
        blocked_rows, age_kn, state.config_epoch, cfg.k, cfg.c,
        cfg.delivery_spread, cfg.delivery_prob_permille,
    )


def _rotation_seed_w(epoch_w: torch.Tensor, j: int) -> torch.Tensor:
    """Per-racer hash-stream seed for coordinator rotation (widened)."""
    return _u32.add(_u32.mul(epoch_w, 0x9E3779B1), (0x5BD1E995 * (j + 1)) & _u32.MASK)


def _classic_attempt(cfg: EngineConfig, state: EngineState, faults: FaultInputs, announced, cp):
    """One classic-Paxos attempt with ``cfg.concurrent_coordinators``
    rank-ordered racers (Paxos.java:93-238). Returns the acceptor lanes,
    the 0-d decided flag and the winning cohort (0-d int32, -1 if none)."""
    cp_rnd_r, cp_rnd_i, cp_vrnd_r, cp_vrnd_i, cp_vval_src = cp
    n, c = cfg.n, cfg.c
    dev = state.alive.device
    cohort_of = state.cohort_of.to(torch.int64)
    active = state.alive & ~faults.crashed
    n_active = active.sum(dtype=torch.int32)
    majority = state.n_members // 2 + 1
    round_num = 2 + state.classic_epoch
    cohort_ids = torch.arange(c, dtype=torch.int32, device=dev)
    active_rank = torch.cumsum(active, 0, dtype=torch.int32)

    def rank_gt(ar, ai, br, bi):
        return (ar > br) | ((ar == br) & (ai > bi))

    coords = []
    epoch_w = _u32.widen(state.classic_epoch)
    for j in range(cfg.concurrent_coordinators):
        pick = _u32.mix32_w(_rotation_seed_w(epoch_w, j))
        target = torch.where(n_active > 0, pick % n_active.clamp(min=1).to(torch.int64) + 1, 1)
        coords.append(torch.argmax((active & (active_rank == target)).to(torch.int32)))

    valid = []
    for j, coord in enumerate(coords):
        v = torch.ones((), dtype=torch.bool, device=dev)
        for prev in coords[:j]:
            v = v & (coord != prev)
        valid.append(v)

    per = []
    for coord, v in zip(coords, valid):
        coord_cohort = cohort_of[coord]
        hears_coord = active & v & ~faults.rx_block[cohort_of, coord]
        coord_hears = active & v & ~faults.rx_block[coord_cohort]
        promise = hears_coord & rank_gt(round_num, coord, cp_rnd_r, cp_rnd_i)
        q1 = promise & coord_hears
        phase1_ok = q1.sum(dtype=torch.int32) >= majority
        voters = q1 & (cp_vval_src >= 0)
        mv_r = torch.where(voters, cp_vrnd_r, -1).max()
        mv_i = torch.where(voters & (cp_vrnd_r == mv_r), cp_vrnd_i, -1).max()
        at_max = voters & (cp_vrnd_r == mv_r) & (cp_vrnd_i == mv_i)
        max_counts = (at_max[None, :] & (cp_vval_src[None, :] == cohort_ids[:, None])).sum(
            1, dtype=torch.int32
        )
        chosen = torch.where(
            (max_counts > 0).any(),
            torch.argmax(max_counts),
            torch.where(announced.any(), torch.argmax(announced.to(torch.int32)), -1),
        ).to(torch.int32)
        per.append((coord, hears_coord, promise, phase1_ok, chosen))

    # An acceptor's rnd after every phase1a is the max rank it heard.
    rnd1_r, rnd1_i = cp_rnd_r, cp_rnd_i
    for coord, _, promise, _, _ in per:
        bump = promise & rank_gt(round_num, coord, rnd1_r, rnd1_i)
        rnd1_r = torch.where(bump, round_num, rnd1_r)
        rnd1_i = torch.where(bump, coord.to(torch.int32), rnd1_i)

    acc_r, acc_i, acc_src = cp_vrnd_r, cp_vrnd_i, cp_vval_src
    fb_decided = torch.zeros((), dtype=torch.bool, device=dev)
    chosen_winner = torch.full((), -1, dtype=torch.int32, device=dev)
    any_touch = torch.zeros((n,), dtype=torch.bool, device=dev)
    for coord, hears_coord, promise, phase1_ok, chosen in per:
        can_accept = (
            phase1_ok & (chosen >= 0) & hears_coord & (rnd1_r == round_num) & (rnd1_i == coord)
        )
        accept_count = can_accept.sum(dtype=torch.int32)
        won = phase1_ok & (chosen >= 0) & (accept_count >= majority)
        fb_decided = fb_decided | won
        chosen_winner = torch.where(won, chosen, chosen_winner)
        acc_r = torch.where(can_accept, round_num, acc_r)
        acc_i = torch.where(can_accept, coord.to(torch.int32), acc_i)
        acc_src = torch.where(can_accept, chosen, acc_src)
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


def _compute_round(
    cfg: EngineConfig, state: EngineState, faults: FaultInputs, edge_masks=None
) -> Tuple[EngineState, bool, torch.Tensor, StepEvents]:
    """One protocol round WITHOUT the view change: returns the
    round-advanced state, whether it decided (a host bool), the decided cut
    and the round's events."""
    n, c = cfg.n, cfg.c
    dev = state.alive.device
    if edge_masks is None:
        edge_masks = _edge_masks(cfg, state, faults)
    observer_active, blocked_rows = edge_masks

    # 1. Failure-detector tick.
    fd_count, fd_hist, fd_fired, fire = _fd_tick(cfg, state, faults, observer_active)
    fire_round = torch.where(fire, state.round_idx, state.fire_round)
    alerts_emitted = fire.sum(dtype=torch.int32)

    # 2. Delivery, zeroed once every fired alert has matured (the JAX
    #    version skips the work with lax.cond; the select gives the same
    #    bits, since matured alerts are already merged into report_bits).
    last_mature = torch.where(fd_fired, fire_round, -1).max() + cfg.delivery_spread
    need_delivery = fd_fired.any() & (state.round_idx <= last_mature)
    delivered = _deliver_alerts(cfg, state, fire_round, blocked_rows)
    new_bits = torch.where(need_delivery, delivered, 0)
    heard_down = ((new_bits != 0) & state.alive[None, :]).any(1)

    # 3. Cut detection per cohort.
    report_bits, released, announced, seen_down, proposed_now, prop_masks = (
        cohort_watermark_pass(
            state.report_bits, new_bits, state.seen_down, state.released, state.announced,
            state.alive | state.join_pending, state.inval_obs, heard_down, cfg.h, cfg.l, cfg.k,
        )
    )
    prop_hi_new, prop_lo_new = masked_set_hash(state.id_hi, state.id_lo, prop_masks)
    prop_hi = torch.where(proposed_now, prop_hi_new, state.prop_hi)
    prop_lo = torch.where(proposed_now, prop_lo_new, state.prop_lo)
    prop_mask = torch.where(proposed_now[:, None], prop_masks, state.prop_mask)

    # 4. Fast-round votes, once per member per configuration.
    cohort = state.cohort_of.to(torch.int64)
    can_vote = state.alive & ~faults.crashed & ~state.vote_valid & announced[cohort]
    vote_hi = torch.where(can_vote, prop_hi[cohort], state.vote_hi)
    vote_lo = torch.where(can_vote, prop_lo[cohort], state.vote_lo)
    vote_valid = state.vote_valid | can_vote

    # 5. Quorum tally.
    tally = tally_candidates(
        vote_hi, vote_lo, vote_valid, prop_hi, prop_lo, announced, state.n_members
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
    any_announced = announced.any()
    stalled = any_announced & ~fast_decided
    rounds_undecided = torch.where(stalled, state.rounds_undecided + 1, state.rounds_undecided)
    fallback_due = (rounds_undecided >= cfg.fallback_rounds) & stalled

    # 5b. Classic fallback: a host branch (it is rare and costs a few
    #     [c, n] passes).
    fast_host, fallback_host = _host.read(torch.stack([fast_decided, fallback_due]))
    if fallback_host:
        *cp, fb_decided, chosen = _classic_attempt(cfg, state, faults, announced, cp)
        decided_host = fast_host or _host.read(fb_decided)
        classic_epoch = state.classic_epoch + 1
    else:
        fb_decided = torch.zeros((), dtype=torch.bool, device=dev)
        chosen = torch.full((), -1, dtype=torch.int32, device=dev)
        decided_host = fast_host
        classic_epoch = state.classic_epoch
    cp_rnd_r, cp_rnd_i, cp_vrnd_r, cp_vrnd_i, cp_vval_src = cp

    decided = fast_decided | fb_decided
    winner_cohort = torch.where(
        fast_decided,
        torch.argmax(
            (announced & (prop_hi == tally.winner_hi) & (prop_lo == tally.winner_lo)).to(
                torch.int32
            )
        ),
        chosen.clamp(min=0),
    )
    cohort_ids = torch.arange(c, dtype=torch.int64, device=dev)
    winner_mask = decided & (prop_mask & (cohort_ids == winner_cohort)[:, None]).any(0)

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
    return round_state, decided_host, winner_mask, events


def apply_view_change_impl(cfg: EngineConfig, state: EngineState, winner_mask) -> EngineState:
    """Commit a decided cut: flip membership, re-derive ring topology, reset
    the per-configuration state. Joiners not in the cut stay pending with
    their fired UP edges re-stamped to round 0."""
    n, k, c = cfg.n, cfg.k, cfg.c
    dev = state.alive.device
    alive2 = state.alive ^ winner_mask
    topo = ring_topology_from_perm(state.ring_perm, alive2)
    config_hi, config_lo = masked_set_hash(state.id_hi, state.id_lo, alive2)
    still_pending = state.join_pending & ~winner_mask
    fd_fired2 = state.fd_fired & still_pending[:, None]

    def zeros(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return state._replace(
        alive=alive2,
        retired=state.retired | (winner_mask & state.alive),
        obs_idx=torch.where(still_pending[None, :], state.obs_idx, topo.obs_idx),
        subj_idx=topo.subj_idx,
        inval_obs=torch.where(still_pending[None, :], state.inval_obs, topo.obs_idx),
        config_epoch=state.config_epoch + 1,
        config_hi=config_hi,
        config_lo=config_lo,
        n_members=alive2.sum(dtype=torch.int32),
        fd_count=zeros((n, k)),
        fd_hist=zeros((n, k)),
        fd_fired=fd_fired2,
        fire_round=torch.where(fd_fired2, 0, FIRE_NEVER).to(torch.int32),
        join_pending=still_pending,
        report_bits=zeros((c, n)),
        seen_down=zeros((c,), torch.bool),
        released=zeros((c, n), torch.bool),
        announced=zeros((c,), torch.bool),
        prop_mask=zeros((c, n), torch.bool),
        prop_hi=zeros((c,)),
        prop_lo=zeros((c,)),
        vote_hi=zeros((n,)),
        vote_lo=zeros((n,)),
        vote_valid=zeros((n,), torch.bool),
        rounds_undecided=zeros(()),
        cp_rnd_r=zeros((n,)),
        cp_rnd_i=zeros((n,)),
        cp_vrnd_r=zeros((n,)),
        cp_vrnd_i=zeros((n,)),
        cp_vval_src=torch.full((n,), -1, dtype=torch.int32, device=dev),
        classic_epoch=zeros(()),
        round_idx=zeros(()),
    )


def engine_step(
    cfg: EngineConfig, state: EngineState, faults: FaultInputs
) -> Tuple[EngineState, StepEvents, bool]:
    """One full round including the view change when it decided. Returns
    (state, events, decided)."""
    round_state, decided, winner_mask, events = _compute_round(cfg, state, faults)
    if decided:
        round_state = apply_view_change_impl(cfg, round_state, winner_mask)
    return round_state, events, decided


def run_to_decision(cfg: EngineConfig, state: EngineState, faults: FaultInputs, max_steps: int):
    """Rounds until a view change commits or ``max_steps`` run out. Returns
    (state, steps, decided, winner_mask)."""
    edge_masks = _edge_masks(cfg, state, faults)
    steps, decided = 0, False
    winner = torch.zeros((cfg.n,), dtype=torch.bool, device=state.alive.device)
    while not decided and steps < max_steps:
        state, decided, winner, _ = _compute_round(cfg, state, faults, edge_masks)
        steps += 1
    if decided:
        state = apply_view_change_impl(cfg, state, winner)
    return state, steps, decided, winner


def run_until_membership(
    cfg: EngineConfig,
    state: EngineState,
    faults: FaultInputs,
    target: int,
    max_steps: int,
    max_cuts: int,
    min_cuts: int,
):
    """Rounds through several view changes until the membership reaches
    ``target`` with at least ``min_cuts`` committed cuts, the step or cut
    budget runs out, or a convergence stalls undecided. Returns (state,
    total_steps, cuts, resolved, sizes) where ``sizes[i]`` is the
    membership after the i-th cut."""
    edge_masks = _edge_masks(cfg, state, faults)
    members = _host.read(state.n_members)
    steps, cuts, stalled, sizes = 0, 0, False, []
    while not (
        (members == target and cuts >= min_cuts)
        or stalled
        or steps >= max_steps
        or cuts >= max_cuts
    ):
        decided = False
        while not decided and steps < max_steps:
            state, decided, winner, _ = _compute_round(cfg, state, faults, edge_masks)
            steps += 1
        if decided:
            state = apply_view_change_impl(cfg, state, winner)
            edge_masks = _edge_masks(cfg, state, faults)
            members = _host.read(state.n_members)
            sizes.append(members)
            cuts += 1
        stalled = not decided
    resolved = members == target and cuts >= min_cuts
    return state, steps, cuts, resolved, sizes


class VirtualCluster:
    """Host driver around the engine: owns the state, injects faults and
    join waves, and runs rounds until convergence. Runs on CUDA unless
    ``device`` names another device."""

    def __init__(self, cfg: EngineConfig, state: EngineState):
        validate_config(cfg)
        self.cfg = cfg
        self.state = state
        self.device = state.alive.device
        self.faults = FaultInputs.none(cfg, self.device)
        self.last_decided = False

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
        state."""
        n = n_slots if n_slots is not None else n_members
        if n < n_members:
            raise ValueError(f"n_slots ({n}) < n_members ({n_members})")
        cfg = EngineConfig(
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
        validate_config(cfg)
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        key_hi = rng.integers(0, 2**32, size=(k, n), dtype=np.uint32)
        key_lo = rng.integers(0, 2**32, size=(k, n), dtype=np.uint32)
        id_hi = rng.integers(0, 2**32, size=(n,), dtype=np.uint32)
        id_lo = rng.integers(0, 2**32, size=(n,), dtype=np.uint32)
        alive = torch.zeros((n,), dtype=torch.bool, device=dev)
        alive[:n_members] = True
        state = initial_state(
            cfg,
            _u32.from_numpy(key_hi, dev),
            _u32.from_numpy(key_lo, dev),
            _u32.from_numpy(id_hi, dev),
            _u32.from_numpy(id_lo, dev),
            alive,
        )
        return cls(cfg, state)

    # -- fault & membership injection ----------------------------------

    def _slot_index(self, slots: Sequence[int]) -> torch.Tensor:
        """Bounds-checked slot indices on the device (torch would raise on a
        bad index on the CPU and assert on a card; this names the slots)."""
        arr = np.asarray(slots, dtype=np.int64).reshape(-1)
        if arr.size and (arr.min() < 0 or arr.max() >= self.cfg.n):
            raise IndexError(
                f"slot indices out of range [0, {self.cfg.n}): "
                f"{arr[(arr < 0) | (arr >= self.cfg.n)].tolist()}"
            )
        return torch.from_numpy(arr).to(self.device)

    def _set_crashed(self, idx: torch.Tensor, value: bool) -> None:
        crashed = self.faults.crashed.clone()
        crashed[idx] = value
        self.faults = self.faults._replace(crashed=crashed)

    def crash(self, slots: Sequence[int]) -> None:
        """Crash-stop the given slots (unresponsive until revived)."""
        self._set_crashed(self._slot_index(slots), True)

    def revive(self, slots: Sequence[int]) -> None:
        self._set_crashed(self._slot_index(slots), False)

    def _stamp_fired_edges(self, idx: torch.Tensor, edge_mask: torch.Tensor) -> None:
        """Mark (slot, ring) edges ``[j, k]`` as fired at the current round;
        the round body then applies rx-blocks and delivery delays."""
        state = self.state
        fd_fired = state.fd_fired.clone()
        fire_round = state.fire_round.clone()
        fd_fired[idx] = edge_mask
        fire_round[idx] = torch.where(edge_mask, state.round_idx, FIRE_NEVER).to(torch.int32)
        self.state = state._replace(fd_fired=fd_fired, fire_round=fire_round)

    def initiate_leave(self, slots: Sequence[int]) -> None:
        """Graceful batched leave: each leaver broadcasts its own departure
        on every ring (it becomes its own column's observer) and stops
        responding."""
        idx = self._slot_index(slots)
        obs_idx = self.state.obs_idx.clone()
        obs_idx[:, idx] = idx.to(torch.int32)[None, :].expand(self.cfg.k, -1)
        self.state = self.state._replace(obs_idx=obs_idx)
        self._stamp_fired_edges(
            idx, torch.ones((len(idx), self.cfg.k), dtype=torch.bool, device=self.device)
        )
        self._set_crashed(idx, True)

    def set_flaky_edges(self, probe_fail: np.ndarray) -> None:
        """Arbitrary per-(subject, ring) probe failures."""
        arr = torch.from_numpy(np.array(probe_fail, dtype=bool)).to(self.device)
        self.faults = self.faults._replace(probe_fail=arr)

    def stagger_fd_counts(self, rng: np.random.Generator, spread_rounds: int) -> None:
        """Randomize per-edge detection latency (negative initial counters),
        drawn from ``rng`` exactly as the JAX package draws them."""
        offsets = rng.integers(0, spread_rounds + 1, size=(self.cfg.n, self.cfg.k))
        fd_count = torch.from_numpy((-offsets).astype(np.int32)).to(self.device)
        self.state = self.state._replace(fd_count=fd_count)

    def inject_join_wave(self, slots: Sequence[int], check_admissible: bool = True) -> None:
        """Admit a batch of joiners: their gatekeepers (alive ring
        predecessors) become their observers and fire UP alerts on every
        ring, delivered like DOWN alerts. Current members, pending joiners
        and retired slots are refused (one read of ``[j]`` bools)."""
        slots = np.asarray(slots)
        state = self.state
        idx = self._slot_index(slots)
        if check_admissible:
            bad = np.asarray(_host.read((state.alive | state.join_pending | state.retired)[idx]))
            if bad.any():
                raise ValueError(
                    f"slots not admissible as joiners (member/pending/retired): "
                    f"{slots[bad].tolist()}"
                )
        pred = predecessor_of_keys(
            state.key_hi, state.key_lo, state.alive,
            state.key_hi[:, idx], state.key_lo[:, idx], perm=state.ring_perm,
        )  # [k, j]
        join_pending = state.join_pending.clone()
        obs_idx = state.obs_idx.clone()
        inval_obs = state.inval_obs.clone()
        join_pending[idx] = True
        obs_idx[:, idx] = pred
        inval_obs[:, idx] = pred
        self.state = state._replace(join_pending=join_pending, obs_idx=obs_idx, inval_obs=inval_obs)
        self._stamp_fired_edges(idx, (pred >= 0).T)

    def assign_cohorts(self, cohort_of: np.ndarray) -> None:
        arr = torch.from_numpy(np.array(cohort_of, dtype=np.int32)).to(self.device)
        self.state = self.state._replace(cohort_of=arr)

    def assign_cohorts_roundrobin(self) -> None:
        """Spread the N slots evenly over the C receiver cohorts."""
        self.assign_cohorts(np.arange(self.cfg.n, dtype=np.int32) % self.cfg.c)

    def set_rx_block(self, rx_block: np.ndarray) -> None:
        """Change per-cohort receive blocking and re-stamp every fired edge
        to the current round, so alerts redeliver to newly-hearing cohorts."""
        arr = torch.from_numpy(np.array(rx_block, dtype=bool)).to(self.device)
        self.faults = self.faults._replace(rx_block=arr)
        self.state = self.state._replace(
            fire_round=torch.where(self.state.fd_fired, self.state.round_idx, self.state.fire_round)
        )

    # -- execution ------------------------------------------------------

    def step(self) -> StepEvents:
        """One round (and the view change if it decided)."""
        self.state, events, self.last_decided = engine_step(self.cfg, self.state, self.faults)
        return events

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
        self.state, steps, decided, winner = run_to_decision(
            self.cfg, self.state, self.faults, max_steps
        )
        return steps, decided, winner, _host.read(self.state.n_members)

    def run_until_membership(
        self, target: int, max_steps: int = 192, max_cuts: int = 8, min_cuts: int = 0
    ) -> Tuple[int, int, bool, Tuple[int, ...]]:
        """Convergences with view changes between them until the membership
        reaches ``target``; returns (rounds, cuts, resolved, sizes)."""
        if not 0 <= target <= self.cfg.n:
            raise ValueError(f"target must be in [0, {self.cfg.n}]: {target}")
        self.state, steps, cuts, resolved, sizes = run_until_membership(
            self.cfg, self.state, self.faults, target, max_steps, max_cuts, min_cuts
        )
        return steps, cuts, resolved, tuple(sizes)

    # -- observers ------------------------------------------------------

    @property
    def membership_size(self) -> int:
        return _host.read(self.state.n_members)

    @property
    def alive_mask(self) -> np.ndarray:
        return self.state.alive.cpu().numpy()

    @property
    def config_epoch(self) -> int:
        return _host.read(self.state.config_epoch)

    @property
    def config_id(self) -> int:
        hi, lo = _host.read(_u32.widen(torch.stack([self.state.config_hi, self.state.config_lo])))
        return (hi << 32) | lo
