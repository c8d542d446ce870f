"""The engine half of the chaos oracles (port of ``rapid_tpu/sim/oracles.py``).

- :class:`Violation`, the record every oracle returns;
- :func:`cuts_refine`, THE refinement check between a fine cut sequence and
  coarse per-phase groups;
- :func:`inject_engine_event`, the host-event -> engine-seam mapping shared
  by the engine replay and the fleet chaos compiler
  (:mod:`rapid_tpu_torch.tenancy.chaos`);
- :func:`replay_through_engine`, a schedule's membership phases replayed
  through one engine cluster (on CUDA unless ``device`` names another);
- :func:`check_differential`, the host<->device oracle: the host run's cut
  sequence must refine the engine replay's, and the final memberships must
  match. It reads any result object with the JAX package's ``RunResult``
  fields it needs (``schedule``, ``endpoints``, ``cuts``,
  ``final_membership``, ``final_converged``, ``aborted_at_event``).

The host oracles (chain consistency, monotonicity, agreement, membership
outcome, stability, bounded convergence) and ``check_all`` read the host
runner's ``RunResult``, which the port does not have.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Set, Tuple

import numpy as np

from rapid_tpu_torch import _host
from rapid_tpu_torch.sim.faults import FaultSchedule
from rapid_tpu_torch.types import EdgeStatus, Endpoint


@dataclass(frozen=True)
class Violation:
    oracle: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.oracle}] {self.detail}"


def cuts_refine(fine_cuts: Sequence[Set], coarse_groups: Sequence[Sequence[frozenset]]):
    """None when ``fine_cuts`` is a refinement of ``coarse_groups``, else a
    human-readable mismatch description.

    Refinement: the fine sequence partitions each coarse group's union into
    consecutive sub-cuts — it may split a cut the coarser observer commits
    whole (sub-interval alert timing), but may never produce an element
    outside the current group's union, reorder across groups, or leave a
    group's union unreached. Strict equality is the degenerate refinement
    (each group one cut, each fine cut the whole union)."""
    fine = [set(c) for c in fine_cuts]
    i = 0
    for group in coarse_groups:
        target = set().union(*group) if group else set()
        acc: set = set()
        while acc != target:
            if i >= len(fine) or not fine[i] <= target:
                return (
                    f"cut sequence does not refine the reference: "
                    f"fine={fine_cuts} coarse={coarse_groups}"
                )
            acc |= fine[i]
            i += 1
    if i != len(fine):
        return (
            f"cut sequence has cuts beyond the reference's: "
            f"fine={fine_cuts} coarse={coarse_groups}"
        )
    return None


def inject_engine_event(vc, event) -> int:
    """Apply one membership-phase event to an engine cluster and return its
    expected-membership delta — THE host-event -> engine-seam mapping,
    shared by the differential replay below and the fleet chaos compiler, so
    the two can never diverge on what a schedule means at the engine grain:

    - ``join``/``leave`` — the engine's own injection seams;
    - ``crash``/``partition_oneway``/``committee_crash`` — detector-identical
      crash-stops (the engine has no committee; the victim's removal is
      what the membership chain must agree on);
    - ``false_alert``/``alert_storm`` (H-crossing, normalized by
      ``membership_phases`` to carry the cumulative ring set) — per-(subject,
      ring) probe failures (``set_flaky_edges``): the engine's observers of
      those rings report DOWN about the healthy subject.

    Every index is checked on the host before anything reaches the device:
    the slot seams raise the JAX package's ``IndexError``, and the lie's
    (subject, rings) index a host copy of the probe lanes (one counted
    read), so a bad event raises a catchable error and never a device-side
    assert."""
    kind, slots, args = event.kind, list(event.slots), event.args
    if kind == "join":
        vc.inject_join_wave(slots)
        return len(slots)
    if kind == "leave":
        vc.initiate_leave(slots)
        return -len(slots)
    if kind in ("false_alert", "alert_storm"):
        subject = int(args["subject"])
        rings = [int(r) for r in args["rings"]]
        probe = np.array(_host.read(vc.faults.probe_fail), dtype=bool)
        vc._account_d2h(probe.nbytes)
        probe[subject, rings] = True
        vc.set_flaky_edges(probe)
        return -1  # only H-crossing lies appear in phase groups
    # crash / partition_oneway / committee_crash are detector-identical.
    vc.crash(slots)
    return -len(slots)


def replay_through_engine(
    schedule: FaultSchedule, endpoints: Sequence[Endpoint], device=None
) -> Tuple[List[List[frozenset]], Set[Endpoint]]:
    """Replay the schedule's membership phases through one engine cluster
    (same ring topology as the host view, matched FD/batching semantics: one
    engine round = one detector interval, fd_threshold=1 for the host's
    static detector, delivery_spread=0 for the in-process transport's
    same-window delivery), on CUDA unless ``device`` names another device.
    Returns (cuts per phase group, final membership), each cut a frozenset
    of ``(endpoint, EdgeStatus)`` pairs. Environment-only faults (loss,
    delay, symmetric partitions that heal) change no membership and are not
    replayed — by the protocol's own claim they must not affect WHAT is
    decided, only when, which is exactly what comparing against this replay
    verifies."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    if not schedule.engine_compatible:
        raise ValueError("schedule contains restarts (engine slots are spent forever)")
    vc = VirtualCluster.from_endpoints(
        list(endpoints), n_slots=len(endpoints), n_members=schedule.n0,
        k=10, h=9, l=4, fd_threshold=1, delivery_spread=0, device=device,
    )
    groups: List[List[frozenset]] = []
    expected = schedule.n0
    for group in schedule.membership_phases():
        for event in group:
            expected += inject_engine_event(vc, event)
        cuts: List[frozenset] = []
        # One decision per injected event at most; overlapped groups may
        # resolve in fewer cuts (one combined decision) or one per event.
        for _ in range(len(group) + 1):
            was_alive = vc.alive_mask
            rounds, decided, winner, n_members = vc.run_to_decision(max_steps=48)
            if not decided:
                raise AssertionError(
                    f"engine did not decide for phase group {group}"
                )
            mask = winner.cpu().numpy()
            vc._account_d2h(mask.nbytes)
            cuts.append(frozenset(
                (
                    endpoints[s],
                    EdgeStatus.DOWN if was_alive[s] else EdgeStatus.UP,
                )
                for s in np.nonzero(mask)[0].tolist()
            ))
            if n_members == expected:
                break
        else:
            raise AssertionError(f"phase group {group} never reached {expected}")
        groups.append(cuts)
    alive = vc.alive_mask
    final = {endpoints[s] for s in np.nonzero(alive)[0].tolist()}
    return groups, final


def check_differential(result, device=None) -> List[Violation]:
    """The host run's cut sequence must refine the engine replay's, group by
    group, and the final memberships must match. Refinement (not strict
    per-cut equality): within one multi-node phase the host's sub-interval
    alert timing can split a cut the round-granular engine commits whole.
    Skipped (empty result) when the run did not converge — the convergence
    oracles own that failure — or when the schedule is not engine-replayable
    (restarts)."""
    if not result.final_converged or result.aborted_at_event is not None:
        return []
    if not result.schedule.engine_compatible:
        return []
    try:
        engine_groups, engine_final = replay_through_engine(
            result.schedule, result.endpoints, device
        )
    except AssertionError as exc:
        return [Violation("differential", f"engine replay failed: {exc}")]
    if engine_final != result.final_membership:
        return [Violation(
            "differential",
            f"final membership diverged: host "
            f"{sorted(map(str, result.final_membership))} vs engine "
            f"{sorted(map(str, engine_final))}",
        )]
    mismatch = cuts_refine(result.cuts, engine_groups)
    if mismatch is not None:
        return [Violation("differential", f"host vs engine: {mismatch}")]
    return []
