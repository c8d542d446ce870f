"""Invariant oracles executed after every simulated run.

Each oracle inspects a :class:`~rapid_tpu_torch.sim.scenario.RunResult` and
returns zero or more :class:`Violation` records. The set encodes the
protocol's safety and liveness claims (paper §3, §5):

- ``chain-consistency`` — no split-brain: the configuration chain is single.
  Node 0 (never faulted, participates in every decision) delivers the full
  chain; every other node's delivered configuration history must be an
  ordered subsequence of it (catch-up may legitimately SKIP configurations —
  a partition survivor pulls the latest — but may never interleave a
  configuration node 0 never had, i.e. a fork), and any two nodes that
  deliver the same configuration id must agree on its membership.
- ``monotonicity`` — no node ever re-delivers a configuration id: the chain
  only advances (the UUID/identifier-history discipline).
- ``agreement`` — strong consistency at rest: all live nodes end on the
  identical (configuration id, membership).
- ``membership-outcome`` — the final membership is exactly the schedule's
  surviving slots, and only slots the schedule removed were evicted
  (a KICKED on any other node is a false eviction).
- ``stability`` — the flaky/hostile-observer claim (paper §4.2, pushed to
  observers that LIE): a never-crashed subject whose cumulative false-report
  count stayed below H must never be evicted — in any cut, not just the
  final membership; past-H false reports may evict, but the wrong cut must
  still be one agreed, chain-consistent decision (the other oracles enforce
  that half once the schedule accounting counts the subject as removed).
- ``bounded-convergence`` — after the last fault heals, every live node
  reaches the final configuration within the schedule's simulated-time
  budget.
- ``differential`` — the host<->device oracle: the identical fault schedule
  replayed through the engine (``models/virtual_cluster.py``, on CUDA
  unless ``device`` names another device) must produce a cut sequence the
  host's refines, and the identical final membership.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from rapid_tpu_torch import _host
from rapid_tpu_torch.sim.faults import WATERMARK_H, FaultSchedule
from rapid_tpu_torch.sim.scenario import RunResult
from rapid_tpu_torch.types import EdgeStatus, Endpoint


@dataclass(frozen=True)
class Violation:
    oracle: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.oracle}] {self.detail}"


# ---------------------------------------------------------------------------
# chain / agreement / eviction oracles (host-only)
# ---------------------------------------------------------------------------


def check_chain_consistency(result: RunResult) -> List[Violation]:
    violations: List[Violation] = []
    reference = [cid for cid, _ in result.configs.get(0, [])]
    ref_index = {cid: i for i, cid in enumerate(reference)}
    membership_of: Dict[int, Tuple[Endpoint, ...]] = {}
    for slot, history in sorted(result.configs.items()):
        for cid, members in history:
            seen = membership_of.setdefault(cid, members)
            if set(seen) != set(members):
                violations.append(Violation(
                    "chain-consistency",
                    f"configuration {cid:#x} has two memberships: slot {slot} "
                    f"delivered {sorted(map(str, members))}, another node "
                    f"{sorted(map(str, seen))}",
                ))
        if slot == 0:
            continue
        positions = [ref_index.get(cid) for cid, _ in history]
        unknown = [f"{cid:#x}" for (cid, _), p in zip(history, positions) if p is None]
        if unknown:
            violations.append(Violation(
                "chain-consistency",
                f"slot {slot} delivered configurations the reference chain "
                f"(node 0) never had — a fork: {unknown}",
            ))
            continue
        if any(b <= a for a, b in zip(positions, positions[1:])):
            violations.append(Violation(
                "chain-consistency",
                f"slot {slot}'s configuration history is not an ordered "
                f"subsequence of the reference chain: positions {positions}",
            ))
    return violations


def check_monotonicity(result: RunResult) -> List[Violation]:
    violations: List[Violation] = []
    for slot, history in sorted(result.configs.items()):
        ids = [cid for cid, _ in history]
        if len(set(ids)) != len(ids):
            repeated = sorted({f"{c:#x}" for c in ids if ids.count(c) > 1})
            violations.append(Violation(
                "monotonicity",
                f"slot {slot} re-delivered configuration id(s) {repeated}",
            ))
    return violations


def check_agreement(result: RunResult) -> List[Violation]:
    finals = {}
    for slot in result.live_slots:
        history = result.configs.get(slot, [])
        if not history:
            return [Violation("agreement", f"slot {slot} has no delivered configuration")]
        cid, members = history[-1]
        finals[slot] = (cid, frozenset(members))
    if len(set(finals.values())) > 1:
        lines = ", ".join(
            f"slot {s}: cfg={cid:#x} n={len(m)}" for s, (cid, m) in sorted(finals.items())
        )
        return [Violation("agreement", f"live nodes disagree at rest: {lines}")]
    return []


def check_membership_outcome(result: RunResult) -> List[Violation]:
    violations: List[Violation] = []
    s = result.schedule
    joined: Set[int] = set(range(s.n0))
    for event in s.events:
        if event.kind in ("join", "restart"):
            joined |= set(event.slots)
    expected_slots = joined - s.expected_removed_slots()
    expected = {result.endpoints[i] for i in sorted(expected_slots)}
    if result.final_membership != expected:
        violations.append(Violation(
            "membership-outcome",
            f"final membership {sorted(map(str, result.final_membership))} != "
            f"schedule's surviving slots {sorted(map(str, expected))}",
        ))
    # KICKED legitimacy is judged against ever-removed, not final-removed: a
    # restarted slot's previous incarnation may rightly discover its own
    # eviction after the fresh incarnation already rejoined.
    false_evictions = set(result.kicked) - s.ever_removed_slots()
    if false_evictions:
        violations.append(Violation(
            "membership-outcome",
            f"healthy slots evicted (KICKED): {sorted(false_evictions)} — "
            "only schedule-removed slots may be kicked",
        ))
    return violations


def check_stability(result: RunResult) -> List[Violation]:
    """The paper's stability claim, extended to HOSTILE observers (the half
    the reference's evaluation never tests): a never-crashed subject whose
    cumulative FALSE-report count stayed below the H watermark must never
    be evicted — not in the final membership (membership-outcome covers
    that) and not in ANY intermediate cut or KICKED signal (this oracle's
    addition: a transient wrongful eviction would slip past an
    outcome-only check). False alerts pushed past H MAY evict — the
    adversary can buy a wrong cut — but the schedule accounting then counts
    the subject as removed, so chain-consistency, agreement, and
    membership-outcome still enforce that the wrong cut is ONE agreed,
    chain-consistent decision."""
    s = result.schedule
    lied_about = {
        int(e.args["subject"])  # type: ignore[arg-type]
        for e in s.events
        if e.kind in ("false_alert", "alert_storm")
    }
    if not lied_about:
        return []
    crossed = {sub for sub, _ in s.adversarial_crossings().values()}
    # Subjects also removed by HONEST schedule events (crash/leave/...) are
    # legitimately evicted regardless of the lies; judge only the rest.
    honestly_removed = {
        slot
        for e in s.events
        if e.kind in ("crash", "leave", "partition_oneway", "committee_crash")
        for slot in e.slots
    }
    protected = lied_about - crossed - honestly_removed
    violations: List[Violation] = []
    for subject in sorted(protected):
        endpoint = result.endpoints[subject]
        for i, cut in enumerate(result.cuts):
            if (endpoint, EdgeStatus.DOWN) in cut:
                violations.append(Violation(
                    "stability",
                    f"slot {subject} was cut DOWN (cut {i}) although its "
                    f"false-report count stayed below H={WATERMARK_H} and it "
                    f"never failed — sub-H reports must delay, not trigger, "
                    f"a view change",
                ))
                break
        if subject in result.kicked:
            violations.append(Violation(
                "stability",
                f"slot {subject} observed its own eviction (KICKED) although "
                f"its false-report count stayed below H={WATERMARK_H}",
            ))
    return violations


def check_bounded_convergence(result: RunResult) -> List[Violation]:
    if result.aborted_at_event is not None:
        return [Violation(
            "bounded-convergence",
            f"run aborted at event {result.aborted_at_event}: a membership "
            f"phase did not converge within its budget",
        )]
    if not result.final_converged:
        return [Violation(
            "bounded-convergence",
            f"live nodes did not reach one view within "
            f"{result.schedule.converge_budget_ms:.0f} simulated ms of the "
            f"schedule's end",
        )]
    return []


# ---------------------------------------------------------------------------
# differential host<->device oracle
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# the full battery
# ---------------------------------------------------------------------------

HOST_ORACLES = (
    check_chain_consistency,
    check_monotonicity,
    check_agreement,
    check_membership_outcome,
    check_stability,
    check_bounded_convergence,
)


def check_all(
    result: RunResult, differential: bool = True, device=None
) -> List[Violation]:
    """Run every oracle; returns all violations (empty = the run upheld
    every invariant). ``differential=False`` skips the engine replay (used
    by shrink loops, which re-verify the surviving violation set against
    the full battery at the end). The replay runs on CUDA unless ``device``
    names another device."""
    violations: List[Violation] = []
    for oracle in HOST_ORACLES:
        violations.extend(oracle(result))
    if differential:
        violations.extend(check_differential(result, device))
    return violations
