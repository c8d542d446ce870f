"""Schedule-space search: seeded generation, named families, shrinking.

Three pieces:

- **Named scenario families** — the four canonical adverse-network shapes
  (partition-heal, asymmetric link, crash-during-join, churn-under-loss),
  the ADVERSARIAL shapes (false-alert stability, watermark probe — Byzantine
  observers lying against the H/L watermarks, scenarios the paper's
  honest-but-flaky evaluation never reached), and the WAN-shaped
  hierarchical-membership shapes (inter-cohort loss/latency asymmetry,
  delegate gray failure, cohort-boundary flapping, committee crash during
  reconfiguration — ``profile="hier"``, run over the two-level protocol of
  :mod:`rapid_tpu_torch.hier`), each a seeded generator over a fixed slot
  geometry so every (family, seed) pair is one pinned, replayable scenario.
  The tier-1 chaos smoke runs a pinned grid of these; ``tools/chaosrun.py``
  runs them by name over the JAX package only (the port has no CLI).
- **Random schedules** — :func:`random_schedule` draws arbitrary mixes of
  membership phases and environment faults, sized to keep the cluster
  decidable (slot 0 never faulted, enough reachable voters for a classic
  majority, partitions always healed) so a violation means the PROTOCOL
  broke, not the scenario.
- **The shrinker** — :func:`shrink` greedily minimizes an oracle-violating
  schedule: drop events, shrink fault sets, zero dwell times — accepting a
  reduction only if the original violation (same oracle set) still fires.
  The result is the smallest repro the greedy pass can reach, which is what
  gets written to disk and attached to the bug.

All geometry is shared (``N0``/``N_SLOTS``), so every scenario's engine
cluster has one shape and a fleet of them stacks. Whatever runs the
differential replay (:func:`replay`, :func:`fuzz`) takes a trailing
``device`` (CUDA unless it names another); :func:`shrink` runs without it.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from rapid_tpu_torch.hier.cohorts import CohortMap
from rapid_tpu_torch.sim.faults import (
    WATERMARK_H,
    WATERMARK_L,
    FaultEvent,
    FaultSchedule,
    ScheduleError,
)
from rapid_tpu_torch.sim.oracles import Violation, check_all
from rapid_tpu_torch.sim.scenario import (
    RunResult,
    ScenarioRunner,
    endpoints_for,
    hier_sim_settings,
)

#: One slot geometry for every generated scenario: 8 initial members, a
#: 4-slot joiner pool. Small enough that a full run is cheap, large enough
#: that H=9-of-K=10 cut detection, fast-quorum arithmetic (7 of 8), and the
#: classic fallback (majority 5) are all exercised.
N0 = 8
N_SLOTS = 12


def _initial_live(rng: random.Random) -> List[int]:
    """Non-seed initial members, shuffled — faultable in draw order."""
    live = list(range(1, N0))
    rng.shuffle(live)
    return live


# ---------------------------------------------------------------------------
# the flat named families
# ---------------------------------------------------------------------------


def partition_heal(seed: int) -> FaultSchedule:
    """One-way partition across a crash decision, then heal: the blocked
    members' ingress is dead through the view change — they miss the
    decision (and hold the fast round below quorum, so the CLASSIC path
    decides) and must re-join the configuration through config pulls, first
    through the partition, then after the heal."""
    rng = random.Random(f"partition-heal:{seed}")
    pool = _initial_live(rng)
    blocked, victim = sorted(pool[:2]), pool[2]
    return FaultSchedule(
        n0=N0, n_slots=N_SLOTS, seed=seed, name=f"partition_heal/{seed}",
        events=[
            FaultEvent("ingress_block", tuple(blocked), dwell_ms=500),
            FaultEvent("crash", (victim,), dwell_ms=1_000),
            FaultEvent("heal_partitions", dwell_ms=500),
        ],
    )


def asymmetric_link(seed: int) -> FaultSchedule:
    """A one-way ingress partition (the victim still sends — the asymmetric
    failure the paper's §1 motivates): observers evict it; a fresh joiner
    then arrives through the healed network."""
    rng = random.Random(f"asymmetric-link:{seed}")
    pool = _initial_live(rng)
    victim, skewed = pool[0], pool[1]
    joiner = N0 + (seed % (N_SLOTS - N0))
    return FaultSchedule(
        n0=N0, n_slots=N_SLOTS, seed=seed, name=f"asymmetric_link/{seed}",
        events=[
            FaultEvent("clock_skew", (skewed,), args={"offset_ms": 350.0}),
            FaultEvent("partition_oneway", (victim,), dwell_ms=1_000),
            FaultEvent("heal_partitions", dwell_ms=500),
            FaultEvent("join", (joiner,), dwell_ms=500),
        ],
    )


def crash_during_join(seed: int) -> FaultSchedule:
    """A join wave overlapped with a crash (settle=False): the join's UP
    alerts and the crash's DOWN alerts race into the same cut detectors —
    the straddling-configuration shape of the fixed-scenario oracle."""
    rng = random.Random(f"crash-during-join:{seed}")
    pool = _initial_live(rng)
    victim = pool[0]
    joiners = tuple(range(N0, N0 + 2))
    return FaultSchedule(
        n0=N0, n_slots=N_SLOTS, seed=seed, name=f"crash_during_join/{seed}",
        events=[
            FaultEvent("join", joiners, settle=False),
            FaultEvent("crash", (victim,), dwell_ms=1_000),
        ],
    )


def churn_under_loss(seed: int) -> FaultSchedule:
    """Sustained 5% symmetric message loss (plus duplication) while the
    membership churns — joins, a crash, a graceful leave. The delivery-
    liveness machinery (alert redelivery, config-sync pulls) must absorb
    the loss; the decided cuts must be exactly the clean-network ones."""
    rng = random.Random(f"churn-under-loss:{seed}")
    pool = _initial_live(rng)
    victim, leaver = pool[0], pool[1]
    joiners = tuple(range(N0, N0 + 2))
    return FaultSchedule(
        n0=N0, n_slots=N_SLOTS, seed=seed, name=f"churn_under_loss/{seed}",
        events=[
            FaultEvent("loss", args={"permille": 50}),
            FaultEvent("duplicate", args={"permille": 20}),
            FaultEvent("join", joiners, dwell_ms=500),
            FaultEvent("crash", (victim,), dwell_ms=500),
            FaultEvent("leave", (leaver,), dwell_ms=500),
            FaultEvent("loss", args={"permille": 0}),
        ],
    )


# ---------------------------------------------------------------------------
# adversarial families: Byzantine observers against the H/L watermarks
# ---------------------------------------------------------------------------


def false_alert_stability(seed: int) -> FaultSchedule:
    """The paper's stability claim, tested against an observer that LIES:
    a Byzantine liar claims a seeded number of distinct rings in [L, H)
    about a healthy subject, then three more colluders re-claim the SAME
    rings (an idempotent storm — per-ring dedup must keep the count where
    it is). The cumulative tally sits in the stable band for the whole run:
    no view change may fire, the subject stays in every view, and once the
    lies cease the cluster is simply converged (it never moved)."""
    rng = random.Random(f"false-alert-stability:{seed}")
    pool = _initial_live(rng)
    liar, subject = pool[0], pool[1]
    colluders = tuple(sorted(pool[2:5]))
    reports = rng.randint(WATERMARK_L, WATERMARK_H - 1)
    rings = list(range(reports))
    return FaultSchedule(
        n0=N0, n_slots=N_SLOTS, seed=seed, name=f"false_alert_stability/{seed}",
        events=[
            FaultEvent("false_alert", (liar,),
                       args={"subject": subject, "rings": rings},
                       dwell_ms=2_000),
            FaultEvent("alert_storm", colluders,
                       args={"subject": subject, "rings": rings},
                       dwell_ms=2_000),
        ],
    )


def watermark_probe(seed: int) -> FaultSchedule:
    """Adversarially timed against the exact watermark boundary: one liar
    holds the subject's count at a seeded value in [L, H) for a dwell (the
    stable band — no view change), then a storm of colluders tops the
    cumulative count up to EXACTLY H. The healthy subject is evicted — the
    adversary wins that much — but the eviction must be one agreed,
    chain-consistent cut: every node delivers the same (wrong) view."""
    rng = random.Random(f"watermark-probe:{seed}")
    pool = _initial_live(rng)
    liar, subject = pool[0], pool[1]
    colluders = tuple(sorted(pool[2:4]))
    hold = rng.randint(WATERMARK_L, WATERMARK_H - 1)
    return FaultSchedule(
        n0=N0, n_slots=N_SLOTS, seed=seed, name=f"watermark_probe/{seed}",
        events=[
            FaultEvent("false_alert", (liar,),
                       args={"subject": subject, "rings": list(range(hold))},
                       dwell_ms=1_500),
            FaultEvent("alert_storm", colluders,
                       args={"subject": subject,
                             "rings": list(range(hold, WATERMARK_H))},
                       dwell_ms=1_000),
        ],
    )


# ---------------------------------------------------------------------------
# WAN-shaped hierarchical families (rapid_tpu_torch/hier; profile="hier")
# ---------------------------------------------------------------------------


def hier_geometry(seed: int):
    """The cohort structure of the INITIAL 8-member hierarchical cluster for
    a family seed: (cohort map, slot-of-endpoint). Deterministic — the
    generator reasons about the exact cohorts the runner will boot, so a
    family can aim a fault at a real delegate or a real cohort boundary."""
    settings = hier_sim_settings()
    endpoints = endpoints_for(seed, N_SLOTS)
    cmap = CohortMap(
        endpoints[:N0], settings.hier_seed, settings.hier_target_cohort_size
    )
    slot_of = {ep: i for i, ep in enumerate(endpoints)}
    return cmap, endpoints, slot_of


def wan_cohort_asym(seed: int) -> FaultSchedule:
    """Inter-cohort latency/loss asymmetry: the cohort on the far side of a
    lossy, slow WAN boundary (25% cross-boundary loss, +20..120 ms
    cross-boundary delay) loses a member and admits a joiner. The cohort-
    local fast path never crosses the boundary — detection and cohort
    agreement run at LAN speed — and only the thin global tier pays the WAN;
    its redelivery/classic machinery must absorb the loss."""
    cmap, endpoints, slot_of = hier_geometry(seed)
    rng = random.Random(f"wan-cohort-asym:{seed}")
    seed_cohort = cmap.cohort_of(endpoints[0])
    far = next(c for c in range(cmap.n_cohorts) if c != seed_cohort)
    group = sorted(slot_of[ep] for ep in cmap.members_of(far))
    victim = rng.choice(group)
    joiner = N0 + (seed % (N_SLOTS - N0))
    return FaultSchedule(
        n0=N0, n_slots=N_SLOTS, seed=seed, profile="hier",
        name=f"wan_cohort_asym/{seed}",
        events=[
            FaultEvent("wan_asym", tuple(group),
                       args={"loss_permille": 250, "delay_min_ms": 20.0,
                             "delay_max_ms": 120.0}),
            FaultEvent("crash", (victim,), dwell_ms=1_000),
            FaultEvent("join", (joiner,), dwell_ms=500),
            FaultEvent("wan_asym", args={"loss_permille": 0}),
        ],
    )


def delegate_gray_failure(seed: int) -> FaultSchedule:
    """Gray failure of a delegate: a global-committee member keeps SENDING
    (its egress is open) but hears nothing (ingress partitioned) — the
    asymmetric half-death that wedges naive leader-based designs. Its
    cohort must detect it, decide the cut without it, fail over the
    forwarding chain, and the committee must decide classically around the
    unresponsive member; a joiner then lands through the healed network."""
    cmap, endpoints, slot_of = hier_geometry(seed)
    rng = random.Random(f"delegate-gray:{seed}")
    committee = [ep for ep in cmap.committee() if ep != endpoints[0]]
    victim = slot_of[rng.choice(committee)]
    skew_pool = [s for s in range(1, N0) if s != victim]
    skewed = rng.choice(skew_pool)
    joiner = N0 + (seed % (N_SLOTS - N0))
    return FaultSchedule(
        n0=N0, n_slots=N_SLOTS, seed=seed, profile="hier",
        name=f"delegate_gray_failure/{seed}",
        events=[
            FaultEvent("clock_skew", (skewed,), args={"offset_ms": 250.0}),
            FaultEvent("partition_oneway", (victim,), dwell_ms=1_000),
            FaultEvent("heal_partitions", dwell_ms=500),
            FaultEvent("join", (joiner,), dwell_ms=500),
        ],
    )


def cohort_boundary_flap(seed: int) -> FaultSchedule:
    """Flapping across the cohort boundary: one inter-cohort link blocks
    and heals repeatedly — in both directions — while a join overlaps a
    crash. The flap touches only cross-cohort traffic (the global tier and
    config pulls); cohort-local detection must stay quiet about it (no
    false evictions of the flapping link's endpoints) and the overlapped
    churn must still serialize into one consistent chain."""
    cmap, endpoints, slot_of = hier_geometry(seed)
    rng = random.Random(f"boundary-flap:{seed}")
    seed_cohort = cmap.cohort_of(endpoints[0])
    far = next(c for c in range(cmap.n_cohorts) if c != seed_cohort)
    near_pool = [
        slot_of[ep] for ep in cmap.members_of(seed_cohort) if ep != endpoints[0]
    ]
    far_pool = sorted(slot_of[ep] for ep in cmap.members_of(far))
    a = rng.choice(near_pool)
    b, victim = rng.sample(far_pool, 2)
    joiner = N0 + (seed % (N_SLOTS - N0))
    return FaultSchedule(
        n0=N0, n_slots=N_SLOTS, seed=seed, profile="hier",
        name=f"cohort_boundary_flap/{seed}",
        events=[
            FaultEvent("link_block", args={"src": a, "dst": b}, dwell_ms=400),
            FaultEvent("link_heal", args={"src": a, "dst": b}, dwell_ms=200),
            FaultEvent("link_block", args={"src": b, "dst": a}, dwell_ms=400),
            FaultEvent("join", (joiner,), settle=False),
            FaultEvent("crash", (victim,), dwell_ms=800),
            FaultEvent("link_heal", args={"src": b, "dst": a}, dwell_ms=300),
        ],
    )


def committee_crash_during_reconfig(seed: int) -> FaultSchedule:
    """Crash a global-committee member INSIDE the hier reconfiguration
    window (the committee-crash shape of "Reconfigurable Atomic Transaction
    Commit", arXiv:1906.01365): the armed tripwire fires the instant the
    triggering crash's cohort cut is forwarded to the committee — after
    forwarding, before the global decision. The committee must still decide
    (classic fallback around the dead member), the cohort forwarding chain
    must fail over, and the dead committee member is detected and evicted
    in a follow-up cut — two removals, one consistent chain."""
    cmap, endpoints, slot_of = hier_geometry(seed)
    rng = random.Random(f"committee-crash:{seed}")
    committee = [ep for ep in cmap.committee() if ep != endpoints[0]]
    victim = slot_of[rng.choice(committee)]
    # The trigger must be a NON-committee member: the committee is static
    # for the configuration and sized 2 per cohort, so losing the armed
    # victim AND a committee-member trigger would drop the global tier
    # below its classic majority — a legitimate wedge, but a different
    # scenario (quorum loss) than the reconfiguration-window crash this
    # family pins.
    committee_slots = {slot_of[ep] for ep in cmap.committee()}
    trigger_pool = [
        s for s in range(1, N0) if s != victim and s not in committee_slots
    ]
    trigger = rng.choice(trigger_pool)
    return FaultSchedule(
        n0=N0, n_slots=N_SLOTS, seed=seed, profile="hier",
        name=f"committee_crash_during_reconfig/{seed}",
        events=[
            FaultEvent("committee_crash", (victim,), settle=False),
            FaultEvent("crash", (trigger,), dwell_ms=1_000),
        ],
    )


FAMILIES: Dict[str, Callable[[int], FaultSchedule]] = {
    "partition_heal": partition_heal,
    "asymmetric_link": asymmetric_link,
    "crash_during_join": crash_during_join,
    "churn_under_loss": churn_under_loss,
    "false_alert_stability": false_alert_stability,
    "watermark_probe": watermark_probe,
    "wan_cohort_asym": wan_cohort_asym,
    "delegate_gray_failure": delegate_gray_failure,
    "cohort_boundary_flap": cohort_boundary_flap,
    "committee_crash_during_reconfig": committee_crash_during_reconfig,
}


def scenario_family(name: str, seed: int) -> FaultSchedule:
    try:
        return FAMILIES[name](seed)
    except KeyError:
        raise ScheduleError(
            f"unknown scenario family {name!r}; known: {sorted(FAMILIES)}"
        ) from None


# ---------------------------------------------------------------------------
# random schedules
# ---------------------------------------------------------------------------


def random_schedule(seed: int, phases: Optional[int] = None) -> FaultSchedule:
    """A seeded random mix of membership phases and environment faults over
    the shared geometry. Sizing rules keep every schedule decidable — a
    violation means the protocol broke, not the scenario: slot 0 is never
    faulted, at most 2 slots are ingress-blocked at once, full symmetric
    partitions only appear as (partition, heal) brackets with no membership
    phase in between (spanning one can legitimately wedge detection below
    H — the shape reserved for the shrinker's violating schedules), every
    block heals, loss stays <= 8%, and membership never drops below 2/3 of
    its peak."""
    rng = random.Random(f"rapid-fuzz:{seed}")
    live = set(range(N0))
    peak = N0
    fresh = list(range(N0, N_SLOTS))
    removed: List[int] = []
    events: List[FaultEvent] = []
    partitioned = False
    blocked_now: set = set()

    lossy = rng.random() < 0.5
    if lossy:
        events.append(FaultEvent("loss", args={"permille": rng.choice([20, 50, 80])}))
    if rng.random() < 0.3:
        events.append(FaultEvent("duplicate", args={"permille": 20}))
    if rng.random() < 0.3:
        events.append(FaultEvent(
            "delay", args={"min_ms": 0.0, "max_ms": float(rng.choice([50, 150]))}
        ))

    for _ in range(phases if phases is not None else rng.randint(2, 4)):
        floor = (peak * 2) // 3
        removable = len(live) - floor
        choices = ["join", "crash", "leave", "partition_oneway"]
        if removed:
            choices.append("restart")
        if not partitioned and removable >= 2 and rng.random() < 0.4:
            blocked = rng.sample(sorted(live - {0}), rng.randint(1, 2))
            events.append(
                FaultEvent("ingress_block", tuple(sorted(blocked)), dwell_ms=500)
            )
            partitioned = True
            blocked_now = set(blocked)
        elif not partitioned and rng.random() < 0.2:
            # A full symmetric partition, healed before the next membership
            # phase: a sub-detection-threshold network blip the cluster must
            # ride out without any membership effect.
            blipped = rng.sample(sorted(live - {0}), 1)
            events.append(FaultEvent("partition", tuple(blipped), dwell_ms=1_000))
            events.append(FaultEvent("heal_partitions", dwell_ms=500))
        kind = rng.choice(choices)
        if kind in ("join", "restart") and blocked_now:
            # An admission while members are ingress-blocked can wedge
            # legitimately: if >= K-H+1 of the joiner's gatekeepers cannot
            # RECEIVE its phase-2 join messages, the admission cut sits
            # below H until the heal — a real protocol property, but not a
            # schedule that must converge. Generated schedules admit only
            # on an unblocked network; the pinned chaos soak covers the
            # join-under-partition shapes that do work.
            kind = "crash"
        if kind == "join" and fresh:
            size = rng.randint(1, min(2, len(fresh)))
            slots = [fresh.pop(0) for _ in range(size)]
            events.append(FaultEvent("join", tuple(slots), dwell_ms=500))
            live |= set(slots)
            peak = max(peak, len(live))
        elif kind == "restart" and removed:
            slot = removed.pop(0)
            events.append(FaultEvent("restart", (slot,), dwell_ms=500))
            live.add(slot)
            peak = max(peak, len(live))
        # Quorum headroom: the decision evicting this phase's victims runs
        # inside the PRE-phase configuration (majority of len(live)), and
        # neither the victims nor the ingress-blocked members can vote (the
        # blocked cannot hear the proposal). Reachable voters must keep a
        # classic majority or the phase wedges until the heal — a real
        # protocol property, but not a schedule that must converge.
        # Under sustained loss, a margin-less quorum (exactly majority
        # reachable) can stall for many simulated seconds — every consensus
        # message of some round must land. Keep one voter of slack.
        max_victims = (
            len(live) - len(blocked_now) - (len(live) // 2 + 1) - (1 if lossy else 0)
        )
        if kind == "crash" and removable >= 1 and max_victims >= 1:
            candidates = sorted(live - {0} - blocked_now)
            if not candidates:
                continue
            size = rng.randint(1, min(2, removable, max_victims, len(candidates)))
            slots = rng.sample(candidates, size)
            events.append(FaultEvent("crash", tuple(sorted(slots)), dwell_ms=500))
            live -= set(slots)
            removed.extend(slots)
        elif kind in ("leave", "partition_oneway") and removable >= 1 and max_victims >= 1:
            candidates = sorted(live - {0} - blocked_now)
            if not candidates:
                continue
            slot = rng.choice(candidates)
            events.append(FaultEvent(kind, (slot,), dwell_ms=500))
            live -= {slot}
            removed.append(slot)
        if partitioned and rng.random() < 0.6:
            events.append(FaultEvent("heal_partitions", dwell_ms=500))
            partitioned = False
            blocked_now = set()

    if partitioned:
        events.append(FaultEvent("heal_partitions", dwell_ms=500))
    events.append(FaultEvent("loss", args={"permille": 0}))
    schedule = FaultSchedule(
        n0=N0, n_slots=N_SLOTS, seed=seed, name=f"fuzz/{seed}", events=events
    )
    schedule.validate()
    return schedule


# ---------------------------------------------------------------------------
# running, shrinking, replaying
# ---------------------------------------------------------------------------


def run_schedule(schedule: FaultSchedule) -> RunResult:
    return ScenarioRunner(schedule).run()


def _violation_names(violations: Iterable[Violation]) -> frozenset:
    return frozenset(v.oracle for v in violations)


def _shrink_candidates(schedule: FaultSchedule) -> Iterable[FaultSchedule]:
    """Reductions in decreasing aggressiveness: drop an event, drop one slot
    from a multi-slot fault, zero a dwell. Each candidate revalidates, so a
    reduction that orphans a later event (e.g. removing a join whose slot is
    later crashed) is skipped, not crashed on."""
    events = schedule.events

    def rebuilt(new_events: List[FaultEvent]) -> FaultSchedule:
        return FaultSchedule(
            n0=schedule.n0, n_slots=schedule.n_slots, seed=schedule.seed,
            events=new_events, converge_budget_ms=schedule.converge_budget_ms,
            phase_budget_ms=schedule.phase_budget_ms, name=schedule.name,
            profile=schedule.profile,
        )

    for i in range(len(events)):
        yield rebuilt(events[:i] + events[i + 1:])
    for i, event in enumerate(events):
        if len(event.slots) > 1:
            for j in range(len(event.slots)):
                slots = event.slots[:j] + event.slots[j + 1:]
                reduced = FaultEvent(
                    event.kind, slots, dict(event.args), event.dwell_ms, event.settle
                )
                yield rebuilt(events[:i] + [reduced] + events[i + 1:])
    for i, event in enumerate(events):
        if event.dwell_ms > 0:
            reduced = FaultEvent(
                event.kind, event.slots, dict(event.args), 0.0, event.settle
            )
            yield rebuilt(events[:i] + [reduced] + events[i + 1:])


def shrink(
    schedule: FaultSchedule,
    violations: List[Violation],
    max_runs: int = 80,
) -> Tuple[FaultSchedule, List[Violation], int]:
    """Greedily minimize an oracle-violating schedule: accept any reduction
    under which every oracle of the ORIGINAL violation set still fires.
    The differential oracle is excluded from the preserved set — the loop
    re-runs candidates without the (expensive) engine replay, so it could
    never observe a differential violation and would otherwise reject every
    reduction; callers re-verify the final repro with the full battery.
    Returns (minimal schedule, its violations, runs spent)."""
    target = _violation_names(violations) - {"differential"}
    if not target:
        if _violation_names(violations):
            raise ValueError(
                "cannot shrink a differential-only violation: the shrink "
                "loop runs without the engine replay"
            )
        raise ValueError("nothing to shrink: the schedule passed its oracles")
    current, current_violations = schedule, violations
    runs = 0
    improved = True
    while improved and runs < max_runs:
        improved = False
        for candidate in _shrink_candidates(current):
            if runs >= max_runs:
                break
            try:
                candidate.validate()
            except ScheduleError:
                continue
            result = run_schedule(candidate)
            runs += 1
            got = check_all(result, differential=False)
            if target <= _violation_names(got):
                current, current_violations = candidate, got
                improved = True
                break
    return current, current_violations, runs


def write_repro(
    result: RunResult,
    violations: List[Violation],
    directory,
) -> Path:
    """The full repro artifact: the run's schedule and captures, plus the
    violations it proves."""
    directory = Path(result.write_repro(directory))
    (directory / "violations.txt").write_text(
        "".join(f"{v}\n" for v in violations) or "(none)\n"
    )
    return directory


def replay(directory, device=None) -> Tuple[RunResult, List[Violation]]:
    """Re-run a written repro: loads ``schedule.json`` and replays it (same
    seed, same draws, same simulated clock) through the full oracle
    battery. Deterministic: the violations reproduce exactly."""
    schedule = FaultSchedule.from_json(
        (Path(directory) / "schedule.json").read_text()
    )
    result = run_schedule(schedule)
    return result, check_all(result, device=device)


def fuzz(
    seeds: Iterable[int],
    out_dir=None,
    shrink_failures: bool = True,
    device=None,
) -> List[dict]:
    """Run random schedules over ``seeds``; on any oracle violation, shrink
    to a minimal repro and (when ``out_dir`` is given) write it to
    ``<out_dir>/seed<N>/``. Returns one summary dict per seed."""
    summaries = []
    for seed in seeds:
        schedule = random_schedule(seed)
        result = run_schedule(schedule)
        violations = check_all(result, device=device)
        summary: dict = {
            "seed": seed,
            "events": len(schedule.events),
            "violations": [str(v) for v in violations],
        }
        if violations and shrink_failures:
            minimal, _, runs = shrink(schedule, violations)
            summary["shrunk_events"] = len(minimal.events)
            summary["shrink_runs"] = runs
            if out_dir is not None:
                repro_dir = Path(out_dir) / f"seed{seed}"
                # Re-verify the minimal schedule with the FULL battery
                # (shrink ran without the differential replay): the repro's
                # recorded violations must be exactly what a replay sees,
                # or `replay` (or the JAX package's `chaosrun replay`) would flag
                # its own artifact.
                min_result = run_schedule(minimal)
                write_repro(min_result, check_all(min_result, device=device), repro_dir)
                summary["repro"] = str(repro_dir)
        summaries.append(summary)
    return summaries
