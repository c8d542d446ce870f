"""Fleet-scale batched chaos: hundreds of adversarial scenarios per
dispatch, the oracle battery checked tenant by tenant, and a per-tenant
shrinker that collapses a violating fleet to a single-tenant repro (port of
``rapid_tpu/tenancy/chaos.py``; every compile, run, shrink, write and
replay takes ``device``, CUDA unless it names another, and the repro files
are the JAX package's, readable by either).

The single-cluster differential oracle (``sim/oracles.replay_through_engine``)
compiles ONE fault schedule's membership phases onto ONE engine; this module
is its fleet twin: B ``(family, seed)`` pairs from ``sim/fuzz.py`` — honest
adverse-network shapes, ADVERSARIAL shapes (Byzantine observers lying
against the H/L watermarks), and the hier×tenancy cross-product (the
WAN-shaped hierarchical families' cohort structure and churn compiled per
tenant) — each an independent seeded scenario, compile onto B per-tenant
clusters with independent fault inputs, stack into one
:class:`~rapid_tpu_torch.tenancy.fleet.TenantFleet`, and resolve phase group by
phase group with ONE fleet-wave dispatch per group (B scenarios'
convergences per dispatch, however differently they churn). After the
groups, a STABILITY SOAK steps the whole stacked fleet a fixed number of
plain rounds so tenants carrying sub-H false-report loads demonstrably hold
the stable band (a frozen tenant proves nothing — the soak is what makes
"no eviction" a run, not a vacuous skip). Scenario diversity and throughput
in one workload — ``run_fleet`` reports wall clock and a first-class
``scenarios_per_sec``, the number ``bench.py``'s ``chaos`` stage and
``chaosrun fuzz --fleet`` publish.

The per-tenant verdicts mirror the sim battery's oracle vocabulary at the
engine grain, every violation naming its tenant index (no cross-tenant
bleed — one tenant's broken chain must never taint its neighbors' verdicts,
pinned in the JAX package's tests and, against it, in
tests/test_torch_chaos.py):

- ``fleet-convergence`` — every phase group resolved within its budget;
- ``fleet-membership`` — final alive slots are exactly the schedule's
  surviving slots;
- ``fleet-chain-consistency`` — the tenant's configuration chain only
  advances: per-phase config ids all distinct, epochs strictly increasing;
- ``fleet-stability`` — a tenant whose only hostile load is sub-H false
  reports committed a cut during the soak (the stable band leaked);
- ``fleet-injection`` — a scenario's fault injection itself failed
  mid-``run_fleet``; the tenant is named and frozen instead of the whole
  fleet dying on a bare exception.

When a violation fires, :func:`shrink_tenant` greedily minimizes ONLY the
violating tenant's schedule — every other tenant replaced by quiescent
filler so each probe run stays one fleet dispatch at the original fleet
shape — and :func:`write_fleet_repro` collapses the result to a
single-tenant repro directory in the sim schedule format, replayable by
:func:`replay_fleet_repro` here or in the JAX package (whose ``chaosrun
replay`` recognizes the ``fleet.json`` marker).

Host reads on the card: the fleet's per-group observations (config ids,
epochs, sizes) and the final alive lanes are counted reads after each wave;
the soak's per-round decided flags are summed on the device and read once.
Each tenant's cluster gets views of the stacked fleet's lanes back after a
wave (``TenantFleet.tenant_state``); every injection seam stores
out-of-place, so the next group's injections never write the fleet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rapid_tpu_torch import _host
from rapid_tpu_torch.models.state import map_lanes
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
from rapid_tpu_torch.sim.faults import (
    WATERMARK_H,
    WATERMARK_K,
    WATERMARK_L,
    FaultEvent,
    FaultSchedule,
)
from rapid_tpu_torch.sim.fuzz import hier_geometry, scenario_family
from rapid_tpu_torch.sim.oracles import Violation, inject_engine_event
from rapid_tpu_torch.sim.scenario import endpoints_for
from rapid_tpu_torch.tenancy.fleet import TenantFleet

#: Engine-replayable flat families (restart-bearing schedules are excluded
#: by engine_compatible). The adversarial flat families ride the same
#: geometry: stable-band lies compile to persistent sub-H probe-fail loads,
#: H-crossing lies to membership-bearing phase groups.
ENGINE_FAMILIES = (
    "partition_heal",
    "asymmetric_link",
    "crash_during_join",
    "churn_under_loss",
    "false_alert_stability",
    "watermark_probe",
)

#: The hier×tenancy cross-product: the hierarchical families' cohort
#: structure (the seeded CohortMap of the initial cluster, mapped onto the
#: engine's receiver-cohort axis) and membership churn compiled per tenant.
#: Environment-only faults (WAN loss/delay, link flaps, clock skew) have no
#: round-granular engine analog and are not replayed — the same contract as
#: the differential oracle: they must change WHEN, never WHAT, is decided.
HIER_FAMILIES = (
    "wan_cohort_asym",
    "delegate_gray_failure",
    "cohort_boundary_flap",
    "committee_crash_during_reconfig",
)

#: Everything the fleet fuzzer mixes per dispatch, in DISPATCH order:
#: adversarial shapes lead so any fleet size B >= 1 carries Byzantine
#: coverage — ``fleet_specs`` cycles this tuple, and a small-B run must
#: still be an ADVERSARIAL workload, not four honest churn scenarios
#: wearing the chaos label.
FLEET_FAMILIES = (
    "false_alert_stability",
    "committee_crash_during_reconfig",
    "watermark_probe",
    "partition_heal",
    "wan_cohort_asym",
    "crash_during_join",
    "delegate_gray_failure",
    "churn_under_loss",
    "cohort_boundary_flap",
    "asymmetric_link",
)

#: The default per-tenant knob triple (h, l, fd_threshold): the reference
#: watermarks the schedules' own accounting uses — deriving it (instead of
#: re-typing 9/4) keeps a Settings retune from silently forking the
#: compiler's defaults away from what validate()/adversarial_crossings()
#: judge against (the knob/schedule-mismatch shape stays an EXPLICIT act).
DEFAULT_KNOBS = (WATERMARK_H, WATERMARK_L, 1)

#: Plain rounds stepped after the phase groups so stable-band tenants
#: demonstrably hold: enough rounds for a (wrongly) released cut to decide
#: if the detector leaked, small enough to stay negligible per dispatch.
STABILITY_SOAK_ROUNDS = 12

#: Ring capacity of the repro verify run: large enough to hold a shrunk
#: schedule's full round history (shrunk repros resolve in a handful of
#: short phase groups), so the ``trace.json`` artifact usually carries
#: every round the repro executed, not just a tail window.
REPRO_TRACE_R = 64


@dataclass
class TenantScenario:
    """One tenant's compiled scenario: the schedule, its engine cluster, and
    the host-side expectations the oracles check against."""

    family: str
    seed: int
    schedule: FaultSchedule
    vc: VirtualCluster
    groups: List[List[FaultEvent]]
    expected_slots: frozenset  # surviving slot indices at the end
    knobs: Tuple[int, int, int] = DEFAULT_KNOBS
    delivery_spread: int = 0
    #: Subjects carrying a sub-H false-report load for the whole run — the
    #: stability soak asserts these tenants commit NO cut.
    stable_subjects: frozenset = frozenset()

    @property
    def name(self) -> str:
        return f"{self.family}/{self.seed}"


@dataclass
class PhaseRecord:
    resolved: bool
    cuts: int
    config_id: int
    config_epoch: int
    members: int


@dataclass
class FleetRunResult:
    """What one batched chaos run observed, per tenant — the oracle input."""

    scenarios: List[TenantScenario]
    phases: List[List[PhaseRecord]] = field(default_factory=list)
    final_slots: List[frozenset] = field(default_factory=list)
    dispatches: int = 0
    total_rounds: int = 0
    total_cuts: int = 0
    #: Mid-run per-tenant failures (injection raised) as (tenant index,
    #: already-formed violation) pairs, prepended by check_fleet — a broken
    #: scenario must never surface as a bare exception that kills the
    #: other B-1 tenants' verdicts. The index rides structurally (never
    #: re-parsed out of the formatted message).
    errors: List[Tuple[int, Violation]] = field(default_factory=list)
    #: Cuts each tenant committed during the stability soak (None = no soak).
    soak_cuts: Optional[np.ndarray] = None
    soak_rounds: int = 0
    #: Wall clock of the whole batched run and the first-class throughput
    #: number it buys: scenarios resolved per second of fleet dispatch.
    wall_ms: float = 0.0
    scenarios_per_sec: float = 0.0


def _hier_cohort_of(seed: int, n_slots: int) -> np.ndarray:
    """The engine receiver-cohort assignment for a hier-profile tenant: the
    family's own seeded CohortMap over the initial members (so a fault
    aimed at a real cohort boundary lands on the same structure the host
    protocol would build), joiner slots round-robin."""
    cmap, endpoints, slot_of = hier_geometry(seed)
    cohort_of = np.zeros(n_slots, dtype=np.int32)
    for ep, slot in slot_of.items():
        if slot < len(endpoints) and cmap.is_member(ep):
            cohort_of[slot] = cmap.cohort_of(ep)
    n0 = sum(1 for ep in slot_of if cmap.is_member(ep))
    for slot in range(n0, n_slots):
        cohort_of[slot] = slot % cmap.n_cohorts
    return cohort_of


def compile_schedule(
    schedule: FaultSchedule,
    family: str,
    seed: int,
    knobs: Tuple[int, int, int] = DEFAULT_KNOBS,
    delivery_spread: int = 0,
    telemetry: bool = False,
    trace: int = 0,
    device=None,
) -> TenantScenario:
    """Compile one schedule onto a per-tenant engine cluster (on ``device``) — the same
    event mapping the differential oracle uses (``inject_engine_event``),
    with the tenant's ``(h, l, fd_threshold)`` knobs on top. ``trace``
    additionally carries the round-trace ring (implies telemetry) — engine
    results are bit-identical with or without either plane.

    Sub-H false-report loads (the stable band) are applied HERE, as
    persistent per-(subject, ring) probe failures: they are environment-
    shaped (membership never changes), so they ride every subsequent round
    of every group and the stability soak. H-crossing lies arrive as
    membership-bearing phase groups, normalized by ``membership_phases`` to
    carry the cumulative ring set.

    Note the deliberate asymmetry: the schedule's OWN accounting (does this
    lie evict?) always uses the reference watermarks (``WATERMARK_H``),
    while the tenant may run different knobs — a knob/schedule mismatch is
    exactly the violating-fleet shape the shrinker regression pins."""
    if not schedule.engine_compatible:
        raise ValueError(
            f"{family}/{seed}: schedule is not engine-replayable (restarts "
            f"spend engine slots forever)"
        )
    endpoints = endpoints_for(seed, schedule.n_slots)
    h, l, fd_threshold = knobs
    vc = VirtualCluster.from_endpoints(
        endpoints, n_slots=len(endpoints), n_members=schedule.n0,
        k=WATERMARK_K, h=h, l=l, fd_threshold=fd_threshold,
        delivery_spread=delivery_spread,
        telemetry=telemetry or bool(trace), trace=trace, device=device,
    )
    if schedule.profile == "hier":
        vc.assign_cohorts(_hier_cohort_of(seed, schedule.n_slots))
    # Persistent sub-H lies: everything claimed about subjects that never
    # cross H. (Crossing subjects' rings arrive with their phase group.)
    crossed = {s for s, _ in schedule.adversarial_crossings().values()}
    stable: Dict[int, set] = {}
    for event in schedule.events:
        if event.kind not in ("false_alert", "alert_storm"):
            continue
        if str(event.args.get("status", "DOWN")) != "DOWN":
            continue
        subject = int(event.args["subject"])  # type: ignore[arg-type]
        if subject in crossed:
            continue
        stable.setdefault(subject, set()).update(
            int(r) for r in event.args.get("rings", ())  # type: ignore[union-attr]
        )
    if stable:
        probe = np.zeros((schedule.n_slots, WATERMARK_K), dtype=bool)
        for subject, rings in stable.items():
            assert len(rings) < WATERMARK_H
            probe[subject, sorted(rings)] = True
        vc.set_flaky_edges(probe)
    joined = set(range(schedule.n0))
    for event in schedule.events:
        if event.kind in ("join", "restart"):
            joined |= set(event.slots)
    expected = frozenset(joined - schedule.expected_removed_slots())
    return TenantScenario(
        family=family,
        seed=seed,
        schedule=schedule,
        vc=vc,
        groups=schedule.membership_phases(),
        expected_slots=expected,
        knobs=tuple(knobs),
        delivery_spread=delivery_spread,
        stable_subjects=frozenset(stable),
    )


def compile_tenant(
    family: str,
    seed: int,
    knobs: Tuple[int, int, int] = DEFAULT_KNOBS,
    delivery_spread: int = 0,
    telemetry: bool = False,
    device=None,
) -> TenantScenario:
    """Compile one named ``(family, seed)`` scenario (sim/fuzz.py) onto a
    per-tenant engine cluster. ``telemetry=True`` carries the device
    telemetry plane — engine results are bit-identical either way."""
    return compile_schedule(
        scenario_family(family, seed), family, seed, knobs, delivery_spread,
        telemetry, device=device,
    )


def compile_quiescent(
    seed: int,
    knobs: Tuple[int, int, int] = DEFAULT_KNOBS,
    delivery_spread: int = 0,
    n0: int = 8,
    n_slots: int = 12,
    device=None,
) -> TenantScenario:
    """An event-free filler tenant at the shared geometry: it idles through
    every wave for free (already at target, zero cuts demanded). The
    shrinker swaps these in for every non-violating tenant so a probe run
    keeps the original fleet shape — one dispatch, same compiled program."""
    schedule = FaultSchedule(
        n0=n0, n_slots=n_slots, seed=seed, name=f"quiescent/{seed}"
    )
    return compile_schedule(
        schedule, "quiescent", seed, knobs, delivery_spread, device=device
    )


def compile_fleet(
    specs: Sequence[Tuple[str, int]],
    knobs: Optional[Sequence[Tuple[int, int, int]]] = None,
    delivery_spread: int = 0,
    telemetry: bool = False,
    device=None,
) -> List[TenantScenario]:
    """One compiled scenario per ``(family, seed)`` spec — honest, hostile,
    and hier families freely mixed. All families share the fuzz geometry
    (``N0``/``N_SLOTS``), so the B clusters stack into one fleet; ``knobs``
    optionally varies (h, l, fd_threshold) per tenant; ``delivery_spread``
    is fleet-static (it pins the compiled program) and applies to every
    tenant."""
    if knobs is not None and len(knobs) != len(specs):
        raise ValueError(f"need {len(specs)} knob triples, got {len(knobs)}")
    return [
        compile_tenant(
            family, seed, knobs[i] if knobs else DEFAULT_KNOBS,
            delivery_spread, telemetry, device,
        )
        for i, (family, seed) in enumerate(specs)
    ]


def _restore_trace_rings(
    fleet: TenantFleet, scenarios: Sequence[TenantScenario]
) -> None:
    """Hand each tenant's slice of the fleet's trace ring back to its
    cluster, so the ring stays continuous across the per-group
    ``from_clusters`` restacks (the same continuity ``vc.state`` gets
    above). No-op for untraced fleets — device-side slicing, no fetch. A
    single cluster's ring has no tenant axis, so each tenant gets its
    row."""
    if fleet.trace_ring is None:
        return
    for i, scenario in enumerate(scenarios):
        scenario.vc.trace_ring = map_lanes(lambda lane, t=i: lane[t], fleet.trace_ring)


def _inject_group(vc: VirtualCluster, group: List[FaultEvent]) -> int:
    """Apply one membership phase group's events to a tenant's cluster via
    the shared host-event -> engine-seam mapping. Returns the membership
    delta."""
    return sum(inject_engine_event(vc, event) for event in group)


def run_fleet(
    scenarios: Sequence[TenantScenario],
    max_steps: int = 64,
    max_cuts: int = 8,
    soak_rounds: Optional[int] = None,
) -> FleetRunResult:
    """Resolve every tenant's scenario, phase group by phase group: inject
    group ``g`` into each tenant that still has one, stack, and resolve the
    whole fleet in ONE wave dispatch per group (tenants whose schedule ran
    out of groups idle for free — already at target, zero cuts demanded),
    then soak ``soak_rounds`` plain fleet rounds (default: the stability
    soak when any tenant carries a sub-H false-report load, else none).

    A tenant whose injection RAISES is frozen and reported as a
    ``fleet-injection`` violation naming its index — never a bare exception
    (the mid-run plumbing). Per-tenant observations
    land in a :class:`FleetRunResult` for :func:`check_fleet`, alongside
    the run's wall clock and ``scenarios_per_sec``. The run happens where
    the scenarios' clusters were compiled."""
    scenarios = list(scenarios)
    started = time.perf_counter()
    result = FleetRunResult(scenarios=scenarios)
    result.phases = [[] for _ in scenarios]
    expected = [s.schedule.n0 for s in scenarios]
    dead = [False] * len(scenarios)
    n_groups = max((len(s.groups) for s in scenarios), default=0)
    fleet: Optional[TenantFleet] = None
    for g in range(n_groups):
        min_cuts = []
        for i, scenario in enumerate(scenarios):
            if not dead[i] and g < len(scenario.groups):
                try:
                    expected[i] += _inject_group(scenario.vc, scenario.groups[g])
                    min_cuts.append(1)
                except Exception as exc:  # noqa: BLE001 — named, not propagated
                    dead[i] = True
                    result.errors.append((i, Violation(
                        "fleet-injection",
                        f"tenant {i} ({scenario.name}): phase group {g} "
                        f"injection failed: {exc!r}",
                    )))
                    expected[i] = scenario.vc.membership_size
                    min_cuts.append(0)
            else:
                min_cuts.append(0)
        fleet = TenantFleet.from_clusters([s.vc for s in scenarios])
        rounds, cuts, resolved, _sizes = fleet.run_until_membership(
            expected, max_steps=max_steps, max_cuts=max_cuts,
            min_cuts=min_cuts,
        )
        config_ids = fleet.config_ids()
        epochs = fleet.config_epochs()
        members = fleet.membership_sizes()
        result.dispatches += 1
        result.total_rounds += int(rounds.sum())
        result.total_cuts += int(cuts.sum())
        for i, scenario in enumerate(scenarios):
            scenario.vc.state = fleet.tenant_state(i)
            result.phases[i].append(PhaseRecord(
                resolved=bool(resolved[i]),
                cuts=int(cuts[i]),
                config_id=config_ids[i],
                config_epoch=int(epochs[i]),
                members=int(members[i]),
            ))
        _restore_trace_rings(fleet, scenarios)

    if soak_rounds is None:
        soak_rounds = (
            STABILITY_SOAK_ROUNDS
            if any(s.stable_subjects for s in scenarios)
            else 0
        )
    if soak_rounds > 0:
        # The stability soak: plain lockstep rounds with NO targets — every
        # tenant steps (a wave would freeze already-at-target tenants, and
        # a frozen detector proves nothing about the stable band).
        fleet = TenantFleet.from_clusters([s.vc for s in scenarios])
        decided_rounds = []
        for _ in range(soak_rounds):
            events = fleet.step()
            decided_rounds.append(events.decided)
        soak_cuts = torch.stack(decided_rounds).to(torch.int32).sum(0)
        result.soak_cuts = np.asarray(_host.read(soak_cuts, "chaos_soak"), dtype=np.int32)
        fleet._account_d2h(result.soak_cuts.nbytes)
        result.soak_rounds = soak_rounds
        result.dispatches += soak_rounds
        result.total_rounds += soak_rounds * len(scenarios)
        result.total_cuts += int(result.soak_cuts.sum())
        for i, scenario in enumerate(scenarios):
            scenario.vc.state = fleet.tenant_state(i)
        _restore_trace_rings(fleet, scenarios)

    if fleet is not None:
        alive = fleet.state.alive.cpu().numpy()  # host-read-ok: the run's final membership for the oracles
        fleet._account_d2h(alive.nbytes)
    else:
        alive = np.stack([s.vc.alive_mask for s in scenarios])
    result.final_slots = [
        frozenset(np.nonzero(alive[i])[0].tolist())
        for i in range(len(scenarios))
    ]
    result.wall_ms = (time.perf_counter() - started) * 1000.0
    result.scenarios_per_sec = (
        len(scenarios) / (result.wall_ms / 1000.0) if result.wall_ms > 0 else 0.0
    )
    return result


# ---------------------------------------------------------------------------
# The per-tenant oracle battery
# ---------------------------------------------------------------------------


def check_fleet(result: FleetRunResult) -> List[Violation]:
    """Run every fleet oracle over every tenant's record; each violation
    names its tenant index and scenario. One tenant's defect must never
    leak into another's verdict — the checks below consult ONLY tenant
    ``i``'s record when judging tenant ``i``. Mid-run injection failures
    (already tenant-named) come first; an errored tenant is otherwise
    skipped (its state is whatever the failure left behind — judging it
    would manufacture noise)."""
    violations: List[Violation] = [v for _, v in result.errors]
    errored = {t for t, _ in result.errors}
    for i, scenario in enumerate(result.scenarios):
        if i in errored:
            continue
        label = f"tenant {i} ({scenario.name})"
        records = result.phases[i]
        for g, record in enumerate(records):
            if not record.resolved:
                violations.append(Violation(
                    "fleet-convergence",
                    f"{label}: phase group {g} unresolved after "
                    f"{record.cuts} cut(s)",
                ))
        if result.final_slots and result.final_slots[i] != scenario.expected_slots:
            violations.append(Violation(
                "fleet-membership",
                f"{label}: final membership slots "
                f"{sorted(result.final_slots[i])} != schedule's surviving "
                f"slots {sorted(scenario.expected_slots)}",
            ))
        chain = [r.config_id for r in records if r.cuts > 0]
        if len(set(chain)) != len(chain):
            repeated = sorted({f"{c:#x}" for c in chain if chain.count(c) > 1})
            violations.append(Violation(
                "fleet-chain-consistency",
                f"{label}: configuration id(s) {repeated} re-delivered — "
                f"the chain must only advance",
            ))
        epochs = [r.config_epoch for r in records]
        if any(b < a for a, b in zip(epochs, epochs[1:])):
            violations.append(Violation(
                "fleet-chain-consistency",
                f"{label}: config epochs regressed across phases: {epochs}",
            ))
        if (
            scenario.stable_subjects
            and result.soak_cuts is not None
            and int(result.soak_cuts[i]) > 0
        ):
            violations.append(Violation(
                "fleet-stability",
                f"{label}: committed {int(result.soak_cuts[i])} cut(s) "
                f"during the stability soak although its false-report "
                f"count stayed below H — sub-H reports must delay, not "
                f"trigger, a view change",
            ))
    return violations


def violating_tenants(violations: Sequence[Violation]) -> Dict[int, List[str]]:
    """tenant index -> the oracle names that flagged it (the no-bleed
    assertion's grain). Every fleet violation — including mid-run injection
    failures — carries the ``tenant <i> (<name>): ...`` detail prefix, so
    this parse is total over the battery's output."""
    out: Dict[int, List[str]] = {}
    for violation in violations:
        prefix = violation.detail.split(":", 1)[0]  # "tenant <i> (<name>)"
        idx = int(prefix.split()[1])
        out.setdefault(idx, []).append(violation.oracle)
    return out


# ---------------------------------------------------------------------------
# Per-tenant shrinking + the single-tenant fleet repro
# ---------------------------------------------------------------------------


def shrink_tenant(
    scenarios: Sequence[TenantScenario],
    violations: Sequence[Violation],
    max_runs: int = 32,
    max_steps: int = 64,
    device=None,
) -> Tuple[int, FaultSchedule, List[Violation], int]:
    """Greedily minimize ONLY the violating tenant's schedule: every other
    tenant is replaced by quiescent filler so each probe run keeps the
    original fleet shape (one dispatch, same compiled wave program), and a
    reduction is accepted only if the SAME oracle set still flags the SAME
    tenant index. Returns (tenant index, minimal schedule, the minimal
    run's violations, probe runs spent). With multiple violating tenants
    the lowest index is shrunk (one repro per run keeps the artifact
    readable; rerun for the rest). Each probe fleet is compiled on
    ``device``."""
    from rapid_tpu_torch.sim.fuzz import _shrink_candidates

    by_tenant = violating_tenants(violations)
    if not by_tenant:
        raise ValueError("nothing to shrink: the fleet upheld every oracle")
    t = min(by_tenant)
    target = frozenset(by_tenant[t])
    victim = scenarios[t]

    def probe(schedule: FaultSchedule) -> Tuple[frozenset, List[Violation]]:
        row = [
            compile_schedule(
                schedule, victim.family, victim.seed, victim.knobs,
                victim.delivery_spread, device=device,
            )
            if i == t
            else compile_quiescent(
                s.seed, s.knobs, s.delivery_spread,
                n0=s.schedule.n0, n_slots=s.schedule.n_slots, device=device,
            )
            for i, s in enumerate(scenarios)
        ]
        got = check_fleet(run_fleet(row, max_steps=max_steps))
        return frozenset(violating_tenants(got).get(t, [])), got

    current = victim.schedule
    current_violations = list(violations)
    runs = 0
    improved = True
    while improved and runs < max_runs:
        improved = False
        for candidate in _shrink_candidates(current):
            if runs >= max_runs:
                break
            try:
                candidate.validate()
            except Exception:  # noqa: BLE001 — invalid reduction, skip
                continue
            if not candidate.engine_compatible:
                continue
            runs += 1
            got_oracles, got = probe(candidate)
            if target <= got_oracles:
                current, current_violations = candidate, got
                improved = True
                break
    return t, current, current_violations, runs


def write_fleet_repro(
    directory,
    schedule: FaultSchedule,
    knobs: Tuple[int, int, int],
    family: str,
    seed: int,
    delivery_spread: int = 0,
    tenant_index: int = 0,
    fleet_size: int = 1,
    device=None,
) -> Path:
    """Collapse a shrunk violating tenant to a single-tenant repro dir in
    the sim schedule format: ``schedule.json`` (the repro itself),
    ``fleet.json`` (the engine-side compile recipe — knobs, family, the
    original tenant index and fleet size for provenance), ``violations.txt``
    re-verified by ONE fresh single-tenant fleet run (tenant index 0 — what
    a replay will see), and ``trace.json`` — the verify run's decoded
    round-trace ring (capacity :data:`REPRO_TRACE_R`), the write-time round
    history ``replay_trace_divergence`` diffs a replay against to name the
    first divergent round. The verify run carries the ring on top of the
    engine (bit-identical either way — the trace differential the HLO gate
    pins), so the artifact costs no extra run. The verify run happens on
    ``device``; the files are the JAX package's, and its ``chaosrun
    replay`` reads them."""
    import json

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    single = compile_schedule(
        schedule, family, seed, knobs, delivery_spread,
        telemetry=True, trace=REPRO_TRACE_R, device=device,
    )
    verified = check_fleet(run_fleet([single]))
    # Repro-write boundary — the verify run is over; sync() fetches the
    # ring's digest once and decodes it (vc.trace).
    single.vc.sync()
    summary = single.vc.trace
    (directory / "trace.json").write_text(
        json.dumps(summary, indent=1, sort_keys=True) + "\n"
    )
    (directory / "schedule.json").write_text(schedule.to_json())
    (directory / "fleet.json").write_text(json.dumps({
        "version": 1,
        "family": family,
        "seed": seed,
        "knobs": list(knobs),
        "delivery_spread": delivery_spread,
        "tenant_index": tenant_index,
        "fleet_size": fleet_size,
    }, indent=1) + "\n")
    (directory / "violations.txt").write_text(
        "".join(f"{v}\n" for v in verified) or "(none)\n"
    )
    return directory


def replay_fleet_repro(directory, device=None) -> Tuple[FleetRunResult, List[Violation]]:
    """Re-run a single-tenant fleet repro: compile the schedule with the
    recorded knobs onto one engine tenant (on ``device``), run, and return
    the violations — deterministic, so a written repro reproduces exactly
    (and a repro that STOPS failing is itself news worth printing)."""
    import json

    directory = Path(directory)
    recipe = json.loads((directory / "fleet.json").read_text())
    schedule = FaultSchedule.from_json((directory / "schedule.json").read_text())
    scenario = compile_schedule(
        schedule,
        str(recipe.get("family", "repro")),
        int(recipe.get("seed", schedule.seed)),
        tuple(recipe.get("knobs", DEFAULT_KNOBS)),
        int(recipe.get("delivery_spread", 0)),
        device=device,
    )
    result = run_fleet([scenario])
    return result, check_fleet(result)


def replay_trace_divergence(directory, device=None) -> Optional[dict]:
    """Diff a repro dir's written ``trace.json`` (the decoded round-trace
    ring frozen at write time) against a fresh trace-enabled replay of the
    same schedule. Returns None for pre-trace repro dirs (no artifact —
    older repros stay replayable); otherwise a dict carrying both runs'
    recorded-round counts and ``first_divergent_round`` — the global round
    ordinal where the two histories fork, or None when the rings agree
    record for record (the deterministic-repro invariant). This is the
    round-granular instrument behind ``chaosrun replay``: when verdicts
    diverge, it names WHERE, not just that they did. The replay runs on
    ``device``."""
    import json

    from rapid_tpu_torch.utils import engine_telemetry

    directory = Path(directory)
    path = directory / "trace.json"
    if not path.exists():
        return None
    written = json.loads(path.read_text())
    capacity = int(written.get("capacity", REPRO_TRACE_R))
    recipe = json.loads((directory / "fleet.json").read_text())
    schedule = FaultSchedule.from_json((directory / "schedule.json").read_text())
    scenario = compile_schedule(
        schedule,
        str(recipe.get("family", "repro")),
        int(recipe.get("seed", schedule.seed)),
        tuple(recipe.get("knobs", DEFAULT_KNOBS)),
        int(recipe.get("delivery_spread", 0)),
        telemetry=True, trace=capacity, device=device,
    )
    run_fleet([scenario])
    # Replay boundary — the run is over; sync() decodes the replayed ring
    # for the divergence diff.
    scenario.vc.sync()
    replayed = scenario.vc.trace
    return {
        "capacity": capacity,
        "written_rounds": int(written["rounds_recorded"]),
        "replayed_rounds": replayed["rounds_recorded"],
        "first_divergent_round": engine_telemetry.first_divergent_round(
            written, replayed
        ),
    }


# ---------------------------------------------------------------------------
# Fleet fuzzing (the chaosrun --fleet / bench `chaos` stage workload)
# ---------------------------------------------------------------------------


def fleet_specs(b: int, base_seed: int = 0) -> List[Tuple[str, int]]:
    """B mixed specs cycling every fleet family with independent seeds —
    the default hostile-heavy workload of the JAX package's ``chaosrun fuzz
    --fleet`` and ``bench.py``'s ``chaos`` stage."""
    return [
        (FLEET_FAMILIES[i % len(FLEET_FAMILIES)], base_seed + 1 + i)
        for i in range(b)
    ]


def fuzz_fleet(
    b: int,
    base_seed: int = 0,
    out_dir=None,
    max_steps: int = 64,
    shrink_failures: bool = True,
    device=None,
) -> dict:
    """One fleet-fuzz round: compile B mixed scenarios, resolve them in
    batched wave dispatches, run the per-tenant battery, and (on violation)
    shrink the violating tenant and write a single-tenant repro. Returns a
    summary dict with per-family scenario and violation tallies plus the
    throughput numbers ``chaosrun`` prints. Compiles and runs on
    ``device``."""
    specs = fleet_specs(b, base_seed)
    scenarios = compile_fleet(specs, device=device)
    result = run_fleet(scenarios, max_steps=max_steps)
    violations = check_fleet(result)
    by_tenant = violating_tenants(violations)
    families: Dict[str, int] = {}
    family_violations: Dict[str, int] = {}
    for i, (family, _seed) in enumerate(specs):
        families[family] = families.get(family, 0) + 1
        if i in by_tenant:
            family_violations[family] = family_violations.get(family, 0) + 1
    summary = {
        "tenants": b,
        "dispatches": result.dispatches,
        "total_cuts": result.total_cuts,
        "wall_ms": round(result.wall_ms, 3),
        "scenarios_per_sec": round(result.scenarios_per_sec, 2),
        "families": families,
        "family_violations": family_violations,
        "violations": [str(v) for v in violations],
        "violating_tenants": sorted(by_tenant),
    }
    if violations and shrink_failures:
        t, minimal, _min_violations, runs = shrink_tenant(
            scenarios, violations, max_steps=max_steps, device=device
        )
        summary["shrunk_tenant"] = t
        summary["shrunk_events"] = len(minimal.events)
        summary["shrink_runs"] = runs
        if out_dir is not None:
            victim = scenarios[t]
            repro = write_fleet_repro(
                Path(out_dir) / f"tenant{t}", minimal, victim.knobs,
                victim.family, victim.seed, victim.delivery_spread,
                tenant_index=t, fleet_size=b, device=device,
            )
            summary["repro"] = str(repro)
    return summary
