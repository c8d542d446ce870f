"""The PyTorch port's engine side of the chaos subsystem against the JAX
package's, exactly (integers and strings, no tolerance).

- Fleet runs: ``tests/test_tenancy_chaos.py``'s two fleets (the four honest
  ``SPECS`` and one tenant per fleet family) through both packages on the
  CPU: every ``PhaseRecord``, the final slots, the soak cuts, the totals and
  the oracle battery's text are equal. Module fixtures share one run per
  package and fleet.
- The oracle battery's isolation, the mid-run injection failure, the
  tampered-tenant shrink and its repro (written by either package and
  replayed by the other), and the aliasing of tenant views after a run.
- The engine replay of the differential oracle on every engine-compatible
  family, and the differential oracle over one JAX host ``RunResult``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rapid_tpu.sim import fuzz as jfuzz
from rapid_tpu.sim import oracles as joracles
from rapid_tpu.sim.faults import FaultEvent as JaxFaultEvent
from rapid_tpu.tenancy import chaos as jchaos
from rapid_tpu_torch.convert import state_to_numpy
from rapid_tpu_torch.sim import fuzz, oracles
from rapid_tpu_torch.sim.faults import FaultEvent
from rapid_tpu_torch.tenancy import chaos

CPU = torch.device("cpu")
SPECS = [
    ("partition_heal", 5),
    ("asymmetric_link", 6),
    ("crash_during_join", 7),
    ("churn_under_loss", 8),
]
ADVERSARIAL_SPECS = [(family, 20 + i) for i, family in enumerate(chaos.FLEET_FAMILIES)]
TAMPERED_SPECS = [("partition_heal", 1), ("false_alert_stability", 3)]
TAMPERED_KNOBS = [(9, 4, 1), (5, 2, 1)]  # tenant 1: H=5 < the schedule's H=9


def record(result):
    """Everything a fleet run observed, as plain Python values."""
    return dict(
        phases=[[dataclasses.asdict(r) for r in records] for records in result.phases],
        final_slots=[sorted(s) for s in result.final_slots],
        soak_cuts=None if result.soak_cuts is None else result.soak_cuts.tolist(),
        soak_rounds=result.soak_rounds,
        dispatches=result.dispatches,
        total_rounds=result.total_rounds,
        total_cuts=result.total_cuts,
        errors=[(t, str(v)) for t, v in result.errors],
        expected=[sorted(s.expected_slots) for s in result.scenarios],
        stable=[sorted(s.stable_subjects) for s in result.scenarios],
    )


@pytest.fixture(scope="module")
def fleet_runs():
    return (jchaos.run_fleet(jchaos.compile_fleet(SPECS)),
            chaos.run_fleet(chaos.compile_fleet(SPECS, device=CPU)))


@pytest.fixture(scope="module")
def adversarial_runs():
    return (jchaos.run_fleet(jchaos.compile_fleet(ADVERSARIAL_SPECS)),
            chaos.run_fleet(chaos.compile_fleet(ADVERSARIAL_SPECS, device=CPU)))


@pytest.mark.parametrize("runs", ["fleet_runs", "adversarial_runs"])
def test_fleet_run_is_jax(runs, request):
    jax_result, result = request.getfixturevalue(runs)
    assert record(result) == record(jax_result)
    violations = chaos.check_fleet(result)
    assert [str(v) for v in violations] == [str(v) for v in jchaos.check_fleet(jax_result)]
    assert violations == []
    assert result.wall_ms > 0
    assert result.scenarios_per_sec == pytest.approx(len(result.scenarios) / (result.wall_ms / 1e3))
    for i, scenario in enumerate(result.scenarios):
        assert result.final_slots[i] == scenario.expected_slots


def test_adversarial_soak_ran_and_held_the_band(adversarial_runs):
    _, result = adversarial_runs
    assert result.soak_rounds == chaos.STABILITY_SOAK_ROUNDS
    stable = [i for i, s in enumerate(result.scenarios) if s.stable_subjects]
    assert stable and all(int(result.soak_cuts[i]) == 0 for i in stable)


def test_tables_are_jax():
    assert chaos.ENGINE_FAMILIES == jchaos.ENGINE_FAMILIES
    assert chaos.HIER_FAMILIES == jchaos.HIER_FAMILIES
    assert chaos.FLEET_FAMILIES == jchaos.FLEET_FAMILIES
    assert chaos.DEFAULT_KNOBS == jchaos.DEFAULT_KNOBS
    assert (chaos.STABILITY_SOAK_ROUNDS, chaos.REPRO_TRACE_R) == (
        jchaos.STABILITY_SOAK_ROUNDS, jchaos.REPRO_TRACE_R)
    assert chaos.fleet_specs(23, 70_000) == jchaos.fleet_specs(23, 70_000)


def test_compile_tenant_rejects_unknown_families_with_jax_text():
    with pytest.raises(Exception) as port_err:
        chaos.compile_tenant("no_such_family", 0, device=CPU)
    with pytest.raises(Exception) as jax_err:
        jchaos.compile_tenant("no_such_family", 0)
    assert str(port_err.value) == str(jax_err.value)
    for family in chaos.ENGINE_FAMILIES:
        scenario = chaos.compile_tenant(family, 3, device=CPU)
        assert scenario.schedule.engine_compatible
        assert scenario.groups or scenario.stable_subjects


# The isolation cases of tests/test_tenancy_chaos.py: one tenant's tampered
# record flags that tenant alone, with the JAX battery's text.
def _tamper_chain(result, victim):
    tampered = dataclasses.replace(result)
    tampered.phases = [list(records) for records in result.phases]
    first = next(r for r in tampered.phases[victim] if r.cuts > 0)
    tampered.phases[victim][-1] = dataclasses.replace(
        tampered.phases[victim][-1], cuts=1, config_id=first.config_id)
    return tampered


def _tamper_membership(result, victim):
    tampered = dataclasses.replace(result)
    tampered.final_slots = list(result.final_slots)
    tampered.final_slots[victim] = frozenset(set(result.final_slots[victim]) ^ {0})
    return tampered


def _tamper_convergence(result, victim):
    tampered = dataclasses.replace(result)
    tampered.phases = [list(records) for records in result.phases]
    tampered.phases[victim][0] = dataclasses.replace(tampered.phases[victim][0], resolved=False)
    return tampered


@pytest.mark.parametrize("tamper,victim,oracle", [
    (_tamper_chain, 2, "fleet-chain-consistency"),
    (_tamper_membership, 1, "fleet-membership"),
    (_tamper_convergence, 3, "fleet-convergence"),
])
def test_single_tenant_violation_is_isolated(fleet_runs, tamper, victim, oracle):
    jax_result, result = fleet_runs
    violations = chaos.check_fleet(tamper(result, victim))
    assert [str(v) for v in violations] == [
        str(v) for v in jchaos.check_fleet(tamper(jax_result, victim))]
    by_tenant = chaos.violating_tenants(violations)
    assert set(by_tenant) == {victim}
    assert by_tenant[victim] == [oracle]
    assert f"tenant {victim} ({result.scenarios[victim].name})" in violations[0].detail


def test_midrun_injection_failure_names_its_tenant_in_jax_text():
    specs = [("partition_heal", 5), ("crash_during_join", 7)]
    scenarios = chaos.compile_fleet(specs, device=CPU)
    jax_scenarios = jchaos.compile_fleet(specs)
    scenarios[1].groups[0] = [FaultEvent("join", (99,))]
    jax_scenarios[1].groups[0] = [JaxFaultEvent("join", (99,))]
    result = chaos.run_fleet(scenarios)  # must not raise
    jax_result = jchaos.run_fleet(jax_scenarios)
    assert record(result) == record(jax_result)
    violations = chaos.check_fleet(result)
    assert [str(v) for v in violations] == [str(v) for v in jchaos.check_fleet(jax_result)]
    assert chaos.violating_tenants(violations) == {1: ["fleet-injection"]}
    assert "IndexError('slot indices out of range [0, 12): [99]')" in violations[0].detail
    assert result.final_slots[0] == scenarios[0].expected_slots


def test_bad_lie_index_is_a_host_error_in_jax_text():
    """A lie about an out-of-range subject fails on the host copy of the
    probe lanes (numpy's IndexError, as in JAX), never on the device."""
    specs = [("partition_heal", 5), ("watermark_probe", 4)]
    scenarios = chaos.compile_fleet(specs, device=CPU)
    jax_scenarios = jchaos.compile_fleet(specs)
    lie = dict(subject=40, rings=list(range(9)))
    scenarios[1].groups[0] = [FaultEvent("alert_storm", (2, 3), dict(lie))]
    jax_scenarios[1].groups[0] = [JaxFaultEvent("alert_storm", (2, 3), dict(lie))]
    result, jax_result = chaos.run_fleet(scenarios), jchaos.run_fleet(jax_scenarios)
    assert record(result) == record(jax_result)
    assert [str(v) for v in chaos.check_fleet(result)] == [
        str(v) for v in jchaos.check_fleet(jax_result)]
    assert result.errors and "IndexError" in str(result.errors[0][1])


@pytest.fixture(scope="module")
def shrunk(tmp_path_factory):
    """The tampered two-tenant fleet shrunk by both packages, each repro
    written by its own package."""
    out = {}
    for name, pkg, kw in (("jax", jchaos, {}), ("port", chaos, {"device": CPU})):
        scenarios = pkg.compile_fleet(TAMPERED_SPECS, knobs=TAMPERED_KNOBS, **kw)
        violations = pkg.check_fleet(pkg.run_fleet(scenarios))
        t, minimal, min_violations, runs = pkg.shrink_tenant(
            pkg.compile_fleet(TAMPERED_SPECS, knobs=TAMPERED_KNOBS, **kw), violations, **kw)
        repro = pkg.write_fleet_repro(
            tmp_path_factory.mktemp(name) / "repro", minimal, TAMPERED_KNOBS[1],
            "false_alert_stability", 3, tenant_index=t, fleet_size=len(TAMPERED_SPECS), **kw)
        out[name] = dict(violations=[str(v) for v in violations], t=t, minimal=minimal.to_json(),
                         min_violations=[str(v) for v in min_violations], runs=runs, repro=repro)
    return out


def test_tampered_tenant_shrinks_as_jax(shrunk):
    port, ref = shrunk["port"], shrunk["jax"]
    for key in ("violations", "t", "minimal", "min_violations", "runs"):
        assert port[key] == ref[key], key
    assert port["t"] == 1 and port["runs"] > 0
    assert any("fleet-stability" in v for v in port["violations"])
    assert len(fuzz.FaultSchedule.from_json(port["minimal"]).events) <= 3
    for name in ("schedule.json", "fleet.json", "violations.txt", "trace.json"):
        assert (port["repro"] / name).read_text() == (ref["repro"] / name).read_text(), name


@pytest.mark.parametrize("writer,replayer", [("port", "jax"), ("jax", "port")])
def test_repro_replays_across_the_packages(shrunk, writer, replayer):
    repro = shrunk[writer]["repro"]
    recorded = [line for line in (repro / "violations.txt").read_text().splitlines()
                if line and line != "(none)"]
    assert recorded
    if replayer == "port":
        _, replayed = chaos.replay_fleet_repro(repro, device=CPU)
        diff = chaos.replay_trace_divergence(repro, device=CPU)
    else:
        _, replayed = jchaos.replay_fleet_repro(repro)
        diff = jchaos.replay_trace_divergence(repro)
    assert sorted(map(str, replayed)) == sorted(recorded)
    written = json.loads((repro / "trace.json").read_text())
    assert diff["first_divergent_round"] is None
    assert diff["written_rounds"] == diff["replayed_rounds"] == written["rounds_recorded"] > 0


def test_injection_after_a_run_leaves_the_fleet_and_other_tenants_untouched():
    """After ``run_fleet`` every tenant's cluster holds views of the last
    stacked fleet; an injection into tenant 0 through every seam must store
    out-of-place, so the fleet's lanes and tenant 1 keep their values."""
    scenarios = chaos.compile_fleet([("crash_during_join", 7), ("partition_heal", 5)], device=CPU)
    chaos.run_fleet(scenarios)
    vc0, vc1 = scenarios[0].vc, scenarios[1].vc
    fleet_views = list(vc0.state)
    assert vc0.state.alive.data_ptr() != vc1.state.alive.data_ptr()
    assert vc0.state.alive._base is vc1.state.alive._base is not None  # both view the fleet
    before0 = [lane.clone() for lane in fleet_views]
    before1 = state_to_numpy(vc1.state)
    dead = sorted(set(range(12)) - scenarios[0].expected_slots)
    live = sorted(scenarios[0].expected_slots - {0})
    oracles.inject_engine_event(vc0, FaultEvent("crash", (live[0],)))
    oracles.inject_engine_event(vc0, FaultEvent("leave", (live[1],)))
    oracles.inject_engine_event(vc0, FaultEvent("join", (dead[-1],)))
    oracles.inject_engine_event(
        vc0, FaultEvent("false_alert", (live[2],), {"subject": live[3], "rings": [0, 1]}))
    vc0.set_rx_block(np.ones((vc0.cfg.c, vc0.cfg.n), dtype=bool))
    vc0.assign_cohorts(np.zeros(vc0.cfg.n, dtype=np.int32))
    vc0.run_to_decision(max_steps=4)
    for lane, want in zip(fleet_views, before0):
        assert torch.equal(lane, want)
    after1 = state_to_numpy(vc1.state)
    for field, want in before1.items():
        np.testing.assert_array_equal(after1[field], want, err_msg=field, strict=True)


def _replay_tuples(groups, final):
    return ([[sorted((ep.hostname, ep.port, status.name) for ep, status in cut) for cut in g]
             for g in groups], sorted((ep.hostname, ep.port) for ep in final))


@pytest.mark.parametrize("family,seed", [
    (family, seed) for family in jfuzz.FAMILIES for seed in (2, 9, 31)
])
def test_engine_replay_is_jax(family, seed):
    schedule, jax_schedule = fuzz.scenario_family(family, seed), jfuzz.scenario_family(family, seed)
    assert schedule.engine_compatible
    endpoints = fuzz.endpoints_for(seed, schedule.n_slots)
    jax_endpoints = jfuzz.endpoints_for(seed, jax_schedule.n_slots)
    got = oracles.replay_through_engine(schedule, endpoints, device=CPU)
    want = joracles.replay_through_engine(jax_schedule, jax_endpoints)
    assert _replay_tuples(*got) == _replay_tuples(*want)
    assert len(got[0]) == len(schedule.membership_phases())


def test_cuts_refine_is_jax():
    a, b, c = (frozenset({(i, "DOWN")}) for i in range(3))
    cases = [
        ([a | b], [[a, b]]), ([a, b], [[a | b]]), ([a, b, c], [[a | b]]),
        ([b, a], [[a], [b]]), ([], [[a]]), ([a], []), ([a | c], [[a | b]]),
    ]
    for fine, coarse in cases:
        assert oracles.cuts_refine(fine, coarse) == joracles.cuts_refine(fine, coarse)


@pytest.fixture(scope="module")
def host_run():
    """One JAX host run of a pinned family (the asyncio stack the port does
    not have): the input of the differential oracle."""
    return jfuzz.run_schedule(jfuzz.scenario_family("crash_during_join", 7))


@pytest.mark.parametrize("tamper", ["none", "cut_dropped", "membership"])
def test_check_differential_over_a_jax_run_is_jax(host_run, tamper):
    result = dataclasses.replace(host_run)
    if tamper == "cut_dropped":
        result.cuts = list(host_run.cuts[1:])
    elif tamper == "membership":
        result.final_membership = set(host_run.final_membership) - {host_run.endpoints[1]}
    got = [str(v) for v in oracles.check_differential(result, device=CPU)]
    assert got == [str(v) for v in joracles.check_differential(result)]
    assert (got == []) == (tamper == "none")
