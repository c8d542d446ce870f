"""The port's host chaos harness against the JAX package's, on the CPU.

- The runner: every scenario family at seeds 1 and 2, and
  ``random_schedule`` at three seeds, through both packages'
  ``run_schedule`` in one process. ``RunResult.to_dict()`` (cuts, every
  slot's configuration history, kicked slots, phase and final convergence,
  the shaper's counts) and the fault log are equal, and both packages'
  ``check_all`` find no violation (the port's engine replay on the CPU).
- The link shaper: the same rng gives the same plans and counts.
- The shrinker: JAX's known violating schedule shrinks to the same minimal
  schedule and violations in both packages, and ``fuzz`` gives JAX's
  summaries.
- Repro directories replay across the packages both ways, and
  ``tools/traceview.py`` renders the port's.
"""

import functools
import random
import sys
from pathlib import Path

import pytest

import rapid_tpu.sim.faults as j_faults
import rapid_tpu.sim.fuzz as j_fuzz
import rapid_tpu.sim.oracles as j_oracles
import rapid_tpu_torch.sim.faults as t_faults
import rapid_tpu_torch.sim.fuzz as t_fuzz
import rapid_tpu_torch.sim.oracles as t_oracles
from rapid_tpu.utils.clock import ManualClock as JaxClock
from rapid_tpu_torch.utils.clock import ManualClock as PortClock

REPO = Path(__file__).resolve().parent.parent

CASES = [(family, seed) for family in sorted(j_fuzz.FAMILIES) for seed in (1, 2)] + [
    ("random", seed) for seed in (0, 3, 8)]


def _schedule(fuzz, family, seed):
    return fuzz.random_schedule(seed) if family == "random" else fuzz.scenario_family(family, seed)


@functools.lru_cache(maxsize=None)
def _runs(family, seed):
    """Both packages' runs of one case (cached: each case runs once a
    process)."""
    jax_result = j_fuzz.run_schedule(_schedule(j_fuzz, family, seed))
    port_result = t_fuzz.run_schedule(_schedule(t_fuzz, family, seed))
    return jax_result, port_result


@pytest.mark.parametrize("family,seed", CASES)
def test_run_result_and_fault_log_are_jax(family, seed):
    jax_result, port_result = _runs(family, seed)
    assert port_result.to_dict() == jax_result.to_dict()
    assert port_result.faultlog == jax_result.faultlog
    assert [sorted(map(str, cut)) for cut in port_result.cuts] == [
        sorted(map(str, cut)) for cut in jax_result.cuts]
    assert sorted(port_result.snapshots) == sorted(jax_result.snapshots)
    if port_result.schedule.membership_phases():
        assert port_result.cuts, "a run that asks for membership change made no cut"


@pytest.mark.parametrize("family,seed", CASES)
def test_check_all_is_clean_in_both_packages(family, seed):
    jax_result, port_result = _runs(family, seed)
    assert j_oracles.check_all(jax_result) == []
    assert t_oracles.check_all(port_result, device="cpu") == []
    # Each package's host oracles read the other's result the same way.
    for oracle in t_oracles.HOST_ORACLES:
        assert oracle(jax_result) == []


@pytest.mark.parametrize("seed", [4, 19])
def test_link_shaper_plans_are_jax(seed):
    shapers = []
    for faults, clock in ((j_faults, JaxClock), (t_faults, PortClock)):
        shaper = faults.LinkShaper(random.Random(seed), clock())
        shaper.loss_permille, shaper.dup_permille = 120, 90
        shaper.delay_min_ms, shaper.delay_max_ms = 5.0, 40.0
        shaper.asym_group = {"a", "b"}
        shaper.asym_loss_permille, shaper.asym_delay_max_ms = 200, 80.0
        plans = [tuple(shaper.plan(src, dst)) for src, dst in
                 [("a", "c"), ("c", "b"), ("a", "b"), ("c", "d")] * 60]
        counts = (shaper.dropped, shaper.delayed, shaper.duplicated, shaper.asym_dropped,
                  shaper.asym_delayed)
        shapers.append((plans, counts))
    assert shapers[0] == shapers[1]
    assert shapers[1][1][3] > 0 and shapers[1][1][2] > 0


def _known_violating_schedule(faults):
    """``tests/test_sim_fuzz.py``'s schedule: slot 3 isolated across a crash
    decision and never healed, with noise for the shrinker to strip."""
    return faults.FaultSchedule(
        n0=8, n_slots=12, seed=5, name="violating/partition-no-heal",
        phase_budget_ms=20_000, converge_budget_ms=10_000,
        events=[
            faults.FaultEvent("loss", args={"permille": 30}),
            faults.FaultEvent("join", (8,), dwell_ms=500),
            faults.FaultEvent("partition", (3,), dwell_ms=500),
            faults.FaultEvent("crash", (2,), dwell_ms=500),
        ],
    )


@pytest.fixture(scope="module")
def shrunk():
    """Both packages' shrink of the known violating schedule."""
    out = {}
    for name, faults, fuzz, oracles in (("jax", j_faults, j_fuzz, j_oracles),
                                        ("port", t_faults, t_fuzz, t_oracles)):
        schedule = _known_violating_schedule(faults)
        result = fuzz.run_schedule(schedule)
        violations = oracles.check_all(result, differential=False)
        out[name] = (violations, *fuzz.shrink(schedule, violations))
    return out


def test_shrink_gives_jax_minimal_schedule(shrunk):
    jax_violations, jax_min, jax_min_violations, jax_runs = shrunk["jax"]
    port_violations, port_min, port_min_violations, port_runs = shrunk["port"]
    assert "bounded-convergence" in {v.oracle for v in port_violations}
    assert [str(v) for v in port_violations] == [str(v) for v in jax_violations]
    assert port_min.to_json() == jax_min.to_json()
    assert [e.kind for e in port_min.events] == ["partition", "crash"]
    assert [str(v) for v in port_min_violations] == [str(v) for v in jax_min_violations]
    assert port_runs == jax_runs > 0
    with pytest.raises(ValueError) as port_err:
        t_fuzz.shrink(t_fuzz.random_schedule(0), [])
    with pytest.raises(ValueError) as jax_err:
        j_fuzz.shrink(j_fuzz.random_schedule(0), [])
    assert str(port_err.value) == str(jax_err.value)


def test_fuzz_summaries_are_jax(tmp_path, monkeypatch):
    # The fuzz loop's failure path: the generator returns the known
    # violating schedule in both packages; the summaries (shrink included)
    # and the written repros are equal.
    monkeypatch.setattr(j_fuzz, "random_schedule", lambda seed: _known_violating_schedule(j_faults))
    monkeypatch.setattr(t_fuzz, "random_schedule", lambda seed: _known_violating_schedule(t_faults))
    (jax_summary,) = j_fuzz.fuzz([42], out_dir=tmp_path / "jax")
    (port_summary,) = t_fuzz.fuzz([42], out_dir=tmp_path / "port", device="cpu")
    jax_summary.pop("repro"), port_summary.pop("repro")
    assert port_summary == jax_summary and port_summary["violations"]
    for name in ("schedule.json", "result.json", "faultlog.json", "violations.txt"):
        assert (tmp_path / "port/seed42" / name).read_text() == (
            tmp_path / "jax/seed42" / name).read_text()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_repros_replay_across_the_packages(tmp_path, writer):
    # A repro written by one package replays in the other to the same
    # result and violations; the result files are byte-equal.
    jax_result, port_result = _runs("churn_under_loss", 1)
    if writer == "port":
        t_fuzz.write_repro(port_result, t_oracles.check_all(port_result, device="cpu"), tmp_path)
    else:
        j_fuzz.write_repro(jax_result, j_oracles.check_all(jax_result), tmp_path)
    jax_replayed, jax_violations = j_fuzz.replay(tmp_path)
    port_replayed, port_violations = t_fuzz.replay(tmp_path, device="cpu")
    assert jax_violations == [] and port_violations == []
    assert port_replayed.to_dict() == jax_replayed.to_dict() == jax_result.to_dict()
    other = tmp_path / "other"
    (j_fuzz if writer == "port" else t_fuzz).write_repro(
        jax_replayed if writer == "port" else port_replayed, [], other)
    for name in ("schedule.json", "result.json", "faultlog.json", "violations.txt"):
        assert (other / name).read_text() == (tmp_path / name).read_text()


def test_traceview_renders_the_ports_repro(tmp_path):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import traceview
    finally:
        sys.path.pop(0)
    _, port_result = _runs("delegate_gray_failure", 2)
    port_result.write_repro(tmp_path)
    paths, faultlog = traceview.expand_scenario_dir(str(tmp_path))
    assert len(paths) == len(port_result.snapshots) and faultlog is not None
    events = traceview.merge_events(traceview.load_snapshots(paths)
                                    + [traceview.fault_snapshot(faultlog)])
    names = {e["name"] for e in events}
    assert "view_change" in names and any(n.startswith("fault:") for n in names)
    chrome = traceview.chrome_trace(events)
    lanes = {e["args"]["name"] for e in chrome["traceEvents"] if e.get("name") == "process_name"}
    assert traceview.FAULT_LANE in lanes
    # Hierarchical recordings lane by cohort, as JAX's do.
    assert any(lane.startswith("c1:") for lane in lanes)
