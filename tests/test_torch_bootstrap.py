"""The paper's bootstrap through one seed (``benchmark/configs/paper2k.json``,
cell ``paper2k.bootstrap``) on the port's join path, on the CPU:

- the benchmark's burst loop over the configuration, judged against the
  NumPy reference with every number 0, at a small size and at the published
  N = 2,000, and the join control (``benchmark/control_joins.py``) judged
  wrong;
- the join wave's dispatch record (its joiners, its admissibility read's
  time), the cuts on the run's record, and the readers that use them;
- the ``join_wave`` span, on only inside ``profiling.trace()``.
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import control_joins, core
from rapid_tpu_torch import _host
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
from rapid_tpu_torch.utils import dispatch, profiling
from rapid_tpu_torch.utils.dispatch import DispatchRecord

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CELL = "paper2k.bootstrap"
SEED = 2**31 + 20_011
#: The cell's configuration at a small size: the one-member seed, 63 joiners.
SMALL = {"n_slots": 64}


def plan(config=None, **mix):
    """The cell's plan, its configuration and mix overridden; no warm-up and
    every request's K rings compared."""
    p = core.plan(core.load_spec(REPO), CELL, REPO)
    config = {**p.config, **(config or {})}
    joiners = config["n_slots"] - config["n_members"]
    return p._replace(config=config, mix={**p.mix, "join": joiners, "warmup": 0,
                                          "ring_share": 1.0, **mix})


def one_request(p, substitute=None):
    """One request (a window of 0 s) on the CPU: the run and its line."""
    run = core.measure(p, SEED, 0.0, False, CPU, time.perf_counter(), substitute=substitute)
    return run, core.result_line(p, run, False, CPU)


def seed_cluster(n_slots=64, seed=5):
    """The configuration's one-member seed cluster at ``n_slots`` slots."""
    config = json.loads((REPO / "benchmark/configs/paper2k.json").read_text())
    vc = VirtualCluster.create(
        config["n_members"], n_slots=n_slots, k=config["k"], h=config["h"], l=config["l"],
        cohorts=config["cohorts"], fd_threshold=config["fd_threshold"], seed=seed,
        delivery_spread=config["delivery_spread"], device=CPU)
    vc.assign_cohorts_roundrobin()
    vc.stagger_fd_counts(np.random.default_rng(seed), spread_rounds=config["fd_stagger_rounds"])
    return vc


# ---------------------------------------------------------------------------
# The cell through the harness
# ---------------------------------------------------------------------------


def test_the_configuration_is_the_papers_bootstrap():
    p = core.plan(core.load_spec(REPO), CELL, REPO)
    config, mix = p.config, p.mix
    assert (config["kind"], config["tenants"], config["n_members"], config["n_slots"]) == (
        "cluster", 1, 1, 2000)
    assert (config["k"], config["h"], config["l"]) == (10, 9, 3) and config["reduced"] == []
    assert (mix["loop"], mix["crash"], mix["join"]) == ("burst", 0, 1999)
    assert config["n_members"] + mix["join"] == config["n_slots"]
    assert [m["name"] for m in p.end_to_end] == ["view_change_p95_ms", "setup_s"]
    assert {m["name"] for m in p.per_layer} == {
        "join.inject_ms", "join.admitted_per_cut", "round.enqueue_ms.bootstrap",
        "round.kernels.bootstrap", "delivery_roofline.bootstrap"}


@pytest.mark.parametrize("config", [SMALL, {}], ids=["n64", "n2000"])
def test_the_burst_loop_admits_every_joiner_as_the_reference(config):
    run, line = one_request(plan(config))
    assert line["correct"] and line["attempted"] == 1 and line["failed"] == 0
    assert {name: c["value"] for name, c in line["checks"].items()} == dict.fromkeys(
        ("unresolved", "members_wrong", "config_id_wrong", "rings_wrong"), 0)
    (record,) = run.records
    assert record["resolved"] == [True] and record["view_changes"] >= 1
    assert "view_change_p95_ms" in line["metrics"] and "setup_s" in line["metrics"]


def test_the_join_control_is_not_correct():
    _, line = one_request(plan(SMALL), substitute=control_joins.control_answers)
    assert not line["correct"]
    assert line["failed"] == line["attempted"] == 1
    for name in ("unresolved", "members_wrong", "config_id_wrong", "rings_wrong"):
        assert line["checks"][name]["value"] == 1, name


def test_the_readers_read_the_cells_records():
    dispatch.clear_records()
    run, _ = one_request(plan(SMALL))
    (wave,) = [r for r in dispatch.records() if r.entry == "inject_join_wave"]
    (drive,) = [r for r in dispatch.records() if r.entry == "run_until_membership"]
    assert wave.joiners == 63 and drive.cuts == run.records[0]["view_changes"]
    inject_ms = core.reader(REPO, "join.inject_ms")(run)
    assert inject_ms == pytest.approx((wave.wall_ns - wave.read_ns) / 1e6)
    assert core.reader(REPO, "join.admitted_per_cut")(run) == 63 / drive.cuts
    assert core.reader(REPO, "round.enqueue_ms.bootstrap")(run) == core.reader(
        REPO, "round.enqueue_ms.latency")(run)


# ---------------------------------------------------------------------------
# The join wave's record, read and span
# ---------------------------------------------------------------------------


def test_a_join_wave_leaves_one_record_whose_read_is_the_admissibility_read():
    vc = seed_cluster()
    dispatch.clear_records()
    count, before = _host.read.count, _host.site_totals()
    registry = dict(vc.metrics.counters)
    vc.inject_join_wave(np.arange(1, 64))
    after = _host.site_totals()
    (record,) = dispatch.records()
    assert (record.entry, record.joiners, record.profiled) == ("inject_join_wave", 63, False)
    assert _host.read.count - count == after["join_admissibility"][0] - before[
        "join_admissibility"][0] == 1
    assert record.read_ns == after["join_admissibility"][1] - before["join_admissibility"][1]
    assert 0 < record.read_ns < record.wall_ns
    # The registry stays the JAX driver's: no dispatch counted, none timed.
    assert vc.metrics.counters["engine_dispatches"] == registry.get("engine_dispatches", 0)
    assert "inject_join_wave" not in vc.metrics.phase_timings.get("engine_dispatch", {})
    steps, cuts, resolved, sizes = vc.run_until_membership(64, max_steps=96, max_cuts=8,
                                                           min_cuts=1)
    (_, drive) = dispatch.records()
    assert resolved and sizes[-1] == 64
    assert (drive.entry, drive.rounds, drive.cuts) == ("run_until_membership", steps, cuts)
    assert record.joiners == sizes[-1] - 1


def test_an_unchecked_join_wave_makes_no_read():
    vc = seed_cluster()
    dispatch.clear_records()
    count, ns = _host.read.count, _host.read_ns()
    vc.inject_join_wave(np.arange(1, 64), check_admissible=False)
    (record,) = dispatch.records()
    assert _host.read.count == count and _host.read_ns() == ns
    assert record.joiners == 63 and record.read_ns == 0


def test_an_inadmissible_wave_raises_and_still_leaves_its_record():
    vc = seed_cluster()
    dispatch.clear_records()
    with pytest.raises(ValueError, match="not admissible"):
        vc.inject_join_wave([0, 1])
    (record,) = dispatch.records()
    assert record.entry == "inject_join_wave" and record.read_ns > 0


def test_join_wave_is_a_span_only_inside_the_ports_trace(tmp_path):
    assert "join_wave" in profiling.registered()
    assert dispatch.RECORDED_ENTRIES <= profiling.registered()
    assert not dispatch.RECORDED_ENTRIES & dispatch.ENGINE_DISPATCH_PHASES
    vc = seed_cluster()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        vc.inject_join_wave(np.arange(1, 32))
    assert not [e for e in prof.key_averages() if e.key.startswith(profiling.PREFIX)]
    with profiling.trace(str(tmp_path)):
        vc.inject_join_wave(np.arange(32, 64))
    table = profiling.span_table(profiling.trace_file(str(tmp_path)))
    assert table["inject_join_wave"]["count"] == table["join_wave"]["count"] == 1
    assert table["read.join_admissibility"]["count"] == 1
    assert table["join_wave"]["total_ms"] <= table["inject_join_wave"]["total_ms"]
    assert profiling.span("join_wave") is profiling.OFF


def test_an_unregistered_recorded_entry_raises():
    vc = seed_cluster()
    with pytest.raises(ValueError, match="unregistered recorded entry"):
        with vc._record_entry("fleet_wave"):
            pass


def fake_record(entry, wall_ms, read_ms, joiners=0, cuts=0, profiled=False):
    r = DispatchRecord(entry, 0, profiled)
    r.wall_ns, r.read_ns, r.joiners, r.cuts = int(wall_ms * 1e6), int(read_ms * 1e6), joiners, cuts
    return r


def _read(name, monkeypatch, ring):
    monkeypatch.setattr(dispatch, "records", lambda: list(ring))
    return core.reader(REPO, name)(None)


def test_join_readers_pair_waves_with_runs_and_leave_profiled_records_out(monkeypatch):
    ring = [fake_record("run_until_membership", 30, 1, cuts=2),         # before the first wave
            fake_record("inject_join_wave", 5, 1, joiners=1999),        # 4.0 ms
            fake_record("run_until_membership", 30, 1, cuts=1),
            fake_record("inject_join_wave", 9, 1, joiners=1999),        # 8.0 ms
            fake_record("run_until_membership", 30, 1, cuts=2),
            fake_record("inject_join_wave", 7, 1, joiners=1999),        # 6.0 ms
            fake_record("run_until_membership", 30, 1, cuts=1),
            fake_record("inject_join_wave", 90, 1, joiners=1999, profiled=True),
            fake_record("run_until_membership", 90, 1, cuts=8, profiled=True)]
    assert _read("join.inject_ms", monkeypatch, ring) == pytest.approx(6.0)
    assert _read("join.admitted_per_cut", monkeypatch, ring) == pytest.approx(3 * 1999 / 4)


@pytest.mark.parametrize("metric", ["join.inject_ms", "join.admitted_per_cut"])
def test_join_readers_find_nothing_without_a_join_wave(metric, monkeypatch):
    assert _read(metric, monkeypatch, []) is None
    assert _read(metric, monkeypatch, [fake_record("run_until_membership", 9, 1, cuts=1)]) is None
    monkeypatch.delattr(dispatch, "records")
    assert core.reader(REPO, metric)(None) is None
