"""The port's spans and counters, on the CPU at small N.

- Counted reads by site (``_host.read``): every call in the package names a
  registered site, an unregistered one raises, and the per-site totals add
  up to ``read.count`` and to the dispatch records' read time.
- The dispatch ring (``utils/dispatch.py``): one record per entry point,
  with the rounds the entry point computed, a fleet wave's tenant-rounds, and
  whether a ``torch.profiler`` session was recording.
- Phase spans (``utils/profiling.py``): on only inside ``profiling.trace()``,
  where the entry, round, phase and read spans nest in the Chrome trace and
  ``span_table``'s self times add up to the entry's duration; the shared
  no-op object everywhere else, a foreign profiler session included.
- The benchmark's readers of the ring.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import core as bench_core
from rapid_tpu_torch import _host
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
from rapid_tpu_torch.tenancy import TenantFleet
from rapid_tpu_torch.testing import churn_cluster, resolve, wave_exit
from rapid_tpu_torch.utils import dispatch, profiling
from rapid_tpu_torch.utils.dispatch import DispatchRecord

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
N, CHURN, COHORTS = 256, 8, 4
PHASES = ("fd_tick", "delivery", "cut_detection", "votes", "tally", "classic", "commit")


def churned(seed=3):
    return churn_cluster(N, CHURN, CHURN, COHORTS, seed, CPU)[0]


def small_fleet(tenants=3, n=64, crashed=(1, 2, 40)):
    """``tenants`` clusters of ``n`` with the slots ``crashed`` crashed in
    each (one upload onto the stacked mask)."""
    clusters = []
    for i in range(tenants):
        vc = VirtualCluster.create(n, k=10, h=9, l=4, cohorts=2, fd_threshold=3, seed=20 + i,
                                   delivery_spread=2, device=CPU)
        vc.assign_cohorts_roundrobin()
        vc.stagger_fd_counts(np.random.default_rng(i), spread_rounds=3)
        clusters.append(vc)
    fleet = TenantFleet.from_clusters(clusters)
    fleet.stream_crash(np.array([[t, s] for t in range(tenants) for s in crashed]))
    return fleet


def trace_events(log_dir):
    return json.loads(Path(profiling.trace_file(str(log_dir))).read_text())["traceEvents"]


def span_events(events):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(profiling.PREFIX)]


# ---------------------------------------------------------------------------
# Vocabularies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["churn", "round.fd_tick", "", "read.nowhere"])
def test_an_unregistered_span_raises(name):
    with pytest.raises(ValueError, match="unregistered span"):
        profiling.span(name)


@pytest.mark.parametrize("site", ["churn", "", "read.branch_point"])
def test_an_unregistered_read_site_raises_before_reading(site):
    count, totals = _host.read.count, _host.site_totals()
    with pytest.raises(ValueError, match="unregistered read site"):
        _host.read(torch.zeros(2), site)
    assert (_host.read.count, _host.site_totals()) == (count, totals)


def test_a_read_later_is_counted_once_when_first_waited_for():
    count, (reads, _) = _host.read.count, _host.site_totals()["fleet_wave_active"]
    value = _host.read_later(torch.tensor([True, False]).any(), "fleet_wave_active")
    assert _host.read.count == count
    assert value() is True and value() is True
    assert (_host.read.count, _host.site_totals()["fleet_wave_active"][0]) == (count + 1, reads + 1)


@pytest.mark.parametrize("site", ["churn", "read.fleet_wave_active"])
def test_an_unregistered_site_raises_before_a_read_later_is_queued(site):
    count, totals = _host.read.count, _host.site_totals()
    with pytest.raises(ValueError, match="unregistered read site"):
        _host.read_later(torch.zeros(2), site)
    assert (_host.read.count, _host.site_totals()) == (count, totals)


def _read_calls():
    for path in sorted((REPO / "rapid_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("read", "read_later")
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "_host"):
                yield f"{path.relative_to(REPO)}:{node.lineno}", node


def test_every_host_read_in_the_package_names_a_registered_site():
    calls = list(_read_calls())
    assert len(calls) >= 29
    for where, node in calls:
        assert len(node.args) == 2 and not node.keywords, where
        site = node.args[1]
        assert isinstance(site, ast.Constant) and site.value in _host.READ_SITES, where


def test_every_read_site_and_entry_point_has_a_span():
    names = profiling.registered()
    assert {"read." + site for site in _host.READ_SITES} <= names
    assert dispatch.ENGINE_DISPATCH_PHASES <= names
    assert {"round", "edge_masks", "view_change", "fleet_select", "planes", *PHASES} <= names


# ---------------------------------------------------------------------------
# Counted reads and the dispatch ring
# ---------------------------------------------------------------------------


def test_a_churn_leaves_one_record_whose_reads_the_sites_account_for():
    vc = churned()
    dispatch.clear_records()
    count, before = _host.read.count, _host.site_totals()
    steps, cuts, resolved, _ = resolve(vc, N)
    after = _host.site_totals()
    moved = {site: (after[site][0] - before[site][0], after[site][1] - before[site][1])
             for site in after if after[site] != before[site]}
    (record,) = dispatch.records()
    assert resolved and cuts >= 1
    assert (record.entry, record.rounds, record.profiled) == ("run_until_membership", steps, False)
    assert sum(n for n, _ in moved.values()) == _host.read.count - count
    assert sum(ns for _, ns in moved.values()) == record.read_ns
    assert 0 < record.read_ns < record.wall_ns
    # The round's branch point and invalidation gate each round, the wave
    # loop's predicate once and after each cut.
    assert moved["branch_point"][0] == moved["invalidation_gate"][0] == steps
    assert moved["membership_predicate"][0] == 1 + cuts
    assert set(moved) <= {"branch_point", "invalidation_gate", "membership_predicate",
                          "classic_outcome"}


@pytest.mark.parametrize("entry", ["step", "run_to_decision"])
def test_each_cluster_entry_records_its_rounds(entry):
    vc = churned(5)
    dispatch.clear_records()
    out = vc.step() if entry == "step" else vc.run_to_decision(64)
    (record,) = dispatch.records()
    assert record.entry == entry
    assert record.rounds == (1 if entry == "step" else out[0])
    assert record.wall_ns > 0 and record.ordinal >= 0


def test_ordinals_grow_and_the_ring_is_bounded():
    vc = churned(6)
    dispatch.clear_records()
    for _ in range(3):
        vc.step()
    ordinals = [r.ordinal for r in dispatch.records()]
    assert ordinals == sorted(ordinals) and len(set(ordinals)) == 3
    assert dispatch.RING_SIZE == 4096 and dispatch._ring.maxlen == dispatch.RING_SIZE


def test_a_fleet_wave_counts_tenant_rounds_active_and_computed():
    fleet = small_fleet()
    max_steps = 24
    dispatch.clear_records()
    rounds, cuts, resolved, _ = fleet.run_until_membership(
        64 - 3, max_steps=max_steps, max_cuts=4, min_cuts=1)
    (record,) = dispatch.records()
    assert record.entry == "fleet_wave" and resolved.all()
    # The wave stops once no tenant is active (testing.wave_exit).
    ran = wave_exit(rounds, max_steps)[0]
    assert record.rounds == ran < max_steps
    assert record.tenant_rounds_active == int(rounds.sum())
    assert record.tenant_rounds_computed == fleet.b * ran
    assert record.tenant_rounds_active <= record.tenant_rounds_computed


def test_a_fleet_decision_counts_its_slowest_tenant_for_every_tenant():
    fleet = small_fleet()
    dispatch.clear_records()
    rounds, decided, _, _ = fleet.run_to_decision(32)
    (record,) = dispatch.records()
    assert decided.all() and record.entry == "fleet_decision"
    assert record.rounds == rounds.max()
    assert record.tenant_rounds_active == rounds.sum()
    assert record.tenant_rounds_computed == fleet.b * rounds.max()


def test_a_foreign_profiler_session_marks_the_record_and_holds_no_span(tmp_path):
    vc = churned(7)
    dispatch.clear_records()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        resolve(vc, N)
    (record,) = dispatch.records()
    assert record.profiled
    prof.export_chrome_trace(str(tmp_path / "foreign.json"))
    events = json.loads((tmp_path / "foreign.json").read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert not [e for e in events if e.get("name", "").startswith(profiling.PREFIX)]
    assert not [e for e in prof.key_averages() if e.key.startswith(profiling.PREFIX)]


# ---------------------------------------------------------------------------
# Phase spans
# ---------------------------------------------------------------------------


def _nested_in(inner, outer):
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3)


@pytest.fixture(scope="module")
def traced_churn(tmp_path_factory):
    """One churn inside ``profiling.trace()``: (its events, its record, its
    steps)."""
    log_dir = tmp_path_factory.mktemp("spans")
    vc = churned(9)
    dispatch.clear_records()
    with profiling.trace(str(log_dir)):
        steps = resolve(vc, N)[0]
    (record,) = dispatch.records()
    return trace_events(log_dir), record, steps, log_dir


def test_the_trace_nests_entry_round_phase_and_read_spans(traced_churn):
    events, record, steps, _ = traced_churn
    spans = span_events(events)
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"][len(profiling.PREFIX):], []).append(e)
    (entry,) = by_name["run_until_membership"]
    rounds = by_name["round"]
    assert record.profiled and len(rounds) == steps
    assert all(_nested_in(e, entry) for e in spans)
    for phase in PHASES:
        assert len(by_name[phase]) == steps, phase
        assert all(any(_nested_in(p, r) for r in rounds) for p in by_name[phase])
    for read in by_name["read.branch_point"]:
        assert any(_nested_in(read, c) for c in by_name["classic"])
    for read in by_name["read.invalidation_gate"]:
        assert any(_nested_in(read, c) for c in by_name["cut_detection"])
    assert len(by_name["view_change"]) >= 1 and "read.membership_predicate" in by_name


def test_span_table_self_times_add_up_to_the_entry(traced_churn):
    _, _, steps, log_dir = traced_churn
    table = profiling.span_table(profiling.trace_file(str(log_dir)))
    entry = table["run_until_membership"]
    assert entry["count"] == 1 and table["round"]["count"] == steps
    assert sum(row["self_ms"] for row in table.values()) == pytest.approx(
        entry["total_ms"], rel=0.01)
    for name, row in table.items():
        assert 0 <= row["self_ms"] <= row["total_ms"] + 1e-6, name


def test_span_table_subtracts_only_the_children_of_each_span(tmp_path):
    def x(name, ts, dur, tid=1):
        return {"ph": "X", "cat": "user_annotation", "name": profiling.PREFIX + name,
                "pid": 1, "tid": tid, "ts": ts, "dur": dur}

    events = [x("fleet_wave", 0, 100), x("round", 10, 30), x("fd_tick", 12, 5),
              x("round", 50, 40), x("view_change", 60, 10), x("round", 0, 7, tid=2),
              {"ph": "X", "cat": "gpu_user_annotation", "name": profiling.PREFIX + "round",
               "pid": 1, "tid": 9, "ts": 0, "dur": 500},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1, "tid": 1,
               "ts": 13, "dur": 1}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    table = profiling.span_table(str(path))
    assert table["fleet_wave"] == {"count": 1, "total_ms": 0.1, "self_ms": pytest.approx(0.03)}
    assert table["round"]["count"] == 3
    assert table["round"]["total_ms"] == pytest.approx(0.077)
    assert table["round"]["self_ms"] == pytest.approx(0.025 + 0.03 + 0.007)
    assert table["fd_tick"]["self_ms"] == pytest.approx(0.005)


def test_spans_are_off_outside_the_ports_own_trace(monkeypatch):
    def entered(*args, **kwargs):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    assert all(profiling.span(name) is profiling.OFF for name in profiling.registered())
    vc = churned(11)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.span("round") is profiling.OFF
        resolve(vc, N)
    fleet = small_fleet(2)
    fleet.step()
    with profiling.OFF as inside:
        assert inside is None


def test_a_trace_that_fails_to_start_leaves_spans_off(tmp_path, monkeypatch):
    class Refuses:
        def __init__(self, **_kw):
            pass

        def start(self):
            raise RuntimeError("no profiler backend")

    monkeypatch.setattr(torch.profiler, "profile", Refuses)
    with profiling.trace(str(tmp_path)):
        assert profiling.span("round") is profiling.OFF
    assert profiling.span("round") is profiling.OFF


def test_spanned_rejects_an_unregistered_name_when_decorating():
    with pytest.raises(ValueError, match="unregistered span"):
        profiling.spanned("nowhere")


# ---------------------------------------------------------------------------
# The benchmark's readers of the ring
# ---------------------------------------------------------------------------


def record(entry, wall_ms, read_ms, rounds, profiled=False, active=0, computed=0):
    r = DispatchRecord(entry, 0, profiled)
    r.wall_ns, r.read_ns, r.rounds = int(wall_ms * 1e6), int(read_ms * 1e6), rounds
    r.tenant_rounds_active, r.tenant_rounds_computed = active, computed
    return r


def read_metric(name, monkeypatch, ring):
    monkeypatch.setattr(dispatch, "records", lambda: list(ring))
    return bench_core.reader(REPO, name)(None)


@pytest.mark.parametrize("metric, entry", [("round.enqueue_ms.latency", "run_until_membership"),
                                           ("round.enqueue_ms.rate", "fleet_wave")])
def test_enqueue_readers_take_the_median_of_unprofiled_records(metric, entry, monkeypatch):
    other = "fleet_wave" if entry == "run_until_membership" else "run_until_membership"
    ring = [record(entry, 50, 10, 8),            # 5.0 ms a round
            record(entry, 90, 2, 8),             # 11.0
            record(entry, 46, 6, 8),             # 5.0 ... median of 4.0, 5.0, 5.0, 11.0
            record(entry, 40, 8, 8),             # 4.0
            record(entry, 900, 0, 8, profiled=True),
            record(other, 1, 0, 1),
            record(entry, 10, 0, 0)]             # no round: left out
    assert read_metric(metric, monkeypatch, ring) == pytest.approx(5.0)


@pytest.mark.parametrize("metric", ["round.enqueue_ms.latency", "round.enqueue_ms.rate",
                                    "fleet.tenant_rounds_useful"])
def test_readers_find_nothing_in_an_empty_or_profiled_ring(metric, monkeypatch):
    assert read_metric(metric, monkeypatch, []) is None
    profiled = [record("run_until_membership", 9, 1, 8, profiled=True),
                record("fleet_wave", 9, 1, 96, profiled=True, active=64, computed=768)]
    assert read_metric(metric, monkeypatch, profiled) is None


def test_useful_tenant_rounds_sum_every_unprofiled_wave(monkeypatch):
    ring = [record("fleet_wave", 1, 0, 96, active=2048, computed=256 * 96),
            record("fleet_wave", 1, 0, 96, active=4096, computed=256 * 96),
            record("fleet_wave", 1, 0, 96, profiled=True, active=256 * 96, computed=256 * 96),
            record("run_until_membership", 1, 0, 8)]
    got = read_metric("fleet.tenant_rounds_useful", monkeypatch, ring)
    assert got == pytest.approx(100 * 6144 / (2 * 256 * 96))


def test_readers_return_none_on_a_program_without_records(monkeypatch):
    monkeypatch.delattr(dispatch, "records")
    for metric in ("round.enqueue_ms.latency", "round.enqueue_ms.rate",
                   "fleet.tenant_rounds_useful"):
        assert bench_core.reader(REPO, metric)(None) is None
