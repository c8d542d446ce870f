"""The PyTorch port's engine observability tier against the JAX package's.

Both packages' ``VirtualCluster`` and ``TenantFleet`` are driven through the
same seeded crash, join wave and decision on the CPU (a cluster of N=24 in
40 slots, K=3; a fleet of 3 x 16), with the telemetry plane and ring off
and on, and with a ``Supervisor`` (and its ``StreamDriver``) attached to a
cluster and to a fleet, scraped between waves. Their
``telemetry_snapshot()`` dicts must be equal except the ``engine.compile``
and ``engine.memory`` sections (the port's build capture and allocator; the
key sets must still be JAX's) and wall-clock values: every ``*_ms``
histogram compares by its count, and the stream's drained rates and the
recovery MTTR by whether they are set. The Prometheus metric names must be
JAX's, and the port's ``exposition.prometheus_text`` must render any
snapshot byte for byte as JAX's does. ``health()`` must equal JAX's after
every round of a churn. The copied vocabularies (health, events, clock and
recorder) are pinned to the originals, and the ring's flight recording must
merge in ``tools/traceview.py`` to JAX's timeline. Module-scope fixtures
share the JAX compiles.
"""

import json
import logging
import sys
from pathlib import Path

import jax
import pytest
import torch

from rapid_tpu.models.virtual_cluster import VirtualCluster as JaxCluster
from rapid_tpu.serving import FleetPoissonChurn as JaxFleetChurn
from rapid_tpu.serving import PoissonChurn as JaxChurn
from rapid_tpu.serving import Supervisor as JaxSupervisor
from rapid_tpu.tenancy import TenantFleet as JaxFleet
from rapid_tpu.utils import engine_telemetry as jax_telemetry
from rapid_tpu.utils import exposition as jax_exposition
from rapid_tpu.utils import flight_recorder as jax_recorder
from rapid_tpu.utils import health as jax_health
from rapid_tpu.utils.clock import ManualClock as JaxManualClock
from rapid_tpu_torch import _build, _host
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster as TorchCluster
from rapid_tpu_torch.serving import FleetPoissonChurn, PoissonChurn, Supervisor
from rapid_tpu_torch.tenancy import TenantFleet as TorchFleet
from rapid_tpu_torch.utils import engine_telemetry, exposition, flight_recorder, health, profiling
from rapid_tpu_torch.utils.clock import ManualClock

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import clustertop  # noqa: E402  — tools/clustertop.py
import traceview  # noqa: E402  — tools/traceview.py
from chip_smoke import comparable_snapshot  # noqa: E402

CPU = "cpu"
R = 10  # ring capacity: the churn's rounds wrap it, its decision stays held
PLANES = {"off": {}, "on": dict(telemetry=True, trace=R)}
ROUNDS = 12  # rounds stepped by the churn drive (both cuts commit within them)


def cluster(cls, seed=0, **planes):
    kw = dict(device=CPU) if cls is TorchCluster else {}
    vc = cls.create(24, n_slots=40, k=3, h=3, l=1, cohorts=2, fd_threshold=2, seed=seed,
                    **planes, **kw)
    vc.assign_cohorts_roundrobin()
    return vc


def fleet(cls, fleet_cls, churn=True, **planes):
    clusters = []
    for i, seed in enumerate((10, 11, 12)):
        vc = cls.create(16, n_slots=20, k=3, h=3, l=1, cohorts=2, fd_threshold=2, seed=seed,
                        **planes, **(dict(device=CPU) if cls is TorchCluster else {}))
        vc.assign_cohorts_roundrobin()
        if churn:
            vc.crash([i + 1, 7])
            if i != 1:
                vc.inject_join_wave([16, 17])
        clusters.append(vc)
    return fleet_cls.from_clusters(clusters)


def churn(vc):
    """The seeded churn: two crashes and a join wave, then ROUNDS rounds of
    ``step()``; the health after the injections and after every round."""
    vc.crash([3, 17])
    vc.inject_join_wave([30, 31])
    healths = [vc.health().value]
    for _ in range(ROUNDS):
        vc.step()
        healths.append(vc.health().value)
    vc.sync()
    return healths


def assert_same_snapshot(got, want):
    assert got["engine"]["compile"].keys() == want["engine"]["compile"].keys()
    assert got["engine"]["memory"].keys() == want["engine"]["memory"].keys()
    assert comparable_snapshot(got) == comparable_snapshot(want)


def settled(sup):
    """JAX's CPU backend completes tickets asynchronously, so its reaper's
    answers (and so ``waves_completed`` at a scrape) would vary from run to
    run; it waits for each ticket here, as the port's CPU ticket, which is
    always ready."""
    probe = sup.driver._ticket_ready

    def ready(wave, ticket):
        jax.block_until_ready(ticket)
        return probe(wave, ticket)

    sup.driver._ticket_ready = ready
    return sup


@pytest.fixture(scope="module")
def clusters():
    """Per plane setting, both packages' clusters after the churn, with the
    health after every round."""
    out = {}
    for name, planes in PLANES.items():
        pair = {"jax": cluster(JaxCluster, **planes), "torch": cluster(TorchCluster, **planes)}
        out[name] = {side: (vc, churn(vc)) for side, vc in pair.items()}
    return out


@pytest.fixture(scope="module")
def fleets():
    out = {}
    for name, planes in PLANES.items():
        pair = {"jax": fleet(JaxCluster, JaxFleet, **planes),
                "torch": fleet(TorchCluster, TorchFleet, **planes)}
        for f in pair.values():
            resolved = f.run_until_membership([16, 14, 16], max_steps=48, max_cuts=4,
                                              min_cuts=1)[2]
            assert resolved.all()
            f.sync()
        out[name] = pair
    return out


def supervise(target, sup_cls, waves, settle):
    """``waves`` through a ``Supervisor`` over ``target``, which is scraped
    after attach, after every submit (between waves) and after the drain;
    returns the snapshots."""
    sup = sup_cls(target, rounds_per_wave=4, depth=2)
    if settle:
        settled(sup)
    snaps = [target.telemetry_snapshot()]
    for wave in waves:
        sup.submit(wave)
        snaps.append(target.telemetry_snapshot())
    sup.drain()
    snaps.append(target.telemetry_snapshot())
    return snaps


@pytest.fixture(scope="module")
def supervised():
    """A supervised stream (trace on) of 6 waves in each package."""
    out = {}
    for side, cls, sup_cls, churn_cls in (("jax", JaxCluster, JaxSupervisor, JaxChurn),
                                          ("torch", TorchCluster, Supervisor, PoissonChurn)):
        vc = cluster(cls, **PLANES["on"])
        waves = churn_cls(24, 40, rate=1.0, seed=7).waves(6)
        out[side] = (vc, supervise(vc, sup_cls, waves, settle=side == "jax"))
    return out


@pytest.fixture(scope="module")
def supervised_fleet():
    """A supervised 3-tenant fleet stream (plane and ring on) of 4 waves in
    each package."""
    out = {}
    for side, cls, fleet_cls, sup_cls, churn_cls in (
        ("jax", JaxCluster, JaxFleet, JaxSupervisor, JaxFleetChurn),
        ("torch", TorchCluster, TorchFleet, Supervisor, FleetPoissonChurn),
    ):
        target = fleet(cls, fleet_cls, churn=False, **PLANES["on"])
        waves = churn_cls(3, 16, rate=0.5, seed=9).waves(4)
        out[side] = (target, supervise(target, sup_cls, waves, settle=side == "jax"))
    return out


# ---------------------------------------------------------------------------
# The copied vocabularies
# ---------------------------------------------------------------------------


def test_health_vocabulary_and_every_pair_aggregate_like_jax():
    assert [(s.name, s.value, s.severity) for s in health.NodeHealth] == [
        (s.name, s.value, s.severity) for s in jax_health.NodeHealth
    ]
    raw = [s.value for s in health.NodeHealth] + [s.name for s in health.NodeHealth]
    for value in raw + ["bogus", None]:
        assert health.parse_health(value).value == jax_health.parse_health(value).value
    states = [s.value for s in health.NodeHealth] + [None, "unknown"]
    for a in states:
        for b in states:
            assert health.aggregate_health([a, b]) == jax_health.aggregate_health([a, b])
    assert health.aggregate_health([]) == jax_health.aggregate_health([])


def test_event_names_and_recorder_are_jax():
    assert [(e.name, e.value, e.phase_rank) for e in flight_recorder.EventName] == [
        (e.name, e.value, e.phase_rank) for e in jax_recorder.EventName
    ]
    for args in (("10.0.0.1:5000", 7, 12.5), ("n", 0, 0.0), ("host:1", 2**63, 1e9)):
        assert flight_recorder.mint_trace_id(*args) == jax_recorder.mint_trace_id(*args)
    snaps = []
    for clock, recorder_cls, names in (
        (ManualClock(), flight_recorder.FlightRecorder, flight_recorder.EventName),
        (JaxManualClock(), jax_recorder.FlightRecorder, jax_recorder.EventName),
    ):
        rec = recorder_cls("node-a", clock, capacity=5)
        fired = []
        clock.call_later_ms(2.5, lambda: fired.append(clock.now_ms()))
        for i, event in enumerate(list(names)[:8]):
            clock.advance_ms(1.0)
            rec.record(event, config_id=i, trace_id=i * 3, step=i)
        assert fired == [2.5] and len(rec) == 5 and rec.dropped == 3
        snaps.append((rec.snapshot(), rec.snapshot(tail=2)))
    assert snaps[0] == snaps[1]


# ---------------------------------------------------------------------------
# The drivers' scrapes against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("planes", sorted(PLANES))
def test_cluster_health_follows_jax_through_the_churn(clusters, planes):
    (_, want), (_, got) = clusters[planes]["jax"], clusters[planes]["torch"]
    assert got == want
    assert want[0] == "proposing" and want[-1] == "stable"


@pytest.mark.parametrize("planes", sorted(PLANES))
def test_cluster_snapshot_and_names_are_jax(clusters, planes):
    jvc, tvc = clusters[planes]["jax"][0], clusters[planes]["torch"][0]
    got, want = tvc.telemetry_snapshot(), jvc.telemetry_snapshot()
    assert_same_snapshot(got, want)
    assert ("activity" in got["engine"], "trace" in got["engine"]) == (planes == "on",) * 2
    assert exposition.metric_names(tvc.prometheus_text()) == jax_exposition.metric_names(
        jvc.prometheus_text())
    # A scrape charges JAX's 8 + 4 + 4 + 4 bytes in 4 reads, none of the
    # plane's lanes.
    before = [vc.metrics.counters["engine_d2h_bytes"] for vc in (tvc, jvc)]
    reads = _host.read.count
    tvc.telemetry_snapshot(), jvc.telemetry_snapshot()
    after = [vc.metrics.counters["engine_d2h_bytes"] for vc in (tvc, jvc)]
    assert [a - b for a, b in zip(after, before)] == [20, 20]
    assert _host.read.count - reads == 4


@pytest.mark.parametrize("planes", sorted(PLANES))
def test_fleet_snapshot_health_and_names_are_jax(fleets, planes):
    jf, tf = fleets[planes]["jax"], fleets[planes]["torch"]
    assert tf.health().value == jf.health().value == "stable"
    got, want = tf.telemetry_snapshot(), jf.telemetry_snapshot()
    assert_same_snapshot(got, want)
    assert got["engine"]["tenancy"]["tenants"] == 3
    assert ("tenant_activity" in got["engine"]) == (planes == "on")
    text = tf.prometheus_text()
    assert exposition.metric_names(text) == jax_exposition.metric_names(jf.prometheus_text())
    assert all(f'tenant="{t}"' in text for t in range(3)) == (planes == "on")


def test_supervised_stream_snapshots_and_names_are_jax(supervised):
    (jvc, jsnaps), (tvc, tsnaps) = supervised["jax"], supervised["torch"]
    assert len(tsnaps) == len(jsnaps) == 8
    for got, want in zip(tsnaps, jsnaps):
        assert_same_snapshot(got, want)
    last = tsnaps[-1]["engine"]
    assert {"stream", "recovery", "activity", "trace"} <= last.keys()
    assert last["stream"]["waves_completed"] == 6
    text = tvc.prometheus_text()
    assert exposition.metric_names(text) == jax_exposition.metric_names(jvc.prometheus_text())
    assert "rapid_engine_stream_waves_total" in text
    assert "rapid_engine_recovery_checkpoints_total" in text


def test_supervised_fleet_snapshots_and_names_are_jax(supervised_fleet):
    (jf, jsnaps), (tf, tsnaps) = supervised_fleet["jax"], supervised_fleet["torch"]
    for got, want in zip(tsnaps, jsnaps):
        assert_same_snapshot(got, want)
    last = tsnaps[-1]["engine"]
    assert {"tenancy", "stream", "recovery", "tenant_activity", "tenant_trace"} <= last.keys()
    assert last["tenancy"]["tenant_rounds_total"] == 3 * 4 * 4
    assert exposition.metric_names(tf.prometheus_text()) == jax_exposition.metric_names(
        jf.prometheus_text())


def _host_snapshot():
    """A host node's snapshot: phase families with a path label, transport
    stats, a recorder and every value kind the renderer formats."""
    from rapid_tpu_torch.utils.metrics import Metrics

    metrics = Metrics()
    metrics.inc("alerts_received", 3)
    for ms, phase in ((1.5, "detection"), (40.0, "agreement/fast"), (900.0, "agreement/classic")):
        metrics.record_ms("view_change_phase", ms, phase=phase)
    metrics.record_ms("convergence", 12.25)
    rec = flight_recorder.FlightRecorder("h:1", ManualClock(), capacity=2)
    for _ in range(3):
        rec.record(flight_recorder.EventName.VIEW_CHANGE)
    return {
        "node": 'h:1"\\', "configuration_id": -5, "membership_size": 7, "health": "WEDGED",
        "metrics": metrics.summary(),
        "transport": {"client": {"msgs_tx": 4, "kbps_tx": float("inf")}, "server": None},
        "recorder": rec.snapshot(tail=1),
        "engine": {"memory": {"live_buffers": None, "device_bytes_in_use": 2**40},
                   "compile": {"compiles": 2, "compile_ms": {"count": 0}},
                   "stream": {"waves_submitted": 1, "overlap_efficiency": float("nan"),
                              "rounds_to_decision_p99": None}},
    }


def test_exposition_text_is_byte_identical_to_jax(clusters, fleets, supervised,
                                                  supervised_fleet):
    snaps = [_host_snapshot()]
    for planes in PLANES:
        snaps += [clusters[planes][side][0].telemetry_snapshot() for side in ("jax", "torch")]
        snaps += [fleets[planes][side].telemetry_snapshot() for side in ("jax", "torch")]
    snaps += supervised["jax"][1] + supervised["torch"][1]
    snaps += supervised_fleet["jax"][1] + supervised_fleet["torch"][1]
    for snap in snaps:
        text = exposition.prometheus_text(snap)
        assert text == jax_exposition.prometheus_text(snap)
        assert exposition.metric_names(text) == jax_exposition.metric_names(text)
        assert exposition.snapshot_json(snap, indent=1) == jax_exposition.snapshot_json(snap, 1)


# ---------------------------------------------------------------------------
# The ring as a flight recording, and the dashboards
# ---------------------------------------------------------------------------


def test_ring_flight_recording_merges_to_jax_timeline(clusters):
    jvc, tvc = clusters["on"]["jax"][0], clusters["on"]["torch"][0]
    assert tvc.trace == jvc.trace and tvc.trace["wraps"] > 0
    config_id = tvc.config_id
    assert config_id == jvc.config_id
    kw = dict(t0_ms=100.0, ms_per_round=2.0, config_id=config_id)
    got = engine_telemetry.trace_recorder_snapshot(tvc.trace, **kw)
    want = jax_telemetry.trace_recorder_snapshot(jvc.trace, **kw)
    assert got == want and got["dropped"] == ROUNDS - R
    assert {e["name"] for e in got["events"]} >= {"engine_round", "engine_decision"}
    host = flight_recorder.FlightRecorder("10.0.0.1:1", ManualClock())
    host.record(flight_recorder.EventName.CONSENSUS_DECIDED, config_id=1)
    assert traceview.merge_events([got, host.snapshot()]) == traceview.merge_events(
        [want, host.snapshot()])


def _same_instruments(got, want):
    """``got`` with ``want``'s compile and memory sections and wall-clock
    values, so a pane differs only where the drives differ."""
    got = json.loads(json.dumps(got))
    got["engine"]["compile"] = want["engine"]["compile"]
    got["engine"]["memory"] = want["engine"]["memory"]
    for name, value in want["metrics"].items():
        if isinstance(value, dict):
            got["metrics"][name] = value
    for section in ("stream", "recovery"):
        if section in want["engine"]:
            got["engine"][section] = {**got["engine"][section], **{
                k: want["engine"][section][k] for k in (
                    "view_changes_per_sec", "overlap_efficiency", "p99_alert_to_commit_ms",
                    "mttr_ms") if k in want["engine"][section]}}
    return got


def test_clustertop_panes_render_alike(clusters, fleets, supervised):
    pairs = [(clusters["on"]["torch"][0].telemetry_snapshot(),
              clusters["on"]["jax"][0].telemetry_snapshot()),
             (fleets["on"]["torch"].telemetry_snapshot(), fleets["on"]["jax"].telemetry_snapshot()),
             (supervised["torch"][1][-1], supervised["jax"][1][-1])]
    got = [_same_instruments(g, w) for g, w in pairs]
    want = [w for _, w in pairs]
    for render in (clustertop.render_engine_pane, clustertop.render_stream_pane,
                   clustertop.render_recovery_pane, clustertop.render_rounds_pane):
        assert render(got) == render(want)
    engine_rows = clustertop.render_engine_pane(got)
    assert any(row.split()[1] == "3" for row in engine_rows[2:])  # the fleet's TENANTS
    assert len(clustertop.render_rounds_pane(got)) == 2 + 1 + 3 + 1  # blank, header, rings


def test_timed_convergence_and_alive_mask():
    vcs = [cluster(JaxCluster), cluster(TorchCluster)]
    for vc in vcs:
        vc.crash([5])
    (jrounds, _), (trounds, ms) = (vc.timed_convergence() for vc in vcs)
    assert trounds == jrounds and ms > 0
    tvc = vcs[1]
    reads, d2h = _host.read.count, tvc.metrics.counters["engine_d2h_bytes"]
    mask = tvc.alive_mask
    assert mask.dtype == bool and mask.shape == (40,) and (mask == vcs[0].alive_mask).all()
    assert _host.read.count == reads + 1
    assert tvc.metrics.counters["engine_d2h_bytes"] == d2h + 40
    with pytest.raises(AssertionError, match="did not converge"):
        cluster(TorchCluster).timed_convergence(max_steps=2)


# ---------------------------------------------------------------------------
# Build capture, ptxas facts and memory gauges
# ---------------------------------------------------------------------------

_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124delivery_new_bits_kernelILi10ELi1EEEvPKjPKiS3_Pjjjiiiijyjj' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124delivery_new_bits_kernelILi10ELi1EEEvPKjPKiS3_Pjjjiiiijyjj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 108 registers, used 0 barriers, 16896 bytes smem, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124delivery_new_bits_kernelILi0ELi2EEEvPKjPKiS3_Pjjjiiiijyjj' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124delivery_new_bits_kernelILi0ELi2EEEvPKjPKiS3_Pjjjiiiijyjj
    24 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 416 bytes cmem[0], 8 bytes cmem[2]
ptxas info    : Function properties for _Z6helperv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z6simplePi' for 'sm_90a'
ptxas info    : Function properties for _Z6simplePi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 8 registers
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """``_build`` over two sources in ``tmp_path`` with a stand-in ``nvcc``
    that writes an empty library and prints the canned ptxas report; the
    source ``hit`` is already built, ``miss`` is not."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    for name in ("hit", "miss"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ \"$1\" = -o ]; then : > \"$2\"; fi\n"
        "  shift\ndone\ncat >&2 <<'EOF'\n" + _PTXAS + "EOF\n"
    )
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", build)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_requested", set())
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    _build._target("hit").write_bytes(b"")
    return _build


def test_compile_delta_counts_a_hit_and_a_miss(fake_build):
    before = engine_telemetry.compile_snapshot()
    with engine_telemetry.CompileDelta() as phase:
        fake_build.load("hit")
        fake_build.load("miss")
        fake_build.load("miss")  # loaded: no lookup
        fake_build.build_all(["hit", "miss"])  # looked up before: not again
    delta = dict(phase.delta)
    assert delta.pop("compile_ms") >= 0.0
    assert delta == {"persistent_cache_hits": 1, "persistent_cache_misses": 1,
                     "cache_requests": 2, "compiles": 1}
    after = engine_telemetry.compile_snapshot()
    assert after["compile_ms"]["count"] == before["compile_ms"]["count"] + 1
    assert after["compiles"] == after["compile_ms"]["count"]
    assert after.keys() == jax_telemetry.compile_snapshot().keys()
    assert engine_telemetry.install() is True and engine_telemetry.install() is True
    # The build kept ptxas's report beside its library.
    assert fake_build.report_path("miss").read_text() == _PTXAS
    assert engine_telemetry.compiled_memory_analysis("hit") is None  # built without a report
    assert engine_telemetry.compiled_memory_analysis("miss")["simple"]["registers"] == 8


def test_compiled_memory_analysis_parses_ptxas(fake_build):
    fake_build.report_path("hit").write_text(_PTXAS)
    facts = engine_telemetry.compiled_memory_analysis("hit")
    assert facts == {
        "delivery_new_bits_kernel<10, 1>": {
            "registers": 108, "shared_bytes": 16896, "spill_store_bytes": 0,
            "spill_load_bytes": 0, "stack_bytes": 0, "constant_bytes": 416},
        "delivery_new_bits_kernel<0, 2>": {
            "registers": 255, "shared_bytes": 0, "spill_store_bytes": 8,
            "spill_load_bytes": 12, "stack_bytes": 24, "constant_bytes": 424},
        "simple": {
            "registers": 8, "shared_bytes": 0, "spill_store_bytes": 0,
            "spill_load_bytes": 0, "stack_bytes": 0, "constant_bytes": 0},
    }
    assert engine_telemetry.compiled_memory_analysis("no_such_kernel") is None
    fake_build.report_path("hit").write_text("ptxas info    : 0 bytes gmem\n")
    assert engine_telemetry.compiled_memory_analysis("hit") is None


def test_device_memory_snapshot_on_the_cpu_has_jax_keys():
    got = engine_telemetry.device_memory_snapshot(torch.device("cpu"))
    assert got == dict.fromkeys(jax_telemetry.device_memory_snapshot(), None)


# ---------------------------------------------------------------------------
# Profiler hooks (the cases of tests/test_profiling.py)
# ---------------------------------------------------------------------------


class _FakeProfile:
    """A stand-in ``torch.profiler.profile`` whose start or stop raises."""

    stopped = []

    def __init__(self, fail, **_kw):
        self.fail = fail

    def start(self):
        if self.fail == "start":
            raise RuntimeError("no profiler backend")

    def stop(self):
        _FakeProfile.stopped.append(True)
        if self.fail == "stop":
            raise RuntimeError("flush failed")

    def export_chrome_trace(self, path):
        raise AssertionError("nothing to export")


def test_trace_records_the_annotated_span_and_rejects_nesting(tmp_path):
    with profiling.trace(str(tmp_path / "outer")):
        with pytest.raises(RuntimeError, match="does not nest"):
            with profiling.trace(str(tmp_path / "inner")):
                pass  # pragma: no cover — must not be reached
        with profiling.annotate("churn"):
            torch.ones(8).cumsum(0)
    events = json.loads(Path(profiling.trace_file(str(tmp_path / "outer"))).read_text())
    assert any(e.get("name") == "churn" for e in events["traceEvents"])
    assert not (tmp_path / "inner").exists()


def test_guard_resets_when_block_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _FakeProfile(None))
    with pytest.raises(ValueError, match="inner failure"):
        with profiling.trace(str(tmp_path / "t")):
            raise ValueError("inner failure")
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _FakeProfile("stop"))
    with profiling.trace(str(tmp_path / "t2")):
        pass  # not "already active"


def test_noop_when_profiler_unavailable(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(profiling, "profiler_available", lambda: False)
    ran = []
    with caplog.at_level(logging.WARNING, logger="rapid_tpu_torch.utils.profiling"):
        with profiling.trace(str(tmp_path)):
            ran.append(True)
    assert ran
    assert any("unavailable" in r.message for r in caplog.records)
    with profiling.annotate("phase"):
        ran.append(True)
    assert len(ran) == 2


@pytest.mark.parametrize("fail", ["start", "stop"])
def test_failed_start_runs_unprofiled_and_failed_stop_is_logged(tmp_path, monkeypatch, caplog,
                                                                  fail):
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _FakeProfile(fail))
    _FakeProfile.stopped.clear()
    ran = []
    with caplog.at_level(logging.WARNING, logger="rapid_tpu_torch.utils.profiling"):
        with profiling.trace(str(tmp_path)):
            ran.append(True)
    assert ran
    if fail == "start":
        assert any("running unprofiled" in r.message for r in caplog.records)
        assert not _FakeProfile.stopped  # never started -> never stopped
    else:
        assert any("stop_trace" in r.message for r in caplog.records)
        assert _FakeProfile.stopped


def test_profiler_available_reports_bool():
    assert isinstance(profiling.profiler_available(), bool)
