"""The PyTorch port's streaming pipeline against the JAX package's, exactly.

The shapes of ``tests/test_stream.py``: a cluster of N=24 members in 40
slots (K=3, H=3, L=1, C=2, fd_threshold 2) and a fleet of 3 tenants of 16.
The same seeded Poisson schedules go through JAX's ``StreamDriver`` and the
port's on the CPU, and must give the same cuts, config ids, final lanes
(state, faults, planes), ``StreamResult`` counts, ``metrics.counters`` and
per-phase dispatch counts. The port's stream is also held against its own
batch drive, and its read-free round (``stream_step``) against ``step()``
round by round. Module-scope fixtures share the JAX compiles.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from rapid_tpu.models.virtual_cluster import VirtualCluster as JaxCluster
from rapid_tpu.serving import FleetPoissonChurn as JaxFleetChurn
from rapid_tpu.serving import PoissonChurn as JaxChurn
from rapid_tpu.serving import StreamDriver as JaxDriver
from rapid_tpu.serving import waves_from_schedule as jax_waves_from_schedule
from rapid_tpu.sim.faults import FaultEvent as JaxFaultEvent
from rapid_tpu.sim.faults import FaultSchedule as JaxFaultSchedule
from rapid_tpu.tenancy import TenantFleet as JaxFleet
from rapid_tpu.utils import histogram as jax_histogram
from rapid_tpu.utils.metrics import Metrics as JaxMetrics
from rapid_tpu_torch import _host
from rapid_tpu_torch.convert import state_to_numpy
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster as TorchCluster
from rapid_tpu_torch.serving import (
    STREAMABLE_KINDS,
    FleetPoissonChurn,
    FleetWave,
    PoissonChurn,
    StreamDriver,
    StreamWave,
    waves_from_schedule,
)
from rapid_tpu_torch.sim import fuzz
from rapid_tpu_torch.sim.faults import FaultEvent, FaultSchedule, ScheduleError
from rapid_tpu_torch.tenancy import TenantFleet as TorchFleet
from rapid_tpu_torch.utils import histogram
from rapid_tpu_torch.utils.dispatch import ENGINE_DISPATCH_PHASES
from rapid_tpu_torch.utils.metrics import Metrics

RPW, DEPTH = 4, 2
FLEET_RPW = 3


def cluster(make, seed=0, **kw):
    vc = make(24, n_slots=40, k=3, h=3, l=1, cohorts=2, fd_threshold=2, seed=seed, **kw)
    vc.assign_cohorts_roundrobin()
    return vc


def torch_cluster(seed=0, **kw):
    return cluster(TorchCluster.create, seed, device="cpu", **kw)


def fleet(make, fleet_cls, seeds=(10, 11, 12), **kw):
    clusters = []
    for s in seeds:
        vc = make(16, k=3, h=3, l=1, cohorts=2, fd_threshold=2, seed=s, **kw)
        vc.assign_cohorts_roundrobin()
        clusters.append(vc)
    return fleet_cls.from_clusters(clusters)


def torch_fleet(seeds=(10, 11, 12), **kw):
    return fleet(TorchCluster.create, TorchFleet, seeds, device="cpu", **kw)


def jax_lanes(tree):
    return {} if tree is None else {f: np.asarray(getattr(tree, f)) for f in tree._fields}


def torch_lanes(tree):
    return {} if tree is None else state_to_numpy(tree)


def all_lanes(target, lanes):
    return {
        **lanes(target.state), **lanes(target.faults),
        **{f"telem.{k}": v for k, v in lanes(target.telem).items()},
        **{f"trace.{k}": v for k, v in lanes(target.trace_ring).items()},
    }


def assert_same(got: dict, want: dict, where: str):
    assert set(got) == set(want), where
    for field, w in want.items():
        assert got[field].dtype == w.dtype, f"{where}: {field} {got[field].dtype} != {w.dtype}"
        np.testing.assert_array_equal(got[field], w, err_msg=f"{where}: lane {field}", strict=True)


def phase_counts(metrics):
    return {p: h.count for p, h in metrics.phase_timings.get("engine_dispatch", {}).items()}


def as_tuples(waves):
    return [(w.crash, getattr(w, "join", ())) for w in waves]


def settled(_wave, ticket):
    """JAX's reaper probe, answered as the port's CPU ticket answers it:
    ready (after waiting for it). JAX's CPU backend runs asynchronously, so
    its own probe says "not yet" at random, and which waits count as
    ``stream_fetch`` dispatches would vary from run to run."""
    jax.block_until_ready(ticket)
    return True


def stream(driver_cls, target, waves, rpw):
    extra = dict(ticket_ready=settled) if driver_cls is JaxDriver else {}
    driver = driver_cls(target, rounds_per_wave=rpw, depth=DEPTH, **extra)
    for wave in waves:
        driver.submit(wave)
    return driver, driver.drain()


@pytest.fixture(scope="module")
def cluster_pair():
    """The schedule of test_stream.py's cluster differential through both
    packages' drivers."""
    jax_waves = JaxChurn(24, 40, rate=1.0, seed=7).waves(6)
    waves = PoissonChurn(24, 40, rate=1.0, seed=7).waves(6)
    jvc, tvc = cluster(JaxCluster.create), torch_cluster()
    jd, jres = stream(JaxDriver, jvc, jax_waves, RPW)
    td, tres = stream(StreamDriver, tvc, waves, RPW)
    return dict(jax=(jvc, jd, jres, jax_waves), torch=(tvc, td, tres, waves))


@pytest.fixture(scope="module")
def fleet_pair():
    jax_waves = JaxFleetChurn(3, 16, rate=0.7, seed=3).waves(5)
    waves = FleetPoissonChurn(3, 16, rate=0.7, seed=3).waves(5)
    jf, tf = fleet(JaxCluster.create, JaxFleet), torch_fleet()
    jd, jres = stream(JaxDriver, jf, jax_waves, FLEET_RPW)
    td, tres = stream(StreamDriver, tf, waves, FLEET_RPW)
    return dict(jax=(jf, jd, jres, jax_waves), torch=(tf, td, tres, waves))


@pytest.mark.parametrize("shape", ["cluster", "fleet"])
def test_stream_matches_jax(shape, cluster_pair, fleet_pair):
    pair = cluster_pair if shape == "cluster" else fleet_pair
    (jt, jd, jres, jw), (tt, td, tres, tw) = pair["jax"], pair["torch"]
    assert as_tuples(tw) == as_tuples(jw)  # the generators' numpy draws are JAX's
    assert_same(all_lanes(tt, torch_lanes), all_lanes(jt, jax_lanes), f"{shape} final lanes")
    if shape == "cluster":
        assert tt.config_id == jt.config_id and tt.config_epoch == jt.config_epoch
    else:
        assert tt.config_ids() == jt.config_ids()
        np.testing.assert_array_equal(tt.config_epochs(), jt.config_epochs())
    for field in ("waves", "rounds", "cuts", "h2d_bytes"):
        assert getattr(tres, field) == getattr(jres, field), field
    assert tres.cuts > 0, "the schedule made no cut: the comparison is vacuous"
    assert dict(tt.metrics.counters) == dict(jt.metrics.counters)
    assert phase_counts(tt.metrics) == phase_counts(jt.metrics)
    assert tt.metrics.timings["engine_stream_alert_to_commit"].count == tres.waves
    assert td.waves_completed == jd.waves_completed == tres.waves


@pytest.mark.parametrize("shape", ["cluster", "fleet"])
def test_stream_matches_own_batch_drive(shape, cluster_pair, fleet_pair):
    # The batch seams: crash / inject_join_wave (with its admissibility
    # read) or stream_crash, then step() rounds, on a fresh target.
    pair = cluster_pair if shape == "cluster" else fleet_pair
    streamed, _, result, waves = pair["torch"]
    batch = torch_cluster() if shape == "cluster" else torch_fleet()
    rpw = RPW if shape == "cluster" else FLEET_RPW
    cuts = 0
    for wave in waves:
        if isinstance(wave, FleetWave):
            batch.stream_crash(wave.crash)
        else:
            if wave.crash:
                batch.crash(list(wave.crash))
            if wave.join:
                batch.inject_join_wave(list(wave.join))
        for _ in range(rpw):
            batch.step()
            cuts += shape == "cluster" and batch.last_decided
    assert_same(all_lanes(streamed, torch_lanes), all_lanes(batch, torch_lanes), "stream vs batch")
    if shape == "cluster":
        assert cuts == result.cuts and streamed.config_id == batch.config_id
    else:
        assert int(batch.config_epochs().sum()) == result.cuts


def test_stream_step_equals_step_round_by_round():
    # Planes on, so the telemetry lanes and the ring are held too; crashes
    # and joins, decided and undecided rounds, and (spread 2, staggered
    # detectors, fallback after 2 rounds) classic decisions.
    waves = PoissonChurn(24, 40, rate=3.0, seed=5).waves(5)
    pair = []
    for _ in range(2):
        vc = torch_cluster(telemetry=True, trace=6, fallback_rounds=2, delivery_spread=2)
        vc.stagger_fd_counts(np.random.default_rng(5), 3)
        pair.append(vc)
    a, b = pair
    decided = []
    for wave in waves:
        for vc, check in ((a, True), (b, False)):
            if wave.crash:
                vc.crash(list(wave.crash))
            if wave.join:
                vc.inject_join_wave(list(wave.join), check_admissible=check)
        for _ in range(6):
            reads = _host.read.count
            streamed = a.stream_step()
            assert _host.read.count == reads, "stream_step read the host"
            batched = b.step()
            assert bool(streamed.decided) == b.last_decided
            decided.append(b.last_decided)
            assert_same(torch_lanes(streamed), torch_lanes(batched), "events")
            assert_same(all_lanes(a, torch_lanes), all_lanes(b, torch_lanes), "round lanes")
    assert any(decided) and not all(decided)
    b.sync()
    assert b.activity["decisions_classic"] > 0


def test_trace_trajectory_matches_jax():
    # A ring of 12 rounds under a 6-wave stream of 4 rounds: some waves'
    # spans are evicted, the rest attributed, as in JAX.
    jax_waves = JaxChurn(24, 40, rate=1.0, seed=7).waves(6)
    waves = PoissonChurn(24, 40, rate=1.0, seed=7).waves(6)
    jvc = cluster(JaxCluster.create, telemetry=True, trace=12)
    tvc = torch_cluster(telemetry=True, trace=12)
    jd, _ = stream(JaxDriver, jvc, jax_waves, RPW)
    td, _ = stream(StreamDriver, tvc, waves, RPW)
    assert td.last_trajectory == jd.last_trajectory
    assert td.last_trajectory["waves_evicted"] > 0 and td.last_trajectory["decided_waves"] > 0
    assert tvc.trace == jvc.trace and tvc.activity == jvc.activity
    assert td.snapshot() == {**jd.snapshot(), **{
        k: td.snapshot()[k] for k in ("view_changes_per_sec", "overlap_efficiency",
                                      "p99_alert_to_commit_ms")}}


@pytest.mark.parametrize("seed,rate,join_fraction", [(42, 1.5, 0.5), (9, 3.0, 0.5), (1, 0.5, 0.8),
                                                    (3, 1.5, 0.1)])
def test_poisson_schedules_are_jax_schedules(seed, rate, join_fraction):
    jax_waves = JaxChurn(24, 40, rate=rate, seed=seed, join_fraction=join_fraction).waves(40)
    waves = PoissonChurn(24, 40, rate=rate, seed=seed, join_fraction=join_fraction).waves(40)
    assert as_tuples(waves) == as_tuples(jax_waves)
    assert PoissonChurn(24, 40, rate=rate, seed=seed + 1).waves(40) != waves
    jax_fleet_waves = JaxFleetChurn(4, 16, rate=rate / 2, seed=seed).waves(12)
    assert as_tuples(FleetPoissonChurn(4, 16, rate=rate / 2, seed=seed).waves(12)) == as_tuples(
        jax_fleet_waves)
    assert PoissonChurn.fleet(4, 16, rate / 2, seed).waves(12) == FleetPoissonChurn(
        4, 16, rate / 2, seed).waves(12)


def test_generator_validation():
    for bad in (dict(rate=0.0), dict(rate=1.0, join_fraction=1.5)):
        with pytest.raises(ValueError):
            PoissonChurn(24, 40, **bad)
    with pytest.raises(ValueError):
        PoissonChurn(41, 40, rate=1.0)
    with pytest.raises(ValueError):
        FleetPoissonChurn(0, 16, rate=1.0)


def test_waves_from_schedule_is_jax_and_round_trips():
    spec = [("crash", (3,), False), ("join", (25,), True), ("crash", (4,), True),
            ("crash", (1, 2), True), ("join", (24,), True), ("crash", (5,), False)]
    events = [FaultEvent(kind=k, slots=s, settle=st) for k, s, st in spec]
    jax_events = [JaxFaultEvent(kind=k, slots=s, settle=st) for k, s, st in spec]
    waves = waves_from_schedule(events)
    assert as_tuples(waves) == as_tuples(jax_waves_from_schedule(jax_events))
    assert waves[0] == StreamWave(crash=(3,), join=(25,)) and waves[-1] == StreamWave(crash=(5,))
    assert [e for w in waves[:-1] for e in w.fault_events()] == events[:-1]
    assert [(e.kind, e.slots, e.args, e.dwell_ms, e.settle) for e in events] == [
        (e.kind, e.slots, e.args, e.dwell_ms, e.settle) for e in jax_events]
    with pytest.raises(ValueError, match="not streamable"):
        waves_from_schedule([FaultEvent(kind="loss", args={"permille": 50})])
    with pytest.raises(ValueError, match="dwell_ms"):
        waves_from_schedule([FaultEvent(kind="crash", slots=(1,), dwell_ms=250.0)])
    with pytest.raises(ValueError, match="empty wave"):
        StreamWave().fault_events()
    with pytest.raises(ScheduleError, match="unknown kind"):
        FaultEvent(kind="typo")  # chaos-kind-ok: the unknown kind is what is tested
    assert STREAMABLE_KINDS == {"crash", "join"}


@pytest.mark.parametrize("seed", [2, 7, 30])
def test_waves_from_a_port_schedule_are_jax(seed):
    """The port's own ``FaultSchedule`` streams: a crash-during-join family
    with its dwells zeroed (the stream advances in rounds) gives JAX's
    waves; an environment fault is refused, naming the port's loss mapping."""
    family = fuzz.scenario_family("crash_during_join", seed)
    schedule = FaultSchedule(
        n0=family.n0, n_slots=family.n_slots, seed=seed, name=family.name,
        events=[dataclasses.replace(e, dwell_ms=0.0) for e in family.events]
        + [FaultEvent("crash", (3,)), FaultEvent("join", (11,))],
    )
    schedule.validate()
    waves = waves_from_schedule(schedule)
    assert as_tuples(waves) == as_tuples(
        jax_waves_from_schedule(JaxFaultSchedule.from_json(schedule.to_json())))
    assert len(waves) == 3 and waves[0].join == (8, 9)
    with pytest.raises(ValueError, match=r"rapid_tpu_torch\.sim\.faults\.loss_as_engine_delivery"):
        waves_from_schedule(fuzz.scenario_family("churn_under_loss", seed))


def test_degenerate_drains_report_rate_zero():
    result = StreamDriver(torch_cluster(), rounds_per_wave=2).drain()
    assert (result.waves, result.rounds, result.cuts, result.wall_ms) == (0, 0, 0, 0.0)
    assert result.view_changes_per_sec == 0.0 and result.overlap_efficiency is None
    assert result.p99_alert_to_commit_ms is None
    frozen = StreamDriver(torch_cluster(), rounds_per_wave=2, clock=lambda: 5.0)
    for wave in PoissonChurn(24, 40, rate=1.0, seed=2).waves(3):
        frozen.submit(wave)
    result = frozen.drain()
    assert result.wall_ms == 0.0 and result.view_changes_per_sec == 0.0
    assert result.overlap_efficiency is None
    assert not any(isinstance(v, float) and (math.isnan(v) or math.isinf(v)) for v in result)


def test_backpressure_bounds_waves_in_flight():
    driver = StreamDriver(torch_cluster(), rounds_per_wave=2, depth=2)
    assert driver.snapshot()["view_changes_per_sec"] is None
    for wave in PoissonChurn(24, 40, rate=0.5, seed=1).waves(7):
        driver.submit(wave)
        assert len(driver._pending) <= 2
    driver.drain()
    snap = driver.snapshot()
    assert snap["waves_submitted"] == snap["waves_completed"] == 7 and snap["waves_in_flight"] == 0


def test_driver_rejects_mismatched_waves_and_shapes():
    vc = torch_cluster()
    with pytest.raises(TypeError, match="FleetWave"):
        StreamDriver(vc).submit(FleetWave(crash=((0, 1),)))
    with pytest.raises(TypeError, match="StreamWave"):
        StreamDriver(torch_fleet()).submit(StreamWave(crash=(1,)))
    for bad in (dict(rounds_per_wave=0), dict(depth=0)):
        with pytest.raises(ValueError):
            StreamDriver(vc, **bad)


def test_admissibility_is_kept_on_the_host():
    # The stream's join skips the [j]-bool read (d2h unchanged, as JAX); the
    # batch join pays it; the driver's host mirror refuses what the read
    # would.
    vc = torch_cluster()
    d2h = vc.metrics.counters["engine_d2h_bytes"]
    reads = _host.read.count
    vc.inject_join_wave([30, 31], check_admissible=False)
    assert vc.metrics.counters["engine_d2h_bytes"] == d2h and _host.read.count == reads
    vc.inject_join_wave([32, 33])
    assert vc.metrics.counters["engine_d2h_bytes"] == d2h + 2
    with pytest.raises(ValueError, match="not admissible"):
        vc.inject_join_wave([30])
    driver = StreamDriver(torch_cluster(), rounds_per_wave=1)
    with pytest.raises(ValueError, match="not admissible"):
        driver.submit(StreamWave(join=(3,)))
    driver.submit(StreamWave(crash=(5,), join=(30,)))
    for slot in (30, 5):
        with pytest.raises(ValueError, match="not admissible"):
            driver.submit(StreamWave(join=(slot,)))
    driver.drain()


def test_stream_crash_and_slot_index_bounds():
    tf = torch_fleet()
    for pairs in ([(3, 0)], [(0, 16)], [(-1, 0)]):
        with pytest.raises(IndexError):
            tf.stream_crash(pairs)
    with pytest.raises(IndexError):
        torch_cluster().crash([40])
    tf.stream_crash([(0, 2), (2, 5)])
    crashed = tf.faults.crashed
    assert crashed.dtype == torch.bool and crashed[0, 2] and crashed[2, 5] and crashed.sum() == 2
    assert tf.metrics.counters["engine_h2d_bytes"] >= 16  # the [2, 2] int32 pairs


def test_histogram_metrics_and_phases_are_jax():
    # The copies the stream's numbers go through: the same samples give the
    # same buckets, quantiles, summaries and Prometheus buckets.
    from rapid_tpu.utils.dispatch import ENGINE_DISPATCH_PHASES as JAX_PHASES

    samples = np.random.default_rng(3).lognormal(1.0, 2.0, 500).tolist() + [0.0, 1e-4, 1e9]
    assert histogram.UPPER_BOUNDS_MS == jax_histogram.UPPER_BOUNDS_MS
    assert [histogram.bucket_index(v) for v in samples] == [
        jax_histogram.bucket_index(v) for v in samples]
    ours, theirs = Metrics(), JaxMetrics()
    for i, v in enumerate(samples):
        for m in (ours, theirs):
            m.record_ms("engine_dispatch", v, phase=("stream_fetch", "step")[i % 2])
            m.record_ms("engine_stream_alert_to_commit", v)
            m.inc("engine_steps", i)
    assert ours.summary() == theirs.summary()
    summary = ours.timings["engine_stream_alert_to_commit"].summary()
    assert histogram.cumulative_from_summary(summary) == jax_histogram.cumulative_from_summary(
        summary)
    merged = histogram.LogHistogram.merged(ours.phase_timings["engine_dispatch"].values())
    assert merged.quantile(0.99) == jax_histogram.LogHistogram.merged(
        theirs.phase_timings["engine_dispatch"].values()).quantile(0.99)
    assert ENGINE_DISPATCH_PHASES == JAX_PHASES
    with pytest.raises(ValueError, match="unregistered"):
        with torch_cluster()._dispatch("typo"):
            pass
