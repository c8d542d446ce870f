"""The PyTorch port's supervision tier (``rapid_tpu_torch/serving``
supervisor and recovery) against the JAX package's.

The shapes of ``tests/test_supervisor.py`` (a cluster of N=24 in 40 slots,
K=3; a fleet of 3 x 16). Deadlines, backoff and retries run on fake clocks
and never sleep. The kill/resume drills must end bit for bit where the
uninterrupted run ends, in the port, and where the JAX package's own
uninterrupted run ends, on every lane; the recovery timelines (ledger
events) must be JAX's. Module-scope fixtures share the JAX compiles.
"""

import json

import jax
import numpy as np
import pytest
import torch

from rapid_tpu.models.virtual_cluster import VirtualCluster as JaxCluster
from rapid_tpu.serving import BackoffPolicy as JaxBackoff
from rapid_tpu.serving import FleetPoissonChurn as JaxFleetChurn
from rapid_tpu.serving import PoissonChurn as JaxChurn
from rapid_tpu.serving import SimulatedProcessKill as JaxKill
from rapid_tpu.serving import Supervisor as JaxSupervisor
from rapid_tpu.serving import SupervisorFaultPlan as JaxPlan
from rapid_tpu.serving import recovery as jax_recovery
from rapid_tpu.tenancy import TenantFleet as JaxFleet
from rapid_tpu.utils.ledger import LedgerEvent as JaxLedgerEvent
from rapid_tpu_torch.convert import state_to_numpy
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster as TorchCluster
from rapid_tpu_torch.serving import (
    BackoffPolicy,
    DispatchWedgedError,
    FleetPoissonChurn,
    FleetWave,
    PoissonChurn,
    SimulatedProcessKill,
    StreamWave,
    Supervisor,
    SupervisorBudgets,
    SupervisorFaultPlan,
    recovery,
)
from rapid_tpu_torch.tenancy import TenantFleet as TorchFleet
from rapid_tpu_torch.utils.checkpoint import CheckpointCorruptError, load_serving_state
from rapid_tpu_torch.utils.ledger import LedgerEvent

CPU = "cpu"


def torch_cluster(seed=0):
    vc = TorchCluster.create(24, n_slots=40, k=3, h=3, l=1, cohorts=2, fd_threshold=2, seed=seed,
                             device=CPU)
    vc.assign_cohorts_roundrobin()
    return vc


def jax_cluster(seed=0):
    vc = JaxCluster.create(24, n_slots=40, k=3, h=3, l=1, cohorts=2, fd_threshold=2, seed=seed)
    vc.assign_cohorts_roundrobin()
    return vc


def make_fleet(make, fleet_cls, seeds, **kw):
    clusters = []
    for s in seeds:
        vc = make(16, k=3, h=3, l=1, cohorts=2, fd_threshold=2, seed=s, **kw)
        vc.assign_cohorts_roundrobin()
        clusters.append(vc)
    return fleet_cls.from_clusters(clusters)


def torch_fleet(seeds=(10, 11, 12)):
    return make_fleet(TorchCluster.create, TorchFleet, seeds, device=CPU)


def jax_fleet(seeds=(10, 11, 12)):
    return make_fleet(JaxCluster.create, JaxFleet, seeds)


def lanes_of(target):
    if isinstance(target, (TorchCluster, TorchFleet)):
        return {**state_to_numpy(target.state), **state_to_numpy(target.faults)}
    return {f"{k}": np.asarray(v) for tree in (target.state, target.faults)
            for k, v in tree._asdict().items()}


def assert_same(got, want, where):
    assert set(got) == set(want), where
    for field, w in want.items():
        np.testing.assert_array_equal(got[field], w, err_msg=f"{where}: {field}", strict=True)


class FakeClock:
    """Injected decision clock: advances only when the fake sleep runs."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds


class Recorder:
    """A ledger: any object with ``.emit(event, stage=..., **fields)``."""

    def __init__(self):
        self.events = []

    def emit(self, event, stage=None, **fields):
        self.events.append({"event": event.value, "stage": stage, **fields})

    def kinds(self):
        return [e["event"] for e in self.events]


def settled(sup):
    """``sup`` with its driver's reaper answered as the port's CPU tickets
    answer it: wait for the ticket, then ask the supervisor's own
    (fault-aware) probe. JAX's CPU backend runs asynchronously, so its
    probe says "not yet" at random, and which waits count as
    ``stream_fetch`` dispatches would vary from run to run. The port's
    supervisors are returned as they are."""
    if isinstance(sup, JaxSupervisor):
        probe = sup.driver._ticket_ready

        def ready(wave, ticket):
            jax.block_until_ready(ticket)
            return probe(wave, ticket)

        sup.driver._ticket_ready = ready
    return sup


def drill(sup_cls, kill_cls, resume, target, waves, tmp, plan, **resume_kw):
    """The recovery drill: a supervised stream with checkpoints every 2
    waves killed by ``plan``, resumed from its directory, the rest of the
    schedule replayed. Returns (resumed supervisor, resumed wave, ledger)."""
    ledger = Recorder()
    sup = settled(sup_cls(target, rounds_per_wave=4, depth=2, checkpoint_dir=tmp,
                          checkpoint_every=2, fault_plan=plan, ledger=ledger,
                          ledger_stage="recovery", sleep=lambda s: None))
    with pytest.raises(kill_cls):
        for wave in waves:
            sup.submit(wave)
    resumed, next_wave = resume(tmp, checkpoint_every=2, ledger=ledger, ledger_stage="recovery",
                                **resume_kw)
    settled(resumed)
    for wave in waves[next_wave:]:
        resumed.submit(wave)
    resumed.drain()
    return resumed, next_wave, ledger


@pytest.fixture(scope="module")
def cluster_runs(tmp_path_factory):
    """The JAX and port twins of test_supervisor.py's cluster drill: an
    uninterrupted run and a drill (2 transient failures at wave 1, a kill
    after wave 3) in each package."""
    root = tmp_path_factory.mktemp("cluster")
    out = {}
    for name, sup_cls, kill_cls, plan_cls, resume, make, churn, extra in (
        ("jax", JaxSupervisor, JaxKill, JaxPlan, jax_recovery.resume, jax_cluster, JaxChurn, {}),
        ("torch", Supervisor, SimulatedProcessKill, SupervisorFaultPlan, recovery.resume,
         torch_cluster, PoissonChurn, dict(device=CPU)),
    ):
        waves = churn(24, 40, rate=1.0, seed=7).waves(6)
        unbroken = make()
        sup = settled(sup_cls(unbroken, rounds_per_wave=4, depth=2))
        for wave in waves:
            sup.submit(wave)
        result = sup.drain()
        resumed, next_wave, ledger = drill(
            sup_cls, kill_cls, resume, make(), waves, root / name,
            plan_cls(transient_submit=((1, 2),), kill_after_wave=3), **extra)
        out[name] = dict(unbroken=unbroken, result=result, resumed=resumed, next_wave=next_wave,
                         ledger=ledger)
    return out


def test_backoff_schedules_and_budgets_are_jax():
    for seed in (0, 3, 9):
        assert BackoffPolicy(max_attempts=5, seed=seed).delays_ms() == JaxBackoff(
            max_attempts=5, seed=seed).delays_ms()
    assert BackoffPolicy(seed=3).delays_ms() != BackoffPolicy(seed=4).delays_ms()
    budgets = SupervisorBudgets(submit_ms=10.0)
    assert budgets.for_phase("submit") == 10.0 and budgets.for_phase("checkpoint") == 120_000.0
    with pytest.raises(ValueError, match="no deadline budget"):
        budgets.for_phase("made_up_phase")
    assert {e.name: e.value for e in LedgerEvent} == {e.name: e.value for e in JaxLedgerEvent}


@pytest.mark.parametrize("depth", [1, 2])
def test_wedged_ticket_raises_at_the_drain_budget(depth):
    # At depth 2 the reaper runs before the drain; the plan's wedged ticket
    # must survive it (the fault-aware probe) and wedge the drain.
    clock, vc = FakeClock(), torch_cluster()
    sup = Supervisor(vc, rounds_per_wave=2, depth=depth,
                     budgets=SupervisorBudgets(drain_ms=40.0),
                     fault_plan=SupervisorFaultPlan(wedge_wave=0), clock=clock, sleep=clock.sleep)
    churn = PoissonChurn(24, 40, rate=1.0, seed=5)
    sup.submit(StreamWave(crash=(3,)) if depth == 1 else churn.wave())
    if depth == 2:
        sup.submit(churn.wave())
    with pytest.raises(DispatchWedgedError) as exc:
        sup.drain()
    assert exc.value.phase == "drain" and exc.value.wave_index == 0 and "wave 0" in str(exc.value)
    assert clock.t * 1000.0 >= 40.0
    assert vc.metrics.counters["engine_recovery_wedges"] == 1


def test_lost_ticket_wedges_backpressure_under_the_submit_budget():
    clock, vc = FakeClock(), torch_cluster()
    sup = Supervisor(vc, rounds_per_wave=2, depth=1, budgets=SupervisorBudgets(submit_ms=30.0),
                     fault_plan=SupervisorFaultPlan(lose_ticket_wave=0), clock=clock,
                     sleep=clock.sleep)
    sup.submit(StreamWave(crash=(5,)))
    with pytest.raises(DispatchWedgedError) as exc:
        sup.submit(StreamWave(crash=(6,)))
    assert exc.value.phase == "submit" and exc.value.wave_index == 0
    assert "ticket lost" in str(exc.value)


def test_transient_failures_retry_on_the_seeded_schedule():
    slept = []
    vc = torch_cluster()
    policy = BackoffPolicy(max_attempts=4, base_ms=50.0, seed=9)
    sup = Supervisor(vc, rounds_per_wave=2, poll_ms=0.5, backoff=policy,
                     fault_plan=SupervisorFaultPlan(transient_submit=((0, 2),)),
                     sleep=slept.append)
    sup.submit(StreamWave(crash=(3,)))
    assert vc.metrics.counters["engine_recovery_retries"] == 2
    want = [d / 1000.0 for d in JaxBackoff(max_attempts=4, base_ms=50.0, seed=9).delays_ms()[:2]]
    assert slept == want  # the CPU ticket is ready at once: no poll sleeps
    sup.drain()
    assert sup.driver.waves_completed == 1


def test_exhausted_retries_escalate():
    vc = torch_cluster()
    sup = Supervisor(vc, rounds_per_wave=2, backoff=BackoffPolicy(max_attempts=3, seed=1),
                     fault_plan=SupervisorFaultPlan(transient_submit=((0, 99),)),
                     sleep=lambda s: None)
    with pytest.raises(DispatchWedgedError) as exc:
        sup.submit(StreamWave(crash=(3,)))
    assert exc.value.phase == "submit" and "retries exhausted" in str(exc.value)
    assert vc.metrics.counters["engine_recovery_retries"] == 3
    assert vc.metrics.counters["engine_recovery_wedges"] == 1


def test_cluster_kill_resume_is_bit_identical_and_jax(cluster_runs):
    jx, tr = cluster_runs["jax"], cluster_runs["torch"]
    # Counters first: the reads below charge bytes to the port's side only.
    assert dict(tr["resumed"].target.metrics.counters) == dict(
        jx["resumed"].target.metrics.counters)
    assert tr["result"].cuts == jx["result"].cuts > 0
    assert tr["next_wave"] == jx["next_wave"] == 4
    resumed = tr["resumed"].target
    assert tr["resumed"].last_resume_ms is not None
    for want in (lanes_of(tr["unbroken"]), lanes_of(jx["unbroken"]), lanes_of(jx["resumed"].target)):
        assert_same(lanes_of(resumed), want, "resumed drill")
    assert resumed.config_id == tr["unbroken"].config_id == jx["unbroken"].config_id
    # The recovery timelines are JAX's, event for event.
    strip = ("path", "checkpoint", "mttr_ms", "error")
    timeline = [{k: v for k, v in e.items() if k not in strip} for e in tr["ledger"].events]
    jax_timeline = [{k: v for k, v in e.items() if k not in strip} for e in jx["ledger"].events]
    assert timeline == jax_timeline
    assert tr["ledger"].kinds().count("recovery_retry") == 2


def test_fleet_kill_resume_is_bit_identical_and_jax(tmp_path):
    results = {}
    for name, sup_cls, kill_cls, plan_cls, resume, make, churn, extra in (
        ("jax", JaxSupervisor, JaxKill, JaxPlan, jax_recovery.resume, jax_fleet, JaxFleetChurn, {}),
        ("torch", Supervisor, SimulatedProcessKill, SupervisorFaultPlan, recovery.resume,
         torch_fleet, FleetPoissonChurn, dict(device=CPU)),
    ):
        unbroken = make()
        sup = sup_cls(unbroken, rounds_per_wave=3, depth=2)
        for wave in churn(3, 16, rate=0.7, seed=3).waves(5):
            sup.submit(wave)
        sup.drain()
        target = make()
        sup = sup_cls(target, rounds_per_wave=3, depth=2, checkpoint_dir=tmp_path / name,
                      checkpoint_every=2, fault_plan=plan_cls(kill_after_wave=2))
        with pytest.raises(kill_cls):
            for wave in churn(3, 16, rate=0.7, seed=3).waves(5):
                sup.submit(wave)
        resumed, next_wave = resume(tmp_path / name, **extra)
        assert next_wave == 2 and resumed.target.b == 3
        schedule = recovery.fast_forward(churn(3, 16, rate=0.7, seed=3), next_wave)
        for _ in range(next_wave, 5):
            resumed.submit(schedule.wave())
        resumed.drain()
        results[name] = (unbroken, resumed.target)
    (jax_unbroken, _), (unbroken, resumed) = results["jax"], results["torch"]
    for want in (lanes_of(unbroken), lanes_of(jax_unbroken)):
        assert_same(lanes_of(resumed), want, "resumed fleet")
    for field in resumed.knobs._fields:
        np.testing.assert_array_equal(getattr(resumed.knobs, field).numpy(),
                                      np.asarray(getattr(jax_unbroken.knobs, field)), strict=True)
    assert resumed.config_ids() == unbroken.config_ids() == jax_unbroken.config_ids()


def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    waves = PoissonChurn(24, 40, rate=1.0, seed=7).waves(6)
    unbroken = torch_cluster()
    sup = Supervisor(unbroken, rounds_per_wave=4, depth=2)
    for wave in waves:
        sup.submit(wave)
    sup.drain()
    sup = Supervisor(torch_cluster(), rounds_per_wave=4, depth=2, checkpoint_dir=tmp_path,
                     checkpoint_every=2,
                     fault_plan=SupervisorFaultPlan(kill_after_wave=3, corrupt_checkpoint_at=4))
    with pytest.raises(SimulatedProcessKill):
        for wave in waves:
            sup.submit(wave)
    newest, loaded, skipped = recovery.latest_valid_checkpoint(tmp_path, device=CPU)
    assert newest.name == "ckpt_w00000002.npz" and loaded is not None
    assert [p.name for p in skipped] == ["ckpt_w00000004.npz"]
    with pytest.raises(CheckpointCorruptError):
        load_serving_state(tmp_path / "ckpt_w00000004.npz", device=CPU)
    ledger = Recorder()
    resumed, next_wave = recovery.resume(tmp_path, ledger=ledger, device=CPU)
    assert next_wave == 2 and ledger.kinds() == ["recovery_checkpoint_corrupt", "recovery_resume"]
    for wave in waves[next_wave:]:
        resumed.submit(wave)
    resumed.drain()
    assert_same(lanes_of(resumed.target), lanes_of(unbroken), "fallback resume")


def test_truncated_checkpoint_empty_directory_and_pruning(tmp_path):
    sup = Supervisor(torch_cluster(), rounds_per_wave=2, checkpoint_dir=tmp_path / "t",
                     checkpoint_every=1, checkpoint_keep=1,
                     fault_plan=SupervisorFaultPlan(truncate_checkpoint_at=1))
    sup.submit(StreamWave(crash=(3,)))
    for where in ("t", "never-written"):
        with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
            recovery.resume(tmp_path / where, device=CPU)
    sup = Supervisor(torch_cluster(), rounds_per_wave=2, checkpoint_dir=tmp_path / "p",
                     checkpoint_every=1, checkpoint_keep=2)
    for wave in PoissonChurn(24, 40, rate=0.5, seed=2).waves(5):
        sup.submit(wave)
    sup.drain()
    names = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert names == ["ckpt_w00000004.npz", "ckpt_w00000005.npz"]
    assert sup.checkpoints_written == 5 == sup.snapshot()["checkpoints_written"]
    with pytest.raises(ValueError):
        Supervisor(torch_cluster(), checkpoint_every=2)


def _poison(fleet, t):
    n_members = fleet.state.n_members.clone()
    n_members[t] = -3
    fleet.state = fleet.state._replace(n_members=n_members)


def test_quarantine_spares_the_rest_and_replays_in_both_packages(tmp_path):
    fleet = torch_fleet()
    _poison(fleet, 1)
    np.testing.assert_array_equal(fleet.health_scan(), [False, True, False])
    ledger = Recorder()
    sup = Supervisor(fleet, rounds_per_wave=2, ledger=ledger)
    assert sup.scan_and_quarantine(repro_dir=tmp_path) == [1] and fleet.quarantined == (1,)
    assert sup.scan_and_quarantine() == []
    assert ledger.kinds() == ["recovery_quarantine"]
    assert fleet.metrics.counters["engine_tenant_quarantines"] == 1
    control = torch_fleet((10, 12))
    for f in (fleet, control):
        crashed = f.faults.crashed.clone()
        crashed[:, 3] = True
        f.faults = f.faults._replace(crashed=crashed)
    rounds, cuts, _, _ = fleet.run_until_membership(15, max_steps=64, min_cuts=1)
    c_rounds, c_cuts, _, _ = control.run_until_membership(15, max_steps=64, min_cuts=1)
    assert rounds[1] == 0 and cuts[1] == 0
    for ia, ib in ((0, 0), (2, 1)):
        assert (rounds[ia], cuts[ia]) == (c_rounds[ib], c_cuts[ib])
        assert_same(state_to_numpy(fleet.tenant_state(ia)), state_to_numpy(control.tenant_state(ib)),
                    f"tenant {ia}")
    repro = tmp_path / "tenant1"
    recipe = json.loads((repro / "fleet.json").read_text())
    assert recipe["kind"] == "quarantine" and recipe["tenant_index"] == 1
    recorded = [line for line in (repro / "violations.txt").read_text().splitlines()
                if line and line != "(none)"]
    replayed = recovery.replay_quarantine_repro(repro, device=CPU)
    assert replayed == recorded and any("n_members=-3" in v for v in replayed)
    # The repro is the JAX package's format: its replay reads the same.
    assert jax_recovery.replay_quarantine_repro(repro) == replayed


def test_quarantined_tenants_get_no_churn_and_no_cut_count():
    fleet = torch_fleet()
    _poison(fleet, 0)
    sup = Supervisor(fleet, rounds_per_wave=2)
    sup.scan_and_quarantine()
    sup.submit(FleetWave(crash=((0, 5), (1, 5))))
    result = sup.drain()
    crashed = fleet.faults.crashed
    assert not bool(crashed[0, 5]) and bool(crashed[1, 5])
    assert fleet.metrics.counters["engine_recovery_quarantine_dropped_events"] == 1
    epochs = fleet.config_epochs()
    assert result.cuts == int(epochs[1:].sum())


def test_snapshots_have_jax_keys():
    tsup = Supervisor(torch_cluster(), rounds_per_wave=2)
    jsup = JaxSupervisor(jax_cluster(), rounds_per_wave=2)
    assert tsup.snapshot() == jsup.snapshot()
    assert tsup.driver.snapshot().keys() == jsup.driver.snapshot().keys()
    assert torch.is_tensor(tsup.target.state.alive)
