"""The PyTorch port's tenant fleet against the JAX package's, exactly.

One fleet shape, B=6 tenants of N=64 members in 70 slots with C=4 cohorts,
built the way ``bench.py``'s fleet point builds its tenants: three scenario
families (crash wave, join wave, equal churn) by ``i % 3``, FD counters
staggered over 3 rounds, spread 2, and a per-tenant (H, L, fd_threshold)
mix. Both packages build the same tenants from the same seeds on the CPU;
the JAX side runs its own jnp path, as ``bench.py`` does. Every comparison
is exact, lane by lane (uint32 lanes as uint32 bit patterns). Module-scope
fixtures share the JAX compiles.
"""

import numpy as np
import pytest
import torch

from rapid_tpu.models.virtual_cluster import VirtualCluster as JaxCluster
from rapid_tpu.tenancy import TenantFleet as JaxFleet
from rapid_tpu.tenancy.autotune import sweep_khl as jax_sweep_khl
from rapid_tpu_torch.convert import faults_from_numpy, state_from_numpy, state_to_numpy
from rapid_tpu_torch.models.state import map_lanes
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster as TorchCluster
from rapid_tpu_torch.tenancy import TenantFleet as TorchFleet
from rapid_tpu_torch.tenancy.autotune import sweep_khl as torch_sweep_khl

B, N, SLOTS, C = 6, 64, 70, 4
KNOBS = [(9, 4, 3), (8, 3, 3), (7, 2, 1)]
WAVE = dict(max_steps=48, max_cuts=4, min_cuts=1)
STEPS = 24


def jax_lanes(tree):
    return {f: np.asarray(getattr(tree, f)) for f in tree._fields}


def assert_same_lanes(torch_tree, jax_tree, where):
    got, want = state_to_numpy(torch_tree), jax_lanes(jax_tree)
    assert set(got) == set(want)
    for field, w in want.items():
        assert got[field].dtype == w.dtype, f"{where}: {field} dtype {got[field].dtype} != {w.dtype}"
        np.testing.assert_array_equal(got[field], w, err_msg=f"{where}: lane {field}", strict=True)


def build_tenants(make, seed0=50):
    """B clusters from ``make(n, **kwargs)``, cycling the three families;
    returns (clusters, targets)."""
    n_extra = SLOTS - N
    clusters, targets = [], []
    for i in range(B):
        h, l, fd = KNOBS[(i + i // 3) % 3]
        vc = make(
            N, n_slots=SLOTS, k=10, h=h, l=l, cohorts=C, fd_threshold=fd, seed=seed0 + i,
            delivery_spread=2,
        )
        vc.assign_cohorts_roundrobin()
        rng = np.random.default_rng(seed0 + 10_000 + i)
        vc.stagger_fd_counts(rng, spread_rounds=3)
        family = i % 3
        if family != 1:  # crash wave, or the crash half of equal churn
            vc.crash(rng.choice(N, size=n_extra, replace=False))
        if family != 0:  # join wave, or the join half of equal churn
            vc.inject_join_wave(np.arange(N, SLOTS))
        targets.append(N + n_extra * (int(family == 1) - int(family == 0)))
        clusters.append(vc)
    return clusters, targets


def torch_tenants():
    return build_tenants(lambda *a, **kw: TorchCluster.create(*a, device="cpu", **kw))


def jax_fleet():
    clusters, targets = build_tenants(JaxCluster.create)
    return JaxFleet.from_clusters(clusters), targets


def torch_fleet():
    clusters, targets = torch_tenants()
    return TorchFleet.from_clusters(clusters), targets


@pytest.fixture(scope="module")
def wave():
    """Both fleets after one wave, with the results and the port's fleet."""
    jf, targets = jax_fleet()
    tf, _ = torch_fleet()
    want = jf.run_until_membership(targets, **WAVE)
    got = tf.run_until_membership(targets, **WAVE)
    return jf, tf, targets, want, got


def test_fleets_are_built_equal_and_stack_through_numpy():
    jf, _ = jax_fleet()
    tf, _ = torch_fleet()
    assert_same_lanes(tf.state, jf.state, "stacked state")
    assert_same_lanes(tf.faults, jf.faults, "stacked faults")
    for field in ("h", "l", "fd_threshold", "fallback_rounds"):
        np.testing.assert_array_equal(getattr(tf.knobs, field).numpy(), np.asarray(getattr(jf.knobs, field)))
    state = state_from_numpy(tf.cfg, jax_lanes(jf.state), "cpu", tenants=B)
    faults = faults_from_numpy(tf.cfg, jax_lanes(jf.faults), "cpu", tenants=B)
    assert_same_lanes(state, jf.state, "converted state")
    assert_same_lanes(faults, jf.faults, "converted faults")
    with pytest.raises(ValueError, match="expected"):
        state_from_numpy(tf.cfg, jax_lanes(jf.state), "cpu")


def test_fleet_step_matches_jax_round_by_round():
    jf, _ = jax_fleet()
    tf, _ = torch_fleet()
    decided = 0
    for step in range(STEPS):
        ej, et = jf.step(), tf.step()
        assert_same_lanes(et, ej, f"events, round {step + 1}")
        decided += int(np.asarray(ej.decided).sum())
    assert decided >= B  # every tenant cut at least once
    assert_same_lanes(tf.state, jf.state, f"state after {STEPS} rounds")


def test_fleet_wave_matches_jax(wave):
    jf, tf, _, want, got = wave
    for name, g, w in zip(("rounds", "cuts", "resolved", "sizes"), got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert got[2].all()
    assert_same_lanes(tf.state, jf.state, "state after the wave")
    assert tf.config_ids() == jf.config_ids()
    np.testing.assert_array_equal(tf.config_epochs(), np.asarray(jf.config_epochs()))
    np.testing.assert_array_equal(tf.membership_sizes(), np.asarray(jf.membership_sizes()))


def test_fleet_wave_matches_the_ports_single_clusters(wave):
    _, tf, targets, _, (rounds, cuts, resolved, sizes) = wave
    singles, _ = torch_tenants()
    for i, vc in enumerate(singles):
        r, c, res, sz = vc.run_until_membership(targets[i], **WAVE)
        assert (r, c, res) == (rounds[i], cuts[i], resolved[i]), i
        assert list(sz) == sizes[i, :c].tolist() and (sizes[i, c:] == -1).all(), i
        lanes = state_to_numpy(vc.state)
        for field, value in state_to_numpy(tf.tenant_state(i)).items():
            np.testing.assert_array_equal(value, lanes[field], err_msg=f"tenant {i}: {field}")


def test_fleet_run_to_decision_matches_jax():
    jf, _ = jax_fleet()
    tf, _ = torch_fleet()
    want = jf.run_to_decision(max_steps=32)
    got = tf.run_to_decision(max_steps=32)
    for name, g, w in zip(("rounds", "decided", "winner", "members"), got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert got[1].all()
    assert_same_lanes(tf.state, jf.state, "state after run_to_decision")


def contested_tenants(make):
    """Three tenants of ``tests/test_engine.py``'s contested fallback: cohort
    1 cannot hear the observers of a crashed member, so the fast round
    stalls and the classic fallback (two racing coordinators) decides. The
    tenants differ in seed and fallback delay; the third has no deaf cohort
    and decides in the fast round."""
    clusters = []
    for seed, fallback, deaf in ((11, 8, True), (12, 3, True), (13, 5, False)):
        vc = make(120, fd_threshold=2, seed=seed, fallback_rounds=fallback, concurrent_coordinators=2)
        cohort_of = np.zeros(120, dtype=np.int32)
        cohort_of[80:] = 1
        vc.assign_cohorts(cohort_of)
        vc.crash([10, 60])
        if deaf:
            rx = np.zeros((2, 120), dtype=bool)
            rx[1, np.asarray(vc.state.obs_idx)[:, 60]] = True
            vc.set_rx_block(rx)
        clusters.append(vc)
    return clusters


def torch_contested():
    return contested_tenants(lambda *a, **kw: TorchCluster.create(*a, device="cpu", **kw))


def test_fleet_classic_fallback_matches_jax_per_tenant():
    jf = JaxFleet.from_clusters(contested_tenants(JaxCluster.create))
    tf = TorchFleet.from_clusters(torch_contested())
    classic = np.zeros(3, dtype=bool)
    for step in range(32):
        ej, et = jf.step(), tf.step()
        assert_same_lanes(et, ej, f"events, round {step + 1}")
        classic |= np.asarray(ej.decided) & ~np.asarray(ej.fast_decided)
    assert classic.tolist() == [True, True, False]
    assert_same_lanes(tf.state, jf.state, "state after 32 rounds")


def test_fleet_wave_through_the_classic_fallback_matches_single_clusters():
    tf = TorchFleet.from_clusters(torch_contested())
    got = tf.run_until_membership(118, max_steps=40, max_cuts=2, min_cuts=1)
    assert got[2].all()
    for i, vc in enumerate(torch_contested()):
        r, c, res, sz = vc.run_until_membership(118, max_steps=40, max_cuts=2, min_cuts=1)
        assert (r, c, res, list(sz)) == (got[0][i], got[1][i], got[2][i], got[3][i, :c].tolist())
        lanes = state_to_numpy(vc.state)
        for field, value in state_to_numpy(tf.tenant_state(i)).items():
            np.testing.assert_array_equal(value, lanes[field], err_msg=f"tenant {i}: {field}")


def test_quarantined_tenant_stays_frozen_through_a_wave(wave):
    _, unquarantined, targets, _, (rounds, cuts, resolved, sizes) = wave
    tf, _ = torch_fleet()
    tf.quarantine([1])
    tf.quarantine([1])  # idempotent
    assert tf.quarantined == (1,)
    before = state_to_numpy(tf.tenant_state(1))
    got = tf.run_until_membership(targets, **WAVE)
    assert (got[0][1], got[1][1], got[2][1]) == (0, 0, True)
    for field, value in state_to_numpy(tf.tenant_state(1)).items():
        np.testing.assert_array_equal(value, before[field], err_msg=f"frozen lane {field}")
    others = [t for t in range(B) if t != 1]
    for g, w in zip(got, (rounds, cuts, resolved, sizes)):
        np.testing.assert_array_equal(g[others], w[others])
    for t in others:
        want = state_to_numpy(unquarantined.tenant_state(t))
        for field, value in state_to_numpy(tf.tenant_state(t)).items():
            np.testing.assert_array_equal(value, want[field], err_msg=f"tenant {t}: {field}")


def test_health_scan_and_report_match_jax():
    jf, _ = jax_fleet()
    tf, _ = torch_fleet()
    assert not tf.health_scan().any()
    jf.state = jf.state._replace(n_members=jf.state.n_members.at[2].add(5))
    members = tf.state.n_members.clone()
    members[2] += 5
    tf.state = tf.state._replace(n_members=members)
    poisoned = tf.health_scan()
    np.testing.assert_array_equal(poisoned, np.asarray(jf.health_scan()))
    assert poisoned.tolist() == [t == 2 for t in range(B)]
    for t in range(B):
        assert tf.tenant_health_report(t) == jf.tenant_health_report(t)
    assert tf.tenant_health_report(2) == [f"tenant 2: n_members={N + 5} != alive population {N}"]
    with pytest.raises(IndexError):
        tf.tenant_health_report(B)


def test_from_clusters_rejects_what_jax_rejects():
    def make(**kw):
        return TorchCluster.create(12, n_slots=16, k=4, l=1, device="cpu", **kw)

    a = make(h=3, cohorts=2, fd_threshold=1, seed=0)
    with pytest.raises(ValueError, match="fleet-static"):
        TorchFleet.from_clusters([a, make(h=3, cohorts=4, fd_threshold=1, seed=1)])
    fleet = TorchFleet.from_clusters([a, make(h=2, cohorts=2, fd_threshold=2, seed=2)])
    assert fleet.b == 2
    assert fleet.knobs.h.tolist() == [3, 2] and fleet.knobs.fd_threshold.tolist() == [1, 2]
    with pytest.raises(ValueError, match="1 <= L <= H <= K"):
        TorchFleet.from_clusters([make(h=5, cohorts=2, fd_threshold=1, seed=0)])
    with pytest.raises(ValueError, match="at least one tenant"):
        TorchFleet.from_clusters([])
    bad_knobs = fleet.knobs._replace(h=fleet.knobs.h[:1])
    with pytest.raises(ValueError, match="leading tenant axis"):
        TorchFleet(fleet.cfg, fleet.state, fleet.faults, bad_knobs)
    created = TorchFleet.create(2, 12, n_slots=16, k=4, knobs=[(3, 1, 1), (2, 1, 2)], device="cpu")
    assert created.b == 2 and created.knobs.l.tolist() == [1, 1]
    first = map_lanes(lambda x: x[0], created.state)
    np.testing.assert_array_equal(first.cohort_of.numpy(), np.arange(16) % 2)


def test_sweep_khl_matches_jax():
    got = torch_sweep_khl(n=64, f=2, device="cpu")
    want = jax_sweep_khl(n=64, f=2)
    assert got == want
    assert got["best_knob"] is not None
