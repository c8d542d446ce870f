"""The PyTorch port's telemetry plane and round-trace ring against the JAX
package's, exactly.

Every lane is int32, so every comparison is exact (tolerance 0): the ops
(``undecided_log2_bucket``, ``telemetry_cut_masks``), both digests and the
host decoders on seeded inputs; the single cluster's lanes after every
``step`` and after the fused drivers, on the geometry of
``tests/test_trace_ring.py`` (n=24 in 40 slots, K=3, H=3, L=1, two
cohorts, fd_threshold 2); and a three-tenant fleet through each fleet
driver. The port's engine results must not move with the planes on.
"""

import numpy as np
import pytest
import torch

from rapid_tpu.models.virtual_cluster import VirtualCluster as JaxCluster
from rapid_tpu.models.virtual_cluster import telemetry_digest as jax_telemetry_digest
from rapid_tpu.models.virtual_cluster import trace_digest as jax_trace_digest
from rapid_tpu.ops.consensus import undecided_log2_bucket as jax_bucket
from rapid_tpu.ops.cut_detection import telemetry_cut_masks as jax_cut_masks
from rapid_tpu.tenancy import TenantFleet as JaxFleet
from rapid_tpu.utils import engine_telemetry as jax_decoders
from rapid_tpu_torch import _u32
from rapid_tpu_torch.convert import (
    state_to_numpy,
    telemetry_from_numpy,
    telemetry_to_numpy,
    trace_from_numpy,
    trace_to_numpy,
)
from rapid_tpu_torch.models.state import (
    TELEMETRY_BUCKETS,
    TELEMETRY_LANE_SPECS,
    TRACE_LANE_SPECS,
    EngineConfig,
    lane_dims,
    telemetry_bytes_total,
    trace_bytes_total,
)
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster as TorchCluster
from rapid_tpu_torch.models.virtual_cluster import telemetry_digest, trace_digest
from rapid_tpu_torch.ops.consensus import undecided_log2_bucket
from rapid_tpu_torch.ops.cut_detection import telemetry_cut_masks
from rapid_tpu_torch.tenancy import TenantFleet as TorchFleet
from rapid_tpu_torch.utils import engine_telemetry as decoders
from test_torch_engine import SCENARIOS, Twin, assert_same_lanes, jax_lanes

#: The shared ring capacity (one JAX compile per driver kind).
R = 32


def _cluster(cls, trace=R, telemetry=True, n=24, n_slots=40, seed=0, **kw):
    if cls is TorchCluster:
        kw["device"] = "cpu"
    vc = cls.create(
        n, n_slots=n_slots, k=3, h=3, l=1, cohorts=2, fd_threshold=2, seed=seed,
        telemetry=telemetry, trace=trace, **kw,
    )
    vc.assign_cohorts_roundrobin()
    return vc


def assert_same_planes(tvc, jvc, where):
    """The port's telemetry lanes and ring equal the JAX driver's."""
    assert_same_lanes(tvc.telem, jvc.telem, where)
    if jvc.trace_ring is None:
        assert tvc.trace_ring is None
    else:
        assert_same_lanes(tvc.trace_ring, jvc.trace_ring, where)


class PlaneTwin(Twin):
    """``tests/test_torch_engine.py``'s twin with the planes compared too."""

    def check(self, where):
        super().check(where)
        assert_same_planes(self.torch, self.jax, where)


def _lanes_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Ops, digests and decoders on seeded inputs
# ---------------------------------------------------------------------------


def test_undecided_log2_bucket_matches_jax_over_every_count():
    r = np.arange(-2, 2**15 + 1, dtype=np.int32)
    want = np.asarray(jax_bucket(r, TELEMETRY_BUCKETS))
    got = undecided_log2_bucket(torch.from_numpy(r), TELEMETRY_BUCKETS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[r == 1].item() == 0 and got[r == 2**15].item() == TELEMETRY_BUCKETS - 1


# (h, l) per tenant: the engine's knobs, a wide band, and both degenerate
# bands where a zero word is (l <= 0 < h) or is not active.
CUT_KNOBS = [(3, 1), (9, 4), (4, 0), (0, 0), (2, 3)]


def test_telemetry_cut_masks_match_jax():
    rng = np.random.default_rng(7)
    t, c, n = len(CUT_KNOBS), 3, 50

    def bits():
        words = rng.integers(0, 2**32, size=(t, c, n), dtype=np.uint32)
        return words & rng.integers(0, 2**32, size=(t, c, n), dtype=np.uint32) & np.uint32(0x3FF)

    prev, new = bits(), bits()
    final = np.where(rng.random((t, c, n)) < 0.3, 0, prev | new | bits()).astype(np.uint32)
    subject = rng.random((t, n)) < 0.7
    h = torch.tensor([kn[0] for kn in CUT_KNOBS], dtype=torch.int32)
    l = torch.tensor([kn[1] for kn in CUT_KNOBS], dtype=torch.int32)
    lanes = [_u32.from_numpy(x, "cpu") for x in (prev, new, final)]
    got_active, got_inval = telemetry_cut_masks(*lanes, torch.from_numpy(subject), h, l)
    for i, (hi, li) in enumerate(CUT_KNOBS):
        want = [np.asarray(m) for m in jax_cut_masks(prev[i], new[i], final[i], subject[i], hi, li)]
        assert want[1].any() and not want[1].all()
        np.testing.assert_array_equal(got_active[i].numpy(), want[0], err_msg=f"active {hi, li}")
        np.testing.assert_array_equal(got_inval[i].numpy(), want[1], err_msg=f"invalidated {hi, li}")
        # The single cluster's form: Python-int knobs, no tenant axis.
        one = telemetry_cut_masks(*(x[i] for x in lanes), torch.from_numpy(subject[i]), hi, li)
        for g, w in zip(one, want):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"int knobs {hi, li}")


def _seeded_lanes(specs, cfg, t, seed):
    rng = np.random.default_rng(seed)
    dims = lane_dims(cfg)
    return {
        f: rng.integers(0, 1000, size=(t,) + tuple(dims[s] for s in shape)).astype(np.int32)
        for f, shape in specs.items()
    }


def test_digests_match_jax_per_tenant():
    cfg = EngineConfig(n=20, k=3, h=3, l=1, c=3, telemetry=1, trace=5)
    t = 3
    tl = _seeded_lanes(TELEMETRY_LANE_SPECS, cfg, t, 1)
    tr = _seeded_lanes(TRACE_LANE_SPECS, cfg, t, 2)
    got_tl = telemetry_digest(telemetry_from_numpy(cfg, tl, "cpu", tenants=t))
    got_tr = trace_digest(trace_from_numpy(cfg, tr, "cpu", tenants=t))
    assert got_tl.shape == (t, 18) and got_tr.shape == (t, 2 + 9 * cfg.trace)
    from rapid_tpu.models.state import TelemetryLanes as JaxTelemetry
    from rapid_tpu.models.state import TraceRing as JaxTrace

    for i in range(t):
        want_tl = jax_telemetry_digest(JaxTelemetry(**{f: v[i] for f, v in tl.items()}))
        want_tr = jax_trace_digest(JaxTrace(**{f: v[i] for f, v in tr.items()}))
        np.testing.assert_array_equal(got_tl[i].numpy(), np.asarray(want_tl))
        np.testing.assert_array_equal(got_tr[i].numpy(), np.asarray(want_tr))


def test_decoders_match_jax_on_seeded_digests():
    rng = np.random.default_rng(3)
    n, c, cap = 40, 3, 6
    width = len(decoders.TELEMETRY_DIGEST_FIELDS) + TELEMETRY_BUCKETS
    digests = [rng.integers(0, 50, size=width) for _ in range(4)]
    digests.append(np.zeros(width, dtype=np.int64))  # a tenant that never ran
    summaries = [decoders.activity_summary(d, n, c) for d in digests]
    assert summaries == [jax_decoders.activity_summary(d, n, c) for d in digests]
    assert decoders.aggregate_activity(summaries, n, c) == jax_decoders.aggregate_activity(
        summaries, n, c
    )
    assert decoders.aggregate_activity([], n, c) == jax_decoders.zero_activity_summary(n, c)
    assert decoders.zero_activity_summary(n, c) == jax_decoders.zero_activity_summary(n, c)
    assert decoders.TRACE_RECORD_FIELDS == jax_decoders.TRACE_RECORD_FIELDS
    assert decoders.TRACE_PATH_NAMES == jax_decoders.TRACE_PATH_NAMES
    with pytest.raises(ValueError, match="expected"):
        decoders.activity_summary(digests[0][:-1], n, c)

    rings = []
    for cursor in (0, 4, cap, 17):  # empty, partial, full, wrapped twice
        lanes = rng.integers(0, 9, size=9 * cap)
        lanes[6 * cap : 7 * cap] = rng.integers(0, 3, size=cap)  # path codes
        rings.append(np.concatenate([[cursor, cursor // cap], lanes]))
    decoded = [decoders.trace_summary(d, cap) for d in rings]
    assert decoded == [jax_decoders.trace_summary(d, cap) for d in rings]
    assert decoders.zero_trace_summary(cap) == jax_decoders.zero_trace_summary(cap)
    forked = [dict(r) for r in decoded[3]["records"]]
    forked[2]["tally"] += 1
    pairs = [
        (decoded[3], decoded[3]),
        (decoded[3], {**decoded[3], "records": forked}),
        (decoded[1], decoded[2]),
        (decoded[0], decoded[2]),
    ]
    for a, b in pairs:
        assert decoders.first_divergent_round(a, b) == jax_decoders.first_divergent_round(a, b)
    assert decoders.first_divergent_round(*pairs[1]) == forked[2]["seq"]
    with pytest.raises(ValueError, match="expected"):
        decoders.trace_summary(rings[0][:-1], cap)


def test_lane_sizes_and_numpy_bridge_match_jax():
    from rapid_tpu.models.state import telemetry_bytes_total as jax_tl_bytes
    from rapid_tpu.models.state import trace_bytes_total as jax_tr_bytes

    jvc = _cluster(JaxCluster, seed=6)
    jvc.crash([2])
    for _ in range(3):
        jvc.step()
    cfg = EngineConfig(*jvc.cfg)
    assert telemetry_bytes_total(cfg) == jax_tl_bytes(jvc.cfg)
    assert trace_bytes_total(cfg) == jax_tr_bytes(jvc.cfg)
    telem = telemetry_from_numpy(cfg, jax_lanes(jvc.telem), "cpu")
    ring = trace_from_numpy(cfg, jax_lanes(jvc.trace_ring), "cpu")
    assert_same_lanes(telem, jvc.telem, "loaded telemetry")
    assert_same_lanes(ring, jvc.trace_ring, "loaded ring")
    assert telemetry_to_numpy(telem)["tl_rounds"] == 3 and trace_to_numpy(ring)["tr_cursor"] == 3
    stacked = {f: np.stack([v, v]) for f, v in jax_lanes(jvc.telem).items()}
    assert telemetry_from_numpy(cfg, stacked, "cpu", tenants=2).tl_active.shape == (2, 2, 40)
    with pytest.raises(ValueError, match="expected"):
        trace_from_numpy(cfg, jax_lanes(jvc.trace_ring), "cpu", tenants=2)


# ---------------------------------------------------------------------------
# The single cluster
# ---------------------------------------------------------------------------


def _churn_drive(vc, steps=10):
    """``tests/test_trace_ring.py``'s drive: crash two, join two at step 4,
    through ``step``."""
    joiners = np.nonzero(~vc.alive_mask)[0][:2].tolist()
    vc.crash([3, 5])
    for i in range(steps):
        if i == 4:
            vc.inject_join_wave(joiners)
        vc.step()


def test_step_drive_lanes_match_jax_every_round():
    twin = PlaneTwin(24, n_slots=40, k=3, h=3, l=1, cohorts=2, fd_threshold=2, seed=0,
                     telemetry=True, trace=R)
    twin.do("assign_cohorts_roundrobin")
    joiners = np.nonzero(~twin.lane("alive"))[0][:2].tolist()
    twin.do("crash", [3, 5])
    for i in range(10):
        if i == 4:
            twin.do("inject_join_wave", joiners)
        twin.step()
    tvc, jvc = twin.torch, twin.jax
    assert tvc.sync() == jvc.sync()
    assert tvc.activity == jvc.activity
    assert tvc.trace == jvc.trace
    assert tvc.activity["decisions_fast"] == 2 and tvc.trace["rounds_recorded"] == 10


def test_plane_changes_no_result_of_the_port():
    runs = {}
    for telemetry, trace in ((False, 0), (True, 0), (True, R)):
        vc = _cluster(TorchCluster, trace=trace, telemetry=telemetry)
        _churn_drive(vc)
        runs[(telemetry, trace)] = vc
    base = state_to_numpy(runs[(False, 0)].state)
    for key, vc in runs.items():
        for field, value in state_to_numpy(vc.state).items():
            np.testing.assert_array_equal(value, base[field], err_msg=f"{key}: {field}")
    assert _lanes_equal(runs[(True, 0)].telem, runs[(True, R)].telem)
    off = runs[(False, 0)]
    assert off.telem is None and off.trace_ring is None and off.activity is None and off.trace is None
    assert runs[(True, 0)].trace is None and runs[(True, 0)].trace_ring is None


def crashed_observer(t):
    """A member and its ring-0 observer crash: the member's ring-0 report
    never comes, so the implicit invalidation supplies it."""
    t.do("assign_cohorts_roundrobin")
    t.do("crash", [5, int(t.lane("obs_idx")[0, 5])])
    assert t.converge(16)


# Scenarios with both planes on, every lane compared after every round, and
# the counters each must move (so no lane's equality is vacuous).
PLANE_SCENARIOS = {
    "contested_fallback": (SCENARIOS["contested_fallback"], ("decisions_classic", "conflict_rounds")),
    "coordinators_partitioned": (SCENARIOS["coordinators_partitioned"], ("decisions_classic",)),
    "many_cohorts_jitter_c40": (SCENARIOS["many_cohorts_jitter_c40"], ("conflict_rounds", "proposals")),
    "crashed_observer": (
        (crashed_observer, (24,), dict(n_slots=40, k=3, h=3, l=1, fd_threshold=2, seed=0)),
        ("invalidations", "decisions_fast"),
    ),
}


@pytest.mark.parametrize("name", list(PLANE_SCENARIOS))
def test_scenario_planes_match_jax_every_round(name):
    (scenario, args, kwargs), moved = PLANE_SCENARIOS[name]
    twin = PlaneTwin(*args, telemetry=True, trace=8, **kwargs)
    scenario(twin)
    assert twin.torch.sync() == twin.jax.sync()
    assert twin.torch.activity == twin.jax.activity
    assert twin.torch.trace == twin.jax.trace
    assert all(twin.torch.activity[f] > 0 for f in moved), twin.torch.activity


def test_fused_drivers_match_jax_and_the_stepped_drive():
    jvc, tvc, stepped = _cluster(JaxCluster, seed=1), _cluster(TorchCluster, seed=1), _cluster(
        TorchCluster, seed=1
    )
    for vc in (jvc, tvc, stepped):
        vc.crash([2, 7])
    want = jvc.run_to_decision(max_steps=32)
    got = tvc.run_to_decision(max_steps=32)
    assert (got[0], got[1], got[3]) == (want[0], want[1], want[3])
    assert_same_lanes(tvc.state, jvc.state, "run_to_decision")
    assert_same_planes(tvc, jvc, "run_to_decision")
    for _ in range(got[0]):
        stepped.step()
    assert _lanes_equal(stepped.telem, tvc.telem) and _lanes_equal(stepped.trace_ring, tvc.trace_ring)

    jvc2, tvc2 = _cluster(JaxCluster, seed=2), _cluster(TorchCluster, seed=2)
    off2 = _cluster(TorchCluster, seed=2, telemetry=False, trace=0)
    for vc in (jvc2, tvc2, off2):
        vc.crash([1, 4, 9])
    want2 = jvc2.run_until_membership(21, max_steps=64, min_cuts=1)
    got2 = tvc2.run_until_membership(21, max_steps=64, min_cuts=1)
    assert got2 == want2 == off2.run_until_membership(21, max_steps=64, min_cuts=1)
    assert_same_lanes(tvc2.state, jvc2.state, "run_until_membership")
    assert_same_lanes(off2.state, jvc2.state, "run_until_membership, planes off")
    assert_same_planes(tvc2, jvc2, "run_until_membership")
    tvc2.sync()
    assert tvc2.trace["rounds_recorded"] == tvc2.activity["rounds"] == got2[0]


def test_ring_holds_the_last_rounds_across_wraps():
    small, big = _cluster(TorchCluster, trace=6, seed=3), _cluster(TorchCluster, seed=3)
    jsmall = _cluster(JaxCluster, trace=6, seed=3)
    joiners = np.nonzero(~small.alive_mask)[0][:2].tolist()
    for vc in (small, big, jsmall):
        vc.crash([3, 5])
        for _ in range(4):
            vc.step()
        vc.sync()
    pre = small.trace
    assert (pre["rounds_recorded"], pre["rounds_held"], pre["wraps"]) == (4, 4, 0)
    assert pre["records"] == big.trace["records"]
    for vc in (small, big, jsmall):
        vc.inject_join_wave(joiners)
        for _ in range(13):
            vc.step()
        vc.sync()
    assert_same_planes(small, jsmall, "R=6 after 17 rounds")
    trace, ref = small.trace, big.trace
    assert trace == jsmall.trace
    assert trace["rounds_recorded"] == 17 == small.activity["rounds"]
    assert trace["rounds_held"] == 6 and trace["wraps"] == 17 // 6 == 2
    assert int(small.trace_ring.tr_cursor) == int(small.telem.tl_rounds)
    assert trace["records"] == ref["records"][-6:]
    stamps = [(r["epoch"], r["round"]) for r in trace["records"]]
    assert stamps == sorted(set(stamps))
    assert decoders.first_divergent_round(trace, ref) is None


def test_zero_minted_attach_and_copies():
    vc = _cluster(TorchCluster)
    assert vc.trace == decoders.zero_trace_summary(R) == _cluster(JaxCluster).trace
    assert vc.activity == decoders.zero_activity_summary(40, 2)
    vc.trace["records"].append("garbage")
    vc.activity["rounds"] = 99
    assert vc.trace["records"] == [] and vc.activity["rounds"] == 0


def test_quiescent_soak_reads_zero_but_rounds():
    vc = _cluster(TorchCluster, seed=5)
    for _ in range(16):
        vc.step()
    vc.sync()
    activity = vc.activity
    assert activity["rounds"] == 16
    assert all(activity[f] == 0 for f in decoders.TELEMETRY_DIGEST_FIELDS if f != "rounds")
    assert activity["rounds_undecided_hist"] == [0] * TELEMETRY_BUCKETS
    assert activity["active_fraction"] == 0.0 == activity["conflict_rate"]


def test_construction_errors_are_jax_s():
    for kwargs in (dict(trace=4, telemetry=False), dict(trace=-1, telemetry=True)):
        with pytest.raises(ValueError) as want:
            JaxCluster.create(24, k=3, h=3, l=1, **kwargs)
        with pytest.raises(ValueError) as got:
            TorchCluster.create(24, k=3, h=3, l=1, device="cpu", **kwargs)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The fleet: tests/test_trace_ring.py's three tenants
# ---------------------------------------------------------------------------


def _tenants(cls, trace=R, telemetry=True, b=3, n=16, seed0=10, fd=(2, 2, 2)):
    clusters = []
    for i in range(b):
        kw = {"device": "cpu"} if cls is TorchCluster else {}
        vc = cls.create(
            n, k=3, h=3, l=1, cohorts=2, fd_threshold=fd[i], seed=seed0 + i,
            telemetry=telemetry, trace=trace, **kw,
        )
        vc.assign_cohorts_roundrobin()
        vc.crash(list(range(1, 2 + i)))  # tenants resolve at different rounds
        clusters.append(vc)
    return clusters


TARGETS = [15, 14, 13]
WAVE = dict(max_steps=64, min_cuts=1)


def _tenant_lanes(tree, t):
    return type(tree)(*(x[t] for x in tree))


@pytest.fixture(scope="module")
def waves():
    """The JAX fleet and the port's fleet after one wave each."""
    jf = JaxFleet.from_clusters(_tenants(JaxCluster))
    tf = TorchFleet.from_clusters(_tenants(TorchCluster))
    want = jf.run_until_membership(np.asarray(TARGETS), **WAVE)
    got = tf.run_until_membership(TARGETS, **WAVE)
    return jf, tf, want, got


def test_fleet_wave_lanes_match_jax_and_single_clusters(waves):
    jf, tf, want, got = waves
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[2].all()
    assert_same_lanes(tf.telem, jf.telem, "wave telemetry")
    assert_same_lanes(tf.trace_ring, jf.trace_ring, "wave ring")
    jf.sync()
    tf.sync()
    assert tf.tenant_activity == jf.tenant_activity
    assert tf.tenant_trace == jf.tenant_trace
    assert tf.activity == jf.activity
    for t, vc in enumerate(_tenants(TorchCluster)):
        vc.run_until_membership(TARGETS[t], **WAVE)
        assert _lanes_equal(_tenant_lanes(tf.telem, t), vc.telem), t
        assert _lanes_equal(_tenant_lanes(tf.trace_ring, t), vc.trace_ring), t
        vc.sync()
        assert tf.tenant_trace[t] == vc.trace and tf.tenant_activity[t] == vc.activity


def test_fleet_results_do_not_move_with_the_planes(waves):
    _, on, _, got = waves
    off = TorchFleet.from_clusters(_tenants(TorchCluster, trace=0, telemetry=False))
    assert off.telem is None and off.activity is None and off.tenant_trace is None
    for g, w in zip(off.run_until_membership(TARGETS, **WAVE), got):
        np.testing.assert_array_equal(g, w)
    for field, value in state_to_numpy(off.state).items():
        np.testing.assert_array_equal(value, state_to_numpy(on.state)[field], err_msg=field)


def test_quarantined_tenant_records_nothing(waves):
    _, unquarantined, _, _ = waves
    tf = TorchFleet.from_clusters(_tenants(TorchCluster))
    tf.quarantine([1])
    rounds, cuts, _, _ = tf.run_until_membership(TARGETS, **WAVE)
    assert (rounds[1], cuts[1]) == (0, 0)
    tf.sync()
    assert tf.tenant_activity[1]["rounds"] == 0 and tf.tenant_trace[1]["records"] == []
    for t in (0, 2):
        assert _lanes_equal(_tenant_lanes(tf.telem, t), _tenant_lanes(unquarantined.telem, t))
        assert _lanes_equal(_tenant_lanes(tf.trace_ring, t), _tenant_lanes(unquarantined.trace_ring, t))


def test_from_clusters_carries_lanes_accumulated_before_the_stack():
    jclusters, tclusters = _tenants(JaxCluster), _tenants(TorchCluster)
    for vc in jclusters + tclusters:
        for _ in range(3):
            vc.step()
    jf, tf = JaxFleet.from_clusters(jclusters), TorchFleet.from_clusters(tclusters)
    for t, vc in enumerate(tclusters):
        assert _lanes_equal(_tenant_lanes(tf.telem, t), vc.telem)
        assert int(tf.trace_ring.tr_cursor[t]) == 3
    want = jf.run_until_membership(np.asarray(TARGETS), **WAVE)
    got = tf.run_until_membership(TARGETS, **WAVE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert_same_lanes(tf.telem, jf.telem, "carried telemetry")
    assert_same_lanes(tf.trace_ring, jf.trace_ring, "carried ring")


def test_fleet_step_and_run_to_decision_lanes_match_jax():
    jf = JaxFleet.from_clusters(_tenants(JaxCluster))
    tf = TorchFleet.from_clusters(_tenants(TorchCluster))
    tf.quarantine([2])  # fleet_step keeps running a quarantined tenant's rounds
    for step in range(6):
        assert_same_lanes(tf.step(), jf.step(), f"events, round {step + 1}")
        assert_same_lanes(tf.telem, jf.telem, f"telemetry, round {step + 1}")
        assert_same_lanes(tf.trace_ring, jf.trace_ring, f"ring, round {step + 1}")
    assert int(tf.telem.tl_rounds[2]) == 6
    # Different failure thresholds: the tenants decide in different rounds,
    # and one that decided must stop recording.
    jf2 = JaxFleet.from_clusters(_tenants(JaxCluster, fd=(1, 2, 4)))
    tf2 = TorchFleet.from_clusters(_tenants(TorchCluster, fd=(1, 2, 4)))
    want = jf2.run_to_decision(max_steps=32)
    got = tf2.run_to_decision(max_steps=32)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, np.asarray(w))
    assert len(set(got[0].tolist())) == 3, got[0]
    assert_same_lanes(tf2.state, jf2.state, "run_to_decision state")
    assert_same_lanes(tf2.telem, jf2.telem, "run_to_decision telemetry")
    assert_same_lanes(tf2.trace_ring, jf2.trace_ring, "run_to_decision ring")
    tf2.health_scan()
    jf2.health_scan()
    assert tf2.tenant_trace == jf2.tenant_trace
