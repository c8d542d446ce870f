"""The PyTorch port's compact state layout (``compact=1``) against the JAX
package's, exactly.

At the JAX suite's small geometry (``tests/test_state_compaction.py``: n=24
members in 40 slots, K=3, H=3, L=1, C=2): the policy, the lane table and
the sizing formula over a grid of boundaries; the bit-packed masks; the
wide <-> compact converters and the envelope check; a compact JAX state
through the numpy bridge, one port round and back; the crash, join and
leave churn through the JAX compact engine, the port's compact engine and
the port's wide one; a 2-tenant compact fleet; the envelope's edge; and the
two scenarios whose narrow lanes carry a sign bit (K=16: a uint16 report
lane; ``fd_window``=16: a uint16 history lane). After every round every
lane's dtype must be the policy's (nothing re-widens). The tests share a
few configs, so the JAX engine compiles each once per process.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_tpu.models import state as JS
from rapid_tpu.models.virtual_cluster import VirtualCluster as JaxCluster
from rapid_tpu.tenancy import TenantFleet as JaxFleet
from rapid_tpu_torch.convert import faults_from_numpy, state_from_numpy, state_to_numpy
from rapid_tpu_torch.models import state as TS
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster as TorchCluster
from rapid_tpu_torch.tenancy import TenantFleet as TorchFleet
from rapid_tpu_torch.tenancy.fleet import tenant_health

GEOM = dict(k=3, h=3, l=1, cohorts=2, fd_threshold=2)


def jax_lanes(tree):
    return {f: np.asarray(getattr(tree, f)) for f in tree._fields}


def assert_same_lanes(torch_tree, jax_tree, where):
    got, want = state_to_numpy(torch_tree), jax_lanes(jax_tree)
    assert set(got) == set(want)
    for field, w in want.items():
        assert got[field].dtype == w.dtype, f"{where}: {field} dtype {got[field].dtype} != {w.dtype}"
        np.testing.assert_array_equal(got[field], w, err_msg=f"{where}: lane {field}", strict=True)


def assert_policy_dtypes(vc, where):
    """No lane of the port's state or faults left its policy dtype."""
    want = TS.lane_dtypes(vc.cfg)
    for tree in (vc.state, vc.faults):
        for field, value in state_to_numpy(tree).items():
            assert value.dtype.name == want[field], f"{where}: {field} is {value.dtype}"


def clusters(compact, n=24, n_slots=40, seed=0, **kw):
    """The same cluster built by both packages on the CPU."""
    params = {**GEOM, **kw}
    made = (
        JaxCluster.create(n, n_slots=n_slots, seed=seed, compact=compact, **params),
        TorchCluster.create(n, n_slots=n_slots, seed=seed, compact=compact, device="cpu", **params),
    )
    for vc in made:
        vc.assign_cohorts_roundrobin()
    return made


class Twin:
    """One scenario driven through the JAX package and the port in lockstep,
    every lane compared after every call and every round."""

    def __init__(self, compact=True, **kw):
        self.jax, self.torch = clusters(compact, **kw)
        self.check("create")

    def check(self, where):
        assert_same_lanes(self.torch.state, self.jax.state, where)
        assert_same_lanes(self.torch.faults, self.jax.faults, where)
        assert_policy_dtypes(self.torch, where)

    def do(self, method, *args):
        getattr(self.jax, method)(*args)
        getattr(self.torch, method)(*args)
        self.check(method)

    def step(self, where):
        ej, et = self.jax.step(), self.torch.step()
        assert_same_lanes(et, ej, where)
        self.check(where)
        assert self.torch.last_decided == bool(ej.decided)
        return et


# ---------------------------------------------------------------------------
# Policy, lane table, sizing
# ---------------------------------------------------------------------------


def test_constants_and_lane_sets_match_jax():
    assert (TS.FIRE_NEVER, TS.FIRE_NEVER_NARROW, TS.ROUND_ENVELOPE) == (
        JS.FIRE_NEVER, JS.FIRE_NEVER_NARROW, JS.ROUND_ENVELOPE)
    assert TS.NARROWABLE_LANES == JS.NARROWABLE_LANES
    assert tuple(TS.WIDE_POLICY) == tuple(JS.WIDE_POLICY)
    assert TS.CompactionPolicy._fields == JS.CompactionPolicy._fields
    assert TS.LANE_SPECS == JS.LANE_SPECS
    assert TS.PACKED_MASK_AXES == JS.PACKED_MASK_AXES
    assert set(TS.LANE_SPECS) == set(TS.EngineState._fields) | set(TS.FaultInputs._fields)
    for n in (1, 127, 128, 32_767, 32_768, 10**8):
        assert TS.min_index_dtype(n) == JS.min_index_dtype(n)


@pytest.mark.parametrize("n", [127, 128, 32_767, 32_768])
@pytest.mark.parametrize("k", [8, 9, 16, 17])
def test_policy_lane_dtypes_and_bytes_match_jax_over_the_boundaries(n, k):
    for c, fd_window, use_pallas, compact in itertools.product(
        (127, 128), (0, 8, 9, 16), (0, 1), (0, 1)
    ):
        cfg = TS.EngineConfig(n=n, k=k, h=3, l=1, c=c, fd_window=fd_window,
                              use_pallas=use_pallas, compact=compact)
        jcfg = JS.EngineConfig(*cfg)
        where = f"c={c} fd_window={fd_window} use_pallas={use_pallas} compact={compact}"
        assert tuple(TS.compaction_policy(cfg)) == tuple(JS.compaction_policy(jcfg)), where
        assert TS.lane_dtypes(cfg) == JS.lane_dtypes(jcfg), where
        for packed in (False, True):
            assert TS.state_bytes_total(cfg, packed) == JS.state_bytes_total(jcfg, packed), where
            assert TS.state_bytes_per_member(cfg, packed) == JS.state_bytes_per_member(jcfg, packed)


# (n, c, B/member wide, compact, packed) at the port's three shapes: the
# churn (100,000 members + 2,500 joiner slots, C=64), the 1M scale point
# (C=8) and one fleet tenant (1,024 members + 20 slots, C=8); K=10.
SHAPES = [(102_500, 64, 873, 665, 475), (1_000_000, 8, 481, 385, 342), (1_044, 8, 481, 301, 258)]


@pytest.mark.parametrize("n,c,wide,compact,packed", SHAPES)
def test_state_bytes_at_the_ports_shapes(n, c, wide, compact, packed):
    cfg = TS.EngineConfig(n=n, k=10, h=9, l=4, c=c)
    comp = cfg._replace(compact=1)
    for want_cfg, got_cfg, packs in ((cfg, cfg, False), (comp, comp, False), (comp, comp, True)):
        assert TS.state_bytes_total(got_cfg, packs) == JS.state_bytes_total(JS.EngineConfig(*want_cfg), packs)
    got = [round(TS.state_bytes_per_member(x, p)) for x, p in ((cfg, False), (comp, False), (comp, True))]
    assert got == [wide, compact, packed]


def test_real_state_bytes_equal_the_formula():
    _, vc = clusters(True)
    measured = TS.pytree_nbytes(vc.state) + TS.pytree_nbytes(vc.faults)
    assert measured == TS.state_bytes_total(vc.cfg)
    packed = TS.pytree_nbytes(TS.pack_masks(vc.state)) + TS.pytree_nbytes(TS.pack_masks(vc.faults))
    assert packed == TS.state_bytes_total(vc.cfg, packed=True)
    wide = TorchCluster.create(24, n_slots=40, device="cpu", **GEOM)
    assert TS.pytree_nbytes(wide.state) + TS.pytree_nbytes(wide.faults) == TS.state_bytes_total(wide.cfg)


# ---------------------------------------------------------------------------
# Bit-packed masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axis", [((40,), 0), ((40, 3), 0), ((2, 40), 1), ((16,), 0)])
def test_pack_bool_matches_jax_bit_for_bit(shape, axis):
    mask = np.random.default_rng(3).random(shape) < 0.3
    packed = TS.pack_bool(torch.from_numpy(mask), axis=axis)
    want = np.asarray(JS.pack_bool(mask, axis=axis))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(TS.unpack_bool(packed, axis=axis).numpy(), mask)
    with pytest.raises(ValueError, match="multiple of 8"):
        TS.pack_bool(torch.zeros(13, dtype=torch.bool), axis=0)


def test_pack_masks_matches_jax_on_a_compact_state():
    jvc, tvc = clusters(True)
    for vc in (jvc, tvc):
        vc.crash([1, 2])
        vc.inject_join_wave([30])
    for tree, jtree in ((tvc.state, jvc.state), (tvc.faults, jvc.faults)):
        packed, jpacked = TS.pack_masks(tree), JS.pack_masks(jtree)
        lanes = state_to_numpy(tree)
        for field, want in jax_lanes(jpacked).items():
            got = getattr(packed, field).numpy() if field in TS.PACKED_MASK_AXES else lanes[field]
            assert got.dtype == want.dtype, field
            np.testing.assert_array_equal(got, want, err_msg=field)
        back = state_to_numpy(TS.unpack_masks(packed))
        for field, value in lanes.items():
            np.testing.assert_array_equal(back[field], value, err_msg=field)


# ---------------------------------------------------------------------------
# Converters and the envelope
# ---------------------------------------------------------------------------


def test_narrow_and_widen_match_jax_and_round_trip():
    jvc, tvc = clusters(False, delivery_spread=2)
    for vc in (jvc, tvc):
        vc.stagger_fd_counts(np.random.default_rng(5), spread_rounds=3)
        vc.crash([3, 7])
        vc.step()
    assert_same_lanes(tvc.state, jvc.state, "wide")
    cfg = tvc.cfg._replace(compact=1)
    narrowed = TS.narrow_state(cfg, tvc.state)
    assert_same_lanes(narrowed, JS.narrow_state(JS.EngineConfig(*cfg), jvc.state), "narrowed")
    assert_same_lanes(TS.widen_state(cfg, narrowed), jvc.state, "widened back")
    assert_same_lanes(TS.widen_state(tvc.cfg, tvc.state), jvc.state, "widen of a wide state")
    assert_same_lanes(TS.narrow_state(cfg, tvc.faults), jvc.faults, "faults")


@pytest.mark.parametrize("field,value", [
    ("round_idx", JS.ROUND_ENVELOPE + 5), ("fd_count", 1 << 15), ("classic_epoch", -1),
    ("fire_round", JS.ROUND_ENVELOPE + 1), ("fire_round", -3),
])
def test_validate_envelope_raises_as_jax_does(field, value):
    jvc, tvc = clusters(False)
    cfg = tvc.cfg._replace(compact=1)
    TS.validate_envelope(cfg, tvc.state)  # a clean state passes
    TS.validate_envelope(tvc.cfg, tvc.state._replace(round_idx=torch.tensor(1 << 20)))  # wide: no check
    lane = getattr(tvc.state, field).clone()
    jlane = np.asarray(getattr(jvc.state, field)).copy()
    if lane.dim():
        lane[..., 1], jlane[..., 1] = value, value
    else:
        lane, jlane = torch.tensor(value, dtype=lane.dtype), np.asarray(value, dtype=jlane.dtype)
    with pytest.raises(ValueError) as got:
        TS.validate_envelope(cfg, tvc.state._replace(**{field: lane}))
    with pytest.raises(ValueError) as want:
        JS.validate_envelope(JS.EngineConfig(*cfg), jvc.state._replace(**{field: jnp.asarray(jlane)}))
    assert str(got.value) == str(want.value)


def test_stagger_guard_raises_as_jax_does():
    jvc, tvc = clusters(True)
    with pytest.raises(ValueError, match="envelope") as want:
        jvc.stagger_fd_counts(np.random.default_rng(0), spread_rounds=1 << 15)
    with pytest.raises(ValueError, match="envelope") as got:
        tvc.stagger_fd_counts(np.random.default_rng(0), spread_rounds=1 << 15)
    assert str(got.value) == str(want.value)


def test_compact_jax_state_through_the_bridge_steps_like_jax():
    jvc, _ = clusters(True, delivery_spread=2)
    jvc.crash([4, 11])
    jvc.inject_join_wave([33])
    cfg = TS.EngineConfig(*jvc.cfg)
    tvc = TorchCluster(cfg, state_from_numpy(cfg, jax_lanes(jvc.state), "cpu"))
    tvc.faults = faults_from_numpy(cfg, jax_lanes(jvc.faults), "cpu")
    assert_same_lanes(tvc.state, jvc.state, "converted")
    # Byte for byte both ways: the bridge's arrays are the JAX arrays.
    for field, value in state_to_numpy(tvc.state).items():
        assert value.tobytes() == np.asarray(getattr(jvc.state, field)).tobytes(), field
    for r in range(3):
        assert_same_lanes(tvc.step(), jvc.step(), f"events {r}")
        assert_same_lanes(tvc.state, jvc.state, f"round {r}")
    with pytest.raises(TypeError, match="the layout says"):
        wide = TS.EngineConfig(*jvc.cfg)._replace(compact=0)
        state_from_numpy(wide, jax_lanes(jvc.state), "cpu")


# ---------------------------------------------------------------------------
# The churn differential: JAX compact, port compact, port wide
# ---------------------------------------------------------------------------


def drive_churn(do, step, vc):
    """``test_state_compaction._drive_churn``'s crash, join and leave waves,
    one ``step(round)`` at a time, injections through ``do(method, arg)``,
    observed on ``vc``: (cut labels, config ids, rounds per phase)."""
    cuts, ids, rounds = [], [], []

    def run(target):
        for round_idx in range(96):
            was_alive = vc.alive_mask.copy()
            events = step(round_idx)
            if bool(events.decided):
                mask = events.winner_mask.numpy()
                cuts.append(frozenset(
                    (s, "down" if was_alive[s] else "up") for s in np.nonzero(mask)[0].tolist()
                ))
                ids.append(vc.config_id)
                if vc.membership_size == target:
                    rounds.append(round_idx + 1)
                    return
        raise AssertionError(f"did not reach membership {target}")

    do("crash", [1, 5, 9])
    run(21)
    do("inject_join_wave", [30, 31])
    run(23)
    do("initiate_leave", [2])
    run(22)
    return cuts, ids, rounds


def test_churn_differential_jax_compact_port_compact_port_wide():
    twin = Twin(compact=True)
    compact = drive_churn(twin.do, lambda r: twin.step(f"compact round {r}"), twin.torch)
    wide_vc = clusters(False)[1]
    wide = drive_churn(lambda m, a: getattr(wide_vc, m)(a), lambda r: wide_vc.step(), wide_vc)
    assert compact[0] and compact == wide
    assert twin.torch.config_id == twin.jax.config_id == wide_vc.config_id
    widened = TS.widen_state(twin.torch.cfg, twin.torch.state)
    assert_same_lanes(widened, JS.widen_state(twin.jax.cfg, twin.jax.state), "widened")
    got, want = state_to_numpy(widened), state_to_numpy(wide_vc.state)
    for field, value in want.items():
        assert got[field].dtype == value.dtype, field
        np.testing.assert_array_equal(got[field], value, err_msg=field)


def test_unfired_edges_never_deliver_near_the_envelope_edge():
    twin = Twin(compact=True)
    high = JS.ROUND_ENVELOPE - 8
    twin.jax.state = twin.jax.state._replace(round_idx=jnp.int32(high))
    twin.torch.state = twin.torch.state._replace(round_idx=torch.tensor(high, dtype=torch.int32))
    twin.do("crash", [3])
    for r in range(8):
        events = twin.step(f"envelope round {r}")
        bits = state_to_numpy(twin.torch.state)["report_bits"]
        assert (bits[:, :3] == 0).all() and (bits[:, 4:] == 0).all()
        if bool(events.decided):
            assert set(np.nonzero(events.winner_mask.numpy())[0]) == {3}
            return
    raise AssertionError("no decision at the envelope's edge")


# ---------------------------------------------------------------------------
# Narrow lanes with the sign bit set
# ---------------------------------------------------------------------------


def test_k16_report_lane_carries_bit_15_like_jax():
    twin = Twin(compact=True, k=16, h=14, l=4, delivery_spread=2)
    assert TS.lane_dtypes(twin.torch.cfg)["report_bits"] == "uint16"
    twin.do("crash", [6, 17])
    seen_bit15 = False
    for r in range(24):
        events = twin.step(f"k16 round {r}")
        seen_bit15 |= bool((np.asarray(twin.jax.state.report_bits) & 0x8000).any())
        if bool(events.decided):
            break
    assert seen_bit15 and twin.torch.membership_size == 22
    assert twin.torch.config_id == twin.jax.config_id


def test_fd_window_16_history_carries_bit_15_like_jax():
    twin = Twin(compact=True, fd_window=16, fd_threshold=12)
    assert TS.lane_dtypes(twin.torch.cfg)["fd_hist"] == "uint16"
    blips = np.zeros((40, 3), dtype=bool)
    blips[[4, 13], :] = True
    seen_bit15 = False
    for r in range(20):  # 1-in-4 blips: a full window, never past 12
        twin.do("set_flaky_edges", blips if r % 4 == 0 else np.zeros_like(blips))
        events = twin.step(f"window round {r}")
        assert not bool(events.decided)
        seen_bit15 |= bool((np.asarray(twin.jax.state.fd_hist) & 0x8000).any())
    assert seen_bit15
    twin.do("crash", [21])
    for r in range(32):
        if bool(twin.step(f"crash round {r}").decided):
            break
    assert twin.torch.membership_size == 23


# ---------------------------------------------------------------------------
# A compact fleet
# ---------------------------------------------------------------------------


def test_two_tenant_compact_fleet_matches_jax():
    def tenants(make):
        out = []
        for i, victim in enumerate((2, 5)):
            vc = make(16, n_slots=16, seed=20 + i, compact=True, **GEOM)
            vc.assign_cohorts_roundrobin()
            vc.crash([victim])
            out.append(vc)
        return out

    jfleet = JaxFleet.from_clusters(tenants(JaxCluster.create))
    tfleet = TorchFleet.from_clusters(
        tenants(lambda *a, **kw: TorchCluster.create(*a, device="cpu", **kw))
    )
    assert_same_lanes(tfleet.state, jfleet.state, "stacked")
    assert TS.lane_dtypes(tfleet.cfg)["obs_idx"] == "int8"
    decided = []
    for r in range(24):
        events = tfleet.step()
        assert_same_lanes(events, jfleet.step(), f"fleet events {r}")
        assert_same_lanes(tfleet.state, jfleet.state, f"fleet round {r}")
        decided += [(r, int(t)) for t in np.nonzero(events.decided.numpy())[0]]
    assert {t for _, t in decided} == {0, 1}
    assert tenant_health(tfleet.cfg, tfleet.state).all()
    # Past the envelope a compact tenant is reported, as JAX reports it.
    for fleet, value in ((tfleet, torch.tensor([0, JS.ROUND_ENVELOPE + 1], dtype=torch.int32)),
                         (jfleet, jnp.asarray([0, JS.ROUND_ENVELOPE + 1], dtype=jnp.int32))):
        fleet.state = fleet.state._replace(round_idx=value)
    np.testing.assert_array_equal(tfleet.health_scan(), np.asarray(jfleet.health_scan()))
    assert tfleet.tenant_health_report(1) == jfleet.tenant_health_report(1)


# ---------------------------------------------------------------------------
# The engine scenarios of tests/test_torch_engine.py, compact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["contested_fallback", "coordinators_partitioned",
                                  "many_cohorts_jitter_c40", "windowed_fd"])
def test_engine_scenarios_in_the_compact_layout_match_jax(name):
    # The classic fallback (single and racing coordinators) on int8/int16
    # rank, index and cohort lanes, 40 cohorts (two cohort words) with
    # delivery jitter, and the windowed detector, round by round against
    # JAX compact.
    from test_torch_engine import SCENARIOS
    from test_torch_engine import Twin as EngineTwin

    scenario, args, kwargs = SCENARIOS[name]
    twin = EngineTwin(*args, compact=True, **kwargs)
    assert any(np.dtype(d).itemsize < 4 for d in TS.lane_dtypes(twin.torch.cfg).values())
    scenario(twin)
    assert_policy_dtypes(twin.torch, name)
    assert twin.torch.config_id == twin.jax.config_id
    if name in ("contested_fallback", "coordinators_partitioned"):
        events = twin.last_events
        assert bool(events.decided) and not bool(events.fast_decided)
