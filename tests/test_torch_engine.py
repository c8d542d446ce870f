"""The PyTorch port's engine against the JAX package's, round by round.

Each scenario (from tests/test_engine.py) is driven through both packages'
``VirtualCluster`` with the same calls on the CPU. After construction, after
every injection and after every round, the whole state, the fault masks and
the round's ``StepEvents`` must be equal lane by lane (uint32 lanes as
uint32 bit patterns). A bench-shaped mini churn runs through both
``run_until_membership`` entry points, the port's state built from the JAX
state through ``rapid_tpu_torch.convert``.
"""

import numpy as np
import pytest
import torch

from rapid_tpu.models.virtual_cluster import VirtualCluster as JaxCluster
from rapid_tpu.models.virtual_cluster import classic_coordinator_targets
from rapid_tpu_torch.convert import faults_from_numpy, state_from_numpy, state_to_numpy
from rapid_tpu_torch.models.state import EngineConfig
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster as TorchCluster
from rapid_tpu_torch.types import Endpoint


def jax_lanes(tree):
    return {f: np.asarray(getattr(tree, f)) for f in tree._fields}


def assert_same_lanes(torch_tree, jax_tree, where):
    got, want = state_to_numpy(torch_tree), jax_lanes(jax_tree)
    assert set(got) == set(want)
    for field, w in want.items():
        assert got[field].dtype == w.dtype, f"{where}: {field} dtype {got[field].dtype} != {w.dtype}"
        np.testing.assert_array_equal(got[field], w, err_msg=f"{where}: lane {field}", strict=True)


class Twin:
    """One scenario driven through both packages in lockstep."""

    def __init__(self, *args, **kwargs):
        self.jax = JaxCluster.create(*args, **kwargs)
        self.torch = TorchCluster.create(*args, device="cpu", **kwargs)
        self.rounds = 0
        self.check("create")

    def check(self, where):
        assert_same_lanes(self.torch.state, self.jax.state, where)
        assert_same_lanes(self.torch.faults, self.jax.faults, where)

    def do(self, method, *args):
        getattr(self.jax, method)(*args)
        getattr(self.torch, method)(*args)
        self.check(method)

    def lane(self, field):
        return np.asarray(getattr(self.jax.state, field))

    def step(self):
        ej, et = self.jax.step(), self.torch.step()
        self.rounds += 1
        where = f"round {self.rounds}"
        assert_same_lanes(et, ej, where)
        self.check(where)
        assert self.torch.last_decided == bool(ej.decided)
        self.last_events = et
        return bool(ej.decided)

    def converge(self, max_steps):
        for _ in range(max_steps):
            if self.step():
                return True
        return False


def single_crash(t):
    t.do("crash", [17])
    assert t.converge(64)


def join_then_crash_two_cuts(t):
    t.do("crash", [7, 23])
    t.do("inject_join_wave", list(range(50, 60)))
    assert t.converge(64)
    assert t.converge(64)


def contested_fallback(t):
    cohort_of = np.zeros(120, dtype=np.int32)
    cohort_of[80:] = 1
    t.do("assign_cohorts", cohort_of)
    t.do("crash", [10, 60])
    rx = np.zeros((2, 120), dtype=bool)
    rx[1, t.lane("obs_idx")[:, 60]] = True
    t.do("set_rx_block", rx)
    assert t.converge(64)


def coordinators_partitioned(t):
    n, victim = 60, 25
    cohort_of = np.zeros(n, dtype=np.int32)
    cohort_of[40:] = 1
    t.do("assign_cohorts", cohort_of)
    t.do("crash", [victim])
    rx = np.zeros((2, n), dtype=bool)
    rx[1, t.lane("obs_idx")[:, victim]] = True
    active = [i for i in range(n) if i != victim]
    racers = [active[x - 1] for x in classic_coordinator_targets(0, len(active), 2)]
    rx[:, max(racers)] = True  # nobody hears the higher-ranked coordinator
    t.do("set_rx_block", rx)
    assert t.converge(64)


def many_cohorts_jitter(t):
    t.do("assign_cohorts_roundrobin")
    t.do("crash", [7, 100, 201])
    assert t.converge(96)


def windowed_fd(t):
    blips = np.zeros((60, 10), dtype=bool)
    blips[13, :] = True
    for r in range(8):  # intermittent 1-in-4 blips: forgiven by the window
        t.do("set_flaky_edges", blips if r % 4 == 0 else np.zeros_like(blips))
        assert not t.step()
    t.do("crash", [21])
    assert t.converge(32)


def pending_joiner_survives_view_change(t):
    n, joiner, k, h = 100, 100, 10, 7
    cohort_of = np.zeros(101, dtype=np.int32)
    cohort_of[50:] = 1
    t.do("assign_cohorts", cohort_of)
    t.do("inject_join_wave", [joiner])
    obs = t.lane("obs_idx")
    gatekeepers = {int(s) for s in obs[:, joiner] if s >= 0}
    victim = next(
        cand for cand in range(n)
        if cand not in gatekeepers and sum(int(s) in gatekeepers for s in obs[:, cand]) <= k - h
    )
    rx = np.zeros((2, 101), dtype=bool)
    rx[:, sorted(gatekeepers)] = True
    t.do("set_rx_block", rx)
    t.do("crash", [victim])
    assert t.converge(48)
    assert bool(t.lane("join_pending")[joiner])
    t.do("set_rx_block", np.zeros((2, 101), dtype=bool))
    assert t.converge(48)


def graceful_leave(t):
    t.do("initiate_leave", [12, 40])
    assert t.converge(32)


SCENARIOS = {
    "single_crash": (single_crash, (100,), dict(k=10, h=9, l=4, fd_threshold=3, seed=0)),
    "join_then_crash_two_cuts": (
        join_then_crash_two_cuts, (50,), dict(n_slots=60, fd_threshold=3, seed=4)
    ),
    "contested_fallback": (contested_fallback, (120,), dict(fd_threshold=2, seed=11)),
    "coordinators_partitioned": (
        coordinators_partitioned, (60,),
        dict(h=7, l=3, fd_threshold=2, seed=13, fallback_rounds=3, concurrent_coordinators=2),
    ),
    "many_cohorts_jitter_c40": (
        many_cohorts_jitter, (256,), dict(cohorts=40, fd_threshold=2, seed=3, delivery_spread=3)
    ),
    "windowed_fd": (windowed_fd, (60,), dict(fd_threshold=4, seed=72, fd_window=8)),
    "pending_joiner_survives_view_change": (
        pending_joiner_survives_view_change, (100,),
        dict(n_slots=101, h=7, l=3, cohorts=2, fd_threshold=2, seed=41),
    ),
    "graceful_leave": (graceful_leave, (80,), dict(fd_threshold=4, seed=51)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_rounds_match_jax(name):
    scenario, args, kwargs = SCENARIOS[name]
    twin = Twin(*args, **kwargs)
    scenario(twin)
    assert twin.torch.membership_size == int(twin.jax.state.n_members)
    assert twin.torch.config_id == twin.jax.config_id


@pytest.mark.parametrize("name", ["contested_fallback", "coordinators_partitioned"])
def test_fallback_scenarios_decide_through_the_classic_round(name):
    # These scenarios hold the port's classic attempt only if the classic
    # round, not the fast round, made the deciding cut.
    scenario, args, kwargs = SCENARIOS[name]
    twin = Twin(*args, **kwargs)
    scenario(twin)
    events = twin.last_events
    assert bool(events.decided) and not bool(events.fast_decided)


def test_bench_shaped_mini_churn_through_run_until_membership():
    # bench.py's 5%-churn recipe at N=256: C=40 cohorts (two cohort words),
    # spread 2, two racing coordinators, FD counters staggered over 3 rounds.
    n, n_join = 256, 6
    jvc = JaxCluster.create(
        n, n_slots=n + n_join, k=10, h=9, l=4, cohorts=40, fd_threshold=3, seed=0,
        delivery_spread=2, concurrent_coordinators=2,
    )
    jvc.assign_cohorts_roundrobin()
    rng = np.random.default_rng(1000)
    jvc.stagger_fd_counts(rng, spread_rounds=3)
    victims = rng.choice(n, size=n_join, replace=False)
    jvc.crash(victims)
    jvc.inject_join_wave(np.arange(n, n + n_join))

    cfg = EngineConfig(*jvc.cfg)
    tvc = TorchCluster(cfg, state_from_numpy(cfg, jax_lanes(jvc.state), "cpu"))
    tvc.faults = faults_from_numpy(cfg, jax_lanes(jvc.faults), "cpu")
    assert_same_lanes(tvc.state, jvc.state, "converted")

    want = jvc.run_until_membership(n, max_steps=384, max_cuts=4, min_cuts=1)
    got = tvc.run_until_membership(n, max_steps=384, max_cuts=4, min_cuts=1)
    assert got == want
    rounds, cuts, resolved, sizes = got
    assert resolved and cuts >= 1 and sizes[-1] == n
    assert_same_lanes(tvc.state, jvc.state, "after churn")
    assert not tvc.alive_mask[victims].any() and tvc.alive_mask[n:].all()


def test_unported_options_raise():
    # compact=1 is ported (tests/test_torch_compaction.py); a compaction
    # level the JAX package does not define, and the java ring topology
    # that the engine cannot hold, still raise.
    with pytest.raises(ValueError, match="compact"):
        TorchCluster.create(16, device="cpu", compact=2)
    with pytest.raises(ValueError, match="native topology"):
        TorchCluster.from_endpoints([Endpoint("h", 1)], topology="java", device="cpu")
    with pytest.raises(ValueError, match="requires telemetry"):
        TorchCluster.create(16, device="cpu", trace=4, telemetry=False)
    with pytest.raises(ValueError, match=">= 0"):
        TorchCluster.create(16, device="cpu", trace=-1, telemetry=True)
    with pytest.raises(ValueError):
        TorchCluster.create(16, delivery_spread=1, delivery_prob_permille=1001, device="cpu")


def test_state_round_trips_through_numpy():
    tvc = TorchCluster.create(40, n_slots=44, cohorts=3, seed=5, device="cpu")
    tvc.inject_join_wave([40, 41])
    lanes = state_to_numpy(tvc.state)
    back = state_from_numpy(tvc.cfg, lanes, torch.device("cpu"))
    for field, value in lanes.items():
        np.testing.assert_array_equal(state_to_numpy(back)[field], value)
