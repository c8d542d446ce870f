"""The delivery kernel's host-side pieces and its plain version at the
kernel's skip edges, on the CPU.

- The fastmod constants the wrapper passes to ``csrc/delivery.cu``, through
  a numpy transcription of the kernel's remainder, against ``%``.
- ``benchmark.roofline.delivery_needed_draws`` (the draws a delivery
  call's inputs need, which the benchmark's bound counts) against a
  brute-force numpy count.
- ``delivery_new_bits_ref`` against the JAX engine's jnp path and the
  Pallas kernel in interpret mode on explicit ages at the edges where the
  kernel skips draws (``rapid_tpu_torch.testing.skip_edge_inputs``). The
  kernel itself is held to ``delivery_new_bits_ref`` on the card
  (tests/test_torch_cuda.py).
- The lane tile (``EngineConfig.pallas_lanes``): refused with the Pallas
  wrapper's message (run in interpret mode) when it is not a positive
  multiple of 128, on the wrapper and through the engine; passed to the
  wrapper on the single-cluster, stream, fleet and sharded routes; and
  ``examples/delivery_autotune --interpret`` checking every width against
  the first with JAX's keys.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.roofline import delivery_needed_draws
from rapid_tpu.models.virtual_cluster import _deliver_alerts
from rapid_tpu.ops import pallas_kernels as jpk
from rapid_tpu_torch import _u32
from rapid_tpu_torch.ops import kernels as tk
from rapid_tpu_torch.testing import delivery_inputs, skip_edge_inputs

CPU = torch.device("cpu")


def fastmod(x, m, d):
    """csrc/delivery.cu's ``fastmod`` in numpy uint64 arithmetic (which
    wraps mod 2**64 as the kernel's does)."""
    low = np.uint64(m) * x.astype(np.uint64)
    lo_part = ((low & np.uint64(0xFFFFFFFF)) * np.uint64(d)) >> np.uint64(32)
    hi_part = (low >> np.uint64(32)) * np.uint64(d)
    return ((hi_part + lo_part) >> np.uint64(32)).astype(np.uint32)


@pytest.mark.parametrize("d", [*range(1, 65), 1000])
def test_fastmod_constant_gives_the_remainder_for_every_32_bit_input(d):
    rng = np.random.default_rng(d)
    x = np.concatenate([
        np.array([0, d - 1, d, 2**31, 2**32 - 1], dtype=np.uint32),
        rng.integers(0, 2**32, size=10_000, dtype=np.uint32),
    ])
    m = tk.fastmod_multiplier(d)
    assert 0 <= m < 2**64
    np.testing.assert_array_equal(fastmod(x, m, d), x % np.uint32(d))


@pytest.mark.parametrize("spread,permille,want", [(0, 1000, 1), (2, 1000, 3), (3, 300, 3), (31, 250, 31)])
def test_delivery_divisor_is_the_draws_modulus(spread, permille, want):
    assert tk.delivery_divisor(spread, permille) == want


def test_fastmod_multiplier_refuses_divisors_out_of_range():
    for d in (0, 2**32):
        with pytest.raises(ValueError, match="fastmod divisor"):
            tk.fastmod_multiplier(d)


def test_wrapper_refuses_calls_past_the_kernels_thread_count():
    # One kernel thread per (tenant, cohort word, slot), counted in 32 bits.
    t, c, k, n = 2048, 1024, 2, 40_000
    blocked = torch.empty((t, 32 * k, n), dtype=torch.int32, device="meta")
    age = torch.empty((t, k, n), dtype=torch.int32, device="meta")
    epoch = torch.empty((t,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="too large"):
        tk.delivery_new_bits(blocked, age, epoch, k, c, 1, 1000)


def brute_needed_draws(blocked, age, k, c, spread):
    """Unblocked (tenant, cohort, slot, ring) edges with 0 <= age < spread,
    one cohort and ring at a time."""
    if age.ndim == 2:
        blocked, age = blocked[None], age[None]
    count = 0
    for cohort in range(c):
        for ring in range(k):
            bit = (blocked[:, (cohort // 32) * k + ring] >> np.uint32(cohort % 32)) & np.uint32(1)
            count += int(((bit == 0) & (age[:, ring] >= 0) & (age[:, ring] < spread)).sum())
    return count


@pytest.mark.parametrize("t", [None, 3])
@pytest.mark.parametrize("spread,permille", [(0, 1000), (2, 1000), (3, 300)])
def test_needed_draw_count_matches_brute_force(t, spread, permille):
    c, k, n = 40, 10, 77
    blocked, age, _ = delivery_inputs(c, k, n, 5 + spread, CPU, t=t)
    got = delivery_needed_draws(blocked, age, k, c, spread)
    want = brute_needed_draws(_u32.to_numpy(blocked), age.numpy(), k, c, spread)
    assert got == want
    assert (got > 0) == (spread > 0)


SKIP_EDGE_MODES = [
    (5, 0, 1000),     # no jitter
    (33, 1, 1000),    # uniform draw, two cohort words
    (64, 31, 1000),   # large spread
    (32, 1, 250),     # gated draw
    (40, 31, 300),
]


# No edge can be pending when every delay is 0: all_pending needs spread >= 1.
@pytest.mark.parametrize("kind,c,spread,permille", [
    (kind, *mode) for kind in ("edges", "all_blocked", "none_blocked", "all_pending")
    for mode in SKIP_EDGE_MODES if kind != "all_pending" or mode[1] > 0
])
def test_plain_version_matches_jnp_path_and_pallas_at_skip_edges(kind, c, spread, permille):
    k, n, round_idx = 10, 150, 100
    blocked, age, epoch = skip_edge_inputs(kind, c, k, n, spread, c + spread, CPU)
    got = _u32.to_numpy(tk.delivery_new_bits(blocked, age, epoch, k, c, spread, permille))

    blocked_rows = jnp.asarray(_u32.to_numpy(blocked))
    age_kn = jnp.asarray(age.numpy())
    cfg = SimpleNamespace(n=n, k=k, c=c, use_pallas=False, delivery_spread=spread,
                          delivery_prob_permille=permille)
    state = SimpleNamespace(round_idx=jnp.int32(round_idx), config_epoch=jnp.int32(int(epoch[0])),
                            report_bits=jnp.zeros((c, n), jnp.uint32))
    jnp_path = _deliver_alerts(cfg, state, (round_idx - age_kn).T, blocked_rows)
    pallas = jpk.delivery_new_bits_pallas(
        blocked_rows, age_kn, jnp.asarray(epoch.numpy()).astype(jnp.uint32), k, spread, permille,
        interpret=True,
    )[:c]
    np.testing.assert_array_equal(got, np.asarray(jnp_path))
    np.testing.assert_array_equal(got, np.asarray(pallas))


# -- the lane tile (``EngineConfig.pallas_lanes``) ------------------------------


@pytest.mark.parametrize("lanes", [100, 0])
def test_lane_tile_is_refused_with_the_pallas_wrappers_message(lanes):
    k, c, n = 10, 5, 150
    blocked, age, epoch = skip_edge_inputs("edges", c, k, n, 1, 7, CPU)
    with pytest.raises(ValueError) as jax_error:
        jpk.delivery_new_bits_pallas(
            jnp.asarray(_u32.to_numpy(blocked)), jnp.asarray(age.numpy()),
            jnp.asarray(epoch.numpy()).astype(jnp.uint32), k, 1, 1000, interpret=True, lanes=lanes,
        )
    with pytest.raises(ValueError) as port_error:
        tk.delivery_new_bits(blocked, age, epoch, k, c, 1, 1000, lanes=lanes)
    assert str(port_error.value) == str(jax_error.value)
    # The engine's config reaches the same check on every device.
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    vc = VirtualCluster.create(60, n_slots=64, k=3, h=3, l=1, cohorts=4, pallas_lanes=lanes,
                               device="cpu")
    with pytest.raises(ValueError) as engine_error:
        vc.step()
    assert str(engine_error.value) == str(jax_error.value)


def test_every_lane_tile_gives_the_same_words():
    k, c, n = 10, 40, 777
    blocked, age, epoch = skip_edge_inputs("edges", c, k, n, 2, 3, CPU)
    want = tk.delivery_new_bits_ref(blocked, age, epoch, k, c, 2, 1000)
    for lanes in (128, 256, 512, 1024, 4096):
        assert torch.equal(tk.delivery_new_bits(blocked, age, epoch, k, c, 2, 1000, lanes=lanes),
                           want)


@pytest.fixture
def lanes_seen(monkeypatch):
    """The ``lanes`` of every call of the engine's delivery seam."""
    from rapid_tpu_torch.models import virtual_cluster

    seen = []
    real = virtual_cluster.delivery_new_bits

    def spy(*args, **kwargs):
        seen.append(kwargs.get("lanes"))
        return real(*args, **kwargs)

    monkeypatch.setattr(virtual_cluster, "delivery_new_bits", spy)
    return seen


def _churned(lanes, seed=0, **knobs):
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    vc = VirtualCluster.create(56, n_slots=64, k=3, h=3, l=1, cohorts=4, fd_threshold=2,
                               delivery_spread=1, seed=seed, pallas_lanes=lanes, device="cpu",
                               **knobs)
    vc.assign_cohorts_roundrobin()
    vc.crash([1, 9])
    return vc


def test_lane_tile_reaches_the_wrapper_on_the_single_and_stream_routes(lanes_seen):
    vc = _churned(512)
    vc.step()
    vc.stream_step()
    vc.run_to_decision(max_steps=8)
    assert lanes_seen and set(lanes_seen) == {512}


def test_lane_tile_reaches_the_wrapper_on_the_fleet_route(lanes_seen):
    from rapid_tpu_torch.tenancy import TenantFleet

    fleet = TenantFleet.from_clusters([_churned(256, seed=i) for i in range(3)])
    assert fleet.cfg.pallas_lanes == 256
    fleet.step()
    fleet.run_until_membership([54, 54, 54], max_steps=16)
    assert lanes_seen and set(lanes_seen) == {256}


def test_lane_tile_reaches_the_wrapper_on_the_sharded_route(lanes_seen):
    from rapid_tpu_torch.parallel import mesh as pm
    from rapid_tpu_torch.tools.analysis.device_program import one_rank_group

    vc = _churned(1024)
    with one_rank_group("cpu"):
        m = pm.make_mesh(shape=None, device_type="cpu")
        step = pm.make_sharded_step(vc.cfg, m)
        step(pm.shard_state(vc.state, m), pm.shard_faults(vc.faults, m))
    assert lanes_seen == [1024]


def test_delivery_autotune_interpret_is_the_routing_only(capsys, monkeypatch):
    import json

    from rapid_tpu_torch.examples import delivery_autotune

    assert delivery_autotune.main(["--device", "cpu", "--interpret"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    # JAX's keys, in its interpret smoke: no timing, no winner, a note.
    assert [row["shape"] for row in rows] == [[64, 4_000], [8, 4_000]]
    for row in rows:
        assert set(row) == {"platform", "shape", "spread", "per_width_ms", "best_width", "note"}
        assert (row["platform"], row["spread"], row["per_width_ms"], row["best_width"]) == (
            "cpu", 2, {}, None)
    # Every width is held against the first: a width that changed a word fails.
    real = tk.delivery_new_bits

    def skewed(*args, lanes=128, **kwargs):
        out = real(*args, lanes=lanes, **kwargs)
        return out ^ 1 if lanes == 512 else out

    monkeypatch.setattr(tk, "delivery_new_bits", skewed)
    with pytest.raises(AssertionError, match="lane tile 512 differs from 128"):
        delivery_autotune.main(["--device", "cpu", "--interpret"])
    with pytest.raises(RuntimeError, match="autotune needs the card"):
        delivery_autotune.main(["--device", "cpu"])
