"""The delivery kernel's host-side pieces and its plain version at the
kernel's skip edges, on the CPU.

- The fastmod constants the wrapper passes to ``csrc/delivery.cu``, through
  a numpy transcription of the kernel's remainder, against ``%``.
- ``chip_smoke.delivery_needed_draws`` (the draws a delivery call's inputs
  need, which its bound counts) against a brute-force numpy count.
- ``delivery_new_bits_ref`` against the JAX engine's jnp path and the
  Pallas kernel in interpret mode on explicit ages at the edges where the
  kernel skips draws (``chip_smoke.skip_edge_inputs``). The kernel itself
  is held to ``delivery_new_bits_ref`` on the card (tests/test_torch_cuda.py).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import delivery_inputs, delivery_needed_draws, skip_edge_inputs
from rapid_tpu.models.virtual_cluster import _deliver_alerts
from rapid_tpu.ops import pallas_kernels as jpk
from rapid_tpu_torch import _u32
from rapid_tpu_torch.ops import kernels as tk

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
