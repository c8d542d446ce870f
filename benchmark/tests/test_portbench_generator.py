"""The traffic generator repeats per seed, and gives every seed the same
sizes."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import generator
from benchmark.tests.conftest import tiny_plan

BIG_SEEDS = (0, 7, 2**31 + 5, 2**33 - 1, -12)


def same_churn(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x.crash, y.crash) and np.array_equal(x.join, y.join) for x, y in zip(a, b))


@pytest.mark.parametrize("cell", ["paper1k.crash10", "paper1k_fleet.crash10"])
@pytest.mark.parametrize("seed", BIG_SEEDS)
def test_burst_repeats_per_seed_and_keeps_its_sizes(cell, seed):
    plan = tiny_plan(cell)
    first = generator.burst(plan.mix, plan.config, seed, 3)
    assert same_churn(first, generator.burst(plan.mix, plan.config, seed, 3))
    assert not same_churn(first, generator.burst(plan.mix, plan.config, seed + 1, 3))
    assert not same_churn(first, generator.burst(plan.mix, plan.config, seed, 4))
    n = plan.config["n_members"]
    for churn in first:
        assert len(churn.crash) == plan.mix["crash"] == len(np.unique(churn.crash))
        assert churn.crash.min() >= 0 and churn.crash.max() < n
        assert np.array_equal(churn.join, np.arange(n, n + plan.mix["join"]))


def test_identities_are_the_programs_seeded_build():
    """The reference's keys and identities are the lanes the program builds
    from the same seed."""
    import torch

    from rapid_tpu_torch import _u32
    from benchmark import targets

    plan = tiny_plan("paper1k.crash10")
    target = targets.Target(plan.config, 2**32 + 9, torch.device("cpu"))
    key_hi, key_lo, id_hi, id_lo = generator.identities(
        generator.cluster_seed(2**32 + 9, 0), plan.config["n_slots"], plan.config["k"])
    state = target.system.state
    for lane, want in ((state.key_hi, key_hi), (state.key_lo, key_lo), (state.id_hi, id_hi),
                       (state.id_lo, id_lo)):
        assert np.array_equal(_u32.to_numpy(lane), want)
