"""The reference against the program on the CPU, at tiny sizes: each cell's
mix judged correct, and the reference's hash and rings equal to the
program's own on random inputs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import membership
from benchmark.tests.conftest import tiny_plan, tiny_run


def test_each_cell_is_correct_against_the_reference(cell):
    run, line = tiny_run(tiny_plan(cell))
    assert line["correct"], line
    assert line["attempted"] == 1 and line["failed"] == 0
    assert all(c["value"] == 0 and c["limit"] == 0 for c in line["checks"].values())
    assert list(line)[-1] == "checks"
    assert run.records[0]["view_changes"] >= 1


@pytest.mark.parametrize("seed", range(4))
def test_config_id_is_the_programs_set_hash(seed):
    from rapid_tpu_torch import _u32
    from rapid_tpu_torch.ops.hashing import masked_set_hash

    draw = np.random.default_rng(seed)
    hi, lo = draw.integers(0, 2**32, size=(2, 300), dtype=np.uint32)
    alive = draw.random(300) < 0.7
    got = masked_set_hash(_u32.from_numpy(hi, "cpu"), _u32.from_numpy(lo, "cpu"),
                          torch.from_numpy(alive))
    assert membership.config_id(hi, lo, alive) == tuple(int(_u32.to_numpy(x)) for x in got)


@pytest.mark.parametrize("alive_share", [0.0, 0.004, 0.5, 1.0])
def test_rings_are_the_programs_topology(alive_share):
    from rapid_tpu_torch import _u32
    from rapid_tpu_torch.ops.rings import ring_perms, ring_topology_from_perm

    draw = np.random.default_rng(11)
    k, n = 6, 250
    key_hi = draw.integers(0, 4, size=(k, n), dtype=np.uint32)  # ties on the high word
    key_lo = draw.integers(0, 2**32, size=(k, n), dtype=np.uint32)
    key_lo[:, :10] = key_lo[:, 10:20]  # whole-key ties, broken by slot
    key_hi[:, :10] = key_hi[:, 10:20]
    alive = draw.random(n) < alive_share
    perm = ring_perms(_u32.from_numpy(key_hi, "cpu"), _u32.from_numpy(key_lo, "cpu"))
    topo = ring_topology_from_perm(perm, torch.from_numpy(alive))
    observer, subject = membership.rings(membership.ring_orders(key_hi, key_lo), alive)
    assert np.array_equal(topo.obs_idx.numpy(), observer)
    assert np.array_equal(topo.subj_idx.numpy(), subject)
