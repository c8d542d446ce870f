"""The readers count what the traffic and the device show, not what the
program says of itself: the rate of resolved churn does not move with the
number of view changes the program takes, and the rounds a wave computed
are the delivery kernel's launches, so an early exit from the lockstep wave
shows as useful rounds gained."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import core, generator, readers
from benchmark.tests.conftest import ROOT


def burst_record(tenants, crashes, cuts, steps):
    churn = [generator.Churn(np.arange(crashes), np.zeros(0, np.int64)) for _ in range(tenants)]
    return {"churn": churn, "view_changes": cuts * tenants, "tenant_steps": [steps] * tenants,
            "seconds": 0.1}


def fleet_run(cuts, launches, steps=8):
    records = [burst_record(4, 10, cuts, steps) for _ in range(5)]
    profile = {"rounds": launches, "device_ops": 100 * launches, "host_self_s": 0.01 * launches}
    return SimpleNamespace(records=records, traced=records[:2], window_s=2.0, profile=profile)


@pytest.mark.parametrize("cuts", [1, 2, 4])
def test_the_rate_counts_the_traffic_not_the_cuts(cuts):
    run = fleet_run(cuts, launches=192)
    assert readers.churn_resolved_per_s(run) == 5 * 4 * 10 / 2.0
    assert core.reader(ROOT, "fleet.cuts_per_burst")(run) == cuts


@pytest.mark.parametrize("launches, share", [(192, 100 * 8 / 96), (16, 100.0)])
def test_useful_rounds_follow_the_rounds_computed(launches, share):
    run = fleet_run(1, launches=launches)
    assert core.reader(ROOT, "fleet.useful_rounds")(run) == pytest.approx(share)
    assert core.reader(ROOT, "round.kernels.rate")(run) == pytest.approx(100)


def test_no_trace_reads_nothing():
    run = fleet_run(1, launches=192)
    run.profile = None
    assert core.reader(ROOT, "fleet.useful_rounds")(run) is None
    assert readers.per_round(run, "device_ops") is None
