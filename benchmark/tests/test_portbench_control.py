"""The comparison that decides ``correct`` fails the control and every
fault a cell can have, each planted underneath the timed path; the
harness's look for a card is skipped and the rest of a run is driven on the
CPU at a tiny size. (The fault of an exchange between chips has no place:
every cell runs on one chip.)"""

from __future__ import annotations

import contextlib

import pytest

from benchmark.control import control_answers
from benchmark.tests.conftest import tiny_plan, tiny_run


def test_the_control_is_not_correct(cell):
    run, line = tiny_run(tiny_plan(cell), substitute=control_answers)
    assert not line["correct"]
    assert line["failed"] == line["attempted"] == 1
    assert line["checks"]["members_wrong"]["value"] >= 1
    assert line["checks"]["config_id_wrong"]["value"] >= 1
    assert line["checks"]["rings_wrong"]["value"] >= 1


@contextlib.contextmanager
def patched(pairs):
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in pairs]
    for owner, name, make in pairs:
        setattr(owner, name, make(getattr(owner, name)))
    try:
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def view_change_sites():
    from rapid_tpu_torch.models import virtual_cluster
    from rapid_tpu_torch.tenancy import fleet

    return [(virtual_cluster, "apply_view_change_impl"), (fleet, "apply_view_change_impl")]


def state_unchanged(real):
    """The view change returns the state it was given."""
    return lambda cfg, state, winner, ctx=None: state


def answer_altered(real):
    """The view change commits with one bit of the configuration id flipped."""
    def altered(cfg, state, winner, ctx=None):
        out = real(cfg, state, winner, ctx)
        return out._replace(config_lo=out.config_lo ^ 1)
    return altered


def half_the_batch():
    """Half of each request's churn is left out where it is injected: half
    the crashed slots of a cluster, the crashes of half the tenants of a
    fleet."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
    from rapid_tpu_torch.tenancy import TenantFleet

    def crash(real):
        return lambda self, slots: real(self, list(slots)[: len(slots) // 2])

    def stream_crash(real):
        def keep(self, pairs):
            return real(self, [p for p in pairs if p[0] < self.b // 2])
        return keep

    return [(VirtualCluster, "crash", crash), (TenantFleet, "stream_crash", stream_crash)]


FAULTS = {
    "state_unchanged": lambda: [(o, n, state_unchanged) for o, n in view_change_sites()],
    "answer_altered": lambda: [(o, n, answer_altered) for o, n in view_change_sites()],
    "half_the_batch": half_the_batch,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(cell, fault):
    plan = tiny_plan(cell)
    if fault == "state_unchanged" and plan.mix["loop"] == "burst":
        plan = plan._replace(mix={**plan.mix, "max_steps": 40})  # it never resolves
    with patched(FAULTS[fault]()):
        _, line = tiny_run(plan)
    assert not line["correct"], (fault, line)
    assert line["failed"] == 1
