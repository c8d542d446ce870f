"""The fleet wave run in chunks (``tenancy/fleet.py::WaveGraphs``), on the
CPU at small N.

On one device the wave's lockstep iterations run in chunks of
``WAVE_GRAPH_CHUNK`` and stop once a read before a chunk finds no tenant
active (``rapid_tpu_torch.testing.wave_exit`` says where). On a card each
chunk replays from a captured CUDA graph over static copies of its inputs
(``tests/test_torch_cuda.py`` holds the captured graph to the eager
wave). Here each chunk runs as Python over the
same static buffers (``_direct``), so everything but the capture is
checked: the copy-in, the chunks, the exit, the eager remainder, the copies
handed back, and whether the wave reports a replay; the eager fallback
takes the same exit. Each result is the whole lockstep ``fleet_wave``'s,
lane for lane and dtype for dtype.
"""

import numpy as np
import pytest
import torch

from rapid_tpu_torch import _host
from rapid_tpu_torch.models import virtual_cluster
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
from rapid_tpu_torch.tenancy import TenantFleet
from rapid_tpu_torch.tenancy.fleet import WAVE_GRAPH_CHUNK, WaveGraphs, _lanes, fleet_wave
from rapid_tpu_torch.testing import fleet_clusters, wave_exit
from rapid_tpu_torch.utils import dispatch

CPU = torch.device("cpu")
PLANES = {"off": {}, "on": {"telemetry": True, "trace": 8}}


def assert_same(got, want, what):
    got, want = _lanes(*got), _lanes(*want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), f"{what}: lane {i} differs"


def churned_fleet(planes):
    """Four tenants of 32 members: crash, join and equal-churn waves, two
    knob settings (``rapid_tpu_torch.testing.fleet_clusters``)."""
    clusters, targets = fleet_clusters(4, 32, 4, 4, 900, CPU, **PLANES[planes])
    return TenantFleet.from_clusters(clusters), targets


def wave_args(fleet, targets, max_steps, max_cuts=4, min_cuts=1):
    """``fleet_wave``'s arguments; ``targets`` and ``min_cuts`` broadcast."""
    t = torch.tensor(np.broadcast_to(targets, (fleet.b,)), dtype=torch.int32)
    m = torch.tensor(np.broadcast_to(min_cuts, (fleet.b,)), dtype=torch.int32)
    return (fleet.cfg, fleet.state, fleet.faults, fleet.knobs, t, max_steps, max_cuts, m,
            fleet.telem, fleet.trace_ring)


@pytest.mark.parametrize("planes", sorted(PLANES))
@pytest.mark.parametrize("max_steps", [96, 13, 5])
def test_chunked_wave_equals_the_eager_wave(planes, max_steps):
    """A multiple of the chunk, one that is not, and fewer steps than one
    chunk, with the planes off and on."""
    fleet, targets = churned_fleet(planes)
    args = wave_args(fleet, targets, max_steps)
    graphs = WaveGraphs(_direct=True)
    got, graphed, ran = graphs.wave(*args)
    reads = _host.read.count
    want = fleet_wave(*args)
    assert _host.read.count == reads, "the lockstep wave read the host"
    assert_same(got, want, f"max_steps={max_steps} planes {planes}")
    assert (got[5] is None) == (planes == "off")
    assert ran == wave_exit(want[1], max_steps)[0] < max(max_steps, WAVE_GRAPH_CHUNK + 1)
    # A wave shorter than a chunk has nothing to replay, and runs eagerly.
    assert graphed == (max_steps >= WAVE_GRAPH_CHUNK)
    assert len(graphs._chunks) == graphed
    if max_steps < 13:
        assert not want[3].all(), "every tenant resolved: the short wave is vacuous"


def crash_fleet(direct, fd_thresholds=(3, 3, 3), planes="off"):
    """Settled tenants of 40 members (the benchmark's fleet in miniature),
    one a failure threshold, with their settled lanes kept for restores. A
    higher threshold takes a tenant more rounds to its cut."""
    clusters = []
    for i, fd_threshold in enumerate(fd_thresholds):
        vc = VirtualCluster.create(40, k=10, h=9, l=3, cohorts=4, fd_threshold=fd_threshold,
                                   seed=70 + i, delivery_spread=2, device=CPU, **PLANES[planes])
        vc.assign_cohorts_roundrobin()
        vc.stagger_fd_counts(np.random.default_rng(i), spread_rounds=3)
        clusters.append(vc)
    fleet = TenantFleet.from_clusters(clusters)
    if direct:
        fleet._wave_graphs = WaveGraphs(_direct=True)
    settled = tuple(map(lambda tree: type(tree)(*(x.clone() for x in tree)),
                        (fleet.state, fleet.faults)))
    return fleet, settled


def restore(fleet, settled):
    fleet.state, fleet.faults = (type(tree)(*(x.clone() for x in tree)) for tree in settled)


def test_successive_waves_from_restored_lanes_are_the_eager_waves():
    """Two waves, each from freshly restored lanes with its own crashes,
    as the benchmark drives them: one capture, every replay from the new
    inputs, and no lane handed back is a buffer of the chunk."""
    (chunked, settled), (eager, eager_settled) = crash_fleet(True), crash_fleet(False)
    for wave, crashed in enumerate(((1, 5, 9), (2, 3, 30, 31))):
        results = []
        for fleet, lanes in ((chunked, settled), (eager, eager_settled)):
            restore(fleet, lanes)
            fleet.stream_crash([[t, s] for t in range(3) for s in crashed])
            dispatch.clear_records()
            out = fleet.run_until_membership(40 - len(crashed), max_steps=24, max_cuts=4,
                                             min_cuts=1)
            record = dispatch.records()[-1]
            assert record.graphed == (fleet is chunked)
            results.append((out, fleet.state))
        (got, got_state), (want, want_state) = results
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[2].all(), f"wave {wave}: a tenant did not resolve"
        assert_same((got_state,), (want_state,), f"wave {wave}")
    assert not eager._wave_graphs._chunks
    (chunk,) = chunked._wave_graphs._chunks.values()
    buffers = {x.untyped_storage().data_ptr() for x in _lanes(
        chunk.carry, chunk.inputs.faults, chunk.knobs, chunk.inputs.target, chunk.inputs.min_cuts)}
    held = {x.untyped_storage().data_ptr() for x in _lanes(chunked.state, chunked.faults)}
    assert not buffers & held, "a lane the fleet holds is a buffer of the chunk"


def test_a_quarantined_tenant_stays_frozen_in_the_chunked_wave():
    (chunked, _), (eager, _) = crash_fleet(True), crash_fleet(False)
    graphed = []
    for fleet in (chunked, eager):
        fleet.stream_crash([[t, s] for t in range(3) for s in (4, 8)])
        fleet.quarantine([1])
        before = [x.clone() for x in _lanes(fleet.tenant_state(1))]
        out = fleet.run_until_membership(38, max_steps=16, max_cuts=4, min_cuts=1)
        graphed.append(dispatch.records()[-1].graphed)
        assert_same((fleet.tenant_state(1),), (before,), "the quarantined tenant moved")
        assert out[0][1] == 0 and out[2][0] and out[2][2]
    for g, w in zip(_lanes(chunked.state), _lanes(eager.state)):
        assert torch.equal(g, w)
    assert graphed == [True, False]


# (failure thresholds, min_cuts, max_steps): every tenant done after one
# chunk; one tenant 11 or 21 rounds to its cut, so no tenant is active
# after chunk 2 or 3, which the wave reads a chunk late; a tenant
# that demands a second cut no churn brings, so the wave runs its whole
# budget; an eager rest after a chunk, skipped or run; a budget below one
# chunk.
EXITS = {
    "one_chunk": ((3, 3, 3), 1, 96),
    "second_chunk": ((3, 6, 3), 1, 96),
    "third_chunk": ((3, 16, 3), 1, 96),
    "whole_budget": ((3, 3, 3), (1, 2, 1), 40),
    "rest_skipped": ((3, 3, 3), 1, 13),
    "rest": ((3, 6, 3), 1, 13),
    "short": ((3, 3, 3), 1, 5),
}


@pytest.mark.parametrize("planes", sorted(PLANES))
@pytest.mark.parametrize("path", ["direct", "eager"])
@pytest.mark.parametrize("case", sorted(EXITS))
def test_the_wave_stops_once_no_tenant_is_active(case, path, planes):
    """Through ``run_until_membership``, on the chunk path (``_direct``) and
    on the eager fallback: the results and every lane are the whole
    lockstep wave's, the iterations run and the counted reads are
    ``rapid_tpu_torch.testing.wave_exit``'s, and the dispatch record counts the
    iterations run."""
    fd_thresholds, min_cuts, max_steps = EXITS[case]
    fleet, _ = crash_fleet(path == "direct", fd_thresholds, planes)
    fleet.stream_crash([[t, s] for t in range(fleet.b) for s in (1, 5, 9)])
    state, steps, cuts, resolved, sizes, telem, trace = fleet_wave(
        *wave_args(fleet, 37, max_steps, min_cuts=min_cuts))
    before = _host.site_totals()
    dispatch.clear_records()
    got = fleet.run_until_membership(37, max_steps=max_steps, max_cuts=4, min_cuts=min_cuts)
    reads = {site: n - before[site][0] for site, (n, _) in _host.site_totals().items()
             if n != before[site][0]}
    (record,) = dispatch.records()
    for g, w in zip(got, (steps, cuts, resolved, sizes)):
        np.testing.assert_array_equal(g, w.numpy())
    assert_same((fleet.state, fleet.telem, fleet.trace_ring), (state, telem, trace), case)
    ran, active_reads = wave_exit(steps.tolist(), max_steps)
    assert record.rounds == ran and record.tenant_rounds_computed == fleet.b * ran
    assert record.tenant_rounds_active == int(steps.sum())
    assert record.graphed == (path == "direct" and ran >= WAVE_GRAPH_CHUNK)
    assert reads == {"fleet_wave_active": active_reads, "fleet_wave_observation": 1}
    last = int(steps.max())
    if case == "whole_budget":
        assert ran == max_steps and not resolved[1]
    elif case in ("rest", "short"):
        assert ran == max_steps
    elif case in ("second_chunk", "third_chunk"):
        # From the third chunk on, the exit is read a chunk late: one chunk
        # that changes nothing.
        chunks = -(-last // WAVE_GRAPH_CHUNK)
        assert chunks == {"second_chunk": 2, "third_chunk": 3}[case]
        assert ran == (chunks + 1) * WAVE_GRAPH_CHUNK < max_steps and resolved.all()
    else:
        assert last <= ran == WAVE_GRAPH_CHUNK < max_steps and resolved.all()


@pytest.mark.parametrize("path", ["direct", "eager"])
@pytest.mark.parametrize("why", ["quarantined", "at_target"])
def test_a_wave_done_from_its_first_iteration_runs_no_chunk(why, path):
    """Every tenant quarantined, or every tenant at its target with no cut
    demanded: one read finds none active, and nothing runs."""
    fleet, _ = crash_fleet(path == "direct")
    if why == "quarantined":
        fleet.stream_crash([[t, s] for t in range(fleet.b) for s in (1, 5, 9)])
        fleet.quarantine(list(range(fleet.b)))
    lanes = [x.clone() for x in _lanes(fleet.state)]
    want = fleet_wave(*wave_args(fleet, fleet.membership_sizes(), 24, min_cuts=0))
    before = _host.site_totals()["fleet_wave_active"][0]
    dispatch.clear_records()
    rounds, cuts, resolved, sizes = fleet.run_until_membership(
        40, max_steps=24, max_cuts=4, min_cuts=0)
    (record,) = dispatch.records()
    assert (record.rounds, record.tenant_rounds_computed, record.graphed) == (0, 0, False)
    assert _host.site_totals()["fleet_wave_active"][0] == before + 1
    assert not rounds.any() and not cuts.any() and resolved.all() and (sizes == -1).all()
    assert_same((fleet.state,), (lanes,), why)
    assert_same((fleet.state,), (want[0],), why)


@pytest.mark.parametrize("case", ["one_chunk", "third_chunk", "rest_skipped"])
def test_a_seam_spy_sees_every_round_the_unwrapped_wave_computes(case, monkeypatch):
    """The benchmark's bound run (a wrapper on the delivery seam, so the
    wave runs eagerly) computes the rounds its profiled run (the chunk path)
    computes: both take the same exit."""
    fd_thresholds, min_cuts, max_steps = EXITS[case]
    computed = []
    for spied in (False, True):
        fleet, _ = crash_fleet(True, fd_thresholds)
        fleet.stream_crash([[t, s] for t in range(fleet.b) for s in (1, 5, 9)])
        calls = []
        if spied:
            real = virtual_cluster.delivery_new_bits

            def spy(*args, **kwargs):
                calls.append(1)
                return real(*args, **kwargs)

            monkeypatch.setattr(virtual_cluster, "delivery_new_bits", spy)
        dispatch.clear_records()
        fleet.run_until_membership(37, max_steps=max_steps, max_cuts=4, min_cuts=min_cuts)
        (record,) = dispatch.records()
        assert record.graphed == (not spied and max_steps >= WAVE_GRAPH_CHUNK)
        computed.append((record.rounds, len(calls)))
    (unwrapped, none), (eager, called) = computed
    assert none == 0 and unwrapped == eager == called < max_steps
