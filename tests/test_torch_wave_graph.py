"""The fleet wave replayed in chunks (``tenancy/fleet.py::WaveGraphs``), on
the CPU at small N.

On a card the wave's lockstep iterations replay from captured CUDA graphs of
``WAVE_GRAPH_CHUNK`` iterations over static copies of its inputs
(``tests/test_torch_cuda.py`` holds the captured graph to the eager wave).
Here each chunk runs as Python over the same static buffers (``_direct``),
so everything but the capture is checked: the copy-in, the chunks, the
eager remainder, the copies handed back, and whether the wave reports a
replay. Each result is the eager ``fleet_wave``'s, lane for lane and dtype
for dtype.
"""

import numpy as np
import pytest
import torch

from chip_smoke import fleet_clusters
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
from rapid_tpu_torch.tenancy import TenantFleet
from rapid_tpu_torch.tenancy.fleet import WAVE_GRAPH_CHUNK, WaveGraphs, _lanes, fleet_wave
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
    knob settings (``chip_smoke.fleet_clusters``)."""
    clusters, targets = fleet_clusters(4, 32, 4, 4, 900, CPU, **PLANES[planes])
    return TenantFleet.from_clusters(clusters), targets


def wave_args(fleet, targets, max_steps, max_cuts=4, min_cuts=1):
    t = torch.tensor(targets, dtype=torch.int32)
    m = torch.full_like(t, min_cuts)
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
    got, graphed = graphs.wave(*args)
    want = fleet_wave(*args)
    assert_same(got, want, f"max_steps={max_steps} planes {planes}")
    assert (got[5] is None) == (planes == "off")
    # A wave shorter than a chunk has nothing to replay, and runs eagerly.
    assert graphed == (max_steps >= WAVE_GRAPH_CHUNK)
    assert len(graphs._chunks) == graphed
    if max_steps < 13:
        assert not want[3].all(), "every tenant resolved: the short wave is vacuous"


def crash_fleet(direct):
    """Three settled tenants of 40 members (the benchmark's fleet in
    miniature), with their settled lanes kept for restores."""
    clusters = []
    for i in range(3):
        vc = VirtualCluster.create(40, k=10, h=9, l=3, cohorts=4, fd_threshold=3, seed=70 + i,
                                   delivery_spread=2, device=CPU)
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
