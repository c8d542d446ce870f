"""The PyTorch port on a CUDA card.

The delivery kernel (``rapid_tpu_torch/csrc/delivery.cu``) against its plain
PyTorch version, bit for bit, for one cluster and with a tenant axis, and
the whole engine and a tenant fleet on the card against the same on the
CPU, lane by lane, with and without the telemetry plane and trace ring, in
the wide and the compact layout, an endpoint cluster
(``VirtualCluster.from_endpoints``), a stream of churn waves through
the serving driver against the batch drive and the CPU, its path free of
host reads and synchronizing calls, a chaos fleet, the loss variant's
gated delivery, a lie injected into a card cluster, the scrape's
allocator gauges, build capture and profiler trace, and the host membership
path's two device adapters (card against CPU, no synchronizing call before
quorum, CUDA by default, a 5-node cluster converging on them), and the
host chaos harness's engine replay on the card (``check_all`` on a flat
and a hierarchical family, equal to the CPU's replay; its delivery calls
free of synchronizing calls) with a 2-cohort hierarchical service whose
card cut detector decides what the host detector decides, and the native
host library built there with a 2,048-endpoint cluster resumed from a saved
``Configuration`` on the card equal to the same on the CPU, and the
sharded engine: the delivery kernel on column and cohort shards with
offsets, and the sharded step, wave and fleet step on one-rank NCCL meshes
equal to the unsharded engine on the card, and every lane tile of the
kernel (``pallas_lanes`` 128 to 1,024) equal to width 128, and the fleet
wave replayed from captured CUDA graphs equal to the eager wave, eager
where a wrapper on a seam or ``profiling.trace()`` needs Python.
Every test needs a CUDA card and ``nvcc``
and skips without them. On a GPU machine, from the root of a checkout
(``--noconftest`` because the suite's conftest configures JAX, which the
port does not need)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rapid_tpu_torch import _u32
from rapid_tpu_torch.convert import state_to_numpy
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
from rapid_tpu_torch.ops.kernels import delivery_new_bits, delivery_new_bits_ref
from rapid_tpu_torch.testing import (
    churn_cluster, delivery_inputs, fleet_clusters, fleet_on, resolve, skip_edge_inputs,
    sync_checked_wave, wave_exit,
)

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda", 0)


# (c, k, n, spread, permille, inputs): "random" is testing.delivery_inputs,
# the rest testing.skip_edge_inputs. k=10 takes the kernel's K=10
# instance, any other k its generic instance.
@pytest.mark.cuda
@pytest.mark.parametrize("c,k,n,spread,permille,inputs", [
    (2, 10, 1000, 0, 1000, "random"),    # no jitter
    (32, 10, 129, 1, 1000, "random"),    # one cohort word, ragged slot edge
    (64, 10, 1000, 2, 1000, "random"),   # two words, the main path's mode
    (33, 10, 257, 1, 250, "random"),     # sub-round gate, word boundary
    (40, 10, 5, 3, 300, "random"),       # fewer slots than one thread block
    (64, 10, 1000, 2, 1000, "edges"),    # ages -2^30, -1, 0, spread-1, spread, spread+1
    (64, 10, 1000, 2, 1000, "all_blocked"),
    (64, 10, 1000, 2, 1000, "none_blocked"),
    (64, 10, 1000, 2, 1000, "all_pending"),
    (64, 10, 1000, 2, 1000, "misaligned"),  # pointers off 16-byte alignment
    (64, 10, 1000, 0, 1000, "edges"),
    (64, 10, 1000, 3, 300, "edges"),
    (1, 10, 31, 1, 1000, "edges"),       # one cohort, n < 32
    (31, 10, 130, 31, 1000, "edges"),    # large spread
    (32, 10, 64, 31, 250, "all_pending"),
    (33, 10, 1001, 2, 1000, "none_blocked"),
    (33, 1, 100, 2, 1000, "edges"),      # generic K instance from here on
    (40, 3, 37, 1, 1000, "edges"),
    (64, 17, 129, 31, 300, "all_pending"),
    (5, 32, 64, 2, 1000, "edges"),
    (32, 32, 1000, 0, 1000, "none_blocked"),
    (64, 3, 1000, 3, 300, "all_blocked"),
])
def test_delivery_kernel_matches_plain_version(card, c, k, n, spread, permille, inputs):
    seed = c * 100 + spread
    made = (delivery_inputs(c, k, n, seed, card) if inputs == "random"
            else skip_edge_inputs(inputs, c, k, n, spread, seed, card))
    args = (*made, k, c, spread, permille)
    before = delivery_new_bits.launches
    got = delivery_new_bits(*args)
    want = delivery_new_bits_ref(*args)
    assert delivery_new_bits.launches == before + 1
    assert got.shape == (c, n) and got.device == card
    np.testing.assert_array_equal(_u32.to_numpy(got), _u32.to_numpy(want))


@pytest.mark.cuda
@pytest.mark.parametrize("t,c,k,n,spread,permille,inputs", [
    (256, 8, 10, 1044, 2, 1000, "random"),  # the fleet shape, the fleet path's mode
    (256, 8, 10, 1044, 0, 1000, "random"),
    (256, 8, 10, 1044, 3, 300, "random"),
    (3, 40, 10, 77, 2, 1000, "random"),     # ragged: two cohort words, less than a block
    (1, 64, 10, 129, 1, 1000, "random"),    # a fleet of one
    (2, 1024, 10, 40, 2, 1000, "edges"),    # 32 cohort words
    (4, 8, 10, 1044, 2, 1000, "edges"),
    (3, 8, 10, 1044, 2, 1000, "all_pending"),
    (256, 8, 10, 1044, 2, 1000, "misaligned"),
    (2, 33, 17, 30, 1, 250, "edges"),
])
def test_batched_delivery_kernel_matches_plain_version(card, t, c, k, n, spread, permille, inputs):
    seed = t + spread
    made = (delivery_inputs(c, k, n, seed, card, t=t) if inputs == "random"
            else skip_edge_inputs(inputs, c, k, n, spread, seed, card, t=t))
    args = (*made, k, c, spread, permille)
    before = delivery_new_bits.launches
    got = delivery_new_bits(*args)
    want = delivery_new_bits_ref(*args)
    assert delivery_new_bits.launches == before + 1  # one launch for every tenant
    assert got.shape == (t, c, n) and got.device == card
    np.testing.assert_array_equal(_u32.to_numpy(got), _u32.to_numpy(want))


@pytest.mark.cuda
@pytest.mark.parametrize("c,n", [(64, 100_000), (8, 1_000_000), (40, 777)])
@pytest.mark.parametrize("spread,permille", [(0, 1000), (2, 1000), (3, 300)])
def test_every_lane_tile_gives_the_plain_versions_words(card, c, n, spread, permille):
    # delivery_autotune's shapes (and a ragged one): every width of the
    # lane tile, bit for bit against width 128 and the plain version; a
    # width the kernel does not take raises instead of launching.
    blocked, age, epoch = delivery_inputs(c, 10, n, c + spread, card)
    args = (blocked, age, epoch, 10, c, spread, permille)
    want = delivery_new_bits_ref(*args)
    first = delivery_new_bits(*args, lanes=128)
    assert torch.equal(first, want)
    for lanes in (256, 512, 1024):
        before = delivery_new_bits.launches
        assert torch.equal(delivery_new_bits(*args, lanes=lanes), first)
        assert delivery_new_bits.launches == before + 1
    with pytest.raises(ValueError, match="positive multiple of 128"):
        delivery_new_bits(*args, lanes=192)


@pytest.mark.cuda
def test_delivery_wrapper_raises_on_inputs_split_across_devices(card):
    blocked, age, epoch = delivery_inputs(5, 3, 64, 1, card)
    with pytest.raises(ValueError, match="different devices"):
        delivery_new_bits(blocked, age.cpu(), epoch, 3, 5, 1, 1000)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_lane_by_lane(card):
    # testing.churn_cluster's 5%-churn recipe at N=512 with C=40 (two cohort words).
    n, n_churn = 512, 12
    lanes, results = {}, {}
    for device in (card, torch.device("cpu")):
        vc, _ = churn_cluster(n, n_churn, n_churn, 40, 3, device)
        launches = delivery_new_bits.launches
        results[device.type] = resolve(vc, n)
        if device.type == "cuda":
            assert delivery_new_bits.launches > launches
        lanes[device.type] = state_to_numpy(vc.state)
    assert results["cuda"] == results["cpu"]
    assert results["cuda"][2], results
    for field, want in lanes["cpu"].items():
        np.testing.assert_array_equal(lanes["cuda"][field], want, err_msg=field)


@pytest.mark.cuda
def test_fleet_on_card_matches_cpu_lane_by_lane(card):
    # testing.fleet_clusters' fleet recipe at 6 tenants of N=128 with C=40.
    from rapid_tpu_torch.tenancy import TenantFleet
    from rapid_tpu_torch.utils import dispatch

    lanes, results, ran = {}, {}, {}
    for device in (card, torch.device("cpu")):
        clusters, targets = fleet_clusters(6, 128, 4, 40, 11, device, ((9, 4), (8, 3), (7, 2)))
        fleet = TenantFleet.from_clusters(clusters)
        launches = delivery_new_bits.launches
        got = fleet.run_until_membership(targets, max_steps=48, max_cuts=4, min_cuts=1)
        ran[device.type] = dispatch.records()[-1].rounds
        if device.type == "cuda":
            # The new fleet's wave captures its graph after one scratch round,
            # then replays until no tenant is active.
            assert delivery_new_bits.launches == (launches + ran["cuda"]
                                                  + len(fleet._wave_graphs._chunks))
        results[device.type] = [r.tolist() for r in got]
        lanes[device.type] = state_to_numpy(fleet.state)
    assert results["cuda"] == results["cpu"]
    assert all(results["cuda"][2]), results
    assert ran["cuda"] == ran["cpu"] == wave_exit(results["cuda"][0], 48)[0] < 48
    for field, want in lanes["cpu"].items():
        np.testing.assert_array_equal(lanes["cuda"][field], want, err_msg=field)


@pytest.mark.cuda
def test_telemetry_planes_on_card_match_cpu(card):
    # The churn of test_engine_on_card_matches_cpu_lane_by_lane with the
    # plane and a 6-round ring (wrapped by the quiet rounds after it).
    n, n_churn = 512, 12
    lanes, results = {}, {}
    for device in (card, torch.device("cpu")):
        vc, _ = churn_cluster(n, n_churn, n_churn, 40, 3, device, telemetry=True, trace=6)
        result = resolve(vc, n)
        for _ in range(6):
            vc.step()
        results[device.type] = (result, vc.sync(), vc.activity, vc.trace)
        lanes[device.type] = {**state_to_numpy(vc.state), **state_to_numpy(vc.telem),
                              **state_to_numpy(vc.trace_ring)}
    assert results["cuda"] == results["cpu"]
    assert results["cuda"][3]["wraps"] >= 1
    for field, want in lanes["cpu"].items():
        np.testing.assert_array_equal(lanes["cuda"][field], want, err_msg=field)


@pytest.mark.cuda
def test_fleet_wave_with_planes_makes_no_synchronizing_call(card):
    from rapid_tpu_torch.tenancy import TenantFleet

    knobs, wave = ((9, 4), (8, 3), (7, 2)), dict(max_steps=48, max_cuts=4, min_cuts=1)
    clusters, targets = fleet_clusters(6, 128, 4, 40, 11, card, knobs, telemetry=True, trace=8)
    fleet = TenantFleet.from_clusters(clusters)
    want = [r.tolist() for r in fleet.run_until_membership(targets, **wave)]
    clusters, _ = fleet_clusters(6, 128, 4, 40, 11, card, knobs, telemetry=True, trace=8)
    out = sync_checked_wave(TenantFleet.from_clusters(clusters), targets, **wave)
    assert [x.tolist() for x in out[1:5]] == want
    for got, ref in ((out[5], fleet.telem), (out[6], fleet.trace_ring)):
        for field, value in state_to_numpy(ref).items():
            np.testing.assert_array_equal(state_to_numpy(got)[field], value, err_msg=field)


def _paper1k_fleet(card, tenants=16):
    """``tenants`` clusters of the benchmark's ``paper1k`` shape (1,000
    slots, K/H/L 10/9/3, 8 cohorts, spread 2), built on the CPU and moved to
    the card, with their settled lanes for restores."""
    from rapid_tpu_torch.tenancy import TenantFleet

    clusters = []
    for i in range(tenants):
        vc = VirtualCluster.create(1000, n_slots=1000, k=10, h=9, l=3, cohorts=8, fd_threshold=3,
                                   seed=300 + i, fallback_rounds=8, delivery_spread=2,
                                   device=torch.device("cpu"))
        vc.assign_cohorts_roundrobin()
        vc.stagger_fd_counts(np.random.default_rng(i), spread_rounds=3)
        clusters.append(vc)
    fleet = fleet_on(TenantFleet.from_clusters(clusters), card)
    return fleet, (fleet.state, fleet.faults)


def _crash10(fleet, settled, seed):
    """Restore the settled lanes, then crash 10 members in every tenant."""
    fleet.state, fleet.faults = (type(tree)(*(x.clone() for x in tree)) for tree in settled)
    rng = np.random.default_rng(seed)
    fleet.stream_crash([[t, s] for t in range(fleet.b)
                        for s in rng.choice(1000, size=10, replace=False)])


@pytest.mark.cuda
def test_graphed_fleet_wave_equals_the_eager_wave(card):
    from rapid_tpu_torch.tenancy.fleet import WAVE_GRAPH_CHUNK, fleet_wave
    from rapid_tpu_torch.utils import dispatch

    fleet, settled = _paper1k_fleet(card)
    targets = torch.full((fleet.b,), 990, dtype=torch.int32, device=card)
    min_cuts = torch.ones_like(targets)
    for wave in range(2):
        _crash10(fleet, settled, wave)
        state, *want, _, _ = fleet_wave(fleet.cfg, fleet.state, fleet.faults, fleet.knobs,
                                        targets, 96, 4, min_cuts)
        launches = delivery_new_bits.launches
        got = fleet.run_until_membership(990, max_steps=96, max_cuts=4, min_cuts=1)
        # The first wave captures, after one scratch round; each later one
        # only replays. Every tenant is done after one chunk, so one replay
        # runs.
        record = dispatch.records()[-1]
        assert record.rounds == WAVE_GRAPH_CHUNK >= got[0].max()
        assert delivery_new_bits.launches == launches + record.rounds + (wave == 0)
        assert record.graphed and record.tenant_rounds_computed == fleet.b * record.rounds
        assert len(fleet._wave_graphs._chunks) == 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.cpu().numpy())
        assert got[2].all() and (got[1] == 1).all(), got
        want_lanes = state_to_numpy(state)
        for field, value in state_to_numpy(fleet.state).items():
            np.testing.assert_array_equal(value, want_lanes[field], err_msg=f"wave {wave} {field}")


@pytest.mark.cuda
def test_a_graphed_wave_that_needs_its_whole_budget_equals_the_eager_wave(card):
    # One tenant's target is out of its reach, so it is active through all
    # five chunks: from the third on, the host launches each chunk before it
    # waits for the read made before the chunk still on the card.
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.tenancy.fleet import fleet_wave
    from rapid_tpu_torch.utils import dispatch

    fleet, settled = _paper1k_fleet(card, tenants=4)
    _crash10(fleet, settled, 3)
    targets = np.array([980, 990, 990, 990], dtype=np.int32)
    target = torch.from_numpy(targets).to(card)
    state, *want, _, _ = fleet_wave(fleet.cfg, fleet.state, fleet.faults, fleet.knobs, target,
                                    40, 4, torch.ones_like(target))
    launches, reads = delivery_new_bits.launches, _host.site_totals()["fleet_wave_active"][0]
    got = fleet.run_until_membership(targets, max_steps=40, max_cuts=4, min_cuts=1)
    record = dispatch.records()[-1]
    assert record.graphed and (record.rounds, 4) == wave_exit(got[0], 40) == (40, 4)
    assert _host.site_totals()["fleet_wave_active"][0] == reads + 4
    # The new fleet's wave captures its graph after one scratch round.
    assert delivery_new_bits.launches == launches + 40 + 1
    assert got[0][0] == 40 and not got[2][0] and got[2][1:].all(), got
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.cpu().numpy())
    want_lanes = state_to_numpy(state)
    for field, value in state_to_numpy(fleet.state).items():
        np.testing.assert_array_equal(value, want_lanes[field], err_msg=field)


@pytest.mark.cuda
@pytest.mark.parametrize("why", ["seam", "trace"])
def test_fleet_wave_runs_eagerly_where_a_replay_would_skip_python(card, monkeypatch, tmp_path,
                                                                  why):
    import contextlib

    from rapid_tpu_torch.models import virtual_cluster
    from rapid_tpu_torch.utils import dispatch, profiling

    fleet, settled = _paper1k_fleet(card, tenants=4)
    calls = []

    def spy(*args, **kwargs):
        calls.append(1)
        return delivery_new_bits(*args, **kwargs)

    _crash10(fleet, settled, 7)
    if why == "seam":
        monkeypatch.setattr(virtual_cluster, "delivery_new_bits", spy)
    launches = delivery_new_bits.launches
    with profiling.trace(str(tmp_path)) if why == "trace" else contextlib.nullcontext():
        got = fleet.run_until_membership(990, max_steps=96, max_cuts=4, min_cuts=1)
    assert got[2].all()
    record = dispatch.records()[-1]
    assert not record.graphed
    # The eager chunks stop where the replays would: after the first chunk.
    assert record.rounds == 8
    assert delivery_new_bits.launches == launches + record.rounds
    assert len(calls) == (record.rounds if why == "seam" else 0)
    assert not fleet._wave_graphs._chunks


@pytest.mark.cuda
@pytest.mark.parametrize("k,fd_window", [(10, 0), (16, 0), (10, 16)])
def test_compact_engine_on_card_matches_cpu_and_wide(card, k, fd_window):
    # The churn of test_engine_on_card_matches_cpu_lane_by_lane, compact:
    # int16 index lanes and the report lane at uint16 (bit 15 in play at
    # K=16), or a uint16 history lane (fd_window=16).
    from rapid_tpu_torch.models.state import lane_dtypes, widen_state

    n, n_churn = 512, 12
    lanes, results = {}, {}
    for where, device, compact in (("card", card, True), ("cpu", torch.device("cpu"), True),
                                   ("card_wide", card, False)):
        vc = VirtualCluster.create(n, n_slots=n + n_churn, k=k, h=k - 1, l=4, cohorts=40,
                                   fd_threshold=3, seed=3, delivery_spread=2,
                                   fd_window=fd_window, compact=compact, device=device)
        vc.assign_cohorts_roundrobin()
        vc.crash(np.random.default_rng(3).choice(n, size=n_churn, replace=False))
        vc.inject_join_wave(np.arange(n, n + n_churn))
        launches = delivery_new_bits.launches
        results[where] = resolve(vc, n)
        if device.type == "cuda":
            assert delivery_new_bits.launches > launches
        lanes[where] = state_to_numpy(widen_state(vc.cfg, vc.state) if where == "card" else vc.state)
        if compact:
            got = {f: v.dtype.name for f, v in state_to_numpy(vc.state).items()}
            assert got == {f: d for f, d in lane_dtypes(vc.cfg).items() if f in got}
        lanes[where + "_raw"] = state_to_numpy(vc.state)
    assert results["card"] == results["cpu"] == results["card_wide"]
    assert results["card"][2], results
    for field, want in lanes["cpu_raw"].items():
        np.testing.assert_array_equal(lanes["card_raw"][field], want, err_msg=field)
    for field, want in lanes["card_wide"].items():
        np.testing.assert_array_equal(lanes["card"][field], want, err_msg=field)


@pytest.mark.cuda
def test_compact_fleet_on_card_matches_cpu(card):
    from rapid_tpu_torch.tenancy import TenantFleet
    from rapid_tpu_torch.tenancy.fleet import tenant_health

    lanes, results = {}, {}
    for device in (card, torch.device("cpu")):
        clusters, targets = fleet_clusters(6, 128, 4, 40, 11, device, ((9, 4), (8, 3), (7, 2)),
                                           compact=True)
        fleet = TenantFleet.from_clusters(clusters)
        assert fleet.state.obs_idx.dtype == torch.int16
        results[device.type] = [r.tolist() for r in fleet.run_until_membership(
            targets, max_steps=48, max_cuts=4, min_cuts=1)]
        assert bool(tenant_health(fleet.cfg, fleet.state).all())
        lanes[device.type] = state_to_numpy(fleet.state)
    assert results["cuda"] == results["cpu"] and all(results["cuda"][2])
    for field, want in lanes["cpu"].items():
        np.testing.assert_array_equal(lanes["cuda"][field], want, err_msg=field)


@pytest.mark.cuda
def test_endpoint_cluster_on_card_matches_cpu(card):
    from rapid_tpu_torch.testing import endpoint_churn, endpoint_list

    lanes, results = {}, {}
    for device in (card, torch.device("cpu")):
        vc, _ = endpoint_churn(endpoint_list(1_024), 1_000, 24, 24, device)
        results[device.type] = resolve(vc, 1_000)
        lanes[device.type] = {**state_to_numpy(vc.state), **state_to_numpy(vc.faults)}
    assert results["cuda"] == results["cpu"] and results["cuda"][2]
    for field, want in lanes["cpu"].items():
        np.testing.assert_array_equal(lanes["cuda"][field], want, err_msg=field)


@pytest.mark.cuda
def test_native_host_library_builds_on_the_card_machine(card):
    from rapid_tpu_torch import _build
    from rapid_tpu_torch.utils import _native
    from rapid_tpu_torch.utils.xxhash import xxh64

    assert _native.ensure_built(), _build.build_log.get("rapid_native")
    _native._attempted = False
    assert _native.get_lib() is not None
    assert _native.native_xxh64(b"rapid", 7) == xxh64(b"rapid", 7)


@pytest.mark.cuda
def test_configuration_resume_on_card_matches_cpu(card, tmp_path):
    from rapid_tpu_torch.testing import endpoint_churn, endpoint_list, seeded_node_ids
    from rapid_tpu_torch.protocol.view import MembershipView
    from rapid_tpu_torch.utils.checkpoint import load_configuration, save_configuration

    endpoints = endpoint_list(2_048)
    config = MembershipView(10, node_ids=seeded_node_ids(2_000, 22),
                            endpoints=endpoints[:2_000]).configuration
    save_configuration(tmp_path / "config.rtcf", config)
    resumed = list(load_configuration(tmp_path / "config.rtcf").endpoints) + endpoints[2_000:]
    lanes, results = {}, {}
    for device in (card, torch.device("cpu")):
        vc, _ = endpoint_churn(resumed, 2_000, 48, 48, device)
        results[device.type] = resolve(vc, 2_000)
        lanes[device.type] = {**state_to_numpy(vc.state), **state_to_numpy(vc.faults)}
    assert results["cuda"] == results["cpu"] and results["cuda"][2]
    for field, want in lanes["cpu"].items():
        np.testing.assert_array_equal(lanes["cuda"][field], want, err_msg=field)


def _small_stream_cluster(device, seed=5):
    from rapid_tpu_torch.testing import stream_cluster

    return stream_cluster(256, 320, 8, 64, seed, device)


@pytest.mark.cuda
def test_stream_on_card_equals_batch_drive_and_cpu(card):
    # A short stream (crashes and joins, 8 waves of 8 rounds, 2 deep) on the
    # card, its wave applications and rounds under the sync check
    # (testing.sync_checked_stream), against the same schedule through
    # the batch seams on the card, and the same stream on the CPU.
    from rapid_tpu_torch.testing import all_lanes, batch_drive, run_stream
    from rapid_tpu_torch.serving import PoissonChurn

    waves = PoissonChurn(256, 320, rate=3.0, seed=9).waves(8)
    streamed = _small_stream_cluster(card)
    _, result, launches = run_stream(card, streamed, waves)
    assert launches == 64  # one delivery launch per streamed round
    batch = _small_stream_cluster(card)
    batch_drive(batch, waves, 8)
    on_cpu = _small_stream_cluster(torch.device("cpu"))
    run_stream(torch.device("cpu"), on_cpu, waves, checked=False)
    assert streamed.config_id == batch.config_id == on_cpu.config_id
    assert result["cuts"] == batch.config_epoch > 0
    want = all_lanes(batch)
    for other in (streamed, on_cpu):
        got = all_lanes(other)
        for field, value in want.items():
            np.testing.assert_array_equal(got[field], value, err_msg=field)


@pytest.mark.cuda
def test_stream_path_makes_no_read_and_no_synchronizing_call(card):
    # crash, inject_join_wave(check_admissible=False), stream_step and the
    # fleet's stream_crash and stream_step with every synchronizing call an
    # error (pageable uploads would be one) and the counted reads unchanged.
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.ops.rings import predecessor_of_keys
    from rapid_tpu_torch.tenancy import TenantFleet

    vc = _small_stream_cluster(card)
    fleet = TenantFleet.from_clusters([_small_stream_cluster(card, s) for s in (1, 2, 3)])
    torch.cuda.synchronize(card)
    reads = _host.read.count
    torch.cuda.set_sync_debug_mode("error")
    try:
        vc.crash([3, 7])
        vc.inject_join_wave([256, 257, 300], check_admissible=False)
        s = vc.state
        predecessor_of_keys(s.key_hi, s.key_lo, s.alive, s.key_hi[:, :5], s.key_lo[:, :5],
                            perm=s.ring_perm)
        for _ in range(4):
            vc.stream_step()
        fleet.stream_crash([(0, 3), (2, 9)])
        for _ in range(4):
            fleet.stream_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _host.read.count == reads
    assert len(vc._staged) == 2 and len(fleet._staged) == 1  # the pinned uploads, kept
    assert all(buf.is_pinned() for buf in vc._staged + fleet._staged)
    torch.cuda.synchronize(card)


@pytest.mark.cuda
def test_chaos_fleet_on_card_matches_cpu(card):
    # The four honest families of the chaos tests as one fleet on the card
    # and on the CPU: equal phase records, final slots and totals.
    from rapid_tpu_torch.testing import fleet_records
    from rapid_tpu_torch.tenancy import chaos

    specs = [("partition_heal", 5), ("asymmetric_link", 6), ("crash_during_join", 7),
             ("churn_under_loss", 8)]
    launches = delivery_new_bits.launches
    on_card = chaos.run_fleet(chaos.compile_fleet(specs, device=card))
    assert delivery_new_bits.launches > launches
    on_cpu = chaos.run_fleet(chaos.compile_fleet(specs, device=torch.device("cpu")))
    assert fleet_records(on_card) == fleet_records(on_cpu)
    assert chaos.check_fleet(on_card) == []


@pytest.mark.cuda
def test_loss_mode_churn_on_card_matches_cpu(card):
    # testing.churn_cluster's churn recipe at N=1,024 with the loss variant's knobs
    # (spread 2, 50 permille: the kernel's gated mode).
    n, n_churn = 1_024, 24
    lanes, results = {}, {}
    for device in (card, torch.device("cpu")):
        vc, _ = churn_cluster(n, n_churn, n_churn, 40, 5, device, delivery_spread=2,
                              delivery_prob_permille=50)
        results[device.type] = resolve(vc, n)
        lanes[device.type] = {**state_to_numpy(vc.state), **state_to_numpy(vc.faults)}
    assert results["cuda"] == results["cpu"]
    assert results["cuda"][2], results
    for field, want in lanes["cpu"].items():
        np.testing.assert_array_equal(lanes["cuda"][field], want, err_msg=field)


@pytest.mark.cuda
def test_false_alert_injection_on_a_card_cluster(card):
    # inject_engine_event reads the probe lanes back to the host once: on a
    # CUDA cluster that read must work, and the lie must evict its subject
    # as on the CPU.
    from rapid_tpu_torch.sim import fuzz, oracles
    from rapid_tpu_torch.sim.faults import FaultEvent

    lie = FaultEvent("alert_storm", (2, 3), {"subject": 5, "rings": list(range(9))})
    got = {}
    for device in (card, torch.device("cpu")):
        vc = VirtualCluster.from_endpoints(fuzz.endpoints_for(4, 12), n_members=8, k=10, h=9,
                                           l=4, fd_threshold=1, device=device)
        assert oracles.inject_engine_event(vc, lie) == -1
        assert vc.faults.probe_fail.device.type == device.type
        got[device.type] = (vc.run_to_decision(max_steps=16)[3],
                            vc.faults.probe_fail.cpu().numpy(), vc.alive_mask)
    assert got["cuda"][0] == got["cpu"][0] == 7
    np.testing.assert_array_equal(got["cuda"][1], got["cpu"][1])
    np.testing.assert_array_equal(got["cuda"][2], got["cpu"][2])
    assert not got["cuda"][2][5]


@pytest.mark.cuda
def test_scrape_reads_the_allocator_and_the_build_capture(card):
    from rapid_tpu_torch.models.state import state_bytes_total
    from rapid_tpu_torch.utils.engine_telemetry import compiled_memory_analysis

    vc, _ = churn_cluster(4096, 102, 102, 40, 7, card, telemetry=True, trace=16)
    resolve(vc, 4096)
    vc.sync()
    snap = vc.telemetry_snapshot()
    memory, build = snap["engine"]["memory"], snap["engine"]["compile"]
    assert None not in memory.values()
    assert memory["device_bytes_in_use"] == torch.cuda.memory_allocated(card)
    assert memory["device_peak_bytes"] >= state_bytes_total(vc.cfg)
    assert build["cache_requests"] == build["persistent_cache_hits"] + build["persistent_cache_misses"]
    assert build["cache_requests"] >= 1
    assert build["compiles"] == build["persistent_cache_misses"] == build["compile_ms"]["count"]
    facts = compiled_memory_analysis("delivery")
    assert facts is not None and len(facts) == 6  # K=10 and generic, three delay modes
    assert all(f["registers"] > 0 for f in facts.values())
    assert 'rapid_engine_device_bytes_in_use{node="virtual-cluster/4198"} ' in vc.prometheus_text()


@pytest.mark.cuda
def test_profiler_trace_sees_the_delivery_kernel(card, tmp_path):
    import json

    from rapid_tpu_torch.utils import profiling

    results = []
    for profiled in (True, False):
        vc, _ = churn_cluster(4096, 102, 102, 40, 7, card)
        if profiled:
            with profiling.trace(str(tmp_path)):
                results.append(resolve(vc, 4096))
        else:
            results.append(resolve(vc, 4096))
    assert results[0] == results[1]
    with open(profiling.trace_file(str(tmp_path))) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == profiling.PREFIX + "run_until_membership" for e in events)
    assert any(e.get("cat") == "kernel" and "delivery_new_bits_kernel" in e.get("name", "")
               for e in events)


# -- the host membership path's device adapters -------------------------------


def _host_view(n, seed, k=10):
    from rapid_tpu_torch.protocol import MembershipView
    from rapid_tpu_torch.types import Endpoint, NodeId

    rng = np.random.default_rng(seed)
    ports = rng.choice(40000, size=n, replace=False) + 1
    endpoints = [Endpoint(f"10.5.{i % 256}.{i // 256}", int(p)) for i, p in enumerate(ports)]
    view = MembershipView(k, node_ids=[NodeId(0, i) for i in range(n)], endpoints=endpoints)
    return view, endpoints


def _host_alerts(view, subject, count):
    from rapid_tpu_torch.types import AlertMessage, EdgeStatus

    observers = view.observers_of(subject)
    return [AlertMessage(observers[r], subject, EdgeStatus.DOWN, 0, (r,)) for r in range(count)]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_device_cut_detector_on_card_matches_cpu(card, seed):
    from rapid_tpu_torch.protocol import DeviceCutDetector

    view, endpoints = _host_view(60, seed)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(6):
        batch = []
        for _ in range(rng.integers(1, 4)):
            subject = endpoints[rng.integers(0, len(endpoints))]
            batch.extend(_host_alerts(view, subject, int(rng.integers(1, 11))))
        batches.append(batch)
    batches.append(_host_alerts(view, endpoints[-1], 10))
    # After the view change's clear(), a crash of three that must release
    # (the random batches can leave a subject in flux, which blocks any
    # release on both devices alike).
    crash = [a for s in endpoints[:3] for a in _host_alerts(view, s, 10)]
    outs = []
    for dev in (card, "cpu"):
        det = DeviceCutDetector(10, 8, 3, max_slots=256, device=dev)
        out = [sorted(map(str, det.aggregate_batch(b, view))) for b in batches]
        det.clear()
        out.append(sorted(map(str, det.aggregate_batch(crash, view))))
        outs.append(out + [det.num_proposals, det.batches, det.bytes_uploaded])
    assert outs[0] == outs[1]
    assert outs[0][-4] == sorted(map(str, endpoints[:3]))


@pytest.mark.cuda
def test_device_vote_tally_on_card_matches_cpu_and_syncs_only_after_quorum(card):
    import random

    from rapid_tpu_torch import _host
    from rapid_tpu_torch.ops.consensus import fast_paxos_quorum
    from rapid_tpu_torch.protocol import DeviceVoteTally
    from rapid_tpu_torch.types import Endpoint

    n = 102
    quorum = fast_paxos_quorum(n)
    proposals = [(Endpoint("10.9.0.1", 4000 + i),) for i in range(3)]
    rng = random.Random(3)
    plan = [rng.choice([0, 0, 0, 0, 0, 0, 1, 2]) for _ in range(n)]
    outs = []
    for dev in (card, "cpu"):
        tally = DeviceVoteTally(n, device=dev)
        got, reads0 = [], _host.read.count
        for i, p in enumerate(plan):
            sender = Endpoint("10.8.0.1", 100 + i)
            if i < quorum - 1 and dev is card:
                reads = _host.read.count
                torch.cuda.set_sync_debug_mode("error")
                try:
                    got.append(tally.add_vote(sender, proposals[p]))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                assert _host.read.count == reads
            else:
                got.append(tally.add_vote(sender, proposals[p]))
        outs.append((got, tally.tallies, _host.read.count - reads0))
    assert outs[0] == outs[1]
    assert outs[0][1] == outs[0][2] == n - quorum + 1


@pytest.mark.cuda
def test_adapters_land_on_the_card_without_a_device(card):
    from rapid_tpu_torch.protocol import DeviceCutDetector, DeviceVoteTally

    assert DeviceCutDetector(10, 9, 3).device.type == "cuda"
    tally = DeviceVoteTally(10)
    assert tally.device.type == "cuda" and tally._vote_hi.device.type == "cuda"


@pytest.mark.cuda
def test_five_node_cluster_with_both_adapters_on_card_converges(card):
    import asyncio
    import functools
    import random

    from rapid_tpu_torch.messaging.inprocess import InProcessNetwork
    from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
    from rapid_tpu_torch.protocol import Cluster, DeviceCutDetector, DeviceVoteTally
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.types import Endpoint

    async def scenario():
        settings = Settings()
        settings.batching_window_ms = 20
        settings.failure_detector_interval_ms = 50
        network, fd = InProcessNetwork(), StaticFailureDetectorFactory()
        kw = dict(settings=settings, network=network, fd_factory=fd,
                  cut_detector_factory=functools.partial(DeviceCutDetector, max_slots=64,
                                                         device=card),
                  vote_tally_factory=functools.partial(DeviceVoteTally, device=card))
        eps = [Endpoint("127.0.0.1", 43200 + i) for i in range(5)]
        clusters = [await Cluster.start(eps[0], rng=random.Random(0), **kw)]
        for i in range(1, 5):
            clusters.append(await Cluster.join(eps[0], eps[i], rng=random.Random(i), **kw))

        async def converged(cs, size):
            for _ in range(600):
                if all(c.membership_size == size for c in cs) and (
                        len({tuple(c.membership) for c in cs}) == 1):
                    return True
                await asyncio.sleep(0.02)
            return False

        try:
            assert await converged(clusters, 5)
            victim = clusters[3]
            network.blackholed.add(victim.listen_address)
            fd.add_failed_nodes([victim.listen_address])
            survivors = [c for c in clusters if c is not victim]
            assert await converged(survivors, 4)
            assert all(c.service.cut_detector.device.type == "cuda" for c in survivors)
            assert sum(c.service.cut_detector.batches for c in survivors) > 0
        finally:
            for c in clusters:
                await c.shutdown()

    asyncio.run(asyncio.wait_for(scenario(), timeout=60))


@pytest.mark.cuda
def test_report_matrix_makes_no_synchronizing_call(card):
    # alerts_to_report_matrix fills with index_fill_: ``out[idx] = True``
    # copied a host scalar to the card, which waits for the stream.
    from rapid_tpu_torch.ops.cut_detection import alerts_to_report_matrix

    dst = torch.tensor([3, 5, 5, -1], dtype=torch.int32, device=card)
    rings = torch.tensor([0, 2, 9, 1], dtype=torch.int32, device=card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = alerts_to_report_matrix(8, 4, dst, rings)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.device.type == "cuda"
    assert torch.equal(out.cpu(), alerts_to_report_matrix(8, 4, dst.cpu(), rings.cpu()))
    assert out.cpu().nonzero().tolist() == [[3, 0], [5, 2]]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["churn_under_loss", "delegate_gray_failure"])
def test_check_all_replays_on_card_as_on_cpu(card, family):
    # A flat and a hierarchical family: the host run's oracles with the
    # engine replay on the card, and the replay itself card against CPU.
    from rapid_tpu_torch.sim.fuzz import run_schedule, scenario_family
    from rapid_tpu_torch.sim.oracles import check_all, replay_through_engine

    result = run_schedule(scenario_family(family, 1))
    before = delivery_new_bits.launches
    assert check_all(result, device=card) == [] == check_all(result, device="cpu")
    assert delivery_new_bits.launches > before
    assert replay_through_engine(result.schedule, result.endpoints, device=card) == (
        replay_through_engine(result.schedule, result.endpoints, device="cpu"))


@pytest.mark.cuda
def test_two_cohort_service_with_card_detector_decides_as_host(card):
    import asyncio

    from rapid_tpu_torch.testing import host_service_crash

    runs = {adapters: asyncio.run(asyncio.wait_for(host_service_crash(card, adapters, 8, 4), 120))
            for adapters in (True, False)}
    assert runs[True]["cohorts"] == 2 and runs[True]["cut_passes"] > 0
    for key in ("final", "msgs", "sim_ms", "cohort_counters", "decision_paths"):
        assert runs[True][key] == runs[False][key], key


@pytest.mark.cuda
def test_replay_delivery_calls_make_no_synchronizing_call(card):
    # The delivery call inside the engine replay (``_deliver_alerts``)
    # launches without synchronizing, as it does on the stream path.
    from rapid_tpu_torch.models import virtual_cluster
    from rapid_tpu_torch.sim.fuzz import scenario_family
    from rapid_tpu_torch.sim.oracles import replay_through_engine

    real, calls = virtual_cluster.delivery_new_bits, []

    def checked(*args, **kwargs):
        torch.cuda.synchronize(card)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append(out.shape)
        return out

    schedule = scenario_family("crash_during_join", 2)
    virtual_cluster.delivery_new_bits = checked
    try:
        from rapid_tpu_torch.sim.scenario import endpoints_for

        replay_through_engine(schedule, endpoints_for(schedule.seed, schedule.n_slots),
                              device=card)
    finally:
        virtual_cluster.delivery_new_bits = real
    assert calls


def _packed(blocked, dev):
    """``[c, k, n]`` bools -> ``[w*k, n]`` stored words (row wi*k + ring,
    bit j = cohort 32*wi + j)."""
    c, k, n = blocked.shape
    words = np.zeros(((c + 31) // 32, k, n), dtype=np.uint64)
    for ci in range(c):
        words[ci // 32] |= blocked[ci].astype(np.uint64) << np.uint64(ci % 32)
    return _u32.from_numpy(words.astype(np.uint32).reshape(-1, n), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("c,c_local", [(8, 4), (64, 32), (40, 40)])
@pytest.mark.parametrize("spread,permille", [(0, 1000), (2, 1000), (3, 300)])
def test_delivery_kernel_on_shards_with_offsets(card, c, c_local, spread, permille):
    # Column slices at unaligned slot offsets and cohort shards (one that
    # splits a word at c=8, whole words at c=64): each launch equals its
    # plain version, and the shards side by side equal the whole launch.
    k, n = 10, 3001
    rng = np.random.default_rng(c + spread)
    blocked = rng.random((c, k, n)) < 0.3
    age = torch.from_numpy(rng.integers(-2, 6, size=(k, n)).astype(np.int32)).to(card)
    epoch = torch.tensor([3], dtype=torch.int32, device=card)
    whole = delivery_new_bits(_packed(blocked, card), age, epoch, k, c, spread, permille)
    for c0 in range(0, c, c_local):
        parts = []
        for lo, hi in ((0, 1000), (1000, 1777), (1777, n)):
            args = (_packed(blocked[c0:c0 + c_local, :, lo:hi], card), age[:, lo:hi].contiguous(),
                    epoch, k, c_local, spread, permille, lo, c0)
            got = delivery_new_bits(*args)
            assert torch.equal(got, delivery_new_bits_ref(*args)), (c0, lo)
            parts.append(got)
        assert torch.equal(torch.cat(parts, -1), whole[c0:c0 + c_local]), c0


@pytest.mark.cuda
def test_one_rank_nccl_mesh_runs_the_sharded_engine_as_unsharded(card, tmp_path):
    # The sharded entry points on one-rank NCCL meshes (every collective
    # issued) against the unsharded engine on the card, lane by lane.
    import os

    import torch.distributed as dist
    import torch_mesh_jobs as jobs

    from rapid_tpu_torch.models.virtual_cluster import engine_step, run_until_membership
    from rapid_tpu_torch.parallel import mesh as pm
    from rapid_tpu_torch.parallel.multihost import initialize_multihost
    from rapid_tpu_torch.tenancy.fleet import fleet_step, make_fleet_step

    def create(*args, **kwargs):
        return VirtualCluster.create(*args, device=card, **kwargs)

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    initialize_multihost(f"file://{tmp_path}/store", 1, 0)
    try:
        for shape in (None, (1, 1)):
            mesh = pm.make_mesh(shape=shape)
            vc = jobs.build("multi_cut", create)
            want, *wres, _, _ = run_until_membership(vc.cfg, vc.state, vc.faults, 70, 192, 8, 1)
            vc = jobs.build("multi_cut", create)
            wave = pm.make_sharded_wave(vc.cfg, mesh)
            got, *gres = wave(pm.shard_state(vc.state, mesh), pm.shard_faults(vc.faults, mesh),
                              70, 192, 1)
            assert gres[:3] == wres[:3] and gres[2]
            assert state_to_numpy(pm.local_tree(got)).keys() == state_to_numpy(want).keys()
            for field, value in state_to_numpy(want).items():
                assert np.array_equal(state_to_numpy(pm.local_tree(got))[field], value), field
            vc = jobs.build("partitioned", create)
            state = vc.state
            step = pm.make_sharded_step(vc.cfg, mesh)
            sharded = pm.shard_state(vc.state, mesh)
            faults = pm.shard_faults(vc.faults, mesh)
            for _ in range(12):
                state, _, decided, _, _ = engine_step(vc.cfg, state, vc.faults)
                sharded, _ = step(sharded, faults)
                assert step.decided == decided
            for field, value in state_to_numpy(state).items():
                assert np.array_equal(state_to_numpy(pm.local_tree(sharded))[field], value), field
            assert {r["label"] for r in step.context.log} >= {"classic coordinators", "vote tally"}
        clusters, _ = jobs.fleet_clusters(create)
        from rapid_tpu_torch.tenancy import TenantFleet

        fleet = TenantFleet.from_clusters(clusters)
        mesh = pm.make_mesh(shape=(1, 1, 1))
        step = make_fleet_step(fleet.cfg, mesh)
        state, sharded = fleet.state, pm.shard_fleet_state(fleet.state, mesh)
        faults = pm.shard_fleet_faults(fleet.faults, mesh)
        for _ in range(8):
            state, *_ = fleet_step(fleet.cfg, state, fleet.faults, fleet.knobs)
            sharded, _ = step(sharded, faults, fleet.knobs)
        for field, value in state_to_numpy(state).items():
            assert np.array_equal(state_to_numpy(pm.local_tree(sharded))[field], value), field
    finally:
        dist.destroy_process_group()
