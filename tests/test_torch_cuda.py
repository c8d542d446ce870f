"""The PyTorch port on a CUDA card.

The delivery kernel (``rapid_tpu_torch/csrc/delivery.cu``) against its plain
PyTorch version, bit for bit, for one cluster and with a tenant axis, and
the whole engine and a tenant fleet on the card against the same on the
CPU, lane by lane, with and without the telemetry plane and trace ring, in
the wide and the compact layout, and an endpoint cluster
(``VirtualCluster.from_endpoints``).
Every test needs a CUDA card and ``nvcc``
and skips without them. On a GPU machine, from the root of a checkout
(``--noconftest`` because the suite's conftest configures JAX, which the
port does not need)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    churn_cluster, delivery_inputs, fleet_clusters, resolve, skip_edge_inputs, sync_checked_wave,
)
from rapid_tpu_torch import _u32
from rapid_tpu_torch.convert import state_to_numpy
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
from rapid_tpu_torch.ops.kernels import delivery_new_bits, delivery_new_bits_ref

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda", 0)


# (c, k, n, spread, permille, inputs): "random" is chip_smoke.delivery_inputs,
# the rest chip_smoke.skip_edge_inputs. k=10 takes the kernel's K=10
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
def test_delivery_wrapper_raises_on_inputs_split_across_devices(card):
    blocked, age, epoch = delivery_inputs(5, 3, 64, 1, card)
    with pytest.raises(ValueError, match="different devices"):
        delivery_new_bits(blocked, age.cpu(), epoch, 3, 5, 1, 1000)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_lane_by_lane(card):
    # chip_smoke.py's 5%-churn recipe at N=512 with C=40 (two cohort words).
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
    # chip_smoke.py's fleet recipe at 6 tenants of N=128 with C=40.
    from rapid_tpu_torch.tenancy import TenantFleet

    lanes, results = {}, {}
    for device in (card, torch.device("cpu")):
        clusters, targets = fleet_clusters(6, 128, 4, 40, 11, device, ((9, 4), (8, 3), (7, 2)))
        fleet = TenantFleet.from_clusters(clusters)
        launches = delivery_new_bits.launches
        got = fleet.run_until_membership(targets, max_steps=48, max_cuts=4, min_cuts=1)
        if device.type == "cuda":
            assert delivery_new_bits.launches == launches + 48
        results[device.type] = [r.tolist() for r in got]
        lanes[device.type] = state_to_numpy(fleet.state)
    assert results["cuda"] == results["cpu"]
    assert all(results["cuda"][2]), results
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
    from chip_smoke import endpoint_churn, endpoint_list

    lanes, results = {}, {}
    for device in (card, torch.device("cpu")):
        vc, _ = endpoint_churn(endpoint_list(1_024), 1_000, 24, 24, device)
        results[device.type] = resolve(vc, 1_000)
        lanes[device.type] = {**state_to_numpy(vc.state), **state_to_numpy(vc.faults)}
    assert results["cuda"] == results["cpu"] and results["cuda"][2]
    for field, want in lanes["cpu"].items():
        np.testing.assert_array_equal(lanes["cuda"][field], want, err_msg=field)
