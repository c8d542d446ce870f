"""The PyTorch port's endpoint clusters against the JAX package's, exactly.

Ring keys of real endpoints (``ops.rings.endpoint_ring_keys``, hashed on
the host with a batched numpy XXH64) against the JAX package's, over
hostnames of mixed lengths (empty, short, past one 32-byte stripe,
non-ASCII) and ports 0 and 65535; the sorting ``ring_topology`` against
JAX's and against the sort-free ``ring_topology_from_perm``; and a churn on
a ``VirtualCluster.from_endpoints`` cluster (crashes, then the keyed
joiner slots admitted) through both packages in lockstep, in the wide and
the compact layout.
"""

import numpy as np
import pytest
import torch

from rapid_tpu.models.virtual_cluster import VirtualCluster as JaxCluster
from rapid_tpu.ops import rings as jrings
from rapid_tpu.protocol.view import ring_key as jax_ring_key
from rapid_tpu.types import Endpoint as JaxEndpoint
from rapid_tpu.utils import xxhash as jxx
from rapid_tpu_torch import _u32
from rapid_tpu_torch.convert import state_to_numpy
from rapid_tpu_torch.models.state import lane_dtypes
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster as TorchCluster
from rapid_tpu_torch.ops import rings as trings
from rapid_tpu_torch.types import Endpoint
from rapid_tpu_torch.utils import xxhash as txx


def mixed_endpoints(count, seed):
    """(hostname, port) pairs: lengths 0..69 bytes of ASCII, every seventh
    with non-ASCII letters, the first four ports 0 and 65535."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        host = "".join(map(chr, rng.integers(97, 123, int(rng.integers(0, 70)))))
        if i % 7 == 0:
            host += "ü日本"
        port = (0, 65535)[i % 2] if i < 4 else int(rng.integers(0, 65536))
        out.append((host, port))
    return out


def jax_lanes(tree):
    return {f: np.asarray(getattr(tree, f)) for f in tree._fields}


def assert_same_lanes(torch_tree, jax_tree, where):
    got, want = state_to_numpy(torch_tree), jax_lanes(jax_tree)
    assert set(got) == set(want)
    for field, w in want.items():
        assert got[field].dtype == w.dtype, f"{where}: {field} dtype {got[field].dtype} != {w.dtype}"
        np.testing.assert_array_equal(got[field], w, err_msg=f"{where}: lane {field}", strict=True)


@pytest.mark.parametrize("length", [0, 1, 3, 4, 7, 8, 12, 31, 32, 33, 63, 64, 65, 100])
def test_batched_xxh64_equals_the_scalar_hash_and_jaxs(length):
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, size=(5, length), dtype=np.uint8)
    seeds = [0, 1, 9, 2**63 + 5]
    got = txx.xxh64_rows(data, seeds)
    for s, seed in enumerate(seeds):
        for i in range(5):
            want = jxx.xxh64(data[i].tobytes(), seed)
            assert int(got[s, i]) == want == txx.xxh64(data[i].tobytes(), seed)
    for value in (0, 1, 65535, -1, 2**63, 2**64 - 1):
        assert txx.xxh64_int(value, 3) == jxx.xxh64_int(value, 3)


def test_endpoint_ring_keys_match_jax():
    pairs = mixed_endpoints(500, 0)
    hi, lo = trings.endpoint_ring_keys([Endpoint(*p) for p in pairs], 10)
    jhi, jlo = jrings.endpoint_ring_keys([JaxEndpoint(*p) for p in pairs], 10)
    assert hi.dtype == np.uint32 and lo.dtype == np.uint32
    np.testing.assert_array_equal(hi, np.asarray(jhi))
    np.testing.assert_array_equal(lo, np.asarray(jlo))
    for seed in (0, 9):
        for p in pairs[:40]:
            assert trings.ring_key(Endpoint(*p), seed) == jax_ring_key(JaxEndpoint(*p), seed)


def test_java_topology_raises_as_jax_does():
    eps = [Endpoint("a", 1)]
    with pytest.raises(ValueError) as want:
        jrings.endpoint_ring_keys([JaxEndpoint("a", 1)], 3, topology="java")
    with pytest.raises(ValueError) as got:
        trings.endpoint_ring_keys(eps, 3, topology="java")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="native topology"):
        TorchCluster.from_endpoints(eps, topology="java", device="cpu")


@pytest.mark.parametrize("alive_kind", ["random", "none", "one", "two", "all"])
def test_sorting_ring_topology_matches_jax_and_the_sort_free_one(alive_kind):
    rng = np.random.default_rng(7)
    k, n = 5, 300
    hi = rng.integers(0, 4, size=(k, n), dtype=np.uint32) * np.uint32(0x7FFFFFFF)  # ties, sign bit
    lo = rng.integers(0, 2**32, size=(k, n), dtype=np.uint32)
    lo[:, :20] = lo[:, 20:40]  # equal keys: ties break by slot
    hi[:, :20] = hi[:, 20:40]
    alive = {"random": rng.random(n) < 0.6, "none": np.zeros(n, bool), "one": np.eye(1, n, 17)[0] > 0,
             "two": np.isin(np.arange(n), [3, 250]), "all": np.ones(n, bool)}[alive_kind]
    got = trings.ring_topology(_u32.from_numpy(hi, "cpu"), _u32.from_numpy(lo, "cpu"), torch.from_numpy(alive))
    want = jrings.ring_topology(hi, lo, alive)
    for field in ("obs_idx", "subj_idx", "order"):
        value = getattr(got, field)
        assert value.dtype == torch.int32
        np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(want, field)), err_msg=field)
    perm = trings.ring_perms(_u32.from_numpy(hi, "cpu"), _u32.from_numpy(lo, "cpu"))
    scan = trings.ring_topology_from_perm(perm.to(torch.int16), torch.from_numpy(alive))
    for field in ("obs_idx", "subj_idx", "order"):
        assert torch.equal(getattr(scan, field), getattr(got, field)), field


@pytest.fixture(scope="module")
def endpoints():
    """64 endpoints with hostnames of mixed lengths: 56 members, then 4
    keyed joiner slots, then 4 more keyed slots; 68 slots in all."""
    return [(f"node-{i}.r{i % 7}.dc{i % 3}" + "x" * (i % 40), 7000 + 13 * i) for i in range(64)]


@pytest.mark.parametrize("compact", [False, True])
def test_from_endpoints_churn_matches_jax(endpoints, compact):
    kw = dict(n_slots=68, n_members=56, k=10, h=9, l=4, cohorts=3, fd_threshold=2,
              delivery_spread=1, compact=compact)
    jvc = JaxCluster.from_endpoints([JaxEndpoint(*p) for p in endpoints], **kw)
    tvc = TorchCluster.from_endpoints([Endpoint(*p) for p in endpoints], device="cpu", **kw)
    assert tvc.cfg == tuple(jvc.cfg)
    want_dtypes = lane_dtypes(tvc.cfg)

    def check(where):
        assert_same_lanes(tvc.state, jvc.state, where)
        assert_same_lanes(tvc.faults, jvc.faults, where)
        for field, value in state_to_numpy(tvc.state).items():
            assert value.dtype.name == want_dtypes[field], f"{where}: {field}"

    check("from_endpoints")
    for method, arg in (("assign_cohorts_roundrobin", None), ("crash", [3, 30, 41]),
                        ("inject_join_wave", [56, 57, 58, 59])):
        for vc in (jvc, tvc):
            getattr(vc, method)(*(() if arg is None else (arg,)))
        check(method)
    for r in range(64):
        assert_same_lanes(tvc.step(), jvc.step(), f"events {r}")
        check(f"round {r}")
        if jvc.membership_size == 57:
            break
    assert tvc.membership_size == 57 and tvc.config_id == jvc.config_id
    alive = tvc.alive_mask
    assert alive[56:60].all() and not alive[[3, 30, 41]].any() and not alive[60:].any()


def test_from_endpoints_rejects_what_jax_rejects(endpoints):
    eps = [Endpoint(*p) for p in endpoints]
    for bad in (0, 65):
        with pytest.raises(ValueError, match="n_members"):
            TorchCluster.from_endpoints(eps, n_members=bad, device="cpu")
        with pytest.raises(ValueError, match="n_members"):
            JaxCluster.from_endpoints([JaxEndpoint(*p) for p in endpoints], n_members=bad)
