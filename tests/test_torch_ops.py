"""The PyTorch port's ops against the JAX package, exactly.

Same inputs, made from numpy seeds, go through a ``rapid_tpu`` op and its
``rapid_tpu_torch`` counterpart on the CPU; every comparison is exact (the
engine is all integer and bool), uint32 lanes as uint32 bit patterns. The
delivery kernel's plain version is held against both the JAX engine's jnp
path and the Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_tpu.ops import consensus as jcons
from rapid_tpu.ops import cut_detection as jcut
from rapid_tpu.ops import hashing as jhash
from rapid_tpu.ops import pallas_kernels as jpk
from rapid_tpu.ops import rings as jrings
from rapid_tpu.protocol.fast_paxos import fast_paxos_quorum as jax_quorum
from rapid_tpu_torch import _u32
from rapid_tpu_torch.ops import consensus as tcons
from rapid_tpu_torch.ops import cut_detection as tcut
from rapid_tpu_torch.ops import hashing as thash
from rapid_tpu_torch.ops import kernels as tk
from rapid_tpu_torch.ops import rings as trings

CPU = torch.device("cpu")


def u32(arr):
    """numpy uint32 -> the port's stored lanes on the CPU."""
    return _u32.from_numpy(arr, CPU)


def same_u32(got, want):
    np.testing.assert_array_equal(_u32.to_numpy(got), np.asarray(want, dtype=np.uint32))


def same(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def rand_u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def test_mix32_and_u32_arithmetic_wrap_like_uint32():
    rng = np.random.default_rng(0)
    x = np.concatenate([rand_u32(rng, 4096), np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)])
    same_u32(thash.mix32(u32(x)), jhash.mix32(jnp.asarray(x)))
    w = _u32.widen(u32(x))
    for const in (0x85EBCA6B, 0xFFFFFFFF, 0x9E3779B1):
        same_u32(_u32.narrow(_u32.mul(w, const)), x * np.uint32(const))
    same_u32(_u32.narrow(_u32.add(w, w)), x + x)


def test_masked_set_hash_matches_jax_single_and_batched():
    rng = np.random.default_rng(1)
    n, c = 777, 5
    hi, lo = rand_u32(rng, n), rand_u32(rng, n)
    mask = rng.random(n) < 0.6
    got = thash.masked_set_hash(u32(hi), u32(lo), torch.from_numpy(mask))
    want = jhash.masked_set_hash(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(mask))
    same_u32(got[0], want[0])
    same_u32(got[1], want[1])
    masks = rng.random((c, n)) < 0.3
    got = thash.masked_set_hash(u32(hi), u32(lo), torch.from_numpy(masks))
    for ci in range(c):
        want = jhash.masked_set_hash(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(masks[ci]))
        same_u32(got[0][ci], want[0])
        same_u32(got[1][ci], want[1])


def test_lex_argsort_is_stable_and_unsigned_like_jax():
    rng = np.random.default_rng(2)
    # Few distinct values (many ties) and the full range (sign bit set).
    hi = rng.choice(np.array([0, 7, 2**31, 2**32 - 1], np.uint32), size=(3, 500))
    lo = rng.integers(0, 3, size=(3, 500)).astype(np.uint32)
    got = thash.lex_argsort((_u32.widen(u32(hi)), _u32.widen(u32(lo))))
    want = jhash.lex_argsort((jnp.asarray(hi), jnp.asarray(lo)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def ring_case():
    rng = np.random.default_rng(3)
    k, n, j = 4, 300, 17
    key_hi = rand_u32(rng, (k, n))
    key_hi[:, :40] = key_hi[:, :1]  # shared hi words: order decided by lo
    key_lo = rand_u32(rng, (k, n))
    alive = rng.random(n) < 0.7
    q_hi, q_lo = rand_u32(rng, (k, j)), rand_u32(rng, (k, j))
    q_hi[:, :3], q_lo[:, :3] = key_hi[:, 5:8], key_lo[:, 5:8]  # exact key hits
    return key_hi, key_lo, alive, q_hi, q_lo


def test_ring_perms_and_topology_match_jax(ring_case):
    key_hi, key_lo, alive, _, _ = ring_case
    perm = trings.ring_perms(u32(key_hi), u32(key_lo))
    jperm = jrings.ring_perms(jnp.asarray(key_hi), jnp.asarray(key_lo))
    same(perm, jperm)
    for mask in (alive, np.eye(1, len(alive), 9, dtype=bool)[0], np.zeros_like(alive)):
        got = trings.ring_topology_from_perm(perm, torch.from_numpy(mask))
        want = jrings.ring_topology_from_perm(jperm, jnp.asarray(mask))
        same(got.obs_idx, want.obs_idx)
        same(got.subj_idx, want.subj_idx)
        same(got.order, want.order)


def test_predecessor_of_keys_matches_jax(ring_case):
    key_hi, key_lo, alive, q_hi, q_lo = ring_case
    perm = trings.ring_perms(u32(key_hi), u32(key_lo))
    jperm = jrings.ring_perms(jnp.asarray(key_hi), jnp.asarray(key_lo))
    for mask in (alive, np.zeros_like(alive)):
        got = trings.predecessor_of_keys(
            u32(key_hi), u32(key_lo), torch.from_numpy(mask), u32(q_hi), u32(q_lo), perm=perm
        )
        want = jrings.predecessor_of_keys(
            jnp.asarray(key_hi), jnp.asarray(key_lo), jnp.asarray(mask),
            jnp.asarray(q_hi), jnp.asarray(q_lo), perm=jperm,
        )
        same(got, want)


def test_fast_paxos_quorum_matches_the_host_protocol():
    for n in range(0, 300):
        assert tcons.fast_paxos_quorum(n) == jax_quorum(n)
        assert tcons.fast_paxos_quorum(torch.tensor(n, dtype=torch.int32)).item() == jax_quorum(n)


def test_torch_argmax_takes_the_first_maximum():
    # The engine's argmax sites rely on the first-max tie-break JAX has.
    x = torch.tensor([0, 3, 1, 3, 3, 0], dtype=torch.int32)
    assert torch.argmax(x).item() == 1
    assert torch.argmax(torch.tensor([False, True, True]).to(torch.int32)).item() == 1


@pytest.mark.parametrize("case", ["ties", "decided", "none"])
def test_tally_candidates_matches_jax(case):
    rng = np.random.default_rng({"ties": 4, "decided": 5, "none": 6}[case])
    n, c = 200, 6
    cand_hi, cand_lo = rand_u32(rng, c), rand_u32(rng, c)
    cand_hi[3] = 2**32 - 5  # sign bit set: the winner read must stay unsigned
    cand_valid = np.array([True, True, False, True, True, True])
    if case == "ties":
        pick = np.repeat([1, 3, 4], [80, 80, 40])  # candidates 1 and 3 tie
    elif case == "decided":
        pick = np.where(rng.random(n) < 0.9, 3, 1)
    else:
        pick = rng.integers(0, c, size=n)
    vote_hi, vote_lo = cand_hi[pick], cand_lo[pick]
    vote_valid = rng.random(n) < (0.99 if case == "decided" else 0.9)
    members = np.int32(n)
    got = tcons.tally_candidates(
        u32(vote_hi), u32(vote_lo), torch.from_numpy(vote_valid), u32(cand_hi), u32(cand_lo),
        torch.from_numpy(cand_valid), torch.tensor(members),
    )
    want = jcons.tally_candidates(
        jnp.asarray(vote_hi), jnp.asarray(vote_lo), jnp.asarray(vote_valid),
        jnp.asarray(cand_hi), jnp.asarray(cand_lo), jnp.asarray(cand_valid), jnp.asarray(members),
    )
    same(got.decided, want.decided)
    same_u32(got.winner_hi, want.winner_hi)
    same_u32(got.winner_lo, want.winner_lo)
    same(got.max_count, want.max_count)
    same(got.total_votes, want.total_votes)
    if case == "decided":
        assert bool(want.decided)


def test_popcount_and_watermark_classify_match_jax():
    rng = np.random.default_rng(7)
    old, new = rand_u32(rng, 2048), rand_u32(rng, 2048)
    old[:4] = [0, 1, 2**31, 2**32 - 1]
    mask = rng.random(2048) < 0.9
    same(tk.popcount32(u32(old)), jpk._popcount32(jnp.asarray(old)))
    bits, cls = tk.watermark_merge_classify(u32(old), u32(new), torch.from_numpy(mask), 20, 12)
    jbits, jcls = jpk.watermark_merge_classify(
        jnp.asarray(old), jnp.asarray(new), jnp.asarray(mask), 20, 12
    )
    same_u32(bits, jbits)
    same(cls, jcls)


@pytest.mark.parametrize("seen", [True, False])
def test_cohort_watermark_pass_matches_jax(seen):
    # seen=True: subjects in flux after a DOWN alert, so the gated implicit
    # invalidation pass runs (and changes bits); seen=False: it is skipped.
    rng = np.random.default_rng(8 if seen else 9)
    c, n, k, h, l = 5, 400, 10, 9, 4
    report = (rng.integers(0, 1 << k, size=(c, n)) & rng.integers(0, 1 << k, size=(c, n)))
    report = report.astype(np.uint32)
    new = np.where(rng.random((c, n)) < 0.2, rng.integers(0, 1 << k, size=(c, n)), 0).astype(np.uint32)
    seen_down = np.array([seen, False, seen, False, False])
    heard_down = np.array([False, seen, False, False, False])
    released = rng.random((c, n)) < 0.05
    announced = np.array([False, False, True, False, False])
    subject_mask = rng.random(n) < 0.95
    inval_obs = rng.integers(-1, n, size=(k, n)).astype(np.int32)
    got = tcut.cohort_watermark_pass(
        u32(report), u32(new), torch.from_numpy(seen_down), torch.from_numpy(released),
        torch.from_numpy(announced), torch.from_numpy(subject_mask),
        torch.from_numpy(inval_obs), torch.from_numpy(heard_down), h, l, k,
    )
    want = jcut.cohort_watermark_pass(
        jnp.asarray(report), jnp.asarray(new), jnp.asarray(seen_down), jnp.asarray(released),
        jnp.asarray(announced), jnp.asarray(subject_mask), jnp.asarray(inval_obs),
        jnp.asarray(heard_down), h, l, k,
    )
    same_u32(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        same(g, w)
    merged, _ = jpk.watermark_merge_classify(
        jnp.asarray(report), jnp.asarray(new), jnp.asarray(subject_mask)[None, :], h, l
    )
    invalidated = bool(np.any(np.asarray(want[0]) != np.asarray(merged)))
    assert invalidated == seen


@pytest.mark.parametrize("c,spread,permille", [
    (2, 0, 1000),    # no jitter
    (32, 1, 1000),   # one cohort word, legacy uniform draw
    (64, 2, 1000),   # two words
    (33, 1, 250),    # sub-round gate, word boundary
])
def test_delivery_plain_version_matches_jnp_path_and_pallas(c, spread, permille):
    # Built like tests/test_pallas_kernels.py's kernel test: real cluster
    # state with crashed members, a partly deaf cohort and edges at several
    # fire ages, n ragged against the TPU kernel's 128-lane tile.
    from rapid_tpu.models.virtual_cluster import VirtualCluster, _deliver_alerts, _edge_masks

    k = 10
    rng = np.random.default_rng(c * 1000 + spread)
    n = 1000
    vc = VirtualCluster.create(
        n, cohorts=c, k=k, fd_threshold=1, seed=c, delivery_spread=spread,
        delivery_prob_permille=permille,
    )
    vc.assign_cohorts_roundrobin()
    rx_block = np.zeros((c, vc.cfg.n), dtype=bool)
    rx_block[c - 1] = rng.random(vc.cfg.n) < 0.3
    vc.set_rx_block(rx_block)
    vc.crash(rng.choice(n, size=20, replace=False))
    vc.stagger_fd_counts(np.random.default_rng(1), spread_rounds=2)
    for _ in range(3):
        vc.step()
    cfg, state = vc.cfg, vc.state
    _, blocked_rows = _edge_masks(cfg, state, vc.faults)
    want = np.asarray(_deliver_alerts(cfg, state, state.fire_round, blocked_rows))
    age_kn = state.round_idx - state.fire_round.T
    epoch = state.config_epoch.astype(jnp.uint32).reshape(1)
    pallas = np.asarray(
        jpk.delivery_new_bits_pallas(blocked_rows, age_kn, epoch, k, spread, permille, interpret=True)
    )[:c]

    got = tk.delivery_new_bits(
        u32(np.asarray(blocked_rows)),
        torch.from_numpy(np.array(age_kn)),
        torch.from_numpy(np.array(state.config_epoch).reshape(1)),
        k, c, spread, permille,
    )
    assert want.any() or spread == 0
    same_u32(got, want)
    same_u32(got, pallas)
    assert tk.delivery_new_bits.launches == 0  # CPU tensors take the plain version


# -- A leading tenant axis (the fleet): every op, batched, equals the JAX op
#    run tenant by tenant.

T = 3


def test_masked_set_hash_over_tenants_matches_jax():
    rng = np.random.default_rng(21)
    c, n = 4, 300
    hi, lo = rand_u32(rng, (T, n)), rand_u32(rng, (T, n))
    masks = rng.random((T, c, n)) < 0.4
    got = thash.masked_set_hash(u32(hi)[:, None], u32(lo)[:, None], torch.from_numpy(masks))
    alive = masks[:, 0]
    got_config = thash.masked_set_hash(u32(hi), u32(lo), torch.from_numpy(alive))
    for t in range(T):
        for ci in range(c):
            want = jhash.masked_set_hash(jnp.asarray(hi[t]), jnp.asarray(lo[t]), jnp.asarray(masks[t, ci]))
            same_u32(got[0][t, ci], want[0])
            same_u32(got[1][t, ci], want[1])
        want = jhash.masked_set_hash(jnp.asarray(hi[t]), jnp.asarray(lo[t]), jnp.asarray(alive[t]))
        same_u32(got_config[0][t], want[0])
        same_u32(got_config[1][t], want[1])


def test_ring_topology_over_tenants_matches_jax(ring_case):
    key_hi, key_lo, alive, _, _ = ring_case
    perm = trings.ring_perms(u32(key_hi), u32(key_lo))
    jperm = jrings.ring_perms(jnp.asarray(key_hi), jnp.asarray(key_lo))
    masks = np.stack([alive, np.eye(1, len(alive), 9, dtype=bool)[0], ~alive])
    got = trings.ring_topology_from_perm(perm.expand(T, *perm.shape), torch.from_numpy(masks))
    for t in range(T):
        want = jrings.ring_topology_from_perm(jperm, jnp.asarray(masks[t]))
        same(got.obs_idx[t], want.obs_idx)
        same(got.subj_idx[t], want.subj_idx)
        same(got.order[t], want.order)


def test_tally_candidates_over_tenants_takes_each_tenants_quorum():
    rng = np.random.default_rng(22)
    n, c = 200, 6
    cand_hi, cand_lo = rand_u32(rng, (T, c)), rand_u32(rng, (T, c))
    cand_valid = rng.random((T, c)) < 0.8
    cand_valid[:, 3] = True
    pick = np.where(rng.random((T, n)) < 0.85, 3, rng.integers(0, c, size=(T, n)))
    vote_hi = np.take_along_axis(cand_hi, pick, 1)
    vote_lo = np.take_along_axis(cand_lo, pick, 1)
    vote_valid = rng.random((T, n)) < 0.97
    members = np.array([n, n // 2, 2 * n], dtype=np.int32)  # decided, decided, short of quorum
    got = tcons.tally_candidates(
        u32(vote_hi), u32(vote_lo), torch.from_numpy(vote_valid), u32(cand_hi), u32(cand_lo),
        torch.from_numpy(cand_valid), torch.from_numpy(members),
    )
    for t in range(T):
        want = jcons.tally_candidates(
            jnp.asarray(vote_hi[t]), jnp.asarray(vote_lo[t]), jnp.asarray(vote_valid[t]),
            jnp.asarray(cand_hi[t]), jnp.asarray(cand_lo[t]), jnp.asarray(cand_valid[t]),
            jnp.asarray(members[t]),
        )
        same(got.decided[t], want.decided)
        same_u32(got.winner_hi[t], want.winner_hi)
        same_u32(got.winner_lo[t], want.winner_lo)
        same(got.max_count[t], want.max_count)
        same(got.total_votes[t], want.total_votes)
    assert got.decided.tolist() == [True, True, False]


def test_cohort_watermark_pass_selects_invalidation_per_tenant():
    # Tenant 0 has subjects in flux after a DOWN alert (its invalidation
    # pass runs and changes bits), tenant 1 has none, tenant 2 runs with
    # other watermarks: the select must give each tenant the JAX result.
    rng = np.random.default_rng(23)
    c, n, k = 5, 400, 10
    h, l = np.array([9, 9, 7], np.int32), np.array([4, 4, 2], np.int32)
    report = (rng.integers(0, 1 << k, size=(T, c, n)) & rng.integers(0, 1 << k, size=(T, c, n)))
    report = report.astype(np.uint32)
    new = np.where(rng.random((T, c, n)) < 0.2, rng.integers(0, 1 << k, size=(T, c, n)), 0)
    new = new.astype(np.uint32)
    seen_down = np.array([[True, False, True, False, False], [False] * 5, [True] * 5])
    heard_down = np.zeros((T, c), dtype=bool)
    released = rng.random((T, c, n)) < 0.05
    announced = rng.random((T, c)) < 0.3
    subject_mask = rng.random((T, n)) < 0.95
    inval_obs = rng.integers(-1, n, size=(T, k, n)).astype(np.int32)
    got = tcut.cohort_watermark_pass(
        u32(report), u32(new), torch.from_numpy(seen_down), torch.from_numpy(released),
        torch.from_numpy(announced), torch.from_numpy(subject_mask),
        torch.from_numpy(inval_obs), torch.from_numpy(heard_down),
        torch.from_numpy(h), torch.from_numpy(l), k, select=True,
    )
    invalidated = []
    for t in range(T):
        want = jcut.cohort_watermark_pass(
            jnp.asarray(report[t]), jnp.asarray(new[t]), jnp.asarray(seen_down[t]),
            jnp.asarray(released[t]), jnp.asarray(announced[t]), jnp.asarray(subject_mask[t]),
            jnp.asarray(inval_obs[t]), jnp.asarray(heard_down[t]), int(h[t]), int(l[t]), k,
        )
        same_u32(got[0][t], want[0])
        for g, w in zip(got[1:], want[1:]):
            same(g[t], w)
        merged = (report[t] | new[t]) * subject_mask[t][None, :]
        invalidated.append(bool(np.any(np.asarray(want[0]) != merged)))
    assert invalidated == [True, False, True]


@pytest.mark.parametrize("spread,permille", [(0, 1000), (2, 1000), (3, 300)])
def test_delivery_plain_version_takes_a_tenant_axis(spread, permille):
    # One call over T tenants with distinct epochs equals T one-cluster
    # calls and the JAX engine's jnp path, tenant by tenant.
    from collections import namedtuple

    from rapid_tpu.models.state import EngineConfig as JaxConfig
    from rapid_tpu.models.virtual_cluster import _deliver_alerts

    c, k, n = 33, 10, 300
    w = (c + 31) // 32
    rng = np.random.default_rng(24 + spread)
    blocked = rand_u32(rng, (T, w * k, n)) & rand_u32(rng, (T, w * k, n))
    age = rng.integers(-3, 6, size=(T, k, n)).astype(np.int32)
    epochs = np.array([0, 5, 1 << 20], dtype=np.int32)
    got = tk.delivery_new_bits(u32(blocked), torch.from_numpy(age), torch.from_numpy(epochs),
                               k, c, spread, permille)
    assert got.shape == (T, c, n)
    cfg = JaxConfig(n=n, k=k, h=9, l=4, c=c, delivery_spread=spread,
                    delivery_prob_permille=permille)
    State = namedtuple("State", "round_idx config_epoch report_bits")
    for t in range(T):
        one = tk.delivery_new_bits_ref(u32(blocked[t]), torch.from_numpy(age[t]),
                                       torch.from_numpy(epochs[t:t + 1]), k, c, spread, permille)
        same_u32(got[t], _u32.to_numpy(one))
        state = State(jnp.int32(0), jnp.int32(epochs[t]), jnp.zeros((c, n), jnp.uint32))
        want = _deliver_alerts(cfg, state, jnp.asarray(-age[t].T), jnp.asarray(blocked[t]))
        same_u32(got[t], want)
    # Each tenant's own epoch salts its draws: epoch 0 everywhere changes
    # the tenants whose epoch is not 0, whenever delays are drawn.
    at_zero = tk.delivery_new_bits(u32(blocked), torch.from_numpy(age),
                                   torch.zeros(T, dtype=torch.int32), k, c, spread, permille)
    assert [not torch.equal(at_zero[t], got[t]) for t in range(T)] == [False] + [spread > 0] * 2


# -- narrow lanes (the compact layout) and the rest of rapid_tpu/ops ------

from rapid_tpu_torch import _narrow  # noqa: E402


def narrow(arr):
    """A numpy uint8/uint16/int8/int16/int32/uint32 array as the port's
    stored lane."""
    return _narrow.from_numpy(arr, np.asarray(arr).dtype.name, CPU)


def same_narrow(got, want):
    want = np.asarray(want)
    np.testing.assert_array_equal(_narrow.to_numpy(got, want.dtype.name), want)


def test_u32_widen_refuses_narrow_signed_lanes_and_narrow_helpers_keep_bits():
    lane = narrow(np.array([0xFFFF, 0x8000, 1], dtype=np.uint16))
    with pytest.raises(TypeError, match="_narrow.unsigned"):
        _u32.widen(lane)
    with pytest.raises(TypeError):
        _u32.widen(torch.zeros(3, dtype=torch.int8))
    assert _narrow.unsigned(lane).tolist() == [0xFFFF, 0x8000, 1]
    assert tk.popcount32(lane).tolist() == [16, 1, 1]
    wide = torch.tensor([0x1FFFF, 0x8000, -1, 255], dtype=torch.int64)
    assert _narrow.keep_bits(wide, torch.int16).tolist() == [-1, -32768, -1, 255]
    assert _narrow.keep_bits(wide, torch.uint8).tolist() == [255, 0, 255, 255]
    assert [_narrow.bit(15, torch.int16), _narrow.bit(7, torch.uint8), _narrow.bit(31, torch.int32)] == [
        -32768, 128, -(1 << 31)]


@pytest.mark.parametrize("dtype,k", [(np.uint8, 8), (np.uint16, 16), (np.uint16, 10)])
def test_popcount_and_watermark_classify_keep_narrow_widths_like_jax(dtype, k):
    rng = np.random.default_rng(k)
    old = rng.integers(0, 1 << k, size=(3, 700)).astype(dtype)
    new = rng.integers(0, 1 << k, size=(3, 700)).astype(dtype)
    old[0, :3] = [0, (1 << k) - 1, 1 << (k - 1)]
    mask = rng.random(700) < 0.9
    same(tk.popcount32(narrow(old)), jpk._popcount32(jnp.asarray(old)))
    bits, cls = tk.watermark_merge_classify(narrow(old), narrow(new), torch.from_numpy(mask), k - 1, 3)
    jbits, jcls = jpk.watermark_merge_classify(jnp.asarray(old), jnp.asarray(new), jnp.asarray(mask), k - 1, 3)
    assert bits.dtype == narrow(old).dtype
    same_narrow(bits, jbits)
    same(cls, jcls)


@pytest.mark.parametrize("dtype,k,idx", [(np.uint8, 8, np.int8), (np.uint16, 16, np.int16)])
def test_cohort_watermark_pass_at_narrow_widths_matches_jax(dtype, k, idx):
    # The compact layout's report lane (uint8 or uint16, bit 15 in play at
    # K=16) with narrow index lanes; the implicit pass runs (seen_down).
    rng = np.random.default_rng(k + 100)
    c, n, h, l = 4, 120, k - 1, 3
    report = (rng.integers(0, 1 << k, size=(c, n)) & rng.integers(0, 1 << k, size=(c, n))).astype(dtype)
    new = np.where(rng.random((c, n)) < 0.3, rng.integers(0, 1 << k, size=(c, n)), 0).astype(dtype)
    seen_down = np.array([True, False, True, True])
    heard_down = np.array([False, True, False, False])
    released = rng.random((c, n)) < 0.05
    announced = np.array([False, False, True, False])
    subject_mask = rng.random(n) < 0.95
    inval_obs = rng.integers(-1, n, size=(k, n)).astype(idx)
    args = (report, new, seen_down, released, announced, subject_mask, inval_obs, heard_down)
    got = tcut.cohort_watermark_pass(
        narrow(report), narrow(new), *(torch.from_numpy(a) for a in args[2:6]),
        narrow(inval_obs), torch.from_numpy(heard_down), h, l, k,
    )
    want = jcut.cohort_watermark_pass(*(jnp.asarray(a) for a in args), h, l, k)
    assert got[0].dtype == narrow(report).dtype
    same_narrow(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        same(g, w)
    merged = np.where(subject_mask, report | new, 0)
    assert (np.asarray(want[0]) != merged).any()  # the implicit pass set bits


@pytest.mark.parametrize("case", ["decided", "split", "none_valid", "one_vote"])
def test_tally_sorted_matches_jax(case):
    rng = np.random.default_rng({"decided": 11, "split": 12, "none_valid": 13, "one_vote": 14}[case])
    n = 150
    values = rand_u32(rng, (2, 4))
    values[0, 2] = 2**32 - 3  # sign bit: the sort and the winner read stay unsigned
    pick = {"decided": np.where(rng.random(n) < 0.92, 2, 1), "split": rng.integers(0, 4, n),
            "none_valid": rng.integers(0, 4, n), "one_vote": np.zeros(n, int)}[case]
    vote_hi, vote_lo = values[0][pick], values[1][pick]
    vote_valid = {"decided": rng.random(n) < 0.99, "split": rng.random(n) < 0.8,
                  "none_valid": np.zeros(n, bool), "one_vote": np.eye(1, n, 40)[0] > 0}[case]
    members = np.int32(n)
    got = tcons.tally_sorted(u32(vote_hi), u32(vote_lo), torch.from_numpy(vote_valid), torch.tensor(members))
    want = jcons.tally_sorted(jnp.asarray(vote_hi), jnp.asarray(vote_lo), jnp.asarray(vote_valid),
                              jnp.asarray(members))
    same(got.decided, want.decided)
    same_u32(got.winner_hi, want.winner_hi)
    same_u32(got.winner_lo, want.winner_lo)
    same(got.max_count, want.max_count)
    same(got.total_votes, want.total_votes)
    assert bool(want.decided) == (case == "decided")


@pytest.mark.parametrize("seen,idx", [(True, np.int32), (False, np.int32), (True, np.int16)])
def test_process_alert_batch_matches_jax(seen, idx):
    rng = np.random.default_rng(20 + seen)
    n, k, h, l = 90, 10, 9, 4
    state = (rng.random((n, k)) < 0.5, np.bool_(False), rng.random(n) < 0.05)
    new = rng.random((n, k)) < 0.25
    inval = rng.integers(-1, n, size=(k, n)).astype(idx)
    subject = rng.random(n) < 0.95
    got = tcut.process_alert_batch(
        tcut.CutState(*(torch.from_numpy(np.asarray(a)) for a in state)),
        torch.from_numpy(new), torch.tensor(seen), narrow(inval), torch.from_numpy(subject), h, l,
    )
    want = jcut.process_alert_batch(
        jcut.CutState(*(jnp.asarray(a) for a in state)), jnp.asarray(new), jnp.asarray(seen),
        jnp.asarray(inval), jnp.asarray(subject), h, l,
    )
    for g, w in zip((*got.state, *got[1:]), (*want.state, *want[1:])):
        same(g, w)
    empty = tcut.CutState.create(n, k, device="cpu")
    assert empty.reports.shape == (n, k) and not empty.seen_down


def test_alerts_to_report_matrix_matches_jax():
    n, k = 12, 5
    dst = [0, 3, 3, -1, 11, 12, 40, 2, 7]
    rings = [0, 4, 4, 2, 5, 1, 0, -1, 3]  # padding, an out-of-range ring, slots past n
    same(tcut.alerts_to_report_matrix(n, k, dst, rings, device="cpu"),
         jcut.alerts_to_report_matrix(n, k, dst, rings))
    same(tcut.alerts_to_report_matrix(n, k, [], [], device="cpu"),
         jcut.alerts_to_report_matrix(n, k, [], []))
    # Index lists already on a device keep the matrix there.
    on_cpu = tcut.alerts_to_report_matrix(n, k, torch.tensor(dst), torch.tensor(rings))
    assert on_cpu.device == CPU
    same(on_cpu, jcut.alerts_to_report_matrix(n, k, dst, rings))


@pytest.mark.parametrize("build", ["cut_state", "report_matrix", "virtual_cluster"])
def test_cut_detection_constructors_default_to_cuda(build, monkeypatch):
    # Without a device they resolve to CUDA, as every entry point of the
    # port does: with no card that raises VirtualCluster.create's error
    # instead of quietly building on the CPU.
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "cut_state": lambda: tcut.CutState.create(4, 3),
        "report_matrix": lambda: tcut.alerts_to_report_matrix(4, 3, [1], [2]),
        "virtual_cluster": lambda: VirtualCluster.create(8, k=3, h=3, l=1),
    }
    with pytest.raises(RuntimeError, match="no card is available") as err:
        calls[build]()
    with pytest.raises(RuntimeError) as reference:
        VirtualCluster.create(8, k=3, h=3, l=1)
    assert str(err.value) == str(reference.value)


@pytest.mark.parametrize("k", [3, 10, 32])
def test_report_matrix_and_bits_convert_like_jax(k):
    rng = np.random.default_rng(k)
    reports = rng.random((4, 30, k)) < 0.5
    bits = tk.reports_matrix_to_bits(torch.from_numpy(reports))
    same_u32(bits, jpk.reports_matrix_to_bits(jnp.asarray(reports)))
    same(tk.bits_to_reports_matrix(bits, k), jpk.bits_to_reports_matrix(jpk.reports_matrix_to_bits(
        jnp.asarray(reports)), k))
    if k <= 16:
        narrow_bits = np.asarray(jpk.reports_matrix_to_bits(jnp.asarray(reports))).astype(np.uint16)
        same(tk.bits_to_reports_matrix(narrow(narrow_bits), k),
             jpk.bits_to_reports_matrix(jnp.asarray(narrow_bits), k))
