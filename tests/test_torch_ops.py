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
