"""K-ring expander topology (port of ``rapid_tpu/ops/rings.py``).

Every slot carries K static 64-bit ring keys as stored uint32 (hi, lo)
lanes. The key order of each ring is sorted ONCE (:func:`ring_perms`);
every topology after that is O(N) scans over those permutations
(:func:`ring_topology_from_perm`). Index tables are int32 like the JAX wide
layout; gathers index with int64 copies of them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rapid_tpu_torch import _u32
from rapid_tpu_torch.ops.hashing import lex_argsort


class RingTopology(NamedTuple):
    """obs_idx[k, i] / subj_idx[k, i]: ring-k successor / predecessor slot
    of slot i, or -1 (dead slot, or fewer than 2 alive); order[k, p]: slot
    at ring position p, alive slots first."""

    obs_idx: torch.Tensor
    subj_idx: torch.Tensor
    order: torch.Tensor


def _key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Stored uint32 (hi, lo) lanes as one int64 per key whose SIGNED order
    is the unsigned 64-bit order of the key (hi is offset by 2**31, so no
    value leaves the int64 range)."""
    return (_u32.widen(hi) - (1 << 31)) * (1 << 32) + _u32.widen(lo)


def ring_perms(key_hi: torch.Tensor, key_lo: torch.Tensor) -> torch.Tensor:
    """Static per-ring key-order permutations, ``[K, N]`` int32: slot at
    position p of ring k's fixed unsigned key order, ties by slot index."""
    return lex_argsort((_u32.widen(key_hi), _u32.widen(key_lo))).to(torch.int32)


def _alive_first_order(perm: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Stable partition of each ring's key order into alive-first, ``[K, N]``
    int64, via rank scans and one scatter (no sort)."""
    ao = alive[perm]
    n_alive = ao.sum(-1, keepdim=True)
    alive_rank = torch.cumsum(ao, -1) - 1
    dead_rank = n_alive + torch.cumsum(~ao, -1) - 1
    dest = torch.where(ao, alive_rank, dead_rank)
    return torch.zeros_like(perm).scatter_(-1, dest, perm)


def ring_topology_from_perm(perm: torch.Tensor, alive: torch.Tensor) -> RingTopology:
    """All K rings' topology from the static permutations and the alive
    mask, sort-free. Successor among alive = next alive position in the
    circular key order (suffix min, done as flip + cummin + flip), and
    predecessor = previous alive position (prefix max). Returns int32
    tables."""
    perm = perm.to(torch.int64)
    k, n = perm.shape
    dev = perm.device
    ao = alive[perm]  # [K, N]
    pos = torch.arange(n, dtype=torch.int64, device=dev).expand(k, n)
    n_alive = ao.sum(-1, keepdim=True)

    idx_succ = torch.where(ao, pos, n)
    suffix_min = torch.flip(torch.cummin(torch.flip(idx_succ, [-1]), -1).values, [-1])
    first_alive = suffix_min[:, :1]
    nxt = torch.cat([suffix_min[:, 1:], torch.full((k, 1), n, device=dev)], -1)
    succ_pos = torch.where(nxt >= n, first_alive, nxt)

    idx_pred = torch.where(ao, pos, -1)
    prefix_max = torch.cummax(idx_pred, -1).values
    last_alive = prefix_max[:, -1:]
    prv = torch.cat([torch.full((k, 1), -1, device=dev), prefix_max[:, :-1]], -1)
    pred_pos = torch.where(prv < 0, last_alive, prv)

    valid = ao & (n_alive >= 2)
    # JAX clamps gather indices; torch raises (a device assert on CUDA), so
    # the clips the JAX code makes explicit stay.
    succ_slot = torch.where(valid, perm.gather(-1, succ_pos.clamp(0, n - 1)), -1)
    pred_slot = torch.where(valid, perm.gather(-1, pred_pos.clamp(0, n - 1)), -1)
    obs_idx = torch.full_like(perm, -1).scatter_(-1, perm, succ_slot)
    subj_idx = torch.full_like(perm, -1).scatter_(-1, perm, pred_slot)
    return RingTopology(
        obs_idx=obs_idx.to(torch.int32),
        subj_idx=subj_idx.to(torch.int32),
        order=_alive_first_order(perm, alive).to(torch.int32),
    )


def predecessor_of_keys(
    key_hi: torch.Tensor,
    key_lo: torch.Tensor,
    alive: torch.Tensor,
    query_hi: torch.Tensor,
    query_lo: torch.Tensor,
    perm: torch.Tensor,
) -> torch.Tensor:
    """Expected observers of joiners: for each query key ``[K, J]``, the
    alive slot preceding it on that ring (``-1`` if none is alive).
    Returns ``[K, J]`` int32.

    The JAX version counts, per query, the alive keys below it with a
    masked compare over all N slots: ``[K, J, N]`` elements, 2.6 G at
    N=100K with 2,500 joiners. Here the same count comes from a binary
    search in the key-sorted ring (``perm``) and a prefix count of alive
    slots, ``O(K J log N)``: the count is the same integer, so the result is
    identical."""
    perm = perm.to(torch.int64)
    n = perm.shape[-1]
    sorted_keys = _key64(key_hi, key_lo).gather(-1, perm)
    pos = torch.searchsorted(sorted_keys, _key64(query_hi, query_lo).contiguous())
    ao = alive[perm]
    alive_before = torch.cat(
        [torch.zeros_like(ao[:, :1], dtype=torch.int64), torch.cumsum(ao, -1)], -1
    )
    rank = alive_before.gather(-1, pos)
    n_alive = alive.sum()
    pred_pos = torch.where(rank - 1 < 0, n_alive - 1, rank - 1)
    order = _alive_first_order(perm, alive)
    pred = order.gather(-1, pred_pos.clamp(0, n - 1))
    return torch.where(n_alive >= 1, pred, -1).to(torch.int32)
