"""K-ring expander topology (port of ``rapid_tpu/ops/rings.py``).

Every slot carries K static 64-bit ring keys as stored uint32 (hi, lo)
lanes: for real endpoints the host view's keys (:func:`endpoint_ring_keys`,
hashed on the host). The key order of each ring is sorted ONCE
(:func:`ring_perms`); every topology after that is O(N) scans over those
permutations (:func:`ring_topology_from_perm`, which also takes a fleet's
``[t, K, N]`` permutations and ``[t, N]`` masks); :func:`ring_topology`
sorts afresh and gives the same tables. The tables come back int32, as in
the JAX package, and a compact caller narrows them on store; permutations
of any index dtype are widened to int64 before they gather or scatter.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from rapid_tpu_torch import _u32
from rapid_tpu_torch.ops.hashing import lex_argsort
from rapid_tpu_torch.utils.xxhash import _MASK64, xxh64, xxh64_int, xxh64_rows


class RingTopology(NamedTuple):
    """obs_idx[k, i] / subj_idx[k, i]: ring-k successor / predecessor slot
    of slot i, or -1 (dead slot, or fewer than 2 alive); order[k, p]: slot
    at ring position p, alive slots first."""

    obs_idx: torch.Tensor
    subj_idx: torch.Tensor
    order: torch.Tensor


def ring_key(endpoint, seed: int) -> int:
    """The seeded ordering key of one endpoint on ring ``seed``, native
    topology (MembershipView.java:562-587 with the port hashed as 8 bytes
    and keys compared unsigned): ``xxh64(hostname, seed) * 31 +
    xxh64_int(port, seed)`` mod 2**64."""
    h = xxh64(endpoint.hostname.encode("utf-8"), seed)
    return (h * 31 + xxh64_int(endpoint.port, seed)) & _MASK64


def endpoint_ring_keys(endpoints: Sequence, k: int, topology: str = "native"):
    """Host side: the K seeded 64-bit ring keys of every endpoint (any
    object with ``.hostname`` and ``.port``), as numpy uint32 ``(hi, lo)``
    arrays ``[K, N]``, equal to :func:`ring_key` per endpoint and ring.
    The native library (``utils/_native.py``), when built, hashes the whole
    batch, as in the JAX package; otherwise numpy hashes it in batches of
    equal hostname length (``xxh64_rows``), bit-identical. Unlike JAX's,
    the lanes come back as numpy arrays.

    Native topology only: the device's unsigned 64-bit keyspace cannot hold
    the java-compatible signed ring order, so anything else raises."""
    if topology != "native":
        raise ValueError(
            f"the device/engine path requires the native topology; got {topology!r} "
            "(java-compat ring order is host-path only)"
        )
    from rapid_tpu_torch.utils._native import native_ring_keys_batch

    hosts = [ep.hostname.encode("utf-8") for ep in endpoints]
    ports = [ep.port for ep in endpoints]
    keys = native_ring_keys_batch(hosts, ports, k)
    if keys is None:
        keys = _ring_keys_numpy(hosts, ports, k)
    return (keys >> np.uint64(32)).astype(np.uint32), (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _ring_keys_numpy(hosts, ports, k: int) -> np.ndarray:
    """``[K, N]`` uint64 ring keys of the encoded hostnames and ports,
    hashed by numpy in batches of equal hostname length."""
    seeds = np.arange(k, dtype=np.uint64)
    ports = np.array(ports, dtype=np.int64)
    keys = xxh64_rows(ports.astype("<i8").view(np.uint8).reshape(-1, 8), seeds)
    lengths = np.array([len(h) for h in hosts], dtype=np.int64)
    with np.errstate(over="ignore"):
        for length in np.unique(lengths):
            rows = np.nonzero(lengths == length)[0]
            blob = np.frombuffer(b"".join(hosts[i] for i in rows), dtype=np.uint8)
            host_keys = xxh64_rows(blob.reshape(len(rows), int(length)), seeds)
            keys[:, rows] += host_keys * np.uint64(31)
    return keys


def _key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Stored uint32 (hi, lo) lanes as one int64 per key whose SIGNED order
    is the unsigned 64-bit order of the key (hi is offset by 2**31, so no
    value leaves the int64 range)."""
    return (_u32.widen(hi) - (1 << 31)) * (1 << 32) + _u32.widen(lo)


def ring_perms(key_hi: torch.Tensor, key_lo: torch.Tensor) -> torch.Tensor:
    """Static per-ring key-order permutations, ``[K, N]`` int32: slot at
    position p of ring k's fixed unsigned key order, ties by slot index."""
    return lex_argsort((_u32.widen(key_hi), _u32.widen(key_lo))).to(torch.int32)


def ring_topology(key_hi: torch.Tensor, key_lo: torch.Tensor, alive: torch.Tensor) -> RingTopology:
    """All K rings by sorting: ``key_hi``/``key_lo`` ``[K, N]`` stored
    uint32, ``alive`` ``[N]``. Each ring's alive slots in unsigned key
    order (ties by slot), dead slots after them; a slot's observer is its
    successor and its subject its predecessor on the circle of alive slots.
    Returns int32 tables, equal to :func:`ring_topology_from_perm` on
    :func:`ring_perms`."""
    n = key_hi.shape[-1]
    dev = key_hi.device
    dead = (~alive).to(torch.int64).expand(key_hi.shape)
    order = lex_argsort((dead, _u32.widen(key_hi), _u32.widen(key_lo)))  # [K, N]
    n_alive = alive.sum()
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    succ_pos = torch.where(pos + 1 >= n_alive, 0, pos + 1).clamp(0, n - 1).expand(order.shape)
    pred_pos = torch.where(pos - 1 < 0, n_alive - 1, pos - 1).clamp(0, n - 1).expand(order.shape)
    valid = (pos < n_alive) & (n_alive >= 2)
    succ_slot = torch.where(valid, order.gather(-1, succ_pos), -1)
    pred_slot = torch.where(valid, order.gather(-1, pred_pos), -1)
    obs_idx = torch.full_like(order, -1).scatter_(-1, order, succ_slot)
    subj_idx = torch.full_like(order, -1).scatter_(-1, order, pred_slot)
    return RingTopology(
        obs_idx=obs_idx.to(torch.int32),
        subj_idx=subj_idx.to(torch.int32),
        order=order.to(torch.int32),
    )


def _alive_at(alive: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``alive[perm]`` per batch: the ``[..., N]`` mask read at every
    position of the ``[..., K, N]`` int64 permutations."""
    return torch.gather(alive.unsqueeze(-2).expand(perm.shape), -1, perm)


def _alive_first_order(perm: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Stable partition of each ring's key order into alive-first, ``[...,
    K, N]`` int64, via rank scans and one scatter (no sort)."""
    ao = _alive_at(alive, perm)
    n_alive = ao.sum(-1, keepdim=True)
    alive_rank = torch.cumsum(ao, -1) - 1
    dead_rank = n_alive + torch.cumsum(~ao, -1) - 1
    dest = torch.where(ao, alive_rank, dead_rank)
    return torch.zeros_like(perm).scatter_(-1, dest, perm)


def ring_topology_from_perm(perm: torch.Tensor, alive: torch.Tensor, ctx=None) -> RingTopology:
    """All K rings' topology from the static permutations and the alive
    mask, sort-free. Successor among alive = next alive position in the
    circular key order (suffix min, done as flip + cummin + flip), and
    predecessor = previous alive position (prefix max). ``perm`` may be of
    any index dtype (the compact layout stores it at int8 or int16); it is
    widened to int64 for every gather and scatter. Returns int32 tables.
    Leading batch axes (a fleet's tenants) ride along: ``perm [..., K, N]``
    with ``alive [..., N]``.

    With a collective context (``parallel/collectives.py``) ``perm`` and
    ``alive`` are this rank's columns of a node-sharded cluster. The scans
    run in key order across every shard, so both are gathered over
    ``'nodes'`` (the one collective-heavy op of the engine, on the view
    change's branch only), every rank derives the whole topology, and the
    tables come back as this rank's columns (``order`` as its positions)."""
    if ctx is not None:
        lo, hi = ctx.slot_offset, ctx.slot_offset + ctx.n_local
        topo = ring_topology_from_perm(
            ctx.gather(perm.to(torch.int32), "nodes", "ring permutations"),
            ctx.gather(alive, "nodes", "view-change membership"),
        )
        return RingTopology(*(table[..., lo:hi] for table in topo))
    perm = perm.to(torch.int64)
    n = perm.shape[-1]
    edge = perm.shape[:-1] + (1,)
    dev = perm.device
    ao = _alive_at(alive, perm)  # [..., K, N]
    pos = torch.arange(n, dtype=torch.int64, device=dev).expand(perm.shape)
    n_alive = ao.sum(-1, keepdim=True)

    idx_succ = torch.where(ao, pos, n)
    suffix_min = torch.flip(torch.cummin(torch.flip(idx_succ, [-1]), -1).values, [-1])
    first_alive = suffix_min[..., :1]
    nxt = torch.cat([suffix_min[..., 1:], torch.full(edge, n, device=dev)], -1)
    succ_pos = torch.where(nxt >= n, first_alive, nxt)

    idx_pred = torch.where(ao, pos, -1)
    prefix_max = torch.cummax(idx_pred, -1).values
    last_alive = prefix_max[..., -1:]
    prv = torch.cat([torch.full(edge, -1, device=dev), prefix_max[..., :-1]], -1)
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
    ao = _alive_at(alive, perm)
    alive_before = torch.cat(
        [torch.zeros_like(ao[:, :1], dtype=torch.int64), torch.cumsum(ao, -1)], -1
    )
    rank = alive_before.gather(-1, pos)
    n_alive = alive.sum()
    pred_pos = torch.where(rank - 1 < 0, n_alive - 1, rank - 1)
    order = _alive_first_order(perm, alive)
    pred = order.gather(-1, pred_pos.clamp(0, n - 1))
    return torch.where(n_alive >= 1, pred, -1).to(torch.int32)
