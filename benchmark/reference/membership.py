"""What a committed view has to be, worked out in NumPy from the inputs.

A cluster of ``n`` slots carries, per slot, a 64-bit identity and K 64-bit
ring keys (uint32 halves). Rapid's guarantees fix the view that a burst of
churn ends in, once every crash and join in it is resolved:

- the members are the members before it, less the crashed, plus the joiners;
- the configuration id is the order-independent hash of the members'
  identities (:func:`config_id`);
- on ring r the members sit in the unsigned order of their ring-r keys (ties
  by slot), and each member's observer is its successor on that circle and
  its subject its predecessor (:func:`rings`); a slot that is not a member,
  or a view of fewer than two members, has neither (-1).

Every function takes NumPy arrays and returns NumPy arrays or ints.
"""

from __future__ import annotations

import numpy as np

MASK32 = 0xFFFFFFFF


def mix32(x: np.ndarray) -> np.ndarray:
    """The murmur3 32-bit finalizer on uint64 values below 2**32."""
    x = np.asarray(x, dtype=np.uint64)
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x85EBCA6B)) & np.uint64(MASK32)
    x = x ^ (x >> np.uint64(13))
    x = (x * np.uint64(0xC2B2AE35)) & np.uint64(MASK32)
    return x ^ (x >> np.uint64(16))


def config_id(id_hi: np.ndarray, id_lo: np.ndarray, alive: np.ndarray) -> tuple:
    """The configuration id of the members ``alive`` selects, as a (hi, lo)
    pair of ints below 2**32: with ``a = sum(mix32(hi ^ 0x9E3779B9)) +
    count`` and ``b = sum(mix32(lo ^ 0x85EBCA77))`` over the members, mod
    2**32, the id is ``(mix32(a), mix32(a + b))``."""
    alive = np.asarray(alive, dtype=bool)
    hi = mix32(np.asarray(id_hi, dtype=np.uint64)[alive] ^ np.uint64(0x9E3779B9))
    lo = mix32(np.asarray(id_lo, dtype=np.uint64)[alive] ^ np.uint64(0x85EBCA77))
    a = (int(hi.sum(dtype=np.uint64)) + int(alive.sum())) & MASK32
    b = int(lo.sum(dtype=np.uint64)) & MASK32
    return int(mix32(a)), int(mix32((a + b) & MASK32))


def ring_orders(key_hi: np.ndarray, key_lo: np.ndarray) -> np.ndarray:
    """``[K, n]`` slot order of each ring: unsigned 64-bit key order, ties
    by slot. Fixed for a cluster, so callers compute it once."""
    keys = (np.asarray(key_hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(key_lo, dtype=np.uint64)
    return np.argsort(keys, axis=-1, kind="stable")


def rings(order: np.ndarray, alive: np.ndarray) -> tuple:
    """``(observer, subject)``, each ``[K, n]`` int64: every member's
    successor and predecessor among the members on each ring of ``order``
    (:func:`ring_orders`), -1 for a slot that is not a member and for every
    slot of a view of fewer than two."""
    alive = np.asarray(alive, dtype=bool)
    k, n = order.shape
    observer = np.full((k, n), -1, dtype=np.int64)
    subject = np.full((k, n), -1, dtype=np.int64)
    if alive.sum() < 2:
        return observer, subject
    for r in range(k):
        ring = order[r][alive[order[r]]]
        observer[r, ring] = np.roll(ring, -1)
        subject[r, ring] = np.roll(ring, 1)
    return observer, subject


def after_churn(alive: np.ndarray, crashed, joined) -> np.ndarray:
    """The members once every crash and join is resolved."""
    out = np.array(alive, dtype=bool)
    out[np.asarray(crashed, dtype=np.int64)] = False
    out[np.asarray(joined, dtype=np.int64)] = True
    return out
