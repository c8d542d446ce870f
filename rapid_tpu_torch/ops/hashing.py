"""Hashing and sorting primitives (port of ``rapid_tpu/ops/hashing.py``).

64-bit ring keys and proposal identities travel as (hi, lo) uint32 lane
pairs, stored per :mod:`rapid_tpu_torch._u32`.
"""

from __future__ import annotations

import torch

from rapid_tpu_torch import _u32


def lex_argsort(keys: tuple) -> torch.Tensor:
    """Stable argsort along the last axis by a tuple of equal-shape integer
    tensors, most significant first; ties break by input index. Keys are
    compared by value, so uint32 lanes must be passed widened
    (:func:`rapid_tpu_torch._u32.widen`). One stable sort per key, least
    significant first."""
    idx = None
    for key in reversed(keys):
        k = key.to(torch.int64)
        if idx is not None:
            k = k.gather(-1, idx)
        order = torch.sort(k, dim=-1, stable=True).indices
        idx = order if idx is None else idx.gather(-1, order)
    return idx


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3-style 32-bit finalizer on stored uint32 lanes."""
    return _u32.narrow(_u32.mix32_w(_u32.widen(x)))


def masked_set_hash(hi: torch.Tensor, lo: torch.Tensor, mask: torch.Tensor) -> tuple:
    """Order-independent 64-bit identity of the set of members selected by
    ``mask`` (reduced over the last axis). ``mask`` may carry leading batch
    axes, e.g. ``[c, n]`` for one hash per cohort, and the identity lanes
    broadcast against it: a fleet passes ``[t, 1, n]`` ids with ``[t, c,
    n]`` masks. Sums wrap mod 2**32. Returns stored uint32 (hi, lo)."""
    m = mask.to(torch.int64)
    mixed_hi = _u32.mix32_w(_u32.widen(hi) ^ 0x9E3779B9)
    mixed_lo = _u32.mix32_w(_u32.widen(lo) ^ 0x85EBCA77)
    h1 = _u32.add((mixed_hi * m).sum(-1), m.sum(-1))
    h2 = (mixed_lo * m).sum(-1) & _u32.MASK
    return (
        _u32.narrow(_u32.mix32_w(h1)),
        _u32.narrow(_u32.mix32_w(_u32.add(h2, h1))),
    )
