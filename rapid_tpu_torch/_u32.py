"""The port's one representation of uint32 lanes.

``torch.uint32`` is not usable for this engine: shifts, ``%``, ordered
compares and ``cummax`` raise ``NotImplementedError`` for it. ``torch.int32``
has the opposite trap: ``>>`` is arithmetic and ``%`` is signed, while the
engine's hashes, ring order and set-hash sums all need unsigned semantics.

The rule, used everywhere in :mod:`rapid_tpu_torch`:

- A uint32 lane is STORED as ``torch.int32`` holding the same 32-bit
  pattern (the same bytes as the JAX package's uint32 arrays). Equality,
  ``^``, ``|`` and ``&`` are exact on the stored form.
- ARITHMETIC widens it first: :func:`widen` gives an ``int64`` tensor in
  ``[0, 2**32)``, on which ``>>`` is logical, ``%`` and ``<`` are unsigned,
  and :func:`mul` / :func:`add` wrap mod 2**32 without ever overflowing
  int64. :func:`narrow` turns the result back into the stored form.

numpy is the bridge to the JAX package: :func:`from_numpy` and
:func:`to_numpy` move uint32 arrays in and out as bit views.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_SIGN = 0x80000000


def widen(x: torch.Tensor) -> torch.Tensor:
    """Stored uint32 lanes (int32 bit patterns, or bool / small ints) as
    int64 values in ``[0, 2**32)``."""
    return x.to(torch.int64) & MASK


def narrow(x: torch.Tensor) -> torch.Tensor:
    """Widened values (any int64; taken mod 2**32) back to the stored int32
    bit pattern. Exact: no out-of-range cast is ever made."""
    return (((x & MASK) ^ _SIGN) - _SIGN).to(torch.int32)


def bits(value: int) -> int:
    """A Python uint32 constant as the int32 value with the same bits."""
    value &= MASK
    return value - (1 << 32) if value & _SIGN else value


def mul(x: torch.Tensor, const: int) -> torch.Tensor:
    """Wrapping ``x * const mod 2**32`` on widened ``x`` and a uint32
    constant, split in 16-bit halves so that no product exceeds 2**48."""
    const &= MASK
    lo, hi = const & 0xFFFF, const >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK


def add(x: torch.Tensor, y) -> torch.Tensor:
    """Wrapping ``x + y mod 2**32`` on widened values."""
    return (x + y) & MASK


def mix32_w(x: torch.Tensor) -> torch.Tensor:
    """The murmur3-style finalizer on widened values (see
    :func:`rapid_tpu_torch.ops.hashing.mix32` for the stored form)."""
    x = x ^ (x >> 16)
    x = mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def from_numpy(arr, device) -> torch.Tensor:
    """A numpy uint32 array as stored lanes on ``device``."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Stored lanes as a numpy uint32 array (a bit view, no value change)."""
    if t.dtype != torch.int32:
        raise TypeError(f"uint32 lanes are stored as torch.int32, got {t.dtype}")
    return t.detach().cpu().numpy().view(np.uint32)
