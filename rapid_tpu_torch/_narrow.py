"""The port's storage of the compact layout's narrow lanes (beside
:mod:`rapid_tpu_torch._u32`, the rule for uint32 lanes).

Under ``EngineConfig.compact=1`` the JAX package stores some lanes at
uint8, uint16, int8 or int16 (``models/state.compaction_policy``). Torch's
narrow unsigned types are not all usable: ``torch.uint16`` has no ``<<`` or
``>>``, no ordered compare, no ``where`` on a compare and no ``scatter``;
``torch.uint8`` is fully usable. Gathers take int32 or int64 indices only,
and an int8 or int16 tensor is not a legal index. The rule, used everywhere
in :mod:`rapid_tpu_torch`:

- a ``uint8`` lane is stored as ``torch.uint8``;
- a ``uint16`` lane is stored as ``torch.int16`` holding the same 16 bits
  (the uint32 rule, at half the width);
- an ``int8`` or ``int16`` lane is stored as itself;
- a ``uint32`` lane is stored as ``torch.int32`` bit patterns (``_u32``).

So the stored dtype alone does not say whether an int16 lane is signed: the
lane's kind does (the report and history bitmasks are unsigned, the index,
cohort, counter and round lanes signed). Bitmask lanes are read with
:func:`unsigned`, which widens by a mask of the lane's OWN width (a
sign-extending cast would turn a uint16 0xFFFF into 32 set bits); signed
lanes widen with an ordinary ``.to()``. Stores go through
:func:`keep_bits`, which keeps the low bits of a wider value exactly, as a
device cast wraps. Index lanes are widened to int64 before they index.

numpy is the bridge: :func:`from_numpy` / :func:`to_numpy` move a lane of
any of these dtypes in and out by bit views.
"""

from __future__ import annotations

import numpy as np
import torch

#: numpy dtype name of a lane -> the torch dtype that stores it.
STORAGE = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "uint16": torch.int16,
    "int16": torch.int16,
    "uint32": torch.int32,
    "int32": torch.int32,
}

#: numpy dtype name -> the numpy dtype of its stored bits (a view).
_STORED_NUMPY = {
    "bool": np.bool_,
    "uint8": np.uint8,
    "int8": np.int8,
    "uint16": np.int16,
    "int16": np.int16,
    "uint32": np.int32,
    "int32": np.int32,
}


def unsigned(x: torch.Tensor) -> torch.Tensor:
    """A stored bitmask lane (any integer or bool dtype) as int64 values in
    ``[0, 2**bits)``, ``bits`` being the STORED width: an int16 0xFFFF is
    65535, not -1."""
    if x.dtype == torch.bool:
        return x.to(torch.int64)
    bits = 8 * x.element_size()
    if bits >= 64:
        return x
    return x.to(torch.int64) & ((1 << bits) - 1)


def keep_bits(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The low bits of integer ``x`` stored as ``dtype`` (bool, uint8, int8,
    int16 or int32): the value modulo ``2**bits``, read back as ``dtype``
    reads it. Exact, as a device's wrapping cast: no out-of-range cast is
    ever made."""
    if x.dtype == dtype:
        return x
    if dtype == torch.bool:
        return x != 0
    bits = torch.iinfo(dtype).bits
    mask = (1 << bits) - 1
    x = x.to(torch.int64) & mask
    if dtype == torch.uint8:
        return x.to(dtype)
    sign = 1 << (bits - 1)
    return ((x ^ sign) - sign).to(dtype)


def bit(index: int, dtype: torch.dtype) -> int:
    """The value of a ``dtype`` lane that holds only bit ``index`` (bit 15 of
    an int16 lane is -32768)."""
    value = 1 << index
    info = torch.iinfo(dtype)
    return value - (1 << info.bits) if value > info.max else value


def from_numpy(arr, name: str, device) -> torch.Tensor:
    """A numpy array of dtype ``name`` as the stored lane on ``device``."""
    a = np.array(arr, order="C")  # a copy; 0-d stays 0-d
    if a.dtype != np.dtype(name):
        raise TypeError(f"expected a {name} array, got {a.dtype}")
    return torch.from_numpy(a.view(_STORED_NUMPY[name])).to(device)


def to_numpy(t: torch.Tensor, name: str) -> np.ndarray:
    """A stored lane as the numpy array of dtype ``name`` (a bit view)."""
    if t.dtype != STORAGE[name]:
        raise TypeError(f"a {name} lane is stored as {STORAGE[name]}, got {t.dtype}")
    return t.detach().cpu().numpy().view(np.dtype(name))
