"""State carried across as numpy arrays.

The port never sees a JAX array. A caller holding the JAX package's state
turns it into numpy (``np.asarray(getattr(state, field))``) and builds the
port's state from that; uint32 lanes become stored int32 bit patterns
(:mod:`rapid_tpu_torch._u32`) and come back out as uint32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from rapid_tpu_torch import _u32
from rapid_tpu_torch.models.state import (
    DTYPES,
    LANES,
    EngineConfig,
    EngineState,
    FaultInputs,
)

_NUMPY = {"u32": np.uint32, "i32": np.int32, "bool": np.bool_}


def _expected_shape(field: str, cfg: EngineConfig) -> tuple:
    dims = {"n": cfg.n, "k": cfg.k, "c": cfg.c}
    return tuple(dims[s] for s in LANES[field][0])


def _lane_from_numpy(field: str, arr, cfg: EngineConfig, device) -> torch.Tensor:
    kind = LANES[field][1]
    a = np.asarray(arr)
    if a.shape != _expected_shape(field, cfg):
        raise ValueError(f"lane {field!r}: shape {a.shape}, expected {_expected_shape(field, cfg)}")
    if kind == "u32":
        return _u32.from_numpy(a, device)
    return torch.from_numpy(np.array(a, dtype=_NUMPY[kind])).to(device)


def _from_numpy(cls, cfg: EngineConfig, arrays: Dict[str, np.ndarray], device):
    missing = set(cls._fields) - set(arrays)
    if missing:
        raise KeyError(f"{cls.__name__} lanes missing: {sorted(missing)}")
    dev = torch.device(device)
    return cls(**{f: _lane_from_numpy(f, arrays[f], cfg, dev) for f in cls._fields})


def state_from_numpy(cfg: EngineConfig, arrays: Dict[str, np.ndarray], device) -> EngineState:
    """An :class:`EngineState` on ``device`` from one numpy array per field
    (the JAX package's wide layout: uint32, int32 and bool lanes)."""
    return _from_numpy(EngineState, cfg, arrays, device)


def faults_from_numpy(cfg: EngineConfig, arrays: Dict[str, np.ndarray], device) -> FaultInputs:
    """A :class:`FaultInputs` on ``device`` from numpy arrays."""
    return _from_numpy(FaultInputs, cfg, arrays, device)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Every lane of an :class:`EngineState`, :class:`FaultInputs` or
    :class:`StepEvents` as numpy, at the JAX package's dtypes. Raises if a
    lane carries another dtype than the layout says."""
    out = {}
    for field, value in state._asdict().items():
        kind = LANES[field][1]
        if value.dtype != DTYPES[kind]:
            raise TypeError(f"lane {field!r} is {value.dtype}, the layout says {DTYPES[kind]}")
        out[field] = _u32.to_numpy(value) if kind == "u32" else value.detach().cpu().numpy()
    return out
