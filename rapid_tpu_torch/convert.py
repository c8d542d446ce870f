"""State carried across as numpy arrays.

The port never sees a JAX array. A caller holding the JAX package's state
(or its telemetry lanes and trace ring) turns it into numpy
(``np.asarray(getattr(state, field))``) and builds the port's lanes from
that; uint32 lanes become stored int32 bit patterns
(:mod:`rapid_tpu_torch._u32`) and come back out as uint32. A fleet's
stacked lanes carry a leading ``[t]`` axis (``tenants=t``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from rapid_tpu_torch import _u32
from rapid_tpu_torch.models.state import (
    DTYPES,
    LANES,
    TELEMETRY_LANE_SPECS,
    TRACE_LANE_SPECS,
    EngineConfig,
    EngineState,
    FaultInputs,
    TelemetryLanes,
    TraceRing,
    lane_dims,
)

_NUMPY = {"u32": np.uint32, "i32": np.int32, "bool": np.bool_}

#: Every lane the bridge carries: the engine's, then the telemetry plane's
#: and the trace ring's (all int32).
_SPECS = {
    **LANES,
    **{f: (shape, "i32") for f, shape in {**TELEMETRY_LANE_SPECS, **TRACE_LANE_SPECS}.items()},
}


def _expected_shape(field: str, cfg: EngineConfig, tenants) -> tuple:
    dims = lane_dims(cfg)
    lead = () if tenants is None else (tenants,)
    return lead + tuple(dims[s] for s in _SPECS[field][0])


def _lane_from_numpy(field: str, arr, cfg: EngineConfig, device, tenants) -> torch.Tensor:
    kind = _SPECS[field][1]
    a = np.asarray(arr)
    want = _expected_shape(field, cfg, tenants)
    if a.shape != want:
        raise ValueError(f"lane {field!r}: shape {a.shape}, expected {want}")
    if kind == "u32":
        return _u32.from_numpy(a, device)
    return torch.from_numpy(np.array(a, dtype=_NUMPY[kind])).to(device)


def _from_numpy(cls, cfg: EngineConfig, arrays: Dict[str, np.ndarray], device, tenants):
    missing = set(cls._fields) - set(arrays)
    if missing:
        raise KeyError(f"{cls.__name__} lanes missing: {sorted(missing)}")
    dev = torch.device(device)
    return cls(**{f: _lane_from_numpy(f, arrays[f], cfg, dev, tenants) for f in cls._fields})


def state_from_numpy(
    cfg: EngineConfig, arrays: Dict[str, np.ndarray], device, tenants: Optional[int] = None
) -> EngineState:
    """An :class:`EngineState` on ``device`` from one numpy array per field
    (the JAX package's wide layout: uint32, int32 and bool lanes); with
    ``tenants=t``, a fleet's stacked state, every lane ``[t, ...]``."""
    return _from_numpy(EngineState, cfg, arrays, device, tenants)


def faults_from_numpy(
    cfg: EngineConfig, arrays: Dict[str, np.ndarray], device, tenants: Optional[int] = None
) -> FaultInputs:
    """A :class:`FaultInputs` on ``device`` from numpy arrays (stacked with
    ``tenants=t``)."""
    return _from_numpy(FaultInputs, cfg, arrays, device, tenants)


def telemetry_from_numpy(
    cfg: EngineConfig, arrays: Dict[str, np.ndarray], device, tenants: Optional[int] = None
) -> TelemetryLanes:
    """:class:`TelemetryLanes` on ``device`` from one int32 numpy array per
    field (a JAX cluster's ``telem``; stacked with ``tenants=t``)."""
    return _from_numpy(TelemetryLanes, cfg, arrays, device, tenants)


def trace_from_numpy(
    cfg: EngineConfig, arrays: Dict[str, np.ndarray], device, tenants: Optional[int] = None
) -> TraceRing:
    """A :class:`TraceRing` on ``device`` from one int32 numpy array per
    field (a JAX cluster's ``trace_ring``; stacked with ``tenants=t``)."""
    return _from_numpy(TraceRing, cfg, arrays, device, tenants)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Every lane of an :class:`EngineState`, :class:`FaultInputs`,
    :class:`StepEvents`, :class:`TelemetryLanes` or :class:`TraceRing` (one
    cluster's or a fleet's stacked lanes) as numpy, at the JAX package's
    dtypes. Raises if a lane carries another dtype than the layout says."""
    out = {}
    for field, value in state._asdict().items():
        kind = _SPECS[field][1]
        if value.dtype != DTYPES[kind]:
            raise TypeError(f"lane {field!r} is {value.dtype}, the layout says {DTYPES[kind]}")
        out[field] = _u32.to_numpy(value) if kind == "u32" else value.detach().cpu().numpy()
    return out


#: The plane lanes go out through the same bridge as the state.
telemetry_to_numpy = trace_to_numpy = state_to_numpy
