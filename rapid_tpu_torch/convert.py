"""State carried across as numpy arrays.

The port never sees a JAX array. A caller holding the JAX package's state
(or its telemetry lanes and trace ring) turns it into numpy
(``np.asarray(getattr(state, field))``) and builds the port's lanes from
that, in either layout: every lane's numpy dtype must be the one
``cfg``'s compaction policy gives it (``models/state.lane_dtypes``).
uint32 and uint16 lanes become stored int32 and int16 bit patterns
(:mod:`rapid_tpu_torch._u32`, :mod:`rapid_tpu_torch._narrow`) and come back
out as uint32 and uint16, so a state goes through the bridge byte for byte
both ways. A fleet's stacked lanes carry a leading ``[t]`` axis
(``tenants=t``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from rapid_tpu_torch import _narrow
from rapid_tpu_torch.models.state import (
    EVENT_LANE_SPECS,
    LANE_SPECS,
    TELEMETRY_LANE_SPECS,
    TRACE_LANE_SPECS,
    UNSIGNED_KINDS,
    EngineConfig,
    EngineState,
    FaultInputs,
    TelemetryLanes,
    TraceRing,
    lane_dims,
    lane_dtypes,
)

#: field -> (shape symbols, kind) of every lane the bridge carries: the
#: engine's, its events', then the telemetry plane's and the trace ring's
#: (all int32).
_SPECS = {
    **LANE_SPECS,
    **EVENT_LANE_SPECS,
    **{f: (shape, "int32") for f, shape in {**TELEMETRY_LANE_SPECS, **TRACE_LANE_SPECS}.items()},
}


def _expected(field: str, cfg: EngineConfig, tenants) -> tuple:
    """(shape, numpy dtype name) of ``field`` under ``cfg``."""
    dims = lane_dims(cfg)
    lead = () if tenants is None else (tenants,)
    shape, kind = _SPECS[field]
    name = lane_dtypes(cfg)[field] if field in LANE_SPECS else kind
    return lead + tuple(dims[s] for s in shape), name


def _lane_from_numpy(field: str, arr, cfg: EngineConfig, device, tenants) -> torch.Tensor:
    a = np.asarray(arr)
    want, name = _expected(field, cfg, tenants)
    if a.shape != want:
        raise ValueError(f"lane {field!r}: shape {a.shape}, expected {want}")
    if a.dtype != np.dtype(name):
        raise TypeError(f"lane {field!r}: dtype {a.dtype}, the layout says {name}")
    return _narrow.from_numpy(a, name, device)


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
    at ``cfg``'s policy dtypes (the wide layout's uint32, int32 and bool, or
    the compact one's); with ``tenants=t``, a fleet's stacked state, every
    lane ``[t, ...]``."""
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


def _numpy_name(field: str, value: torch.Tensor) -> str:
    """The numpy dtype a stored lane stands for: its kind's own for the
    fixed kinds, else the stored width read signed or unsigned by kind.
    Raises if the stored dtype is not one the kind can take."""
    kind = _SPECS[field][1]
    if kind in ("uint32", "int32", "bool"):
        name = kind
    elif value.dtype in (torch.uint8, torch.int8, torch.int16, torch.int32):
        bits = torch.iinfo(value.dtype).bits
        name = f"uint{bits}" if kind in UNSIGNED_KINDS else f"int{bits}"
    else:
        raise TypeError(f"lane {field!r} ({kind}) cannot be stored as {value.dtype}")
    if value.dtype != _narrow.STORAGE.get(name):
        raise TypeError(f"lane {field!r} is {value.dtype}, the layout says {name}")
    return name


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Every lane of an :class:`EngineState`, :class:`FaultInputs`,
    :class:`StepEvents`, :class:`TelemetryLanes` or :class:`TraceRing` (one
    cluster's or a fleet's stacked lanes, either layout) as numpy, at the
    JAX package's dtypes. Raises on a lane stored as no dtype its kind
    takes."""
    return {
        field: _narrow.to_numpy(value, _numpy_name(field, value))
        for field, value in state._asdict().items()
    }


#: The plane lanes go out through the same bridge as the state.
telemetry_to_numpy = trace_to_numpy = state_to_numpy
