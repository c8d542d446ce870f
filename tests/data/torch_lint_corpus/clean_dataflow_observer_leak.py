"""Torch lint corpus: the silent twin of ``dataflow_observer_leak.py``:
the observer only written, the fleet's lanes kept per tenant, and the
dense scan's result used whole."""

from typing import NamedTuple

import torch

from rapid_tpu_torch import _host

N = 256
TENANTS = 4


class EngineState(NamedTuple):
    alive: torch.Tensor
    cuts: torch.Tensor


class TelemetryLanes(NamedTuple):
    tl_enq: torch.Tensor


def _lanes():
    return (EngineState(alive=torch.ones(N, dtype=torch.bool), cuts=torch.zeros(N, dtype=torch.int32)),
            TelemetryLanes(tl_enq=torch.zeros(N, dtype=torch.int32)))


def _observer_written():
    state, telem = _lanes()

    def call():
        cuts = state.cuts + 1
        return EngineState(state.alive, cuts), TelemetryLanes(telem.tl_enq + cuts)

    return {"call": call, "inputs": {"state": state, "telemetry": telem}}


def _engine_branch():
    state, telem = _lanes()

    def call():
        cuts = state.cuts
        if _host.read(state.alive.any(), "branch_point"):
            cuts = cuts + 1
        return EngineState(state.alive, cuts + 0), TelemetryLanes(telem.tl_enq + 1)

    return {"call": call, "inputs": {"state": state, "telemetry": telem}}


def _per_tenant_scan():
    lanes = EngineState(alive=torch.ones((TENANTS, 8), dtype=torch.bool),
                        cuts=torch.arange(TENANTS * 8, dtype=torch.int32).reshape(TENANTS, 8))

    def call():
        return EngineState(lanes.alive, torch.cumsum(lanes.cuts, 1, dtype=torch.int32))

    return {"call": call, "inputs": {"state": lanes}}


def _dense_round():
    state, _ = _lanes()

    def call():
        return EngineState(state.alive, torch.cumsum(state.cuts, 0, dtype=torch.int32))

    return {"call": call, "inputs": {"state": state}}


DATAFLOW_AUDIT_PROGRAMS = {
    "observer_written": {
        "build": _observer_written,
        "checks": ("observer-effect",),
    },
    "engine_branch": {
        "build": _engine_branch,
        "checks": ("observer-effect",),
    },
    "per_tenant_scan": {
        "build": _per_tenant_scan,
        "checks": ("cross-tenant",),
        "tenants": TENANTS,
    },
    "dense_round": {
        "build": _dense_round,
        "checks": ("dense-op",),
        "dense_n": N,
    },
}
