"""Torch lint corpus: dataflow provenance defects, one per proof check.

Miniature eager calls in the registry's spec shape, each violating one
property the ``dataflow`` family proves over the real engine: a
telemetry lane added into an engine lane (the observer perturbs its
subject by data), a host branch on a telemetry lane (by control), an
``index_select`` along the fleet's tenant axis (tenant ``t`` reads
tenant ``T-1-t``'s lanes), and a dense full-``N`` scan under a host
branch on the activity mask whose only consumer is a select by that mask
(provably maskable work: a sparse-opportunity candidate the map must
name). ``clean_dataflow_observer_leak.py`` is the silent twin.
"""

from typing import NamedTuple

import torch

from rapid_tpu_torch import _host

N = 256
TENANTS = 4


class EngineState(NamedTuple):
    alive: torch.Tensor  # [n] activity mask: a gating lane
    cuts: torch.Tensor  # [n] per-slot counters


class TelemetryLanes(NamedTuple):
    tl_enq: torch.Tensor  # [n] observer tally: must stay write-only


def _lanes():
    return (EngineState(alive=torch.ones(N, dtype=torch.bool), cuts=torch.zeros(N, dtype=torch.int32)),
            TelemetryLanes(tl_enq=torch.zeros(N, dtype=torch.int32)))


def _observer_feedback():
    state, telem = _lanes()

    def call():
        cuts = state.cuts + telem.tl_enq  # the tally flows into the counters
        return EngineState(state.alive, cuts), TelemetryLanes(telem.tl_enq + 1)

    return {"call": call, "inputs": {"state": state, "telemetry": telem}}


def _observer_branch():
    state, telem = _lanes()

    def call():
        cuts = state.cuts
        if _host.read(telem.tl_enq.any(), "branch_point"):  # the engine branches on the observer
            cuts = cuts + 1
        return EngineState(state.alive, cuts + 0), TelemetryLanes(telem.tl_enq + 1)

    return {"call": call, "inputs": {"state": state, "telemetry": telem}}


def _cross_tenant_select():
    lanes = EngineState(alive=torch.ones((TENANTS, 8), dtype=torch.bool),
                        cuts=torch.arange(TENANTS * 8, dtype=torch.int32).reshape(TENANTS, 8))

    def call():
        flipped = torch.arange(TENANTS - 1, -1, -1)
        return EngineState(lanes.alive, lanes.cuts.index_select(0, flipped))

    return {"call": call, "inputs": {"state": lanes}}


def _gated_dense_round():
    state, _ = _lanes()

    def call():
        cuts = state.cuts
        if _host.read(state.alive.any(), "branch_point"):
            cuts = torch.where(state.alive, torch.cumsum(state.cuts, 0, dtype=torch.int32), cuts)
        return EngineState(state.alive, cuts)

    return {"call": call, "inputs": {"state": state}}


DATAFLOW_AUDIT_PROGRAMS = {
    "observer_feedback": {  # expect: dataflow-observer-effect
        "build": _observer_feedback,
        "checks": ("observer-effect",),
    },
    "observer_branch": {  # expect: dataflow-observer-effect
        "build": _observer_branch,
        "checks": ("observer-effect",),
    },
    "cross_tenant_select": {  # expect: dataflow-cross-tenant
        "build": _cross_tenant_select,
        "checks": ("cross-tenant",),
        "tenants": TENANTS,
    },
    "gated_dense_round": {  # expect: dataflow-dense-op
        "build": _gated_dense_round,
        "checks": ("dense-op",),
        "dense_n": N,
    },
}
