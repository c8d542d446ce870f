"""rapid_tpu_torch: the membership engine of ``rapid_tpu`` ported to
PyTorch, with its alert-delivery kernel written in CUDA C++ for NVIDIA
Hopper (``csrc/delivery.cu``).

Entry points: :class:`rapid_tpu_torch.models.virtual_cluster.VirtualCluster`
(one cluster, built from a seed or from real endpoints, in the wide or the
compact state layout) and :class:`rapid_tpu_torch.tenancy.TenantFleet` (B
independent clusters per round), the serving tier
(:mod:`rapid_tpu_torch.serving`) and the engine side of the chaos
subsystem (:mod:`rapid_tpu_torch.sim`, :mod:`rapid_tpu_torch.tenancy.chaos`),
and the flat host membership path (:class:`rapid_tpu_torch.protocol.Cluster`
over the in-process and TCP transports, whose cut and vote tallies run on
the card through ``DeviceCutDetector`` and ``DeviceVoteTally``), with
the host view's ``Configuration`` checkpoints
(:mod:`rapid_tpu_torch.utils.checkpoint`), the native host library
(:mod:`rapid_tpu_torch.utils._native`, ``csrc/rapid_native.cpp``) and the
reference-wire interop (:mod:`rapid_tpu_torch.interop`, protobuf and gRPC).
They run on CUDA unless given ``device="cpu"``. Both drivers are scraped
through ``health()``, ``telemetry_snapshot()`` and ``prometheus_text()``
(the JAX package's snapshot and text, :mod:`rapid_tpu_torch.utils`).
uint32 lanes are stored as int32 bit patterns (:mod:`rapid_tpu_torch._u32`),
uint16 lanes as int16 bit patterns (:mod:`rapid_tpu_torch._narrow`). The
package imports ``torch`` and numpy only, but for the interop, which
imports ``protobuf`` (and ``grpc`` for its transport) when it is used.
"""

import importlib

_EXPORTS = {
    "Cluster": "rapid_tpu_torch.protocol.cluster",
    "ClusterEvents": "rapid_tpu_torch.protocol.events",
    "Endpoint": "rapid_tpu_torch.types",
    "NodeId": "rapid_tpu_torch.types",
    "Settings": "rapid_tpu_torch.settings",
    "VirtualCluster": "rapid_tpu_torch.models.virtual_cluster",
    "TenantFleet": "rapid_tpu_torch.tenancy.fleet",
    "NodeHealth": "rapid_tpu_torch.utils.health",
    "aggregate_health": "rapid_tpu_torch.utils.health",
    "metric_names": "rapid_tpu_torch.utils.exposition",
    "prometheus_text": "rapid_tpu_torch.utils.exposition",
    "CompileDelta": "rapid_tpu_torch.utils.engine_telemetry",
    "compile_snapshot": "rapid_tpu_torch.utils.engine_telemetry",
    "device_memory_snapshot": "rapid_tpu_torch.utils.engine_telemetry",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    # Lazy: the submodules import this package first.
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'rapid_tpu_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)
