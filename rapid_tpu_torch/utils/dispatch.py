"""The host-side engine dispatch seam shared by the port's drivers (a copy of
``rapid_tpu/utils/dispatch.py``).

``VirtualCluster`` and ``TenantFleet`` (and, through them, the streaming
pipeline in :mod:`rapid_tpu_torch.serving`) observe the engine at one grain:
transfer bytes charged at the host/device boundary, and one bounded latency
histogram per dispatch phase (``engine_dispatch_ms{phase=...}``).
:data:`ENGINE_DISPATCH_PHASES` is the registered phase vocabulary, enforced
when a phase is written: an unregistered phase raises.

The bytes charged are the ones the JAX package charges at the same seam, so
the two packages' counters agree on the same drive. On a card a dispatch
phase times the host's enqueue (PyTorch launches asynchronously, as JAX
dispatches), and ``stream_fetch`` brackets the waits on the device: their
split is what makes the stream's overlap efficiency measurable from the
histograms alone (``serving/stream.py``).

Every dispatch also leaves a :class:`DispatchRecord` in a process-wide ring
of the last :data:`RING_SIZE` (:func:`records`): its wall and counted-read
nanoseconds, the rounds the entry point computed, and whether a
``torch.profiler`` session was recording. Inside a ``profiling.trace()``
block each dispatch is also a span named after its entry.
"""

from __future__ import annotations

import collections
import itertools
import time
from contextlib import contextmanager
from typing import List

from torch.autograd import profiler as _autograd_profiler

from rapid_tpu_torch import _host
from rapid_tpu_torch.utils import profiling

#: The registered dispatch-phase vocabulary, the JAX package's.
ENGINE_DISPATCH_PHASES = frozenset({
    # VirtualCluster entry points.
    "step",
    "sync",
    "run_to_decision",
    "run_until_membership",
    # TenantFleet entry points.
    "fleet_step",
    "fleet_decision",
    "fleet_wave",
    # The per-tenant health reduction (the supervisor's poisoned-tenant
    # tripwire).
    "health_scan",
    # Streaming pipeline: enqueue-only rounds and the explicit waits on the
    # device they synchronize at.
    "stream_enqueue",
    "stream_fetch",
})
profiling.register(*ENGINE_DISPATCH_PHASES)

#: Dispatches the ring keeps, oldest dropped first.
RING_SIZE = 4096
_ring: "collections.deque[DispatchRecord]" = collections.deque(maxlen=RING_SIZE)
_ordinals = itertools.count()


class DispatchRecord:
    """One dispatch of an entry point. ``rounds`` are the rounds the entry
    computed in it; for a fleet, ``tenant_rounds_active`` are the rounds
    tenants stepped and ``tenant_rounds_computed`` the rounds computed for
    every tenant, lockstep included (0 where the entry fills in none).
    ``read_ns`` is the part of ``wall_ns`` spent in counted reads.
    ``profiled``: a ``torch.profiler`` session was recording at its start.
    ``graphed``: the entry replayed a captured CUDA graph (a fleet wave,
    ``tenancy/fleet.py::WaveGraphs``)."""

    __slots__ = ("entry", "ordinal", "profiled", "graphed", "wall_ns", "read_ns", "rounds",
                 "tenant_rounds_active", "tenant_rounds_computed")

    def __init__(self, entry: str, ordinal: int, profiled: bool):
        self.entry, self.ordinal, self.profiled = entry, ordinal, profiled
        self.graphed = False
        self.wall_ns = self.read_ns = self.rounds = 0
        self.tenant_rounds_active = self.tenant_rounds_computed = 0


def records() -> List[DispatchRecord]:
    """The ring's records, oldest first."""
    return list(_ring)


def clear_records() -> None:
    """Empty the ring."""
    _ring.clear()


class DispatchSeam:
    """Mixin: transfer-byte accounting and the phase-validated dispatch
    timer. Hosts provide ``self.metrics`` (a
    :class:`rapid_tpu_torch.utils.metrics.Metrics`)."""

    def _account_h2d(self, *arrays) -> None:
        """Charge host-to-device uploads (numpy arrays or tensors, by
        ``nbytes``) to ``engine_h2d_bytes``."""
        self.metrics.inc(
            "engine_h2d_bytes",
            int(sum(int(getattr(a, "nbytes", 0) or 0) for a in arrays)),
        )

    def _account_d2h(self, nbytes: int) -> None:
        self.metrics.inc("engine_d2h_bytes", int(nbytes))

    @contextmanager
    def _dispatch(self, entry: str):
        """Time one dispatch (and any read the caller makes inside the block)
        into ``engine_dispatch_ms{phase=<entry>}``, count it in
        ``engine_dispatches`` and leave its :class:`DispatchRecord`, which
        the block receives to fill in its rounds, in the ring. ``entry``
        must be one of :data:`ENGINE_DISPATCH_PHASES`."""
        if entry not in ENGINE_DISPATCH_PHASES:
            raise ValueError(
                f"unregistered engine dispatch phase {entry!r}; add it to "
                f"rapid_tpu_torch.utils.dispatch.ENGINE_DISPATCH_PHASES"
            )
        self.metrics.inc("engine_dispatches")
        record = DispatchRecord(entry, next(_ordinals), _autograd_profiler._is_profiler_enabled)
        reads = _host.read_ns()
        start = time.perf_counter_ns()
        try:
            with profiling.span(entry):
                yield record
        finally:
            record.wall_ns = time.perf_counter_ns() - start
            record.read_ns = _host.read_ns() - reads
            _ring.append(record)
            self.metrics.record_ms("engine_dispatch", record.wall_ns / 1e6, phase=entry)
