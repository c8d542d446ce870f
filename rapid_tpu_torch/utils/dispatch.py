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
block each dispatch is also a span named after its entry. The port's own
entries (:data:`RECORDED_ENTRIES`) leave a record and a span the same way,
but no sample in the registry, which stays the JAX driver's.
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
#: Entries recorded in the ring (and spanned) that the JAX package's
#: registry has no phase for: they leave no ``engine_dispatches`` count and
#: no ``engine_dispatch_ms`` sample (:meth:`DispatchSeam._record_entry`).
RECORDED_ENTRIES = frozenset({
    # VirtualCluster's join wave: its admissibility read and the
    # gatekeepers' search over the K rings.
    "inject_join_wave",
})
profiling.register(*ENGINE_DISPATCH_PHASES, *RECORDED_ENTRIES)

#: Dispatches the ring keeps, oldest dropped first.
RING_SIZE = 4096
_ring: "collections.deque[DispatchRecord]" = collections.deque(maxlen=RING_SIZE)
_ordinals = itertools.count()


class DispatchRecord:
    """One dispatch of an entry point. ``rounds`` are the rounds the entry
    computed in it; for a fleet, ``tenant_rounds_active`` are the rounds
    tenants stepped and ``tenant_rounds_computed`` the rounds computed for
    every tenant, lockstep included (0 where the entry fills in none).
    ``cuts`` are the view changes a cluster's ``run_until_membership``
    committed, and ``joiners`` the joiners a join wave injected (0 where
    the entry fills in none). ``read_ns`` is the part of ``wall_ns`` spent in counted reads.
    ``profiled``: a ``torch.profiler`` session was recording at its start.
    ``graphed``: the entry replayed a captured CUDA graph (a fleet wave,
    ``tenancy/fleet.py::WaveGraphs``)."""

    __slots__ = ("entry", "ordinal", "profiled", "graphed", "wall_ns", "read_ns", "rounds",
                 "tenant_rounds_active", "tenant_rounds_computed", "cuts", "joiners")

    def __init__(self, entry: str, ordinal: int, profiled: bool):
        self.entry, self.ordinal, self.profiled = entry, ordinal, profiled
        self.graphed = False
        self.wall_ns = self.read_ns = self.rounds = 0
        self.tenant_rounds_active = self.tenant_rounds_computed = 0
        self.cuts = self.joiners = 0


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
        try:
            with _recorded(record):
                yield record
        finally:
            self.metrics.record_ms("engine_dispatch", record.wall_ns / 1e6, phase=entry)

    @contextmanager
    def _record_entry(self, entry: str):
        """Leave the block's :class:`DispatchRecord` in the ring, as
        :meth:`_dispatch` does, for one of :data:`RECORDED_ENTRIES`,
        with nothing charged to the registry."""
        if entry not in RECORDED_ENTRIES:
            raise ValueError(
                f"unregistered recorded entry {entry!r}; add it to "
                f"rapid_tpu_torch.utils.dispatch.RECORDED_ENTRIES"
            )
        record = DispatchRecord(entry, next(_ordinals), _autograd_profiler._is_profiler_enabled)
        with _recorded(record):
            yield record


@contextmanager
def _recorded(record: DispatchRecord):
    """Run the block inside ``record``'s entry span, then fill in its wall
    and counted-read nanoseconds and append it to the ring."""
    reads = _host.read_ns()
    start = time.perf_counter_ns()
    try:
        with profiling.span(record.entry):
            yield
    finally:
        record.wall_ns = time.perf_counter_ns() - start
        record.read_ns = _host.read_ns() - reads
        _ring.append(record)
