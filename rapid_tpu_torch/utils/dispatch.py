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
"""

from __future__ import annotations

import time
from contextlib import contextmanager

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
        into ``engine_dispatch_ms{phase=<entry>}`` and count it in
        ``engine_dispatches``. ``entry`` must be one of
        :data:`ENGINE_DISPATCH_PHASES`."""
        if entry not in ENGINE_DISPATCH_PHASES:
            raise ValueError(
                f"unregistered engine dispatch phase {entry!r}; add it to "
                f"rapid_tpu_torch.utils.dispatch.ENGINE_DISPATCH_PHASES"
            )
        self.metrics.inc("engine_dispatches")
        start = time.perf_counter()
        try:
            yield
        finally:
            self.metrics.record_ms(
                "engine_dispatch",
                (time.perf_counter() - start) * 1000.0,
                phase=entry,
            )
