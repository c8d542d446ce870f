"""Counted device-to-host reads, and host-to-device uploads that do not wait.

The JAX engine runs its loops and ``lax.cond`` gates on the device. The port
runs them in Python, so every gate it branches on is a read that waits for
the device. All such reads in the engine go through :func:`read`, whose
``count`` attribute says how many were made: read before and after a
drive, it gives the drive's reads per round, the figure a host-bound path
is held to; :func:`upload` counts its calls the same way. Each read names
its call site from :data:`READ_SITES`, and the process keeps a count and
the nanoseconds spent waiting in it per site (:func:`site_totals`).
:func:`read_later` is a read whose wait comes later than its copy.

The other way, a plain ``torch.from_numpy(arr).to("cuda")`` copies from
pageable memory and synchronizes the stream: every upload would wait for
all the work queued before it. :func:`upload` is the streaming path's
spelling, which does not wait.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from rapid_tpu_torch.utils import profiling

#: The registered read sites: every call of :func:`read` names one.
READ_SITES = frozenset({
    # The single cluster's round and its wave loop.
    "branch_point",
    "classic_outcome",
    "invalidation_gate",
    "membership_predicate",
    "decision_observation",
    "join_admissibility",
    # The fleet's loops.
    "fleet_wave_active",
    "fleet_wave_observation",
    "fleet_decision_predicate",
    "fleet_decision_observation",
    # Barriers, planes and observers.
    "sync_checksum",
    "telemetry_digest",
    "trace_digest",
    "stream_fetch",
    "observer",
    "health",
    # The host membership path's device adapters.
    "detector_proposal",
    "vote_tally",
    # Harnesses built on the engine.
    "chaos_soak",
    "oracle_probe",
    "khl_sweep",
})

#: Each site's span (``read.<site>``).
_SPANS = {site: "read." + site for site in READ_SITES}
profiling.register(*_SPANS.values())
#: Per-site totals of this process: site -> [reads, ns waited in them].
_totals: Dict[str, List[int]] = {site: [0, 0] for site in READ_SITES}
#: Nanoseconds waited in every read of this process.
_ns = 0


def read(t: torch.Tensor, site: str):
    """``t.tolist()`` (a Python scalar for a 0-d tensor), counted, and
    timed into ``site``'s totals. Raises ``ValueError`` for a site not in
    :data:`READ_SITES`."""
    return _counted(site, t.tolist)


def read_later(t: torch.Tensor, site: str):
    """:func:`read` of ``t`` queued now and waited for later. On a card
    ``t`` is copied into pinned host memory behind the work on the current
    stream; the function returned waits for that copy alone, so the work
    queued after this call runs on while the host waits. Its first call
    returns the value as :func:`read` does, counted and timed into
    ``site``'s totals; a later call returns the same value uncounted."""
    _site(site)
    if t.device.type != "cuda":
        return functools.cache(lambda: _counted(site, t.tolist))
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    copy_event = torch.cuda.Event()
    copy_event.record(torch.cuda.current_stream(t.device))

    def value():
        copy_event.synchronize()
        return host.tolist()

    return functools.cache(lambda: _counted(site, value))


def _site(site: str) -> List[int]:
    """``site``'s totals; ``ValueError`` for a site not in :data:`READ_SITES`."""
    totals = _totals.get(site)
    if totals is None:
        raise ValueError(
            f"unregistered read site {site!r}; add it to rapid_tpu_torch._host.READ_SITES"
        )
    return totals


def _counted(site: str, value):
    """``value()``, counted and timed into ``site``'s totals."""
    global _ns
    totals = _site(site)
    read.count += 1
    with profiling.span(_SPANS[site]):
        start = time.perf_counter_ns()
        out = value()
        ns = time.perf_counter_ns() - start
    totals[0] += 1
    totals[1] += ns
    _ns += ns
    return out


read.count = 0


def read_ns() -> int:
    """Nanoseconds waited in every read of this process so far."""
    return _ns


def site_totals() -> Dict[str, Tuple[int, int]]:
    """``{site: (reads, ns waited)}`` of this process so far."""
    return {site: (count, ns) for site, (count, ns) in _totals.items()}


def upload(arr: np.ndarray, device: torch.device, keep: List[torch.Tensor]) -> torch.Tensor:
    """``arr`` as a tensor on ``device``, queued behind the work already on
    the current stream without waiting for it. On a card the array is copied
    into a fresh pinned host buffer, which is uploaded with
    ``non_blocking=True`` and appended to ``keep``: the caller holds it
    until the stream has passed the copy (the streaming driver keeps each
    wave's buffers with its completion ticket). On the CPU it is an ordinary
    copy and ``keep`` is untouched."""
    upload.count += 1
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return host.to(device, copy=True)
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    keep.append(pinned)
    return pinned.to(device, non_blocking=True)


upload.count = 0
