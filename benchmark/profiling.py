"""The fenced profiler session of the traced run, and what is read from it.

:func:`profile_run` is a frozen copy of ``chip_smoke.py``'s ``profile_run``
(PR 15). On the H100 a ``torch.profiler`` session loses the kernels of a
span near its start, and the span grows with the process; so the profiled
call is preceded and followed by ``lead_s`` seconds of marker kernels
(``torch.cuda._sleep``, which the program never launches) in a host range,
and fenced by one ``exponential_`` kernel on each side, each waited for. A
session that holds both fences holds every kernel of the call
(``recorded``); the caller profiles again, with more markers, when it does
not.

Beside the copy's sums, :func:`profile_run` reads the session's timeline:
the union of device intervals inside the call (``busy_s``), the device
operations that took most time, and the longest idle gaps of the device,
each named by the innermost host operation running at its middle
(``breakdown``).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

#: Seconds of marker kernels before and after the profiled call.
PROFILE_LEAD_S = 0.02
#: Clock cycles of one marker kernel (~30 us).
PROFILE_MARKER_CYCLES = 50_000
#: The host range around each span of marker kernels.
PROFILE_SPAN = "benchmark.profile_markers"
#: The delivery kernel's symbol, as the profiler names it.
DELIVERY_KERNEL = "delivery_new_bits_kernel"
#: Entries of each list of the breakdown.
BREAKDOWN_ENTRIES = 10
#: What an idle gap is named when no host operation was running.
NO_HOST_OP = "python (no torch op)"


def is_profile_marker(name: str) -> bool:
    """The device rows :func:`profile_run` adds around the profiled call."""
    return name == PROFILE_SPAN or "spin_kernel" in name or is_profile_fence(name)


def is_profile_fence(name: str) -> bool:
    return "exponential" in name or "distribution" in name


def _union_s(intervals) -> float:
    """Seconds covered by ``(start_us, end_us)`` intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e6


def _gaps(intervals, lo, hi):
    """``(start_us, end_us)`` stretches of ``[lo, hi]`` no interval covers."""
    out, cursor = [], lo
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(s, e) for s, e in out if e > s]


def _innermost(host, points):
    """For each time in ``points`` (sorted), the name of the innermost host
    event that contains it, or None: one sweep with a stack of open events
    (the events of one thread nest)."""
    names, stack, i = [], [], 0
    for m in points:
        while i < len(host) and host[i][0] <= m:
            s, e, name = host[i]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        names.append(stack[-1][2] if stack else None)
    return names


def profile_run(dev, run, lead_s=PROFILE_LEAD_S):
    """``run()`` once under torch.profiler, fenced (module docstring).
    Returns ``(run's result, profile)``; the profile holds the call's wall
    seconds, device seconds (kernels and copies, markers and fences left
    out), ``busy_s``, the device operations and their count, the delivery
    kernel's seconds and launches, the host's self seconds of every host
    event inside the call and their count, ``breakdown`` and
    ``recorded``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    scratch = torch.empty(1, device=dev)

    def markers():
        end = time.perf_counter() + lead_s
        while time.perf_counter() < end:
            for _ in range(32):
                torch.cuda._sleep(PROFILE_MARKER_CYCLES)
            torch.cuda.synchronize(dev)

    def fence():
        scratch.exponential_()
        torch.cuda.synchronize(dev)

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(PROFILE_SPAN):
            markers()
        fence()
        start = time.perf_counter()
        result = run()
        torch.cuda.synchronize(dev)
        wall_s = time.perf_counter() - start
        fence()
        with record_function(PROFILE_SPAN):
            markers()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    fences = sorted(e.time_range.start for e in device if is_profile_fence(e.name))
    ops = [e for e in device if not is_profile_marker(e.name)]
    intervals = [(e.time_range.start, e.time_range.end) for e in ops]
    # The call lies between the fences on the device's clock; without both
    # the session lost records, and the caller profiles again.
    lo = fences[0] if fences else min((s for s, _ in intervals), default=0.0)
    hi = fences[-1] if len(fences) > 1 else max((e for _, e in intervals), default=lo)
    by_name = collections.defaultdict(float)
    for e in ops:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    host = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in events
        if e.device_type == DeviceType.CPU and lo <= e.time_range.start and e.time_range.end <= hi
        and e.name != PROFILE_SPAN and not is_profile_fence(e.name)
    )
    # Host self time: every host event inside the call but the waits for
    # the device, which are the device's time, not the host's work.
    host_self_s = sum(e.self_cpu_time_total for e in events
                      if e.device_type == DeviceType.CPU and lo <= e.time_range.start
                      and e.time_range.end <= hi and e.name != PROFILE_SPAN
                      and not is_profile_fence(e.name) and "Synchronize" not in e.name) / 1e6
    gaps = _gaps(intervals, lo, hi)
    named = _innermost(host, [(s + e) / 2 for s, e in gaps])
    idle = collections.defaultdict(float)
    for (s, e), name in zip(gaps, named):
        idle[name or NO_HOST_OP] += (e - s) / 1e6

    def top(table):
        return [[name, seconds] for name, seconds in
                sorted(table.items(), key=lambda kv: kv[1], reverse=True)[:BREAKDOWN_ENTRIES]]

    delivery = [e for e in ops if DELIVERY_KERNEL in e.name]
    return result, {
        "wall_s": wall_s,
        "device_s": sum(by_name.values()),
        "busy_s": _union_s(intervals),
        "device_ops": len(ops),
        "delivery_s": sum((e.time_range.end - e.time_range.start) / 1e6 for e in delivery),
        "delivery_launches": len(delivery),
        "host_self_s": host_self_s,
        "host_events": len(host),
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)},
        "recorded": len(fences) == 2,
    }
