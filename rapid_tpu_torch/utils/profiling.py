"""Profiler hooks on ``torch.profiler`` (the counterpart of
``rapid_tpu/utils/profiling.py``).

Traces engine convergences and kernel passes to a Chrome trace::

    from rapid_tpu_torch.utils.profiling import span_table, trace, trace_file
    with trace("/tmp/rapid-trace"):
        vc.run_until_membership(n)
    span_table(trace_file("/tmp/rapid-trace"))

``trace`` records host activity, and the card's kernels where CUDA is
available, then writes ``<log_dir>/rapid_tpu_torch.<pid>.pt.trace.json``
(Perfetto or ``chrome://tracing`` open it).

The program marks its own phases with :func:`span`: each dispatch entry,
each engine round and its phases, each view change, the fleet's lockstep
select and each counted read. A span name is registered by the module that
owns it (:func:`register`); an unregistered name raises. A span is a
``record_function`` range named ``rapid.<name>`` only while a ``trace()``
block is recording, so the ranges nest over their operators and kernels in
the exported trace; anywhere else, a profiler session the program did not
open included, it is the shared no-op :data:`OFF`, which emits nothing.
:func:`span_table` reads an exported trace back into count, total and self
time per span. The JAX package's semantics of ``trace`` are kept:

- **No nesting**: the profiler is a process-wide singleton, so a ``trace``
  inside an active one raises ``RuntimeError`` eagerly, and the guard
  resets when the block raises.
- **Graceful no-op**: where the profiler is missing, or fails to start, the
  block still runs unprofiled and a WARNING says so; a failed stop or export
  is logged and never masks the block's own outcome.
"""

from __future__ import annotations

import functools
import json
import logging
import os
from contextlib import contextmanager
from typing import Callable, Dict

import torch

logger = logging.getLogger(__name__)

#: Prefix of the range name of every span the program emits.
PREFIX = "rapid."

#: True while a ``trace()`` block is active in this process.
_active = False
#: True while a ``trace()`` block's profiler is recording: spans are on.
_recording = False
#: The registered span vocabulary: span name -> its range's name.
_names: Dict[str, str] = {}


def register(*names: str) -> None:
    """Add span names to the vocabulary :func:`span` accepts."""
    for name in names:
        _names[name] = PREFIX + name


def registered() -> frozenset:
    """The registered span names."""
    return frozenset(_names)


class _Off:
    """The span of a site while no ``trace()`` records: enters and exits
    doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


#: The one object every span site returns while spans are off.
OFF = _Off()


def recording() -> bool:
    """True while a ``trace()`` block records, so that spans are on."""
    return _recording


def span(name: str):
    """The span of a registered phase: a ``record_function`` range named
    ``PREFIX + name`` while a ``trace()`` block records, else :data:`OFF`.
    Raises ``ValueError`` for an unregistered name."""
    full = _names.get(name)
    if full is None:
        raise ValueError(
            f"unregistered span {name!r}; register it with "
            f"rapid_tpu_torch.utils.profiling.register"
        )
    if not _recording:
        return OFF
    return torch.profiler.record_function(full)


def spanned(name: str) -> Callable:
    """Decorator: every call of the function runs inside ``span(name)``.
    ``name`` must be registered already."""
    span(name)

    def decorate(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inside(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inside

    return decorate


def profiler_available() -> bool:
    """True iff this PyTorch build exposes ``torch.profiler.profile``."""
    return hasattr(torch, "profiler") and hasattr(torch.profiler, "profile")


def trace_file(log_dir: str) -> str:
    """The Chrome trace a ``trace(log_dir)`` block of this process writes."""
    return os.path.join(log_dir, f"rapid_tpu_torch.{os.getpid()}.pt.trace.json")


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (host activity, and the card's kernels
    when CUDA is available) and export a Chrome trace into ``log_dir``
    (:func:`trace_file`). No-ops with a WARNING when the profiler is
    unavailable or fails to start; raises ``RuntimeError`` inside an active
    ``trace()`` block (the profiler cannot nest)."""
    global _active, _recording
    if _active:
        raise RuntimeError(
            "profiling.trace() does not nest: a trace is already active in "
            "this process — close it before starting another"
        )
    prof = None
    _active = True
    try:
        if profiler_available():
            try:
                prof = torch.profiler.profile(activities=_activities())
                prof.start()
                _recording = True
            except Exception as exc:  # noqa: BLE001 — profiling is an
                # opt-in diagnostic: a profiler that cannot start must not
                # fail the profiled workload.
                logger.warning(
                    "torch.profiler failed to start for %r (%r); running unprofiled",
                    log_dir, exc,
                )
                prof = None
        else:
            logger.warning("torch.profiler unavailable on this platform; running unprofiled")
        yield
    finally:
        _active = _recording = False
        if prof is not None:
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()  # the block's kernels land in the trace
                prof.stop()
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(trace_file(log_dir))
            except Exception as exc:  # noqa: BLE001 — the block already
                # ran; a failed stop or export leaves no trace file, logged.
                logger.warning("torch.profiler stop_trace/export failed: %r", exc)


def span_table(path: str) -> Dict[str, Dict[str, float]]:
    """Every span of an exported trace (:func:`trace_file`): ``{name:
    {"count", "total_ms", "self_ms"}}`` keyed by the registered name, where
    a span's self time is its duration less the part of it its child spans
    cover. Spans nest per thread; the card's copies of the ranges are left
    out."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(
        (e for e in events
         if e.get("ph") == "X" and e.get("cat") == "user_annotation"
         and e.get("name", "").startswith(PREFIX)),
        key=lambda e: (e["pid"], e["tid"], e["ts"], -e["dur"]),
    )
    table: Dict[str, Dict[str, float]] = {}
    stack = []  # the open spans: (thread, end, row)
    for e in spans:
        thread, start, ms = (e["pid"], e["tid"]), e["ts"], e["dur"] / 1e3
        while stack and (stack[-1][0] != thread or stack[-1][1] <= start):
            stack.pop()
        if stack:
            stack[-1][2]["self_ms"] -= ms
        row = table.setdefault(e["name"][len(PREFIX):],
                               {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += ms
        row["self_ms"] += ms
        stack.append((thread, start + e["dur"], row))
    return table
