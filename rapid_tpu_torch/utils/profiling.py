"""Profiler hooks on ``torch.profiler`` (the counterpart of
``rapid_tpu/utils/profiling.py``).

Traces engine convergences and kernel passes to a Chrome trace without
touching call sites::

    from rapid_tpu_torch.utils.profiling import annotate, trace
    with trace("/tmp/rapid-trace"):
        with annotate("churn"):
            vc.run_until_membership(n)

``trace`` records host activity, and the card's kernels where CUDA is
available, then writes ``<log_dir>/rapid_tpu_torch.<pid>.pt.trace.json``
(Perfetto or ``chrome://tracing`` open it). The JAX package's semantics are
kept:

- **No nesting**: the profiler is a process-wide singleton, so a ``trace``
  inside an active one raises ``RuntimeError`` eagerly, and the guard
  resets when the block raises.
- **Graceful no-op**: where the profiler is missing, or fails to start, the
  block still runs unprofiled and a WARNING says so; a failed stop or export
  is logged and never masks the block's own outcome.
"""

from __future__ import annotations

import logging
import os
from contextlib import contextmanager, nullcontext

import torch

logger = logging.getLogger(__name__)

#: True while a ``trace()`` block is active in this process.
_active = False


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
    global _active
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
        _active = False
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


@contextmanager
def annotate(name: str):
    """A named span for a host phase: ``torch.profiler.record_function``,
    plus an NVTX range where CUDA is available; a no-op when the profiler
    is unavailable."""
    if not profiler_available():
        yield
        return
    with torch.profiler.record_function(name):
        with torch.cuda.nvtx.range(name) if torch.cuda.is_available() else nullcontext():
            yield
