"""Counters and bounded timer histograms (a copy of
``rapid_tpu/utils/metrics.py``).

Timings land in fixed-schedule :class:`~rapid_tpu_torch.utils.histogram.LogHistogram`
buckets, never unbounded lists. The owning component may inject its clock's
``now_ms``; the engine drivers use the default wall clock for their
dispatch timers.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, Dict, Optional

from rapid_tpu_torch.utils.histogram import LogHistogram


def _wall_now_ms() -> float:
    return time.perf_counter_ns() / 1e6


class Metrics:
    def __init__(self, now_ms: Optional[Callable[[], float]] = None) -> None:
        self.counters: Dict[str, int] = defaultdict(int)
        #: Plain timers: name -> bounded histogram.
        self.timings: Dict[str, LogHistogram] = {}
        #: Labeled timer families: name -> phase -> bounded histogram (a
        #: phase key may carry a secondary label as "phase/path", e.g.
        #: "agreement/fast", which the JAX package's exposition splits).
        self.phase_timings: Dict[str, Dict[str, LogHistogram]] = {}
        self._marks: Dict[str, float] = {}
        self._now_ms = now_ms if now_ms is not None else _wall_now_ms

    def now_ms(self) -> float:
        """This registry's clock reading (the injected source, or wall)."""
        return self._now_ms()

    def inc(self, name: str, value: int = 1) -> None:
        self.counters[name] += value

    def record_ms(self, name: str, value_ms: float, phase: Optional[str] = None) -> None:
        if phase is None:
            hist = self.timings.get(name)
            if hist is None:
                hist = self.timings[name] = LogHistogram()
        else:
            family = self.phase_timings.setdefault(name, {})
            hist = family.get(phase)
            if hist is None:
                hist = family[phase] = LogHistogram()
        hist.observe(value_ms)

    @contextmanager
    def timer(self, name: str):
        start = self._now_ms()
        try:
            yield
        finally:
            self.record_ms(name, self._now_ms() - start)

    def mark(self, name: str, now_ms: float | None = None) -> None:
        """Start (or restart) a named epoch for ``elapsed_since_ms``. The
        injected clock supplies the default reading; pass one explicitly to
        reuse a reading the caller already took this tick."""
        self._marks[name] = now_ms if now_ms is not None else self._now_ms()

    def has_mark(self, name: str) -> bool:
        return name in self._marks

    def clear_mark(self, name: str) -> None:
        self._marks.pop(name, None)

    def elapsed_since_ms(self, name: str, now_ms: float | None = None) -> float:
        start = self._marks.get(name)
        if start is None:
            return 0.0
        now = now_ms if now_ms is not None else self._now_ms()
        return now - start

    def summary(self) -> Dict[str, object]:
        """Counters verbatim; every timer as its bounded histogram summary
        (``<name>_ms`` -> {count,last,p50,p90,p99,max,sum,buckets}); every
        phase family as ``<name>_ms`` -> {phase: histogram summary}."""
        out: Dict[str, object] = dict(self.counters)
        for name, hist in self.timings.items():
            if hist.count:
                out[f"{name}_ms"] = hist.summary()
        for name, family in self.phase_timings.items():
            phases = {
                phase: hist.summary() for phase, hist in family.items() if hist.count
            }
            if phases:
                out[f"{name}_ms"] = phases
        return out
