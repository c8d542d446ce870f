"""Time and scheduling abstraction (a copy of the clock interface and the
manual clock of ``rapid_tpu/utils/clock.py``).

Every timing consumer goes through :class:`Clock` instead of the event loop
directly, so tests and the flight recorder's synthesized engine timelines
run on simulated time (:class:`ManualClock`). The asyncio and per-node
clocks belong to the host stack and are not copied.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
from typing import Callable, List, Tuple


class CancelHandle:
    __slots__ = ("_cancel",)

    def __init__(self, cancel: Callable[[], None]):
        self._cancel = cancel

    def cancel(self) -> None:
        self._cancel()


class Clock:
    """Abstract clock + one-shot scheduler."""

    def now_ms(self) -> float:
        raise NotImplementedError

    async def sleep_ms(self, delay_ms: float) -> None:
        raise NotImplementedError

    def call_later_ms(self, delay_ms: float, fn: Callable[[], None]) -> CancelHandle:
        raise NotImplementedError


class ManualClock(Clock):
    """Deterministic clock for unit tests: time only moves via ``advance_ms``."""

    def __init__(self) -> None:
        self._now = 0.0
        self._counter = itertools.count()
        self._pending: List[Tuple[float, int, Callable[[], None], List[bool]]] = []

    def now_ms(self) -> float:
        return self._now

    async def sleep_ms(self, delay_ms: float) -> None:
        event = asyncio.Event()
        self.call_later_ms(delay_ms, event.set)
        await event.wait()

    def call_later_ms(self, delay_ms: float, fn: Callable[[], None]) -> CancelHandle:
        cancelled = [False]
        heapq.heappush(self._pending, (self._now + delay_ms, next(self._counter), fn, cancelled))
        return CancelHandle(lambda: cancelled.__setitem__(0, True))

    def advance_ms(self, delta_ms: float) -> None:
        """Move time forward, firing due callbacks in order."""
        target = self._now + delta_ms
        while self._pending and self._pending[0][0] <= target:
            when, _, fn, cancelled = heapq.heappop(self._pending)
            self._now = when
            if not cancelled[0]:
                fn()
        self._now = target
