"""Time and scheduling abstraction (a copy of ``rapid_tpu/utils/clock.py``).

Every timing consumer (alert batcher, failure detectors, consensus fallback)
goes through :class:`Clock` instead of the event loop directly, so tests,
the host membership path under simulated time, and the flight recorder's
synthesized engine timelines run on :class:`ManualClock`. The host path's
default is :class:`AsyncioClock` (wall time on the running loop), and
:class:`NodeClock` gives a node its own skewed or paused view of a shared
clock.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
from typing import Callable, List, Optional, Tuple


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


class AsyncioClock(Clock):
    """Wall-clock implementation over the running asyncio loop."""

    def __init__(self, loop: Optional[asyncio.AbstractEventLoop] = None):
        self._loop = loop

    @property
    def loop(self) -> asyncio.AbstractEventLoop:
        if self._loop is None:
            self._loop = asyncio.get_event_loop()
        return self._loop

    def now_ms(self) -> float:
        return self.loop.time() * 1000.0

    async def sleep_ms(self, delay_ms: float) -> None:
        await asyncio.sleep(delay_ms / 1000.0)

    def call_later_ms(self, delay_ms: float, fn: Callable[[], None]) -> CancelHandle:
        handle = self.loop.call_later(delay_ms / 1000.0, fn)
        return CancelHandle(handle.cancel)


class NodeClock(Clock):
    """Per-node view of a shared base clock, with injectable skew and pause.

    The chaos-simulation subsystem (rapid_tpu/sim) gives every simulated
    node its own ``NodeClock`` over the test's one ``ManualClock`` so fault
    schedules can express per-node clock faults deterministically:

    - **skew**: ``set_skew(offset_ms)`` shifts this node's ``now_ms``
      readings (timestamps, metrics, batching-window arithmetic) without
      touching anyone else's — the classic mis-set-NTP failure mode;
    - **pause**: ``pause()`` freezes ``now_ms`` AND defers every timer the
      node scheduled (its failure detectors, alert batcher, sync loops all
      stop firing) until ``resume()`` — a GC pause / VM freeze. The node
      still answers inbound RPCs, which is exactly what makes real frozen
      processes so confusing to their peers.

    Timers are scheduled on the base clock; a callback landing while paused
    is parked and re-armed (delay 0) at resume, so no tick is lost, only
    late — matching a thawed process running its overdue timers.
    """

    def __init__(self, base: Clock) -> None:
        self._base = base
        self._offset_ms = 0.0
        self._paused = False
        self._paused_at = 0.0
        self._parked: List[Callable[[], None]] = []

    def now_ms(self) -> float:
        if self._paused:
            return self._paused_at
        return self._base.now_ms() + self._offset_ms

    def set_skew(self, offset_ms: float) -> None:
        if self._paused:
            raise RuntimeError("cannot re-skew a paused clock (resume first)")
        self._offset_ms = offset_ms

    @property
    def paused(self) -> bool:
        return self._paused

    def pause(self) -> None:
        if self._paused:
            return
        self._paused_at = self.now_ms()
        self._paused = True

    def resume(self) -> None:
        if not self._paused:
            return
        self._paused = False
        parked, self._parked = self._parked, []
        for fn in parked:
            # Re-armed rather than run inline: resume() is called from
            # synchronous schedule-application code, and overdue callbacks
            # must fire from the clock/loop context they were written for.
            self._base.call_later_ms(0, fn)

    async def sleep_ms(self, delay_ms: float) -> None:
        event = asyncio.Event()
        self.call_later_ms(delay_ms, event.set)
        await event.wait()

    def call_later_ms(self, delay_ms: float, fn: Callable[[], None]) -> CancelHandle:
        cancelled = [False]

        def fire() -> None:
            if cancelled[0]:
                return
            if self._paused:
                self._parked.append(fire)
            else:
                fn()

        inner = self._base.call_later_ms(delay_ms, fire)

        def cancel() -> None:
            cancelled[0] = True
            inner.cancel()

        return CancelHandle(cancel)


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
