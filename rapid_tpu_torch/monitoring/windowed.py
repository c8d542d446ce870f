"""Windowed-fraction edge failure detector — the PAPER's stated policy.

The reference paper (§7) describes marking an edge faulty when "40% of the
last 10 probes" failed, but the shipped code uses a consecutive-failure
counter instead (PingPongFailureDetector.java:41, 74-85; SURVEY §2.3 flags
the divergence as behavior to standardize). This rebuild ships BOTH
policies as first-class detectors: ``PingPongFailureDetector`` matches the
shipped code; this detector matches the paper — a sliding window of the
last ``window`` probe outcomes, edge faulty once the window is full and the
failed fraction reaches ``fail_fraction``.

The windowed policy recovers from transient blips (old failures age out of
the window) where the counter policy latches them — the paper's rationale
for fractional measurement over multiple probes.
"""

from __future__ import annotations

import math
from collections import deque

from rapid_tpu_torch.messaging.base import MessagingClient
from rapid_tpu_torch.monitoring.base import (
    EdgeFailureDetector,
    EdgeFailureDetectorFactory,
    EdgeFailureNotifier,
)
from rapid_tpu_torch.monitoring.ping_pong import BOOTSTRAP_COUNT_THRESHOLD
from rapid_tpu_torch.types import Endpoint, NodeStatus, ProbeMessage, ProbeResponse

WINDOW = 10
FAIL_FRACTION = 0.4


class WindowedFailureDetector(EdgeFailureDetector):
    def __init__(
        self,
        my_addr: Endpoint,
        subject: Endpoint,
        client: MessagingClient,
        notifier: EdgeFailureNotifier,
        window: int = WINDOW,
        fail_fraction: float = FAIL_FRACTION,
    ) -> None:
        if not 0 < fail_fraction <= 1:
            raise ValueError(f"fail_fraction must be in (0, 1], got {fail_fraction}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._my_addr = my_addr
        self._subject = subject
        self._client = client
        self._notifier = notifier
        self._window = window
        # ceil honors ">= fail_fraction": round-half would fire below the
        # configured fraction (e.g. 0.44 of 10 firing at 4/10 = 40%).
        self._fail_threshold = max(1, math.ceil(window * fail_fraction))
        self._outcomes: deque = deque(maxlen=window)  # True = probe failed
        self._bootstrap_responses = 0
        self._notified = False

    async def tick(self) -> None:
        if self._notified:
            return
        response = await self._client.send_best_effort(
            self._subject, ProbeMessage(sender=self._my_addr)
        )
        failed = response is None
        if (
            isinstance(response, ProbeResponse)
            and response.status == NodeStatus.BOOTSTRAPPING
        ):
            # Same bootstrap grace as the ping-pong detector: a starting
            # server is not a faulty one, up to a point.
            self._bootstrap_responses += 1
            failed = self._bootstrap_responses > BOOTSTRAP_COUNT_THRESHOLD
        self._outcomes.append(failed)
        if (
            len(self._outcomes) == self._window
            and sum(self._outcomes) >= self._fail_threshold
        ):
            self._notified = True
            self._notifier()


class WindowedFailureDetectorFactory(EdgeFailureDetectorFactory):
    def __init__(
        self,
        my_addr: Endpoint,
        client: MessagingClient,
        window: int = WINDOW,
        fail_fraction: float = FAIL_FRACTION,
    ) -> None:
        self._my_addr = my_addr
        self._client = client
        self._window = window
        self._fail_fraction = fail_fraction

    def create_instance(
        self, subject: Endpoint, notifier: EdgeFailureNotifier
    ) -> EdgeFailureDetector:
        return WindowedFailureDetector(
            self._my_addr,
            subject,
            self._client,
            notifier,
            self._window,
            self._fail_fraction,
        )
