"""Default ping-pong edge failure detector
(reference: monitoring/impl/PingPongFailureDetector.java).

Each tick probes the subject; FAILURE_THRESHOLD consecutive failed windows
mark the edge faulty (notifier fired once). A bootstrapping subject (server up
but service not yet set) is tolerated for BOOTSTRAP_COUNT_THRESHOLD responses
before counting as failure (PingPongFailureDetector.java:41-45).

A copy of ``rapid_tpu/monitoring/ping_pong.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

from rapid_tpu_torch.messaging.base import MessagingClient
from rapid_tpu_torch.monitoring.base import (
    EdgeFailureDetector,
    EdgeFailureDetectorFactory,
    EdgeFailureNotifier,
)
from rapid_tpu_torch.types import Endpoint, NodeStatus, ProbeMessage, ProbeResponse

FAILURE_THRESHOLD = 10
BOOTSTRAP_COUNT_THRESHOLD = 30


class PingPongFailureDetector(EdgeFailureDetector):
    def __init__(
        self,
        my_addr: Endpoint,
        subject: Endpoint,
        client: MessagingClient,
        notifier: EdgeFailureNotifier,
        failure_threshold: int = FAILURE_THRESHOLD,
    ) -> None:
        self._my_addr = my_addr
        self._subject = subject
        self._client = client
        self._notifier = notifier
        self._failure_threshold = failure_threshold
        self._failure_count = 0
        self._bootstrap_responses = 0
        self._notified = False

    async def tick(self) -> None:
        if self._notified:
            return
        if self._failure_count >= self._failure_threshold:
            self._notified = True
            self._notifier()
            return
        response = await self._client.send_best_effort(
            self._subject, ProbeMessage(sender=self._my_addr)
        )
        if response is None:
            self._failure_count += 1
            return
        if isinstance(response, ProbeResponse) and response.status == NodeStatus.BOOTSTRAPPING:
            self._bootstrap_responses += 1
            if self._bootstrap_responses > BOOTSTRAP_COUNT_THRESHOLD:
                self._failure_count += 1
        # An OK probe does not reset the counter: the reference counts
        # consecutive windows without a successful reset either
        # (PingPongFailureDetector.java:74-85 increments only).


class PingPongFailureDetectorFactory(EdgeFailureDetectorFactory):
    def __init__(
        self, my_addr: Endpoint, client: MessagingClient, failure_threshold: int = FAILURE_THRESHOLD
    ) -> None:
        self._my_addr = my_addr
        self._client = client
        self._failure_threshold = failure_threshold

    def create_instance(
        self, subject: Endpoint, notifier: EdgeFailureNotifier
    ) -> EdgeFailureDetector:
        return PingPongFailureDetector(
            self._my_addr, subject, self._client, notifier, self._failure_threshold
        )
