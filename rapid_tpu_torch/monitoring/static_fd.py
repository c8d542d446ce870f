"""Deterministic failure detector for tests and simulation
(reference test fixture: StaticFailureDetector.java:24-62).

A shared mutable blacklist decides which subjects are "down"; adding a node to
the blacklist makes every edge pointing at it fail on the next tick. This is
the host-side analog of the TPU engine's fault-mask arrays.

A copy of ``rapid_tpu/monitoring/static_fd.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

from typing import Iterable, Set

from rapid_tpu_torch.monitoring.base import (
    EdgeFailureDetector,
    EdgeFailureDetectorFactory,
    EdgeFailureNotifier,
)
from rapid_tpu_torch.types import Endpoint


class StaticFailureDetector(EdgeFailureDetector):
    def __init__(self, subject: Endpoint, blacklist: Set[Endpoint], notifier: EdgeFailureNotifier):
        self._subject = subject
        self._blacklist = blacklist
        self._notifier = notifier
        self._notified = False

    async def tick(self) -> None:
        if not self._notified and self._subject in self._blacklist:
            self._notified = True
            self._notifier()


class StaticFailureDetectorFactory(EdgeFailureDetectorFactory):
    def __init__(self, blacklist: Iterable[Endpoint] = ()) -> None:
        self.blacklist: Set[Endpoint] = set(blacklist)

    def add_failed_nodes(self, nodes: Iterable[Endpoint]) -> None:
        self.blacklist.update(nodes)

    def create_instance(
        self, subject: Endpoint, notifier: EdgeFailureNotifier
    ) -> EdgeFailureDetector:
        return StaticFailureDetector(subject, self.blacklist, notifier)
