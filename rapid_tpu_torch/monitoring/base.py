"""Failure-detector plugin SPI (reference: monitoring/IEdgeFailureDetectorFactory.java).

One detector instance per monitoring edge (observer -> subject), re-created on
every configuration change; the membership service schedules each instance at
the failure-detector interval and the instance signals an edge failure by
invoking its notifier exactly once.

A copy of ``rapid_tpu/monitoring/base.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

import abc
from typing import Callable

from rapid_tpu_torch.types import Endpoint

EdgeFailureNotifier = Callable[[], None]


class EdgeFailureDetector(abc.ABC):
    """Per-edge detector; ``tick`` runs once per failure-detector interval."""

    @abc.abstractmethod
    async def tick(self) -> None:
        ...


class EdgeFailureDetectorFactory(abc.ABC):
    @abc.abstractmethod
    def create_instance(
        self, subject: Endpoint, notifier: EdgeFailureNotifier
    ) -> EdgeFailureDetector:
        ...
