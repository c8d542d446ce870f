"""Protocol types the port needs (copies of ``Endpoint`` and ``EdgeStatus``
from ``rapid_tpu/types.py``)."""

from __future__ import annotations

import enum
from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class Endpoint:
    """A process address (``rapid.proto:13-17``)."""

    hostname: str
    port: int

    def __str__(self) -> str:
        return f"{self.hostname}:{self.port}"

    @staticmethod
    def parse(host_port: str) -> "Endpoint":
        host, _, port = host_port.rpartition(":")
        return Endpoint(host, int(port))


class EdgeStatus(enum.IntEnum):
    """``rapid.proto:112-115``."""

    UP = 0
    DOWN = 1
