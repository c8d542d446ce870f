"""Exception types (reference: Cluster.java:483-502, MembershipView.java:502-519).

A copy of ``rapid_tpu/errors.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations


class RapidTpuError(Exception):
    """Base class for all framework errors."""


class NodeAlreadyInRingError(RapidTpuError):
    pass


class NodeNotInRingError(RapidTpuError):
    pass


class UUIDAlreadySeenError(RapidTpuError):
    pass


class JoinError(RapidTpuError):
    """Terminal join failure after all retries (Cluster.java:483-487)."""


class JoinPhaseOneError(RapidTpuError):
    """Seed rejected phase 1; carries the response for retry logic (Cluster.java:489-499)."""

    def __init__(self, join_response) -> None:
        super().__init__(f"phase-1 rejected: {join_response.status_code.name}")
        self.join_response = join_response


class JoinPhaseTwoError(RapidTpuError):
    """No observer returned a valid phase-2 confirmation (Cluster.java:501-502)."""


class ShuttingDownError(RapidTpuError):
    """Messaging client used after shutdown (GrpcClient.java:217-221)."""
