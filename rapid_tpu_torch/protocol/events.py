"""Subscription event model (reference: ClusterEvents.java, ClusterStatusChange.java,
NodeStatusChange.java).

A copy of ``rapid_tpu/protocol/events.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Tuple

from rapid_tpu_torch.protocol.metadata import FrozenMetadata
from rapid_tpu_torch.types import EdgeStatus, Endpoint


class ClusterEvents(enum.Enum):
    """ClusterEvents.java:19-23. The reference declares
    VIEW_CHANGE_ONE_STEP_FAILED but never fires it; here the declared API is
    completed: it fires when the jittered classic-Paxos fallback engages
    because the fast round could not clear (service._on_fast_round_failed)."""

    VIEW_CHANGE_PROPOSAL = "VIEW_CHANGE_PROPOSAL"
    VIEW_CHANGE = "VIEW_CHANGE"
    #: Payload contract: the accompanying ClusterStatusChange carries the
    #: configuration id and membership of the view the fallback is deciding
    #: IN, with EMPTY status_changes — at fallback engagement no view delta
    #: has been decided yet (the fast round failed to pick one). Subscribers
    #: must not assume every notification carries changes; deltas arrive with
    #: the eventual VIEW_CHANGE. Deviation from the reference (which declares
    #: this event but never fires it) documented in PARITY.md.
    VIEW_CHANGE_ONE_STEP_FAILED = "VIEW_CHANGE_ONE_STEP_FAILED"
    KICKED = "KICKED"


@dataclass(frozen=True)
class NodeStatusChange:
    """NodeStatusChange.java:24-40."""

    endpoint: Endpoint
    status: EdgeStatus
    metadata: FrozenMetadata = ()


@dataclass(frozen=True)
class ClusterStatusChange:
    """ClusterStatusChange.java:20-34: (configuration id, full membership,
    delta of status changes)."""

    configuration_id: int
    membership: Tuple[Endpoint, ...]
    status_changes: Tuple[NodeStatusChange, ...]
