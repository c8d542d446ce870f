"""Wire-schema types for the membership protocol.

These mirror the *semantics* of the reference's protobuf schema
(``rapid/src/main/proto/rapid.proto``): one request envelope carrying exactly
one protocol message, one response envelope. We use frozen dataclasses instead
of protobuf — the in-process and TCP transports serialize them with
``rapid_tpu_torch.messaging.codec``; they are hashable so they can key vote tallies
exactly the way the reference keys ``Map<List<Endpoint>, AtomicInteger>``
(``FastPaxos.java:53``).

A copy of ``rapid_tpu/types.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

import enum
import uuid as _uuid
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

# Trace-context note: ``BatchedAlertMessage`` and the five consensus messages
# carry an optional ``trace_id`` — the correlation key minted at the first
# alert of a membership change (protocol/service.py) and propagated on the
# wire (messaging/codec.py appends it as an optional trailing field, so
# frames without it are byte-identical to the pre-trace layout). The field is
# declared ``compare=False``: equality/hash stay keyed on protocol content
# exactly as the reference keys vote tallies, so two identical votes with
# different trace stamps still dedup as one vote.


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


@dataclass(frozen=True, order=True)
class NodeId:
    """A 128-bit logical node identifier (``rapid.proto:50-54``)."""

    high: int
    low: int

    @staticmethod
    def from_uuid(u: Optional[_uuid.UUID] = None) -> "NodeId":
        u = u if u is not None else _uuid.uuid4()
        as_int = u.int
        high = (as_int >> 64) & ((1 << 64) - 1)
        low = as_int & ((1 << 64) - 1)
        return NodeId(high=high, low=low)


class EdgeStatus(enum.IntEnum):
    """``rapid.proto:112-115``."""

    UP = 0
    DOWN = 1


class JoinStatusCode(enum.IntEnum):
    """``rapid.proto:85-91``."""

    HOSTNAME_ALREADY_IN_RING = 0
    UUID_ALREADY_IN_RING = 1
    SAFE_TO_JOIN = 2
    CONFIG_CHANGED = 3
    MEMBERSHIP_REJECTED = 4


class NodeStatus(enum.IntEnum):
    """Probe responses (``rapid.proto:203-206``)."""

    OK = 0
    BOOTSTRAPPING = 1


# --------------------------------------------------------------------------
# Request messages (the RapidRequest oneof, rapid.proto:21-35)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PreJoinMessage:
    """Phase-1 join: joiner → seed (``rapid.proto:57-63``)."""

    sender: Endpoint
    node_id: NodeId


@dataclass(frozen=True)
class JoinMessage:
    """Phase-2 join: joiner → each observer (``rapid.proto:65-72``)."""

    sender: Endpoint
    node_id: NodeId
    ring_numbers: Tuple[int, ...]
    configuration_id: int
    metadata: Tuple[Tuple[str, bytes], ...] = ()


@dataclass(frozen=True)
class AlertMessage:
    """An edge status report (``rapid.proto:101-110``). ``node_id``/``metadata``
    are only set on UP alerts emitted for joiners."""

    edge_src: Endpoint
    edge_dst: Endpoint
    edge_status: EdgeStatus
    configuration_id: int
    ring_numbers: Tuple[int, ...]
    node_id: Optional[NodeId] = None
    metadata: Tuple[Tuple[str, bytes], ...] = ()


@dataclass(frozen=True)
class BatchedAlertMessage:
    """``rapid.proto:95-99``."""

    sender: Endpoint
    messages: Tuple[AlertMessage, ...]
    trace_id: Optional[int] = field(default=None, compare=False)


@dataclass(frozen=True)
class ProbeMessage:
    """Failure-detector ping (``rapid.proto:192-196``)."""

    sender: Endpoint


@dataclass(frozen=True)
class Rank:
    """Paxos rank: ordered by (round, node_index) (``rapid.proto:133-137``)."""

    round: int
    node_index: int

    def as_tuple(self) -> Tuple[int, int]:
        return (self.round, self.node_index)


@dataclass(frozen=True)
class FastRoundPhase2bMessage:
    """A fast-round vote: the sender's cut proposal (``rapid.proto:124-129``)."""

    sender: Endpoint
    configuration_id: int
    endpoints: Tuple[Endpoint, ...]
    trace_id: Optional[int] = field(default=None, compare=False)


@dataclass(frozen=True)
class Phase1aMessage:
    sender: Endpoint
    configuration_id: int
    rank: Rank
    trace_id: Optional[int] = field(default=None, compare=False)


@dataclass(frozen=True)
class Phase1bMessage:
    sender: Endpoint
    configuration_id: int
    rnd: Rank
    vrnd: Rank
    vval: Tuple[Endpoint, ...]
    trace_id: Optional[int] = field(default=None, compare=False)


@dataclass(frozen=True)
class Phase2aMessage:
    sender: Endpoint
    configuration_id: int
    rnd: Rank
    vval: Tuple[Endpoint, ...]
    trace_id: Optional[int] = field(default=None, compare=False)


@dataclass(frozen=True)
class Phase2bMessage:
    sender: Endpoint
    configuration_id: int
    rnd: Rank
    endpoints: Tuple[Endpoint, ...]
    trace_id: Optional[int] = field(default=None, compare=False)


@dataclass(frozen=True)
class LeaveMessage:
    """Graceful-leave intent (``rapid.proto:185-188``)."""

    sender: Endpoint


@dataclass(frozen=True)
class CohortCutMessage:
    """Hierarchical membership (rapid_tpu/hier): a cohort's *decided* cut
    proposal, forwarded by the cohort's delegate (or a failover candidate)
    to the global reconfiguration committee. ``cohort`` is the sender's
    cohort index under the current configuration's cohort map; ``endpoints``
    is the cut the cohort's Fast Paxos agreed on. ``joiner_eps``/``joiner_ids``
    carry the identifiers of any joiners in the cut (their UP alerts only
    circulated inside the gatekeeper cohort, so the committee — and later
    every other cohort — learns them here)."""

    sender: Endpoint
    configuration_id: int
    cohort: int
    endpoints: Tuple[Endpoint, ...]
    joiner_eps: Tuple[Endpoint, ...] = ()
    joiner_ids: Tuple[NodeId, ...] = ()
    trace_id: Optional[int] = field(default=None, compare=False)


@dataclass(frozen=True)
class DelegateDecisionMessage:
    """Hierarchical membership (rapid_tpu/hier): the globally-decided view
    change, disseminated by each committee member to its own cohort's plain
    members so every node applies the identical, totally-ordered
    configuration change without having participated in the global tier."""

    sender: Endpoint
    configuration_id: int
    endpoints: Tuple[Endpoint, ...]
    joiner_eps: Tuple[Endpoint, ...] = ()
    joiner_ids: Tuple[NodeId, ...] = ()
    trace_id: Optional[int] = field(default=None, compare=False)


@dataclass(frozen=True)
class GlobalTierMessage:
    """Hierarchical membership (rapid_tpu/hier): envelope distinguishing the
    global reconfiguration tier's consensus traffic (the five Fast-Paxos /
    classic-Paxos message types, scoped to the delegate committee) from the
    cohort-local fast path's — both tiers speak the same consensus message
    types over the same configuration id, so the envelope is what routes a
    frame to the right engine. ``payload`` is a complete consensus request."""

    sender: Endpoint
    payload: "RapidRequest"


@dataclass(frozen=True)
class GossipMessage:
    """Epidemic-relay envelope for broadcast traffic — the alternate
    broadcast strategy ``IBroadcaster.java:24-29``'s docs name but the
    reference never ships. ``payload`` is the broadcast request being
    spread; (origin, msg_id) dedups redeliveries; ttl bounds relay depth.
    """

    origin: Endpoint
    msg_id: int  # uint64, drawn per broadcast
    ttl: int
    payload: "RapidRequest"


RapidRequest = Union[
    PreJoinMessage,
    JoinMessage,
    BatchedAlertMessage,
    ProbeMessage,
    FastRoundPhase2bMessage,
    Phase1aMessage,
    Phase1bMessage,
    Phase2aMessage,
    Phase2bMessage,
    LeaveMessage,
    GossipMessage,
    CohortCutMessage,
    DelegateDecisionMessage,
    GlobalTierMessage,
]


# --------------------------------------------------------------------------
# Response messages (the RapidResponse oneof, rapid.proto:37-45)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class JoinResponse:
    """``rapid.proto:74-83``."""

    sender: Endpoint
    status_code: JoinStatusCode
    configuration_id: int
    endpoints: Tuple[Endpoint, ...] = ()
    identifiers: Tuple[NodeId, ...] = ()
    metadata_keys: Tuple[Endpoint, ...] = ()
    metadata_values: Tuple[Tuple[Tuple[str, bytes], ...], ...] = ()


@dataclass(frozen=True)
class Response:
    """Empty acknowledgement (``rapid.proto:117-119``)."""


@dataclass(frozen=True)
class ConsensusResponse:
    """Empty consensus acknowledgement (``rapid.proto:172-174``)."""


@dataclass(frozen=True)
class ProbeResponse:
    """``rapid.proto:198-201``."""

    status: NodeStatus = NodeStatus.OK


RapidResponse = Union[JoinResponse, Response, ConsensusResponse, ProbeResponse]
