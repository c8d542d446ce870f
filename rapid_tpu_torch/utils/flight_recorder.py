"""Per-node flight recorder: a bounded ring of structured protocol events
(a copy of ``rapid_tpu/utils/flight_recorder.py``).

Every node keeps a fixed-size ring of structured events stamped with its
protocol clock (simulated time included, utils/clock.py) and a correlation
key, the ``trace_id`` minted at the first alert of a configuration change.
``tools/traceview.py`` merges per-node rings into one causally-ordered
timeline. In the port the engine's decoded round-trace ring is rendered as
such a recording (``utils/engine_telemetry.trace_recorder_snapshot``).

Recording is a list store at an incrementing index; overwrite is the
intended behavior, so a recorder holds the last few view changes of context.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional

from rapid_tpu_torch.utils.clock import Clock
from rapid_tpu_torch.utils.xxhash import xxh64


def mint_trace_id(node: str, config_id: int, now_ms: float) -> int:
    """Mint the correlation key for one membership change: a u64 hash of
    (minting node, configuration, protocol-clock time). Deterministic given
    its inputs — crucially it does NOT consume the service's seeded ``rng``
    stream, so enabling tracing can never perturb peer selection or
    consensus jitter in a reproducible test. Never returns 0 (the wire
    treats the field as optional; 0 stays a valid, if unlikely, id — the
    guard just keeps minted ids visibly non-degenerate)."""
    value = xxh64(f"{node}|{config_id}|{now_ms}".encode("utf-8"), seed=0x7A11)
    return value or 1


class EventName(enum.Enum):
    """Registered flight-recorder event vocabulary.

    The JAX package's members, values and order: ``tools/traceview.py``
    ranks merged events by this vocabulary, so a recording from either
    package orders the same way.
    """

    # Alert pipeline
    ALERT_ENQUEUED = "alert_enqueued"
    ALERT_BATCH_TX = "alert_batch_tx"
    ALERT_BATCH_RX = "alert_batch_rx"
    ALERT_REDELIVERY = "alert_redelivery"
    # Cut detector watermarks
    CUT_L_CROSSED = "cut_l_crossed"
    CUT_H_CROSSED = "cut_h_crossed"
    CUT_RELEASED = "cut_released"
    # Consensus
    FAST_ROUND_PROPOSAL = "fast_round_proposal"
    FAST_ROUND_VOTE_RX = "fast_round_vote_rx"
    CLASSIC_ROUND_START = "classic_round_start"
    CLASSIC_PHASE2A_TX = "classic_phase2a_tx"
    CONSENSUS_DECIDED = "consensus_decided"
    # Hierarchical membership (rapid_tpu/hier): cohort fast path + global tier
    COHORT_CUT_DECIDED = "cohort_cut_decided"
    COHORT_CUT_FORWARDED = "cohort_cut_forwarded"
    COHORT_CUT_RX = "cohort_cut_rx"
    GLOBAL_DECISION = "global_decision"
    # View lifecycle
    VIEW_CHANGE = "view_change"
    KICKED = "kicked"
    # Delivery-liveness machinery
    CATCH_UP_PULL = "catch_up_pull"
    CATCH_UP_RESULT = "catch_up_result"
    CONFIG_BEACON_TX = "config_beacon_tx"
    UNKNOWN_JOINER_WEDGE = "unknown_joiner_wedge"
    # Device engine round-trace ring (models/state.TraceRing): one decoded
    # ring record per fused-engine round, synthesized at fetch boundaries by
    # utils/engine_telemetry.trace_recorder_snapshot so traceview merges
    # device rounds into the same timeline as host and chaos lanes.
    ENGINE_ROUND = "engine_round"
    ENGINE_CONFLICT = "engine_conflict"
    ENGINE_DECISION = "engine_decision"

    # Causal phase rank within one membership change: used by traceview to
    # order events that share a timestamp (simulated clocks tick coarsely).
    @property
    def phase_rank(self) -> int:
        return _PHASE_RANK[self]


_PHASE_RANK: Dict[EventName, int] = {
    EventName.ALERT_ENQUEUED: 0,
    EventName.ALERT_BATCH_TX: 1,
    EventName.ALERT_REDELIVERY: 1,
    EventName.ALERT_BATCH_RX: 2,
    EventName.CUT_L_CROSSED: 3,
    EventName.CUT_H_CROSSED: 4,
    EventName.CUT_RELEASED: 5,
    EventName.FAST_ROUND_PROPOSAL: 6,
    EventName.FAST_ROUND_VOTE_RX: 7,
    EventName.CLASSIC_ROUND_START: 8,
    EventName.CLASSIC_PHASE2A_TX: 9,
    EventName.CONSENSUS_DECIDED: 10,
    # The hierarchy's second tier runs after a cohort's consensus decided
    # and before the view change delivers: rank between them.
    EventName.COHORT_CUT_DECIDED: 10,
    EventName.COHORT_CUT_FORWARDED: 11,
    EventName.COHORT_CUT_RX: 11,
    EventName.GLOBAL_DECISION: 12,
    EventName.CATCH_UP_PULL: 11,
    EventName.CATCH_UP_RESULT: 12,
    EventName.CONFIG_BEACON_TX: 11,
    EventName.UNKNOWN_JOINER_WEDGE: 12,
    EventName.VIEW_CHANGE: 13,
    EventName.KICKED: 13,
    # Device rounds: the round record opens its timestamp's pipeline; the
    # conflict flag aligns with the classic-fallback window and the decision
    # with CONSENSUS_DECIDED, so a host recording and a decoded ring of the
    # same scenario interleave in causal order at equal timestamps.
    EventName.ENGINE_ROUND: 0,
    EventName.ENGINE_CONFLICT: 9,
    EventName.ENGINE_DECISION: 10,
}


class FlightEvent:
    """One recorded protocol event. Plain attributes, not a dataclass: the
    recorder allocates one of these per record() on the protocol hot path."""

    __slots__ = ("seq", "t_ms", "node", "name", "config_id", "trace_id", "fields")

    def __init__(
        self,
        seq: int,
        t_ms: float,
        node: str,
        name: EventName,
        config_id: Optional[int],
        trace_id: Optional[int],
        fields: Dict[str, Any],
    ) -> None:
        self.seq = seq
        self.t_ms = t_ms
        self.node = node
        self.name = name
        self.config_id = config_id
        self.trace_id = trace_id
        self.fields = fields

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seq": self.seq,
            "t_ms": self.t_ms,
            "node": self.node,
            "name": self.name.value,
            "config_id": self.config_id,
            "trace_id": self.trace_id,
            "fields": self.fields,
        }

    def __repr__(self) -> str:  # debugging aid, not wire format
        return (
            f"FlightEvent(#{self.seq} t={self.t_ms} {self.node} "
            f"{self.name.value} cfg={self.config_id} trace={self.trace_id} "
            f"{self.fields})"
        )


class FlightRecorder:
    """Fixed-capacity ring buffer of :class:`FlightEvent`.

    ``clock`` is the owning component's protocol clock — under
    ``ManualClock`` the recording carries simulated timestamps, which is
    what makes recordings from a simulated-time test mergeable.
    """

    DEFAULT_CAPACITY = 512

    def __init__(self, node: str, clock: Clock, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.node = node
        self.capacity = capacity
        self._clock = clock
        self._buf: List[Optional[FlightEvent]] = [None] * capacity
        self._total = 0  # events ever recorded; ring index = seq % capacity

    # -- recording -----------------------------------------------------

    def record(
        self,
        name: EventName,
        config_id: Optional[int] = None,
        trace_id: Optional[int] = None,
        **fields: Any,
    ) -> FlightEvent:
        event = FlightEvent(
            seq=self._total,
            t_ms=self._clock.now_ms(),
            node=self.node,
            name=name,
            config_id=config_id,
            trace_id=trace_id,
            fields=fields,
        )
        self._buf[self._total % self.capacity] = event
        self._total += 1
        return event

    # -- inspection ----------------------------------------------------

    def __len__(self) -> int:
        """Events currently held (== depth gauge in the exposition)."""
        return min(self._total, self.capacity)

    @property
    def recorded_total(self) -> int:
        return self._total

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wraparound."""
        return max(0, self._total - self.capacity)

    def events(self) -> List[FlightEvent]:
        """Held events, oldest first."""
        if self._total <= self.capacity:
            return [e for e in self._buf[: self._total] if e is not None]
        start = self._total % self.capacity
        out = self._buf[start:] + self._buf[:start]
        return [e for e in out if e is not None]

    def tail(self, n: int) -> List[FlightEvent]:
        return self.events()[-n:] if n > 0 else []

    def snapshot(self, tail: Optional[int] = None) -> Dict[str, Any]:
        """JSON-ready recording: metadata + (tail of) the event ring. This is
        the per-node artifact ``tools/traceview.py`` merges."""
        events = self.events() if tail is None else self.tail(tail)
        return {
            "node": self.node,
            "capacity": self.capacity,
            "recorded_total": self._total,
            "dropped": self.dropped,
            "events": [e.to_dict() for e in events],
        }
