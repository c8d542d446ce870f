"""Classic single-decree Paxos with Fast Paxos's coordinator value-pick rule.

Semantics follow ``Paxos.java``: ranks are (round, node_index) tuples; round 1
is reserved for the single fast round; any node may start a classic round >= 2
as coordinator; the coordinator picks values per Figure 2 of the Fast Paxos
paper (``Paxos.java:271-328``). This is the rare recovery path, so it stays
host-side Python; the fast-round tally is what runs on TPU.

Transport-agnostic: the engine injects ``broadcast_fn(request)`` and
``send_fn(destination, request)`` (both fire-and-forget), matching the
reference's IBroadcaster / IMessagingClient seam.

A copy of ``rapid_tpu/protocol/paxos.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from rapid_tpu_torch.types import (
    Endpoint,
    Phase1aMessage,
    Phase1bMessage,
    Phase2aMessage,
    Phase2bMessage,
    Rank,
    RapidRequest,
)
from rapid_tpu_torch.utils.flight_recorder import EventName, FlightRecorder
from rapid_tpu_torch.utils.xxhash import xxh64

BroadcastFn = Callable[[RapidRequest], None]
SendFn = Callable[[Endpoint, RapidRequest], None]
OnDecideFn = Callable[[Tuple[Endpoint, ...]], None]


def node_index_of(endpoint: Endpoint) -> int:
    """Stable per-node rank index for classic rounds (the reference uses
    Java's Object.hashCode, Paxos.java:102)."""
    return xxh64(str(endpoint).encode("utf-8"), 0xC0FFEE) & 0x7FFFFFFF


class Paxos:
    def __init__(
        self,
        my_addr: Endpoint,
        configuration_id: int,
        membership_size: int,
        broadcast_fn: BroadcastFn,
        send_fn: SendFn,
        on_decide: OnDecideFn,
        recorder: Optional[FlightRecorder] = None,
        trace_supplier: Optional[Callable[[], Optional[int]]] = None,
    ) -> None:
        self.my_addr = my_addr
        self.configuration_id = configuration_id
        self.n = membership_size
        self._broadcast = broadcast_fn
        self._send = send_fn
        self._on_decide = on_decide
        # Observability: the owning FastPaxos threads the service's flight
        # recorder and trace-context supplier through, so every classic
        # message this engine emits carries the view change's trace id.
        self._recorder = recorder
        self._trace = trace_supplier if trace_supplier is not None else (lambda: None)

        self.rnd = Rank(0, 0)
        self.vrnd = Rank(0, 0)
        self.vval: Tuple[Endpoint, ...] = ()
        self.crnd = Rank(0, 0)
        self.cval: Tuple[Endpoint, ...] = ()
        self._phase1b_messages: Dict[Endpoint, Phase1bMessage] = {}
        self._accept_responses: Dict[Rank, Dict[Endpoint, Phase2bMessage]] = {}
        self.decided = False

    # -- coordinator ------------------------------------------------------

    def start_phase1a(self, round_number: int) -> None:
        """Become coordinator for ``round_number`` (Paxos.java:98-111).

        Re-entrant: the fallback re-arms with escalating rounds until a
        decision lands (lossy transports can eat an entire round's messages).
        Advancing to a higher rank discards the previous round's coordinator
        state — promises collected at an older crnd must never satisfy the
        new round's majority, and ``cval`` must be re-picked from the new
        round's phase1b quorum (the reference never re-enters,
        FastPaxos.java:189-195, because its transport never drops)."""
        if self.crnd.round > round_number:
            return
        rank = Rank(round_number, node_index_of(self.my_addr))
        if rank.as_tuple() > self.crnd.as_tuple():
            self.crnd = rank
            self._phase1b_messages = {}
            self.cval = ()
        self._broadcast(
            Phase1aMessage(
                sender=self.my_addr,
                configuration_id=self.configuration_id,
                rank=self.crnd,
                trace_id=self._trace(),
            )
        )

    def handle_phase1a(self, msg: Phase1aMessage) -> None:
        """Acceptor: promise to the highest rank seen (Paxos.java:118-148)."""
        if msg.configuration_id != self.configuration_id:
            return
        if self.rnd.as_tuple() < msg.rank.as_tuple():
            self.rnd = msg.rank
        else:
            return
        self._send(
            msg.sender,
            Phase1bMessage(
                sender=self.my_addr,
                configuration_id=self.configuration_id,
                rnd=self.rnd,
                vrnd=self.vrnd,
                vval=self.vval,
                trace_id=msg.trace_id if msg.trace_id is not None else self._trace(),
            ),
        )

    def handle_phase1b(self, msg: Phase1bMessage) -> None:
        """Coordinator: on a majority of promises, pick a value and send
        phase2a (Paxos.java:156-188)."""
        if msg.configuration_id != self.configuration_id:
            return
        if msg.rnd != self.crnd:
            return
        # Keyed by sender: redelivered promises must not inflate the majority
        # count (the reference appends to a list, Paxos.java:168, which is
        # unsafe under at-least-once transports).
        self._phase1b_messages[msg.sender] = msg
        if len(self._phase1b_messages) > self.n // 2:
            chosen = select_proposal_using_coordinator_rule(
                list(self._phase1b_messages.values()), self.n
            )
            if msg.rnd == self.crnd and not self.cval and chosen:
                self.cval = chosen
                if self._recorder is not None:
                    self._recorder.record(
                        EventName.CLASSIC_PHASE2A_TX,
                        config_id=self.configuration_id,
                        trace_id=self._trace(),
                        round=self.crnd.round,
                        proposal=[str(node) for node in chosen],
                    )
                self._broadcast(
                    Phase2aMessage(
                        sender=self.my_addr,
                        configuration_id=self.configuration_id,
                        rnd=self.crnd,
                        vval=chosen,
                        trace_id=self._trace(),
                    )
                )

    # -- acceptor ---------------------------------------------------------

    def handle_phase2a(self, msg: Phase2aMessage) -> None:
        """Acceptor: accept and echo phase2b (Paxos.java:195-216)."""
        if msg.configuration_id != self.configuration_id:
            return
        if self.rnd.as_tuple() <= msg.rnd.as_tuple() and self.vrnd != msg.rnd:
            self.rnd = msg.rnd
            self.vrnd = msg.rnd
            self.vval = msg.vval
            self._broadcast(
                Phase2bMessage(
                    sender=self.my_addr,
                    configuration_id=self.configuration_id,
                    rnd=msg.rnd,
                    endpoints=msg.vval,
                    trace_id=msg.trace_id if msg.trace_id is not None else self._trace(),
                )
            )

    # Classic rounds escalate while undecided (fast_paxos liveness tick), so
    # a long-lived partition would otherwise accumulate one accept-tally per
    # rank forever. Only the highest few ranks can still plausibly complete a
    # majority; pruning below them affects memory, never safety (a pruned
    # rank merely loses the ability to decide at that stale rank).
    _MAX_TRACKED_ACCEPT_RANKS = 8

    def handle_phase2b(self, msg: Phase2bMessage) -> None:
        """Learner: decide on a majority of identical-rank accepts
        (Paxos.java:223-238)."""
        if msg.configuration_id != self.configuration_id:
            return
        in_rnd = self._accept_responses.setdefault(msg.rnd, {})
        in_rnd[msg.sender] = msg
        if len(self._accept_responses) > self._MAX_TRACKED_ACCEPT_RANKS:
            oldest = min(self._accept_responses, key=lambda r: r.as_tuple())
            del self._accept_responses[oldest]
        if len(in_rnd) > self.n // 2 and not self.decided:
            self.decided = True
            self._on_decide(msg.endpoints)

    # -- fast-round bridge ------------------------------------------------

    def register_fast_round_vote(self, vote: Tuple[Endpoint, ...]) -> None:
        """Record our own implicit accept in the (only) fast round, round 1
        (Paxos.java:246-260)."""
        if self.rnd.round > 1:
            return
        self.rnd = Rank(1, 1)
        self.vrnd = self.rnd
        self.vval = tuple(vote)


def select_proposal_using_coordinator_rule(
    phase1b_messages: List[Phase1bMessage], n: int
) -> Tuple[Endpoint, ...]:
    """Figure 2 of the Fast Paxos paper (Paxos.java:271-328):

    - among the quorum's highest-vrnd non-empty vvals, a unique value wins;
    - else any value with more than N/4 occurrences wins;
    - else any non-empty vval may be proposed (empty if none voted).
    """
    if not phase1b_messages:
        raise ValueError("phase1b_messages must not be empty")
    max_vrnd = max(m.vrnd.as_tuple() for m in phase1b_messages)
    collected = [
        tuple(m.vval)
        for m in phase1b_messages
        if m.vrnd.as_tuple() == max_vrnd and len(m.vval) > 0
    ]
    unique = set(collected)
    if len(unique) == 1:
        return collected[0]
    if len(collected) > 1:
        counters: Dict[Tuple[Endpoint, ...], int] = {}
        for value in collected:
            count = counters.get(value, 0)
            if count + 1 > n // 4:
                return value
            counters[value] = count + 1
    for m in phase1b_messages:
        if len(m.vval) > 0:
            return tuple(m.vval)
    return ()
