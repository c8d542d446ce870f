"""Leaderless Fast Paxos: count identical cut proposals; fall back to classic
Paxos on a jittered timer.

Semantics follow ``FastPaxos.java``: every node broadcasts its proposal as an
implicit fast-round phase2b vote; a node decides once it has seen
``N - F`` votes total *and* ``N - F`` votes for one identical proposal, where
``F = floor((N-1)/4)`` (``FastPaxos.java:125-156``). Each ``propose`` also arms
a classic-round fallback after an expovariate jitter with rate 1/N over a base
delay (``FastPaxos.java:200-203``), cancelled on decision.

The same tally runs batched on the device in ``rapid_tpu_torch.ops.consensus``,
whose ``fast_paxos_quorum`` is the port's one definition of the quorum rule;
this class is the per-node host engine and oracle (a copy of
``rapid_tpu/protocol/fast_paxos.py``).
"""

from __future__ import annotations

import math
import random
from typing import Callable, Dict, Optional, Sequence, Set, Tuple

from rapid_tpu_torch.ops.consensus import fast_paxos_quorum
from rapid_tpu_torch.protocol.paxos import BroadcastFn, OnDecideFn, Paxos, SendFn
from rapid_tpu_torch.utils.flight_recorder import EventName, FlightRecorder
from rapid_tpu_torch.types import (
    ConsensusResponse,
    Endpoint,
    FastRoundPhase2bMessage,
    Phase1aMessage,
    Phase1bMessage,
    Phase2aMessage,
    Phase2bMessage,
    RapidRequest,
    RapidResponse,
)
from rapid_tpu_torch.utils.clock import CancelHandle, Clock

BASE_DELAY_MS = 1000


class FastPaxos:
    def __init__(
        self,
        my_addr: Endpoint,
        configuration_id: int,
        membership_size: int,
        broadcast_fn: BroadcastFn,
        send_fn: SendFn,
        on_decide: OnDecideFn,
        clock: Clock,
        consensus_fallback_base_delay_ms: int = BASE_DELAY_MS,
        rng: Optional[random.Random] = None,
        vote_tally=None,
        on_classic_round=None,
        recorder: Optional[FlightRecorder] = None,
        trace_supplier: Optional[Callable[[], Optional[int]]] = None,
    ) -> None:
        self.my_addr = my_addr
        self.configuration_id = configuration_id
        self.n = membership_size
        self._broadcast = broadcast_fn
        self._clock = clock
        self._base_delay_ms = consensus_fallback_base_delay_ms
        # Identity-seeded default (the service always injects its own rng;
        # this covers direct construction): decorrelated across nodes AND
        # configurations, reproducible across runs.
        self._rng = (
            rng
            if rng is not None
            else random.Random(f"paxos:{my_addr}:{configuration_id}")
        )
        # Pluggable tally: None = host hash-map counting; a DeviceVoteTally
        # turns each vote into a device-array write with the quorum check on
        # the accelerator (rapid_tpu_torch.protocol.device_vote_tally).
        self._vote_tally = vote_tally
        # Observer hook: fires when the jittered fallback actually engages a
        # classic round (i.e. the fast round failed to clear in time). The
        # membership service routes this to the declared-but-never-fired
        # reference event VIEW_CHANGE_ONE_STEP_FAILED.
        self._on_classic_round = on_classic_round
        self._votes_per_proposal: Dict[Tuple[Endpoint, ...], int] = {}
        self._votes_received: Set[Endpoint] = set()
        self.decided = False
        #: Which path produced the decision: "fast" (round-1 quorum of
        #: identical votes) or "classic" (the fallback's Paxos learner).
        #: None until decided. The service labels the agreement-phase
        #: histogram with it — the fast/classic split arXiv:1308.1358
        #: identifies as the boundary worth measuring.
        self.decided_path: Optional[str] = None
        self._fallback_task: Optional[CancelHandle] = None
        self._cancelled = False
        self._my_proposal: Optional[Tuple[Endpoint, ...]] = None
        # Classic rounds escalate 2, 3, 4, ... on every liveness tick until a
        # decision lands — the host-side twin of the engine's per-epoch
        # classic-attempt rotation (models/virtual_cluster.py classic_epoch).
        self._next_classic_round = 2

        # Observability: the service's flight recorder + trace-context
        # supplier; every outgoing vote and the decision event carry the
        # membership change's correlation key.
        self._recorder = recorder
        self._trace = trace_supplier if trace_supplier is not None else (lambda: None)

        def on_decide_wrapped(hosts: Tuple[Endpoint, ...]) -> None:
            if self.decided:
                return
            self.decided = True
            # The classic learner (Paxos.handle_phase2b) latches its own
            # decided flag before invoking us; the fast-round tally calls
            # straight in — so the inner engine's flag tells the paths apart.
            self.decided_path = "classic" if self.paxos.decided else "fast"
            if self._fallback_task is not None:
                self._fallback_task.cancel()
            if self._recorder is not None:
                self._recorder.record(
                    EventName.CONSENSUS_DECIDED,
                    config_id=self.configuration_id,
                    trace_id=self._trace(),
                    proposal=[str(node) for node in hosts],
                    path=self.decided_path,
                )
            on_decide(hosts)

        self._on_decide = on_decide_wrapped
        self.paxos = Paxos(
            my_addr, configuration_id, membership_size, broadcast_fn, send_fn,
            on_decide_wrapped, recorder=recorder, trace_supplier=trace_supplier,
        )

    def propose(
        self, proposal: Sequence[Endpoint], recovery_delay_ms: Optional[float] = None
    ) -> None:
        """Vote for ``proposal`` in the fast round and arm the classic-round
        fallback (FastPaxos.java:94-108).

        Unlike the reference — whose transport guarantees delivery, so one
        broadcast and one single-shot fallback suffice — the fallback here is
        a recurring liveness tick: every firing re-broadcasts the fast-round
        vote (receivers dedup by sender) and escalates one classic round,
        re-armed with fresh jitter until the decision lands. One lost
        datagram therefore costs one fallback period, never liveness."""
        proposal = tuple(proposal)
        self._my_proposal = proposal
        self.paxos.register_fast_round_vote(proposal)
        self._broadcast(
            FastRoundPhase2bMessage(
                sender=self.my_addr,
                configuration_id=self.configuration_id,
                endpoints=proposal,
                trace_id=self._trace(),
            )
        )
        self._arm_liveness(recovery_delay_ms)

    def _arm_liveness(self, delay_ms: Optional[float] = None) -> None:
        if self._cancelled or self.decided:
            return
        if delay_ms is None:
            delay_ms = self._random_delay_ms()
        self._fallback_task = self._clock.call_later_ms(delay_ms, self._liveness_tick)

    def _liveness_tick(self) -> None:
        if self._cancelled or self.decided:
            return
        if self._my_proposal is not None:
            # Re-offer our fast-round vote: a late quorum can still decide in
            # round 1, and it re-seeds vval for any classic coordinator.
            self._broadcast(
                FastRoundPhase2bMessage(
                    sender=self.my_addr,
                    configuration_id=self.configuration_id,
                    endpoints=self._my_proposal,
                    trace_id=self._trace(),
                )
            )
        self.start_classic_paxos_round()
        self._arm_liveness()

    def handle_message(self, request: RapidRequest) -> RapidResponse:
        """Route the five consensus message types (FastPaxos.java:163-184)."""
        if isinstance(request, FastRoundPhase2bMessage):
            self._handle_fast_round_vote(request)
        elif isinstance(request, Phase1aMessage):
            self.paxos.handle_phase1a(request)
        elif isinstance(request, Phase1bMessage):
            self.paxos.handle_phase1b(request)
        elif isinstance(request, Phase2aMessage):
            self.paxos.handle_phase2a(request)
        elif isinstance(request, Phase2bMessage):
            self.paxos.handle_phase2b(request)
        else:
            raise TypeError(f"unexpected consensus message: {type(request)!r}")
        return ConsensusResponse()

    def _handle_fast_round_vote(self, msg: FastRoundPhase2bMessage) -> None:
        """FastPaxos.java:125-156."""
        if msg.configuration_id != self.configuration_id:
            return
        if self.decided:
            return
        proposal = tuple(msg.endpoints)
        if self._recorder is not None:
            self._recorder.record(
                EventName.FAST_ROUND_VOTE_RX,
                config_id=self.configuration_id,
                trace_id=msg.trace_id if msg.trace_id is not None else self._trace(),
                voter=str(msg.sender),
            )
        if self._vote_tally is not None:
            winner = self._vote_tally.add_vote(msg.sender, proposal)
            if winner is not None:
                self._on_decide(winner)
            return
        if msg.sender in self._votes_received:
            return
        self._votes_received.add(msg.sender)
        count = self._votes_per_proposal.get(proposal, 0) + 1
        self._votes_per_proposal[proposal] = count
        quorum = fast_paxos_quorum(self.n)
        if len(self._votes_received) >= quorum and count >= quorum:
            self._on_decide(proposal)

    def start_classic_paxos_round(self) -> None:
        """Fallback entry: classic rounds start at round 2 and escalate by
        one on each re-entry (FastPaxos.java:189-195 starts round 2 exactly
        once; the escalation is this implementation's liveness replacement
        for the reference's reliable transport)."""
        if not self.decided:
            if self._on_classic_round is not None:
                # Fires per classic round started (the metric's meaning);
                # the service gates the once-per-configuration
                # VIEW_CHANGE_ONE_STEP_FAILED event itself.
                self._on_classic_round()
            if self._recorder is not None:
                # One event per engagement AND per escalation: the round
                # number distinguishes them in the merged timeline.
                self._recorder.record(
                    EventName.CLASSIC_ROUND_START,
                    config_id=self.configuration_id,
                    trace_id=self._trace(),
                    round=self._next_classic_round,
                )
            self.paxos.start_phase1a(self._next_classic_round)
            self._next_classic_round += 1

    def cancel_fallback(self) -> None:
        self._cancelled = True
        if self._fallback_task is not None:
            self._fallback_task.cancel()

    def _random_delay_ms(self) -> float:
        """Expovariate jitter with rate 1/N over the base delay, keeping the
        expected number of concurrent classic coordinators ~constant
        (FastPaxos.java:200-203)."""
        jitter_rate = 1.0 / max(self.n, 1)
        jitter = -1000.0 * math.log(1.0 - self._rng.random()) / jitter_rate
        return jitter + self._base_delay_ms
