"""The membership service: single protocol engine per endpoint.

Orchestration semantics follow ``MembershipService.java``: one serialized
protocol context handles every message (the reference serializes via a
single-thread executor, ``SharedResources.java:53``; here an asyncio lock),
owns alert batching (100 ms quiescence window), join bookkeeping, failure-
detector scheduling, and view-change application.

Message flow (MembershipService.java:174-196): every RapidRequest enters
``handle_message``; alerts feed the cut detector; a released cut becomes a
Fast Paxos proposal; the decision mutates the K-ring view, notifies
subscribers, re-arms failure detectors, and unblocks joiners.

A copy of ``rapid_tpu/protocol/service.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

import asyncio
import logging
import random
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set, Tuple

from rapid_tpu_torch.errors import NodeNotInRingError
from rapid_tpu_torch.messaging.base import Broadcaster, MessagingClient, UnicastToAllBroadcaster
from rapid_tpu_torch.monitoring.base import EdgeFailureDetectorFactory
from rapid_tpu_torch.protocol.cut_detector import MultiNodeCutDetector
from rapid_tpu_torch.protocol.events import ClusterEvents, ClusterStatusChange, NodeStatusChange
from rapid_tpu_torch.protocol.fast_paxos import FastPaxos
from rapid_tpu_torch.protocol.metadata import FrozenMetadata, MetadataManager
from rapid_tpu_torch.protocol.view import MembershipView
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import (
    AlertMessage,
    BatchedAlertMessage,
    CohortCutMessage,
    DelegateDecisionMessage,
    EdgeStatus,
    Endpoint,
    FastRoundPhase2bMessage,
    GlobalTierMessage,
    JoinMessage,
    JoinResponse,
    JoinStatusCode,
    LeaveMessage,
    NodeId,
    Phase1aMessage,
    Phase1bMessage,
    Phase2aMessage,
    Phase2bMessage,
    PreJoinMessage,
    ProbeMessage,
    ProbeResponse,
    RapidRequest,
    RapidResponse,
    Response,
)
from rapid_tpu_torch.utils import exposition
from rapid_tpu_torch.utils.clock import AsyncioClock, Clock
from rapid_tpu_torch.utils.flight_recorder import EventName, FlightRecorder, mint_trace_id
from rapid_tpu_torch.utils.health import NodeHealth
from rapid_tpu_torch.utils.metrics import Metrics

LOG = logging.getLogger(__name__)

CONSENSUS_TYPES = (
    FastRoundPhase2bMessage,
    Phase1aMessage,
    Phase1bMessage,
    Phase2aMessage,
    Phase2bMessage,
)

#: Hierarchical-membership traffic (rapid_tpu/hier). The flat service
#: acknowledges-and-ignores these (a flat node can share a wire with a
#: hierarchical cluster without raising); HierMembershipService overrides
#: ``_handle_hier_message`` with the real cohort/global-tier routing.
HIER_TYPES = (CohortCutMessage, DelegateDecisionMessage, GlobalTierMessage)

#: Member-initiated config pulls ride the join phase-2 handler stamped with
#: the requester's CURRENT configuration id: an up-to-date peer recognizes a
#: member asking about the configuration it already inhabits and answers with
#: a compact "unchanged" response instead of streaming the full O(N)
#: configuration (the idle heartbeat fires every 30 s on every member — at
#: production N the difference is the whole cost of the heartbeat). A peer on
#: a DIFFERENT configuration takes the mismatch branch and streams, exactly
#: as it does for the joiner's -1 sentinel after HOSTNAME_ALREADY_IN_RING
#: (Cluster.java:374-381).
#:
#: Java-topology clusters keep the -1 sentinel instead: that mode exists so a
#: reference JVM peer can share the ring (PARITY.md), and the reference's
#: phase-2 handler has no unchanged fast path — a config-id MATCH there parks
#: the response future behind a (filtered, never-decided) UP alert until RPC
#: timeout and pollutes the peer's alert stream every heartbeat. The sentinel
#: is guaranteed to mismatch, so any implementation answers immediately.
#: Native-topology clusters cannot contain reference peers (ring orders and
#: configuration ids diverge at the first hash), so the optimization is safe
#: exactly where it is enabled.
CATCH_UP_CONFIG_ID = -1

#: Alert batches are re-broadcast unconditionally this many times (our own
#: copy of the original broadcast may itself have been lost, leaving us with
#: no local evidence that a cut is pending), then only while the cut detector
#: or consensus still shows the cut unresolved, capped at _MAX_REDELIVERIES so
#: a permanently sub-L straggler report cannot generate traffic forever.
_UNCONDITIONAL_REDELIVERIES = 5
_MAX_REDELIVERIES = 30

#: Config-sync pulls per configuration when the only suspicion is an
#: unresolved cut report (a permanently sub-L straggler would otherwise pull
#: a full membership snapshot every interval forever — same rationale as
#: _MAX_REDELIVERIES). The stronger suspicions — an undecided proposal, or a
#: decision we could not apply — stay uncapped: those states MUST resolve and
#: the traffic stops the moment they do.
_MAX_REPORT_ONLY_SYNC_PULLS = 30

#: Futile decided-config catch-up pulls before the wedge is escalated to an
#: ERROR log + flight-recorder event + metrics counter. The pulls themselves
#: stay uncapped (a decision we could not apply MUST eventually resolve, and
#: the only path is a pull), but a cluster that crashed between deciding and
#: answering leaves this node retrying forever — after this many futile
#: attempts that retry loop becomes an observable incident instead of a
#: silent one.
_WEDGED_PULLS_ERROR_THRESHOLD = 100

#: Phase-decomposed convergence SLO timer (utils/metrics.py phase family):
#: one membership change splits into detection (first alert evidence ->
#: proposal release, i.e. the H-watermark crossing that frees the cut),
#: agreement (proposal -> consensus decision, labeled fast/classic by which
#: path decided — the boundary arXiv:1308.1358 measures), and delivery
#: (decision -> view applied + subscribers notified). Rendered as
#: ``rapid_view_change_phase_ms_bucket{phase=...}`` histograms.
_PHASE_TIMER = "view_change_phase"
_MARK_DETECTION = "vc_phase_detection"
_MARK_AGREEMENT = "vc_phase_agreement"
_MARK_DELIVERY = "vc_phase_delivery"


class MembershipService:
    def __init__(
        self,
        my_addr: Endpoint,
        cut_detector: MultiNodeCutDetector,
        view: MembershipView,
        settings: Settings,
        client: MessagingClient,
        fd_factory: EdgeFailureDetectorFactory,
        metadata_map: Optional[Dict[Endpoint, FrozenMetadata]] = None,
        subscriptions: Optional[Dict[ClusterEvents, List]] = None,
        clock: Optional[Clock] = None,
        broadcaster: Optional[Broadcaster] = None,
        rng: Optional[random.Random] = None,
        vote_tally_factory=None,
        node_id: Optional[NodeId] = None,
    ) -> None:
        self.my_addr = my_addr
        # This node's own identifier. Required for the config catch-up path
        # (the pull rides the join phase-2 config-stream branch, which
        # authenticates membership by endpoint + identifier); without it the
        # service falls back to reference-style KICKED recovery.
        self.node_id = node_id
        self.settings = settings
        # The `# guarded-by:` comments below are machine-checked annotations
        # (tools/analysis/concurrency.py): a field marked `_lock` may only
        # be MUTATED while the protocol executor is held; one marked
        # `event-loop` is confined to cooperative scheduling (no lock
        # required, but no read->await->write may straddle an await).
        self.view = view  # guarded-by: _lock
        self.cut_detector = cut_detector
        self.client = client
        self.fd_factory = fd_factory
        self.clock = clock if clock is not None else AsyncioClock()
        # Identity-seeded default: per-node jitter streams stay decorrelated
        # (different endpoints, different seeds) but every run of the same
        # node is reproducible — the determinism-audit contract the chaos
        # subsystem (rapid_tpu/sim) builds on. Callers wanting entropy can
        # still inject random.Random(None) explicitly.
        self.rng = rng if rng is not None else random.Random(f"rapid:{my_addr}")
        self.metadata_manager = MetadataManager()  # guarded-by: _lock
        if metadata_map:
            self.metadata_manager.add_metadata(metadata_map)
        self.broadcaster = (
            broadcaster if broadcaster is not None else UnicastToAllBroadcaster(client, self.rng)
        )
        # vote_tally_factory(membership_size) -> tally object, re-created per
        # configuration (e.g. rapid_tpu_torch.protocol.device_vote_tally.DeviceVoteTally).
        self._vote_tally_factory = vote_tally_factory
        self.subscriptions: Dict[ClusterEvents, List] = {event: [] for event in ClusterEvents}
        if subscriptions:
            for event, callbacks in subscriptions.items():
                self.subscriptions[event].extend(callbacks)

        # The protocol clock is the metrics clock: timers/marks measure
        # simulated time correctly under ManualClock (wall clock would skew
        # every phase SLO in simulated-time tests and engines).
        self.metrics = Metrics(now_ms=self.clock.now_ms)
        self._convergence_timing = False  # guarded-by: _lock
        self._lock = asyncio.Lock()  # the "protocol executor"
        self._joiners_to_respond_to: Dict[Endpoint, List[asyncio.Future]] = {}  # guarded-by: _lock
        self._joiner_uuid: Dict[Endpoint, NodeId] = {}  # guarded-by: _lock
        self._joiner_metadata: Dict[Endpoint, FrozenMetadata] = {}  # guarded-by: _lock
        self._announced_proposal = False  # guarded-by: _lock
        self._send_queue: List[AlertMessage] = []  # guarded-by: _lock
        self._last_enqueue_ms: float = -1.0  # guarded-by: _lock
        self._background_tasks: List[asyncio.Task] = []  # guarded-by: event-loop
        self._fd_tasks: List[asyncio.Task] = []  # guarded-by: event-loop
        self._fd_generation = 0  # guarded-by: event-loop
        self._stopped = False  # guarded-by: event-loop
        # Delivery-liveness state (droppable transports; settings.py):
        # alerts broadcast for the current configuration (redelivery buffer),
        # catch-up bookkeeping, and the config-id history used to tell
        # straggler traffic from evidence of an unknown configuration.
        self._alerts_sent: List[AlertMessage] = []  # guarded-by: _lock
        self._redeliveries_this_config = 0  # guarded-by: _lock
        self._catch_up_inflight = False  # guarded-by: event-loop
        self._catch_up_tasks: Set[asyncio.Task] = set()  # guarded-by: event-loop
        # Edge-failure notifications spawned from failure-detector callbacks:
        # tracked so the loop cannot garbage-collect one mid-flight and so
        # shutdown can cancel-and-await instead of orphaning them.
        self._edge_notify_tasks: Set[asyncio.Task] = set()  # guarded-by: event-loop
        self._last_catch_up_ms = float("-inf")  # guarded-by: event-loop
        self._last_beacon_ms = float("-inf")  # guarded-by: event-loop
        # Idle-heartbeat timer starts at construction: a fresh node is
        # current by definition and owes no immediate anti-entropy pull.
        self._last_idle_sync_ms = self.clock.now_ms()  # guarded-by: event-loop
        self._decision_pending_catch_up = False  # guarded-by: _lock
        self._kicked_signalled = False  # guarded-by: _lock
        self._report_only_sync_pulls = 0  # guarded-by: _lock
        self._undecided_suspicion_ticks = 0  # guarded-by: _lock
        self._wedged_pulls = 0  # guarded-by: _lock
        self._one_step_failed_notified = False  # guarded-by: _lock
        self._known_config_ids: "OrderedDict[int, bool]" = OrderedDict()  # guarded-by: _lock
        self._remember_config_id(self.view.configuration_id)

        # Observability: per-node flight recorder (utils/flight_recorder.py)
        # and the trace-context key for the membership change currently in
        # flight — minted at the first local alert, adopted from the first
        # traced inbound message, cleared when the view change commits.
        self.recorder = FlightRecorder(node=str(my_addr), clock=self.clock)
        self._trace_id: Optional[int] = None  # guarded-by: _lock
        if hasattr(self.cut_detector, "bind_recorder"):
            self.cut_detector.bind_recorder(self.recorder, lambda: self._trace_id)

        self.broadcaster.set_membership(self.view.ring(0))
        self._fast_paxos = self._new_fast_paxos()  # guarded-by: _lock

        # The recording opens with the configuration this node entered
        # (bootstrap or join): a merged timeline then shows every node, even
        # one that crashes before it ever witnesses a membership change.
        self.recorder.record(
            EventName.VIEW_CHANGE,
            config_id=self.view.configuration_id,
            membership_size=self.view.membership_size,
            changes=0,
            origin="startup",
        )

        # Inform the application that the start/join completed
        # (MembershipService.java:162-168).
        self._notify(ClusterEvents.VIEW_CHANGE, self._initial_view_change())

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        """Arm the alert batcher, delivery-liveness loops, and failure
        detectors."""
        self._background_tasks.append(asyncio.ensure_future(self._alert_batcher_loop()))
        self._background_tasks.append(asyncio.ensure_future(self._alert_redelivery_loop()))
        self._background_tasks.append(asyncio.ensure_future(self._config_sync_loop()))
        self._create_failure_detectors()

    async def shutdown(self) -> None:
        self._stopped = True
        self._fast_paxos.cancel_fallback()
        fd_tasks = self._cancel_failure_detectors()
        # Snapshot-and-clear BEFORE awaiting (the interleaving-hazard
        # analysis caught the old shape — read into gather, clear() after
        # it — which would silently drop any task appended mid-await).
        background_tasks, self._background_tasks = self._background_tasks, []
        for task in background_tasks:
            task.cancel()
        catch_up_tasks = list(self._catch_up_tasks)
        for task in catch_up_tasks:
            task.cancel()
        notify_tasks = list(self._edge_notify_tasks)
        for task in notify_tasks:
            task.cancel()
        # Await detectors too: a mid-tick probe must finish (or unwind) before
        # the client underneath it is shut down.
        await asyncio.gather(
            *background_tasks, *fd_tasks, *catch_up_tasks, *notify_tasks,
            return_exceptions=True,
        )
        await self.client.shutdown()

    # ------------------------------------------------------------------
    # accessors (Cluster API surface)
    # ------------------------------------------------------------------

    @property
    def membership(self) -> List[Endpoint]:
        return self.view.ring(0)

    @property
    def membership_size(self) -> int:
        return self.view.membership_size

    def get_metadata(self) -> Dict[Endpoint, FrozenMetadata]:
        return self.metadata_manager.get_all_metadata()

    def register_subscription(self, event: ClusterEvents, callback) -> None:
        self.subscriptions[event].append(callback)

    # ------------------------------------------------------------------
    # observability surface (utils/exposition.py)
    # ------------------------------------------------------------------

    def health(self) -> NodeHealth:
        """This node's health state (utils/health.py vocabulary), derived
        from the protocol's own suspicion machinery — worst condition wins:

        - WEDGED: the decided-config catch-up escalated (futile pulls past
          the error threshold), or the node was evicted (KICKED) — both need
          the application/operator to rejoin or restart;
        - CATCHING_UP: a decided configuration could not be applied locally
          and is being pulled from peers;
        - PROPOSING: a cut proposal announced, consensus undecided;
        - DETECTING: edge reports held below H, or alerts queued to send;
        - STABLE: none of the above.
        """
        if self._kicked_signalled or self._wedged_pulls >= _WEDGED_PULLS_ERROR_THRESHOLD:
            return NodeHealth.WEDGED
        if self._decision_pending_catch_up:
            return NodeHealth.CATCHING_UP
        if self._consensus_pending():
            return NodeHealth.PROPOSING
        if self._send_queue or self.cut_detector.has_pending_reports():
            return NodeHealth.DETECTING
        return NodeHealth.STABLE

    def telemetry_snapshot(self, recorder_tail: Optional[int] = None) -> Dict[str, object]:
        """One unified telemetry snapshot: protocol metrics, health state,
        transport accounting (when the client keeps ``TransportStats``), and
        the flight recording. ``recorder_tail`` bounds the events included
        (None = the whole ring). This dict is the artifact the standalone
        agent's ``--metrics-dump`` writes and ``tools/traceview.py`` /
        ``tools/clustertop.py`` consume."""
        stats = getattr(self.client, "stats", None)
        return {
            "node": str(self.my_addr),
            "configuration_id": self.view.configuration_id,
            "membership_size": self.view.membership_size,
            "health": self.health().value,
            "trace_id": self._trace_id,
            "metrics": self.metrics.summary(),
            "transport": {"client": stats.snapshot() if stats is not None else None},
            "recorder": self.recorder.snapshot(tail=recorder_tail),
        }

    def prometheus_text(self) -> str:
        """The node's telemetry in Prometheus text exposition format, under
        the stable metric names pinned by tests/test_observability.py."""
        return exposition.prometheus_text(self.telemetry_snapshot(recorder_tail=0))

    # ------------------------------------------------------------------
    # message entry point (MembershipService.java:174-196)
    # ------------------------------------------------------------------

    async def handle_message(self, request: RapidRequest) -> RapidResponse:
        # dispatched-elsewhere: GossipMessage — gossip envelopes are
        # unwrapped by the broadcaster's router facade (messaging/gossip.py
        # GossipRouter, installed via Cluster._server_handler) which relays
        # and then forwards only the PAYLOAD here; a raw GossipMessage never
        # reaches this chain. The dispatch analyzer verifies the exemption.
        if isinstance(request, ProbeMessage):
            # Probes bypass the protocol context (MembershipService.java:449-452).
            return ProbeResponse()
        if isinstance(request, PreJoinMessage):
            async with self._lock:
                return self._handle_pre_join(request)
        if isinstance(request, JoinMessage):
            async with self._lock:
                future = self._handle_join_phase2(request)
            if isinstance(future, asyncio.Future):
                return await future
            return future
        if isinstance(request, BatchedAlertMessage):
            self._note_config_evidence(request)
            async with self._lock:
                return self._handle_batched_alerts(request)
        if isinstance(request, CONSENSUS_TYPES):
            self._note_config_evidence(request)
            async with self._lock:
                self._adopt_trace(request.trace_id)
                return self._fast_paxos.handle_message(request)
        if isinstance(request, LeaveMessage):
            async with self._lock:
                self._edge_failure_notification(
                    request.sender, self.view.configuration_id
                )
            return Response()
        if isinstance(request, HIER_TYPES):
            self._note_config_evidence(request)
            async with self._lock:
                return self._handle_hier_message(request)
        raise TypeError(f"unidentified request type {type(request)!r}")

    # ------------------------------------------------------------------
    # join protocol, server side
    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # hierarchy seams (rapid_tpu/hier overrides these; flat defaults here)
    # ------------------------------------------------------------------

    def _handle_hier_message(self, request: RapidRequest) -> RapidResponse:
        """Cohort-cut / delegate / global-tier traffic. Flat mode has no
        hierarchy: acknowledge and ignore (a stray hier frame must not crash
        a flat node). HierMembershipService overrides with real routing."""
        LOG.debug(
            "%s ignoring hierarchical message %s (flat topology)",
            self.my_addr, type(request).__name__,
        )
        return Response()

    def _monitor_topology(self):
        """Who monitors whom: an object answering ``subjects_of`` /
        ``observers_of`` / ``expected_observers_of`` / ``ring_numbers``.
        Flat mode monitors over the full K-ring view; hierarchical mode
        returns the cohort-scoped topology (rapid_tpu/hier/cohorts.py)."""
        return self.view

    def _cut_view(self):
        """The view the cut detector's implicit edge invalidation walks:
        the full view in flat mode, the node's cohort mini-view in
        hierarchical mode (ring numbers must come from the same ring space
        the explicit alerts used)."""
        return self.view

    def _consensus_pending(self) -> bool:
        """True while a membership change this node knows about is agreed
        but not yet applied — the suspicion signal the redelivery and
        config-sync loops (and the health model) act on. Hierarchical mode
        extends it with 'cohort decided, global decision outstanding'."""
        return self._announced_proposal and not self._fast_paxos.decided

    def _adopt_trace(self, trace_id: Optional[int]) -> None:
        """Dapper-style context propagation, receive side: the first traced
        message about the in-flight membership change donates its trace id,
        so every node's recording of that change shares one correlation key
        even when the local node never saw the originating alert."""
        if self._trace_id is None and trace_id is not None:
            self._trace_id = trace_id

    def _handle_pre_join(self, msg: PreJoinMessage) -> JoinResponse:
        """Phase 1 at the seed (MembershipService.java:203-224)."""
        status = self.view.is_safe_to_join(msg.sender, msg.node_id)
        endpoints: Tuple[Endpoint, ...] = ()
        if status in (JoinStatusCode.SAFE_TO_JOIN, JoinStatusCode.HOSTNAME_ALREADY_IN_RING):
            # Gatekeepers come from the monitoring topology: the full view's
            # predecessor rings in flat mode, the joiner's target cohort's
            # rings in hierarchical mode.
            endpoints = tuple(self._monitor_topology().expected_observers_of(msg.sender))
        LOG.info(
            "join at seed %s for %s: %s (config %d, size %d)",
            self.my_addr, msg.sender, status.name,
            self.view.configuration_id, self.view.membership_size,
        )
        return JoinResponse(
            sender=self.my_addr,
            status_code=status,
            configuration_id=self.view.configuration_id,
            endpoints=endpoints,
        )

    def _handle_join_phase2(self, msg: JoinMessage):
        """Phase 2 at an observer (MembershipService.java:232-289). Returns
        either an immediate JoinResponse or a future resolved after consensus."""
        current_config = self.view.configuration_id
        if current_config == msg.configuration_id:
            if self.view.is_host_present(msg.sender) and self.view.is_identifier_present(
                msg.node_id
            ):
                # Not a joiner: an existing member's config-sync pull stamped
                # with the configuration we both inhabit (configuration ids
                # are content hashes — equal id means identical view).
                # Answer compactly instead of enqueueing a to-be-filtered UP
                # alert or streaming the full O(N) configuration.
                self.metrics.inc("config_pull_unchanged_served")
                return JoinResponse(
                    sender=self.my_addr,
                    status_code=JoinStatusCode.SAFE_TO_JOIN,
                    configuration_id=current_config,
                )
            future: asyncio.Future = asyncio.get_event_loop().create_future()
            self._joiners_to_respond_to.setdefault(msg.sender, []).append(future)
            alert = AlertMessage(
                edge_src=self.my_addr,
                edge_dst=msg.sender,
                edge_status=EdgeStatus.UP,
                configuration_id=current_config,
                ring_numbers=msg.ring_numbers,
                node_id=msg.node_id,
                metadata=msg.metadata,
            )
            self._enqueue_alert(alert)
            return future

        # Configuration changed between phase 1 and 2
        # (MembershipService.java:255-286).
        config = self.view.configuration
        if self.view.is_host_present(msg.sender) and self.view.is_identifier_present(msg.node_id):
            # The cluster already admitted this joiner; stream it the config.
            metadata = self.metadata_manager.get_all_metadata()
            return JoinResponse(
                sender=self.my_addr,
                status_code=JoinStatusCode.SAFE_TO_JOIN,
                configuration_id=config.configuration_id,
                endpoints=config.endpoints,
                identifiers=config.node_ids,
                metadata_keys=tuple(metadata.keys()),
                metadata_values=tuple(metadata.values()),
            )
        if self.view.is_identifier_present(msg.node_id):
            # Known identifier, absent host: identifier history is
            # append-only, so this view is at-or-past the sender's EVICTION —
            # a pre-join stale view would never have seen its identifier.
            # Return the configuration as verifiable eviction proof (the
            # sender checks identifiers ⊇ its own ∧ itself ∉ endpoints); a
            # plain joiner retrying phase 2 ignores the payload and retries
            # phase 1 on the status code as before.
            return JoinResponse(
                sender=self.my_addr,
                status_code=JoinStatusCode.CONFIG_CHANGED,
                configuration_id=config.configuration_id,
                endpoints=config.endpoints,
                identifiers=config.node_ids,
            )
        return JoinResponse(
            sender=self.my_addr,
            status_code=JoinStatusCode.CONFIG_CHANGED,
            configuration_id=config.configuration_id,
        )

    # ------------------------------------------------------------------
    # alert pipeline (MembershipService.java:300-354)
    # ------------------------------------------------------------------

    def _handle_batched_alerts(self, batch: BatchedAlertMessage) -> Response:
        self.metrics.inc("alerts_received", len(batch.messages))
        config_id = self.view.configuration_id
        self._adopt_trace(batch.trace_id)
        self.recorder.record(
            EventName.ALERT_BATCH_RX,
            config_id=config_id,
            trace_id=batch.trace_id if batch.trace_id is not None else self._trace_id,
            sender=str(batch.sender),
            alerts=len(batch.messages),
        )
        valid = [
            self._extract_joiner_details(msg)
            for msg in batch.messages
            if self._filter_alert(msg, config_id)
        ]
        if valid and not self._announced_proposal:
            # Detection phase opens at the first alert evidence of this
            # change — received here, or enqueued locally (_enqueue_alert).
            # Same staleness policy as the convergence timer: a mark left by
            # evidence that never led to a proposal (one spurious FD blip,
            # tally below L) would otherwise inflate a much later change's
            # detection sample by hours.
            now = self.clock.now_ms()
            if (
                not self.metrics.has_mark(_MARK_DETECTION)
                or self.metrics.elapsed_since_ms(_MARK_DETECTION, now)
                > self._stale_evidence_ms()
            ):
                self.metrics.mark(_MARK_DETECTION, now)
        if self._announced_proposal:
            # We already initiated consensus and cannot revise our proposal.
            return Response()

        # One batched detector pass (host hash-map or device kernel —
        # DeviceCutDetector overrides aggregate_batch with a fused kernel).
        # The invalidation view matches the ring space the alerts reported
        # in (_cut_view: full view flat, cohort mini-view hierarchical).
        proposal = self.cut_detector.aggregate_batch(valid, self._cut_view())

        if proposal:
            LOG.info("%s proposing membership change of size %d", self.my_addr, len(proposal))
            self.metrics.inc("proposals_announced")
            self.recorder.record(
                EventName.FAST_ROUND_PROPOSAL,
                config_id=config_id,
                trace_id=self._trace_id,
                proposal=[str(node) for node in proposal],
            )
            self._announced_proposal = True
            now = self.clock.now_ms()
            if not self._convergence_timing:
                self._convergence_timing = True
                self.metrics.mark("view_change_convergence", now)
            # Detection phase closes at the H-threshold crossing that
            # released this cut (the detector frees the proposal in the same
            # synchronous pass); agreement opens with the proposal.
            if self.metrics.has_mark(_MARK_DETECTION):
                self.metrics.record_ms(
                    _PHASE_TIMER,
                    self.metrics.elapsed_since_ms(_MARK_DETECTION, now),
                    phase="detection",
                )
                self.metrics.clear_mark(_MARK_DETECTION)
            self.metrics.mark(_MARK_AGREEMENT, now)
            self._notify(
                ClusterEvents.VIEW_CHANGE_PROPOSAL,
                ClusterStatusChange(
                    configuration_id=config_id,
                    membership=tuple(self.view.ring(0)),
                    status_changes=tuple(self._status_changes_for(proposal)),
                ),
            )
            self._fast_paxos.propose(tuple(self.view.ring_zero_sorted(proposal)))
        return Response()

    def _filter_alert(self, msg: AlertMessage, config_id: int) -> bool:
        """Config-id check + the once-in/once-out invariant
        (MembershipService.java:644-675)."""
        if msg.configuration_id != config_id:
            return False
        if msg.edge_status == EdgeStatus.UP and self.view.is_host_present(msg.edge_dst):
            return False
        if msg.edge_status == EdgeStatus.DOWN and not self.view.is_host_present(msg.edge_dst):
            return False
        return True

    def _extract_joiner_details(self, msg: AlertMessage) -> AlertMessage:
        """Save joiner UUID/metadata for the eventual ring add
        (MembershipService.java:677-685)."""
        if msg.edge_status == EdgeStatus.UP:
            if msg.node_id is not None:
                self._joiner_uuid[msg.edge_dst] = msg.node_id
            self._joiner_metadata[msg.edge_dst] = msg.metadata
        return msg

    # ------------------------------------------------------------------
    # consensus decision (MembershipService.java:385-444)
    # ------------------------------------------------------------------

    def _decide_view_change(self, proposal: Tuple[Endpoint, ...]) -> None:
        now = self.clock.now_ms()
        if self.metrics.has_mark(_MARK_AGREEMENT):
            # Agreement phase closes at the consensus decision, labeled by
            # the path that decided it (fast quorum vs classic fallback) —
            # the boundary where the fast path stops paying for itself.
            path = self._fast_paxos.decided_path or "fast"
            self.metrics.record_ms(
                _PHASE_TIMER,
                self.metrics.elapsed_since_ms(_MARK_AGREEMENT, now),
                phase=f"agreement/{path}",
            )
            self.metrics.clear_mark(_MARK_AGREEMENT)
        LOG.info(
            "%s decide view change in config %d (%d nodes): %s",
            self.my_addr, self.view.configuration_id, self.view.membership_size,
            [str(p) for p in proposal],
        )
        # Validate BEFORE mutating anything: alert broadcasts are best-effort
        # (single-attempt, and the UDP hybrid transport ships them as
        # droppable datagrams), so a decision can name a joiner whose UP alert
        # we never saw — leaving us without its UUID. Applying a partial view
        # would fork this node from the cluster; applying half a view and
        # raising mid-loop (the reference NPEs here,
        # MembershipService.java:401-404) would strand it with no failure
        # detectors. Apply nothing and recover instead.
        missing = [
            node
            for node in proposal
            if not self.view.is_host_present(node) and node not in self._joiner_uuid
        ]
        if missing:
            self._recover_from_unknown_joiners(missing)
            return
        # Delivery phase: decision -> view applied + subscribers notified,
        # recorded at the end of _commit_view_change. Armed only once the
        # decision is validated as applicable: the missing-joiner recovery
        # above never commits, and a mark left by it would charge the whole
        # multi-second catch-up pull to "delivery" when the install lands.
        self.metrics.mark(_MARK_DELIVERY, now)
        self._cancel_failure_detectors()

        status_changes: List[NodeStatusChange] = []
        for node in proposal:
            if self.view.is_host_present(node):
                self.view.ring_delete(node)
                status_changes.append(
                    NodeStatusChange(node, EdgeStatus.DOWN, self.metadata_manager.get(node))
                )
                self.metadata_manager.remove_node(node)
            else:
                node_id = self._joiner_uuid.pop(node)
                self.view.ring_add(node, node_id)
                metadata = self._joiner_metadata.pop(node, ())
                if metadata:
                    self.metadata_manager.add_metadata({node: metadata})
                status_changes.append(NodeStatusChange(node, EdgeStatus.UP, metadata))

        change = ClusterStatusChange(
            configuration_id=self.view.configuration_id,
            membership=tuple(self.view.ring(0)),
            status_changes=tuple(status_changes),
        )
        self._commit_view_change(change, respond_to=proposal)

    def _commit_view_change(self, change: ClusterStatusChange, respond_to) -> None:
        """The apply/notify tail every view change shares — consensus
        decision and config catch-up alike: metrics, VIEW_CHANGE notify,
        per-configuration reset, failure-detector re-arm (or KICKED), and
        joiner responses."""
        self.metrics.inc("view_changes")
        if self._convergence_timing:
            self.metrics.record_ms(
                "view_change_convergence",
                self.metrics.elapsed_since_ms("view_change_convergence", self.clock.now_ms()),
            )
            self._convergence_timing = False
        # Recorded with the OLD configuration's trace id (the correlation key
        # of the change that produced this view) before the reset clears it.
        self.recorder.record(
            EventName.VIEW_CHANGE,
            config_id=change.configuration_id,
            trace_id=self._trace_id,
            membership_size=len(change.membership),
            changes=len(change.status_changes),
        )
        self._notify(ClusterEvents.VIEW_CHANGE, change)
        self._reset_for_new_configuration()

        if self.view.is_host_present(self.my_addr):
            self._create_failure_detectors()
        elif not self._kicked_signalled:
            LOG.info("%s was kicked out", self.my_addr)
            self._kicked_signalled = True
            self.metrics.inc("kicked")
            self.recorder.record(
                EventName.KICKED, config_id=change.configuration_id
            )
            self._notify(ClusterEvents.KICKED, change)

        self._respond_to_joiners(respond_to)
        if self.metrics.has_mark(_MARK_DELIVERY):
            # Consensus-decision commits only: a catch-up install never
            # armed the mark (its "decision" happened on another node).
            self.metrics.record_ms(
                _PHASE_TIMER,
                self.metrics.elapsed_since_ms(_MARK_DELIVERY, self.clock.now_ms()),
                phase="delivery",
            )
            self.metrics.clear_mark(_MARK_DELIVERY)

    def _reset_for_new_configuration(self) -> None:
        """Per-configuration protocol state reset, shared by the consensus
        decision path and the config catch-up path."""
        self.cut_detector.clear()
        self._announced_proposal = False
        self._alerts_sent.clear()
        self._redeliveries_this_config = 0
        # Joiner bookkeeping is per-configuration: a live joiner re-alerts in
        # the new configuration on its next attempt, and an identifier
        # recorded under an older configuration must never satisfy a later
        # decision's missing-identifier check — installing a stale identifier
        # would silently fork this node's configuration id from the cluster's.
        self._joiner_uuid.clear()
        self._joiner_metadata.clear()
        self._report_only_sync_pulls = 0
        self._undecided_suspicion_ticks = 0
        self._wedged_pulls = 0
        self._one_step_failed_notified = False
        self._decision_pending_catch_up = False
        # Trace context is per membership change: the next change mints or
        # adopts a fresh correlation key. Phase marks likewise — a detection
        # or agreement epoch left over from the superseded configuration
        # must not leak into the next change's phase timings.
        self.metrics.clear_mark(_MARK_DETECTION)
        self.metrics.clear_mark(_MARK_AGREEMENT)
        self._trace_id = None
        self._remember_config_id(self.view.configuration_id)
        self._fast_paxos.cancel_fallback()
        self._fast_paxos = self._new_fast_paxos()
        self.broadcaster.set_membership(self.view.ring(0))

    def _remember_config_id(self, config_id: int, inhabited: bool = True) -> None:
        """Bounded history of configuration ids this node has inhabited
        (value True) or merely verified via a futile pull as not ahead of it
        (value False): both suppress further evidence pulls, but only
        genuinely-inhabited ids qualify a sender for a config beacon — a
        futile-learned id belongs to a chain we never walked, and beaconing
        on it would let two diverged chains beacon each other forever. Ids
        are hash folds, not ordered; history is the only way to tell
        stragglers from configurations we genuinely missed."""
        if inhabited or not self._known_config_ids.get(config_id, False):
            self._known_config_ids[config_id] = inhabited
        self._known_config_ids.move_to_end(config_id)
        while len(self._known_config_ids) > 64:
            # Prefer evicting futile-learned (inhabited=False) entries:
            # straggler ids are unbounded in principle (any peer can stamp
            # any stale id), and letting them push out genuinely-inhabited
            # history would make OUR OWN old configurations look unknown
            # again — re-triggering spurious evidence pulls for traffic we
            # have already verified as behind us. Inhabited history is
            # bounded by real view changes, so it only rotates against
            # itself. The just-remembered id is exempt (evicting what we
            # came to learn would be a no-op cache).
            victim = next(
                (
                    cid
                    for cid, inh in self._known_config_ids.items()
                    if not inh and cid != config_id
                ),
                None,
            )
            if victim is not None:
                del self._known_config_ids[victim]
            else:
                self._known_config_ids.popitem(last=False)

    def _recover_from_unknown_joiners(self, missing: List[Endpoint]) -> None:
        """The cluster decided a view containing joiners whose identifiers we
        never received (their UP alerts were lost in transit). The decided
        configuration — identifiers included — exists in full at every peer
        that applied it, so the primary recovery is a config catch-up pull
        over the reliable path; the config-sync loop keeps retrying random
        peers until one has applied the decision. Only a service that cannot
        pull (no identity plumbed / sync disabled) falls back to the
        reference-style recovery: stop participating and signal ``KICKED`` so
        the application rejoins with a fresh identity."""
        self.metrics.inc("decision_missing_joiner_uuid")
        if self.node_id is not None and self.settings.config_sync_interval_ms > 0:
            LOG.warning(
                "%s cannot apply view change in config %d: no UUID recorded "
                "for joiner(s) %s; pulling the decided configuration",
                self.my_addr,
                self.view.configuration_id,
                [str(n) for n in missing],
            )
            self._decision_pending_catch_up = True
            peer = self._random_peer()
            if peer is not None:
                self._spawn_catch_up(peer)
            return
        LOG.error(
            "%s cannot apply view change in config %d: no UUID recorded for "
            "joiner(s) %s; signalling KICKED for rejoin",
            self.my_addr,
            self.view.configuration_id,
            [str(n) for n in missing],
        )
        self._cancel_failure_detectors()
        self._notify(
            ClusterEvents.KICKED,
            ClusterStatusChange(
                configuration_id=self.view.configuration_id,
                membership=tuple(self.view.ring(0)),
                status_changes=(),
            ),
        )

    def _new_fast_paxos(self) -> FastPaxos:
        vote_tally = (
            self._vote_tally_factory(self.view.membership_size)
            if self._vote_tally_factory is not None
            else None
        )
        return FastPaxos(
            my_addr=self.my_addr,
            configuration_id=self.view.configuration_id,
            membership_size=self.view.membership_size,
            broadcast_fn=self.broadcaster.broadcast,
            send_fn=self.client.send_nowait,
            on_decide=self._decide_view_change,
            clock=self.clock,
            consensus_fallback_base_delay_ms=self.settings.consensus_fallback_base_delay_ms,
            rng=self.rng,
            vote_tally=vote_tally,
            on_classic_round=self._on_fast_round_failed,
            recorder=self.recorder,
            trace_supplier=lambda: self._trace_id,
        )

    def _on_fast_round_failed(self) -> None:
        """The fallback fired before a fast-round quorum formed: classic
        Paxos is engaging. The metric counts every classic round started
        (rounds escalate while undecided); the VIEW_CHANGE_ONE_STEP_FAILED
        event — which the reference DECLARES but never fires
        (ClusterEvents.java:19-23) — fires once per configuration, the
        moment one-step consensus is first abandoned for the slow path."""
        self.metrics.inc("classic_rounds_started")
        if self._one_step_failed_notified:
            return
        self._one_step_failed_notified = True
        self._notify(
            ClusterEvents.VIEW_CHANGE_ONE_STEP_FAILED,
            ClusterStatusChange(
                configuration_id=self.view.configuration_id,
                membership=tuple(self.view.ring(0)),
                status_changes=(),
            ),
        )

    def _respond_to_joiners(self, proposal: Tuple[Endpoint, ...]) -> None:
        """Stream the new configuration to nodes joining through us
        (MembershipService.java:719-744)."""
        config = self.view.configuration
        metadata = self.metadata_manager.get_all_metadata()
        response = JoinResponse(
            sender=self.my_addr,
            status_code=JoinStatusCode.SAFE_TO_JOIN,
            configuration_id=config.configuration_id,
            endpoints=config.endpoints,
            identifiers=config.node_ids,
            metadata_keys=tuple(metadata.keys()),
            metadata_values=tuple(metadata.values()),
        )
        for node in proposal:
            for future in self._joiners_to_respond_to.pop(node, []):
                if not future.done():
                    future.set_result(response)

    # ------------------------------------------------------------------
    # failure detection (MembershipService.java:472-495, 697-714)
    # ------------------------------------------------------------------

    def _edge_failure_notification(self, subject: Endpoint, config_id: int) -> None:
        if config_id != self.view.configuration_id:
            LOG.info(
                "%s ignoring stale failure notification for %s (config %d != %d)",
                self.my_addr, subject, config_id, self.view.configuration_id,
            )
            return
        self._enqueue_alert(
            AlertMessage(
                edge_src=self.my_addr,
                edge_dst=subject,
                edge_status=EdgeStatus.DOWN,
                configuration_id=config_id,
                ring_numbers=tuple(
                    self._monitor_topology().ring_numbers(self.my_addr, subject)
                ),
            )
        )

    async def inject_byzantine_alert(
        self, subject: Endpoint, status: EdgeStatus, ring_numbers: Sequence[int]
    ) -> None:
        """Chaos seam: enqueue an edge report this node NEVER observed — a
        lying observer (rapid_tpu/sim's ``false_alert``/``alert_storm``
        events). The lie rides the real machinery end to end: the batcher
        broadcasts it, redelivery repeats it, and every receiver's H/L cut
        detector tallies the claimed rings exactly as it would honest
        evidence — which is the point: the paper's stability claim (sub-H
        report counts DELAY, never trigger, a view change) is only tested
        by reports that are actually false. Takes the protocol lock like
        any handler; no internal state is bypassed."""
        async with self._lock:
            self._enqueue_alert(
                AlertMessage(
                    edge_src=self.my_addr,
                    edge_dst=subject,
                    edge_status=status,
                    configuration_id=self.view.configuration_id,
                    ring_numbers=tuple(int(r) for r in ring_numbers),
                )
            )

    def _create_failure_detectors(self) -> None:
        if self._stopped:
            return
        self._fd_generation += 1
        generation = self._fd_generation
        config_id = self.view.configuration_id
        try:
            subjects = self._monitor_topology().subjects_of(self.my_addr)
        except NodeNotInRingError:
            # Evicted between the view change and this rearm: no ring
            # position means no subjects to watch — nothing to arm.
            return
        for subject in set(subjects):
            self._fd_tasks.append(
                asyncio.ensure_future(self._fd_loop(subject, generation, config_id))
            )

    async def _fd_loop(self, subject: Endpoint, generation: int, config_id: int) -> None:
        def notifier() -> None:
            task = asyncio.ensure_future(self._notify_edge_failure(subject, config_id))
            self._edge_notify_tasks.add(task)
            task.add_done_callback(self._edge_notify_tasks.discard)

        detector = self.fd_factory.create_instance(subject, notifier)
        while not self._stopped and generation == self._fd_generation:
            await detector.tick()
            await self.clock.sleep_ms(self.settings.failure_detector_interval_ms)

    async def _notify_edge_failure(self, subject: Endpoint, config_id: int) -> None:
        async with self._lock:
            self._edge_failure_notification(subject, config_id)

    def _cancel_failure_detectors(self) -> List[asyncio.Task]:
        self._fd_generation += 1
        cancelled = list(self._fd_tasks)
        for task in cancelled:
            task.cancel()
        self._fd_tasks.clear()
        return cancelled

    # ------------------------------------------------------------------
    # alert batching (MembershipService.java:572-581, 613-637)
    # ------------------------------------------------------------------

    def _stale_evidence_ms(self) -> float:
        """The window in which alerts related to the same membership change
        can plausibly still arrive; evidence marks (the convergence timer
        and the detection-phase mark) older than this belong to a change
        that never happened and are expired rather than trusted."""
        return 10 * (
            self.settings.failure_detector_interval_ms
            + self.settings.batching_window_ms
        )

    def _enqueue_alert(self, msg: AlertMessage) -> None:
        now = self.clock.now_ms()
        self._last_enqueue_ms = now
        self._send_queue.append(msg)
        self.metrics.inc("alerts_enqueued")
        if self._trace_id is None:
            # First local evidence of this membership change: mint the
            # trace id every node's recording of it will share.
            self._trace_id = mint_trace_id(
                str(self.my_addr), msg.configuration_id, now
            )
        self.recorder.record(
            EventName.ALERT_ENQUEUED,
            config_id=msg.configuration_id,
            trace_id=self._trace_id,
            subject=str(msg.edge_dst),
            status=msg.edge_status.name,
        )
        # North-star timer: first local evidence of a membership change until
        # the view change commits. A mark left by evidence that never led to
        # a proposal (e.g. one spurious FD firing, tally below L) would
        # inflate a much later convergence; expire it after the window in
        # which related alerts could plausibly still arrive.
        if (
            self._convergence_timing
            and not self._announced_proposal
            # Once a proposal is announced, convergence is genuinely in
            # flight (possibly slow via the classic fallback) — never expire.
            and self.metrics.elapsed_since_ms("view_change_convergence", now)
            > self._stale_evidence_ms()
        ):
            self._convergence_timing = False
        if not self._convergence_timing:
            self._convergence_timing = True
            self.metrics.mark("view_change_convergence", now)
            # Detection phase (re)opens with the convergence epoch: same
            # staleness policy, same first-evidence semantics.
            self.metrics.mark(_MARK_DETECTION, now)
        elif not self._announced_proposal and not self.metrics.has_mark(_MARK_DETECTION):
            self.metrics.mark(_MARK_DETECTION, now)

    async def _alert_batcher_loop(self) -> None:
        window = self.settings.batching_window_ms
        while not self._stopped:
            await self.clock.sleep_ms(window)
            # Under the protocol executor, like the redelivery and
            # config-sync loops: the queue swap, the redelivery-buffer
            # append, and the trace-id read must not interleave with a
            # handler mutating the same state while parked on an await
            # (surfaced by the unguarded-mutation analysis; previously this
            # loop touched _send_queue/_alerts_sent lock-free, safe only by
            # the accident of having no await inside the tick body).
            async with self._lock:
                if (
                    self._send_queue
                    and self._last_enqueue_ms > 0
                    and (self.clock.now_ms() - self._last_enqueue_ms) > window
                ):
                    messages, self._send_queue = self._send_queue, []
                    self.metrics.inc("alert_batches_sent")
                    self._alerts_sent.extend(messages)
                    self.recorder.record(
                        EventName.ALERT_BATCH_TX,
                        config_id=self.view.configuration_id,
                        trace_id=self._trace_id,
                        alerts=len(messages),
                    )
                    self.broadcaster.broadcast(
                        BatchedAlertMessage(
                            sender=self.my_addr,
                            messages=tuple(messages),
                            trace_id=self._trace_id,
                        )
                    )

    # ------------------------------------------------------------------
    # delivery liveness (droppable transports; settings.py rationale)
    #
    # The reference's protocol fires every broadcast exactly once and stays
    # live because its transport guarantees delivery (Retries.java:43-90,
    # GrpcClient.java:106-115). Here transports may drop (the UDP hybrid
    # ships one-way traffic as datagrams), so the delivery guarantee is
    # re-established at the protocol level: alert batches are re-broadcast
    # while their cut is unresolved, undecided consensus re-arms (fast_paxos
    # re-offers votes and escalates classic rounds), and a node with
    # evidence or suspicion of staleness pulls the current configuration
    # from a peer over the reliable request/response path.
    # ------------------------------------------------------------------

    async def _alert_redelivery_loop(self) -> None:
        """Re-broadcast this configuration's alert batches while the cut they
        announce is unresolved. Receivers are idempotent — the cut detector
        dedups per (subject, ring) and vote tallies dedup per sender — so
        redelivery is always safe. The first few rounds are unconditional
        (our own copy of the original broadcast may itself have been lost,
        leaving no local evidence of a pending cut); afterwards only while
        local state shows the cut in flight, capped at _MAX_REDELIVERIES."""
        interval = self.settings.alert_redelivery_interval_ms
        if interval <= 0:
            return
        while not self._stopped:
            await self.clock.sleep_ms(interval)
            try:
                async with self._lock:
                    if self._stopped:
                        return
                    config_id = self.view.configuration_id
                    # De-duplicate, order-preserving: join retries enqueue
                    # identical UP alerts; receivers dedup anyway (per
                    # subject+ring), so repeats only waste payload.
                    pending = tuple(dict.fromkeys(
                        m for m in self._alerts_sent if m.configuration_id == config_id
                    ))
                    if not pending or self._redeliveries_this_config >= _MAX_REDELIVERIES:
                        continue
                    unresolved = self._consensus_pending() or (
                        not self._announced_proposal
                        and self.cut_detector.has_pending_reports()
                    )
                    if (
                        not unresolved
                        and self._redeliveries_this_config >= _UNCONDITIONAL_REDELIVERIES
                    ):
                        continue
                    self._redeliveries_this_config += 1
                    self.metrics.inc("alert_batches_redelivered")
                    self.recorder.record(
                        EventName.ALERT_REDELIVERY,
                        config_id=config_id,
                        trace_id=self._trace_id,
                        alerts=len(pending),
                        redelivery=self._redeliveries_this_config,
                    )
                    self.broadcaster.broadcast(
                        BatchedAlertMessage(
                            sender=self.my_addr,
                            messages=pending,
                            trace_id=self._trace_id,
                        )
                    )
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the liveness loop must survive
                LOG.exception("%s alert redelivery tick failed; continuing", self.my_addr)

    async def _config_sync_loop(self) -> None:
        """Anti-entropy for the configuration itself: while this node has
        reason to believe it is stuck — an undecided proposal, an unresolved
        cut, or a decision it could not apply — pull the current
        configuration from a random peer each interval. The pull rides the
        reliable path, so unlike every broadcast above it cannot be lost."""
        interval = self.settings.config_sync_interval_ms
        if interval <= 0 or self.node_id is None:
            return
        while not self._stopped:
            await self.clock.sleep_ms(interval)
            try:
                async with self._lock:
                    if self._stopped:
                        return
                    # An undecided proposal is normal for the first couple of
                    # intervals of any slow classic decision; only a
                    # PERSISTENTLY undecided one warrants pulling snapshots.
                    if self._consensus_pending():
                        self._undecided_suspicion_ticks += 1
                    else:
                        self._undecided_suspicion_ticks = 0
                    strong = self._decision_pending_catch_up or (
                        self._undecided_suspicion_ticks >= 2
                    )
                    report_only = (
                        not self._announced_proposal
                        and self.cut_detector.has_pending_reports()
                        and self._report_only_sync_pulls < _MAX_REPORT_ONLY_SYNC_PULLS
                    )
                    # Anti-entropy heartbeat (settings rationale): with no
                    # suspicion at all, still pull on the slow idle cadence —
                    # the only channel to a member that missed a decision
                    # with zero local evidence and zero inbound traffic.
                    idle_ms = self.settings.config_sync_idle_interval_ms
                    now = self.clock.now_ms()
                    idle_due = (
                        idle_ms > 0 and now - self._last_idle_sync_ms >= idle_ms
                    )
                    suspicious = (
                        not self._kicked_signalled
                        and not self._catch_up_inflight
                        and (strong or report_only or idle_due)
                    )
                    if suspicious:
                        self._last_idle_sync_ms = now
                    peer = self._random_peer() if suspicious else None
                    if peer is not None and not strong and not idle_due:
                        # Budget counts pulls actually ISSUED: a single-member
                        # view has no peer to pull from, and charging its
                        # no-op ticks would exhaust the report-only budget
                        # before a partner ever appears (advisor round 5).
                        self._report_only_sync_pulls += 1
                    if peer is not None and self._decision_pending_catch_up:
                        # A decision we could not apply keeps pulling
                        # uncapped — but if the peers that decided it all
                        # crashed before answering, this node is wedged on a
                        # configuration nobody can serve. Escalate once so
                        # the wedge is an observable incident, not an
                        # indefinite silent retry loop.
                        self._wedged_pulls += 1
                        if self._wedged_pulls == _WEDGED_PULLS_ERROR_THRESHOLD:
                            self.metrics.inc("catch_up_wedged")
                            self.recorder.record(
                                EventName.UNKNOWN_JOINER_WEDGE,
                                config_id=self.view.configuration_id,
                                trace_id=self._trace_id,
                                futile_pulls=self._wedged_pulls,
                            )
                            LOG.error(
                                "%s wedged: %d futile pulls for a decided "
                                "configuration we could not apply (config %d); "
                                "the deciding peers are likely gone — still "
                                "retrying, operator intervention (restart/"
                                "rejoin) may be required",
                                self.my_addr,
                                self._wedged_pulls,
                                self.view.configuration_id,
                            )
                if peer is not None:
                    await self._catch_up(peer)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — anti-entropy must survive, e.g.
                # a raising application subscriber inside a catch-up install.
                LOG.exception("%s config sync tick failed; continuing", self.my_addr)

    def _note_config_evidence(self, request: RapidRequest) -> None:
        """Traffic stamped with a configuration id this node has never
        inhabited is evidence that the cluster moved somewhere we missed:
        pull from the sender (who, having stamped it, holds that config).
        Ids are hash folds, not ordered, so the known-id history — not a
        comparison — tells stragglers from the future."""
        if self.node_id is None or self.settings.config_sync_interval_ms <= 0:
            return
        if self._stopped or self._kicked_signalled or self._catch_up_inflight:
            return
        if isinstance(request, BatchedAlertMessage):
            config_ids = {m.configuration_id for m in request.messages}
        elif isinstance(request, GlobalTierMessage):
            # The envelope itself is unstamped; the consensus payload inside
            # carries the configuration the sender inhabits. A payload
            # without a stamp (never sent by this implementation) is simply
            # not evidence.
            payload_cid = getattr(request.payload, "configuration_id", None)
            config_ids = set() if payload_cid is None else {payload_cid}
        else:
            config_ids = {request.configuration_id}
        unknown = frozenset(
            cid for cid in config_ids if cid not in self._known_config_ids
        )
        sender = request.sender
        if sender == self.my_addr:
            return
        now = self.clock.now_ms()
        if unknown:
            if now - self._last_catch_up_ms >= self.settings.config_sync_interval_ms:
                self._last_catch_up_ms = now
                self._last_idle_sync_ms = now  # a pull IS the heartbeat
                self._spawn_catch_up(sender, trigger_ids=unknown)
        elif (
            config_ids
            and self.view.configuration_id not in config_ids
            and all(self._known_config_ids.get(cid, False) for cid in config_ids)
        ):
            # Every id is one WE have inhabited (futile-learned ids do NOT
            # qualify — see _remember_config_id) but none is current: the
            # sender is demonstrably behind us (e.g. it missed a decision
            # and its liveness tick keeps re-offering old-config votes).
            # Answer with a config BEACON — a semantically inert alert
            # batch (a self-UP alert is filtered by every receiver) whose
            # config stamp is, to the stale sender, evidence of an unknown
            # configuration: its own evidence pull does the rest. Keeps
            # post-decision staleness recovery prompt without new wire
            # types; the idle-cadence pull remains the no-signal fallback.
            if now - self._last_beacon_ms >= self.settings.config_sync_interval_ms:
                self._last_beacon_ms = now
                self.metrics.inc("config_beacons_sent")
                self.recorder.record(
                    EventName.CONFIG_BEACON_TX,
                    config_id=self.view.configuration_id,
                    trace_id=self._trace_id,
                    peer=str(sender),
                )
                self.client.send_nowait(
                    sender,
                    BatchedAlertMessage(
                        sender=self.my_addr,
                        messages=(
                            AlertMessage(
                                edge_src=self.my_addr,
                                edge_dst=self.my_addr,
                                edge_status=EdgeStatus.UP,
                                configuration_id=self.view.configuration_id,
                                ring_numbers=(),
                            ),
                        ),
                    ),
                )

    def _random_peer(self) -> Optional[Endpoint]:
        members = [m for m in self.view.ring(0) if m != self.my_addr]
        if not members:
            return None
        return self.rng.choice(members)

    def _spawn_catch_up(self, peer: Endpoint, trigger_ids: frozenset = frozenset()) -> None:
        task = asyncio.ensure_future(self._catch_up(peer, trigger_ids))
        self._catch_up_tasks.add(task)
        task.add_done_callback(self._catch_up_task_done)

    def _catch_up_task_done(self, task: asyncio.Task) -> None:
        self._catch_up_tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            LOG.error(
                "%s config catch-up task failed: %r", self.my_addr, task.exception()
            )

    async def _catch_up(self, peer: Endpoint, trigger_ids: frozenset = frozenset()) -> None:
        """Pull ``peer``'s current configuration via the join phase-2
        handler (a JoinMessage authenticated by our endpoint + identifier,
        stamped with our current config id — or the -1 sentinel on
        java-topology clusters, see CATCH_UP_CONFIG_ID) and adopt it if it
        is ahead of ours. ``trigger_ids`` are the unknown config ids whose
        traffic triggered this pull: on a futile outcome they are remembered
        as not-ahead (any id the sender stamped lies on its chain at or
        behind the not-ahead config it just answered with), so the same
        straggler traffic cannot re-trigger pulls forever."""
        if self._catch_up_inflight or self._stopped or self.node_id is None:
            return
        self._catch_up_inflight = True
        try:
            # Stamped with OUR current configuration id (not the joiner's -1
            # sentinel): a peer inhabiting the same configuration answers
            # with a compact "unchanged" response instead of streaming the
            # full O(N) configuration — which turns the 30 s idle heartbeat
            # into a true no-op when nothing changed. A peer on any other
            # configuration takes the mismatch branch and streams, exactly
            # as before. Java-topology clusters (which may contain reference
            # JVM peers without the unchanged branch) keep the sentinel —
            # see CATCH_UP_CONFIG_ID.
            self.recorder.record(
                EventName.CATCH_UP_PULL,
                config_id=self.view.configuration_id,
                trace_id=self._trace_id,
                peer=str(peer),
                triggers=len(trigger_ids),
            )
            pull_config_id = (
                CATCH_UP_CONFIG_ID
                if self.settings.topology == "java"
                else self.view.configuration_id
            )
            request = JoinMessage(
                sender=self.my_addr,
                node_id=self.node_id,
                ring_numbers=(),
                configuration_id=pull_config_id,
                metadata=(),
            )
            try:
                response = await self.client.send(peer, request)
            except Exception as exc:  # noqa: BLE001 — any transport failure: retry later
                LOG.debug("%s config pull from %s failed: %r", self.my_addr, peer, exc)
                return
            if not isinstance(response, JoinResponse):
                return
            async with self._lock:
                if not self._stopped:
                    self._apply_catch_up_response(peer, response, trigger_ids)
        finally:
            self._catch_up_inflight = False

    def _apply_catch_up_response(
        self,
        peer: Endpoint,
        response: JoinResponse,
        trigger_ids: frozenset = frozenset(),
    ) -> None:
        if self._kicked_signalled:
            return
        if response.status_code == JoinStatusCode.CONFIG_CHANGED:
            # The peer's view does not contain us. That alone is ambiguous —
            # the peer may be stuck in a configuration predating our join —
            # so eviction is concluded ONLY from verifiable proof: the peer's
            # identifier history contains everything ours does (it is at or
            # past every configuration we inhabited; histories are
            # append-only) yet its endpoints lack us. A stale pre-join peer
            # cannot fabricate this — it has never seen our identifier — so
            # no count of ambiguous answers is needed, and no count of
            # ambiguous answers can falsely convict.
            theirs_ids = frozenset(response.identifiers)
            proven = (
                bool(response.endpoints)
                and theirs_ids >= self.view.identifiers_seen()
                and self.my_addr not in set(response.endpoints)
            )
            if proven:
                LOG.warning(
                    "%s: peer %s proved a configuration past our eviction "
                    "(identifier superset, endpoints exclude us); signalling KICKED",
                    self.my_addr, peer,
                )
                # Latch: KICKED fires once; the application owns the rejoin.
                # Also silence our consensus liveness tick — an evicted node
                # must not keep broadcasting stale votes/rounds at the living.
                self._kicked_signalled = True
                self._fast_paxos.cancel_fallback()
                self.metrics.inc("kicked")
                self.recorder.record(
                    EventName.KICKED,
                    config_id=self.view.configuration_id,
                    peer=str(peer),
                )
                self._cancel_failure_detectors()
                self._notify(
                    ClusterEvents.KICKED,
                    ClusterStatusChange(
                        configuration_id=self.view.configuration_id,
                        membership=tuple(self.view.ring(0)),
                        status_changes=(),
                    ),
                )
            else:
                # Learned nothing actionable: remember the peer's config id
                # AND the trigger ids so this straggler traffic stops
                # re-triggering evidence pulls (ids are hash-unique; a config
                # verified not-ahead of us can never become ahead).
                self._remember_config_id(response.configuration_id, inhabited=False)
                for cid in trigger_ids:
                    self._remember_config_id(cid, inhabited=False)
                self.recorder.record(
                    EventName.CATCH_UP_RESULT,
                    config_id=self.view.configuration_id,
                    trace_id=self._trace_id,
                    peer=str(peer),
                    outcome="futile_config_changed",
                )
            return
        if response.status_code != JoinStatusCode.SAFE_TO_JOIN or not response.endpoints:
            if (
                response.status_code == JoinStatusCode.SAFE_TO_JOIN
                and response.configuration_id == self.view.configuration_id
            ):
                # Compact "unchanged" answer: the peer inhabits the same
                # configuration we do. The trigger ids (if any) are thereby
                # verified not-ahead — remember them so the same straggler
                # traffic cannot re-trigger pulls, exactly as a futile full
                # stream used to.
                self.metrics.inc("config_sync_unchanged")
                for cid in trigger_ids:
                    self._remember_config_id(cid, inhabited=False)
                self.recorder.record(
                    EventName.CATCH_UP_RESULT,
                    config_id=self.view.configuration_id,
                    trace_id=self._trace_id,
                    peer=str(peer),
                    outcome="unchanged",
                )
            return
        theirs_ids = frozenset(response.identifiers)
        mine_ids = self.view.identifiers_seen()
        theirs_eps = set(response.endpoints)
        mine_eps = set(self.view.ring(0))
        # Identifier history is append-only along the decided chain
        # (view.identifiers_seen docstring), which orders configurations
        # without a version counter.
        newer = theirs_ids > mine_ids or (
            theirs_ids == mine_ids and theirs_eps < mine_eps
        )
        if not newer:
            # Futile pull: mark the peer's config and the trigger ids as
            # known-not-ahead so this straggler traffic stops re-triggering
            # evidence pulls.
            self._remember_config_id(response.configuration_id, inhabited=False)
            for cid in trigger_ids:
                self._remember_config_id(cid, inhabited=False)
            self.recorder.record(
                EventName.CATCH_UP_RESULT,
                config_id=self.view.configuration_id,
                trace_id=self._trace_id,
                peer=str(peer),
                outcome="futile_not_newer",
            )
            return
        self.metrics.inc("config_catch_ups")
        self.recorder.record(
            EventName.CATCH_UP_RESULT,
            config_id=self.view.configuration_id,
            trace_id=self._trace_id,
            peer=str(peer),
            outcome="installed",
            new_config_id=response.configuration_id,
        )
        self._install_fetched_configuration(response)

    def _install_fetched_configuration(self, response: JoinResponse) -> None:
        """Adopt a configuration pulled from a peer: the catch-up twin of
        ``_decide_view_change``'s apply path, with status changes computed as
        the membership diff."""
        old_members = set(self.view.ring(0))
        old_metadata = self.metadata_manager.get_all_metadata()
        self._cancel_failure_detectors()
        self.view = MembershipView(
            self.settings.k,
            node_ids=response.identifiers,
            endpoints=response.endpoints,
            topology=self.settings.topology,
        )
        self.metadata_manager = MetadataManager()
        if response.metadata_keys:
            self.metadata_manager.add_metadata(
                dict(zip(response.metadata_keys, response.metadata_values))
            )
        new_members = set(self.view.ring(0))
        status_changes = tuple(
            NodeStatusChange(node, EdgeStatus.UP, self.metadata_manager.get(node))
            for node in self.view.ring_zero_sorted(new_members - old_members)
        ) + tuple(
            NodeStatusChange(node, EdgeStatus.DOWN, old_metadata.get(node, ()))
            for node in sorted(old_members - new_members)
        )
        change = ClusterStatusChange(
            configuration_id=self.view.configuration_id,
            membership=tuple(self.view.ring(0)),
            status_changes=status_changes,
        )
        LOG.info(
            "%s caught up to config %d (%d nodes) via peer pull",
            self.my_addr, self.view.configuration_id, self.view.membership_size,
        )
        # Joiners pending through us that the fetched configuration admitted
        # get it streamed; the rest keep waiting (decide-path contract).
        pending_members = tuple(
            joiner for joiner in self._joiners_to_respond_to if joiner in new_members
        )
        self._commit_view_change(change, respond_to=pending_members)

    # ------------------------------------------------------------------
    # leave (MembershipService.java:545-565)
    # ------------------------------------------------------------------

    async def leave(self) -> None:
        try:
            observers = self._monitor_topology().observers_of(self.my_addr)
        except NodeNotInRingError:
            return  # already removed — nothing to announce
        leave_msg = LeaveMessage(sender=self.my_addr)
        sends = [self.client.send_best_effort(observer, leave_msg) for observer in observers]
        try:
            await asyncio.wait_for(
                asyncio.gather(*sends, return_exceptions=True),
                timeout=self.settings.leave_message_timeout_ms / 1000.0,
            )
        except asyncio.TimeoutError:
            pass

    # ------------------------------------------------------------------
    # events
    # ------------------------------------------------------------------

    def _notify(self, event: ClusterEvents, change: ClusterStatusChange) -> None:
        # Subscriber isolation: callbacks are application code, and several
        # call sites sit mid-transition (view replaced, per-config state not
        # yet reset). A raising subscriber must not abort the transition —
        # that would strand the service half-migrated (new view, old
        # consensus/broadcaster state) with no repair path.
        for callback in self.subscriptions[event]:
            try:
                callback(change)
            except Exception:  # noqa: BLE001 — app callback, not protocol state
                LOG.exception(
                    "%s subscriber for %s raised; continuing", self.my_addr, event
                )

    def _status_changes_for(self, proposal) -> List[NodeStatusChange]:
        return [
            NodeStatusChange(
                node,
                EdgeStatus.DOWN if self.view.is_host_present(node) else EdgeStatus.UP,
                self.metadata_manager.get(node),
            )
            for node in proposal
        ]

    def _initial_view_change(self) -> ClusterStatusChange:
        return ClusterStatusChange(
            configuration_id=self.view.configuration_id,
            membership=tuple(self.view.ring(0)),
            status_changes=tuple(
                NodeStatusChange(node, EdgeStatus.UP, self.metadata_manager.get(node))
                for node in self.view.ring(0)
            ),
        )
