"""Public cluster API: bootstrap a seed or join through one.

API surface mirrors the reference ``Cluster`` builder
(``Cluster.java:53-160``): ``start()`` boots a single-node cluster,
``join(seed)`` runs the two-phase bootstrap with retries
(``Cluster.java:303-437``), plus ``membership``/``metadata`` accessors,
subscriptions, ``leave_gracefully`` and ``shutdown``. Everything is
async-first; transports plug in through the messaging SPI.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Dict, List, Optional

from rapid_tpu_torch.errors import JoinError, JoinPhaseOneError, JoinPhaseTwoError
from rapid_tpu_torch.messaging.base import MessagingClient, MessagingServer
from rapid_tpu_torch.messaging.inprocess import InProcessClient, InProcessNetwork, InProcessServer
from rapid_tpu_torch.monitoring.base import EdgeFailureDetectorFactory
from rapid_tpu_torch.monitoring.ping_pong import PingPongFailureDetectorFactory
from rapid_tpu_torch.protocol.cut_detector import MultiNodeCutDetector
from rapid_tpu_torch.protocol.events import ClusterEvents
from rapid_tpu_torch.protocol.metadata import FrozenMetadata
from rapid_tpu_torch.protocol.service import MembershipService
from rapid_tpu_torch.protocol.view import MembershipView
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import (
    Endpoint,
    JoinMessage,
    JoinResponse,
    JoinStatusCode,
    NodeId,
    PreJoinMessage,
)
from rapid_tpu_torch.utils.clock import Clock

LOG = logging.getLogger(__name__)


class Cluster:
    def __init__(
        self,
        listen_address: Endpoint,
        service: MembershipService,
        server: MessagingServer,
        client: MessagingClient,
    ) -> None:
        self.listen_address = listen_address
        self.service = service
        self._server = server
        self._client = client
        # Set by _from_join_response when the service start is scheduled
        # rather than awaited; shutdown() settles it first.
        self._start_task: Optional[asyncio.Task] = None

    # -- accessors (Cluster.java:98-129) -------------------------------

    @property
    def membership(self) -> List[Endpoint]:
        return self.service.membership

    @property
    def membership_size(self) -> int:
        return self.service.membership_size

    @property
    def metadata(self) -> Dict[Endpoint, FrozenMetadata]:
        return self.service.get_metadata()

    def register_subscription(self, event: ClusterEvents, callback) -> None:
        self.service.register_subscription(event, callback)

    @property
    def metrics(self):
        # Counters + timings for this node; view_change_convergence_ms is the
        # north-star metric (SURVEY §5.1).
        return self.service.metrics.summary()

    def telemetry_snapshot(self, recorder_tail=None):
        """The node's unified telemetry (utils/exposition.py schema): the
        service snapshot plus the server side of the transport accounting,
        which only this layer holds."""
        snapshot = self.service.telemetry_snapshot(recorder_tail=recorder_tail)
        server_stats = getattr(self._server, "stats", None)
        snapshot["transport"]["server"] = (
            server_stats.snapshot() if server_stats is not None else None
        )
        return snapshot

    def prometheus_text(self) -> str:
        """Prometheus text exposition for this node (stable names pinned by
        tests/test_observability.py) — the string to serve on /metrics."""
        from rapid_tpu_torch.utils import exposition

        return exposition.prometheus_text(self.telemetry_snapshot(recorder_tail=0))

    # -- lifecycle ------------------------------------------------------

    async def leave_gracefully(self) -> None:
        """Tell observers to proactively report us DOWN, then shut down
        (Cluster.java:145-149)."""
        await self.service.leave()
        await self.shutdown()

    async def shutdown(self) -> None:
        if self._start_task is not None:
            # A join-built cluster scheduled service.start() instead of
            # awaiting it; settle it so the background loops exist before
            # service.shutdown() cancels them (start() is await-free, so
            # this completes in one scheduling step). A failed start must
            # not abort the teardown below — report it and keep going.
            (result,) = await asyncio.gather(self._start_task, return_exceptions=True)
            if isinstance(result, BaseException) and not isinstance(
                result, asyncio.CancelledError
            ):
                LOG.warning(
                    "%s service start failed before shutdown: %r", self, result
                )
            self._start_task = None
        await self._server.shutdown()
        await self.service.shutdown()

    def __str__(self) -> str:
        return f"Cluster:{self.listen_address}"

    # -- builders -------------------------------------------------------

    @classmethod
    async def start(
        cls,
        listen_address: Endpoint,
        settings: Optional[Settings] = None,
        network: Optional[InProcessNetwork] = None,
        client: Optional[MessagingClient] = None,
        server: Optional[MessagingServer] = None,
        fd_factory: Optional[EdgeFailureDetectorFactory] = None,
        metadata: FrozenMetadata = (),
        subscriptions: Optional[Dict[ClusterEvents, List]] = None,
        clock: Optional[Clock] = None,
        rng: Optional[random.Random] = None,
        cut_detector_factory=None,
        vote_tally_factory=None,
        broadcaster_factory=None,
        node_id: Optional[NodeId] = None,
    ) -> "Cluster":
        """Bootstrap a one-node cluster (Cluster.java:255-280).
        ``cut_detector_factory(k, h, l)`` swaps the detector implementation
        (e.g. DeviceCutDetector); ``vote_tally_factory(membership_size)``
        swaps the consensus vote tally (e.g. DeviceVoteTally) — together they
        put both halves of the protocol hot path on the accelerator.
        ``broadcaster_factory(client, listen_address, rng)`` swaps the
        broadcast strategy (e.g. ``GossipBroadcaster.factory()``); a factory
        whose product has a ``router`` method gets it wrapped around the
        service at the server seam (gossip unwrap/relay)."""
        settings = settings if settings is not None else Settings()
        settings.validate()
        client, server = cls._make_transport(listen_address, settings, network, client, server)
        fd_factory = fd_factory or PingPongFailureDetectorFactory(listen_address, client)
        # An injected identity makes a simulated run a pure function of its
        # seed (rapid_tpu_torch/sim); production callers omit it and get a UUID.
        node_id = node_id if node_id is not None else NodeId.from_uuid()
        view = MembershipView(
            settings.k,
            node_ids=[node_id],
            endpoints=[listen_address],
            topology=settings.topology,
        )
        detector_factory = cut_detector_factory or MultiNodeCutDetector
        cut_detector = detector_factory(settings.k, settings.h, settings.l)
        metadata_map = {listen_address: metadata} if metadata else {}
        broadcaster = (
            broadcaster_factory(client, listen_address, rng) if broadcaster_factory else None
        )
        service = cls._service_class(settings)(
            my_addr=listen_address,
            cut_detector=cut_detector,
            view=view,
            settings=settings,
            client=client,
            fd_factory=fd_factory,
            metadata_map=metadata_map,
            subscriptions=subscriptions,
            clock=clock,
            rng=rng,
            vote_tally_factory=vote_tally_factory,
            broadcaster=broadcaster,
            node_id=node_id,
        )
        server.set_membership_service(cls._server_handler(broadcaster, service))
        await server.start()
        await service.start()
        return cls(listen_address, service, server, client)

    @staticmethod
    def _service_class(settings: Settings):
        """Flat or two-level service, by configuration. Imported lazily:
        the hier package depends on protocol/, not the other way around."""
        if settings.hier_target_cohort_size > 0:
            from rapid_tpu_torch.hier.service import HierMembershipService

            return HierMembershipService
        return MembershipService

    @staticmethod
    def _server_handler(broadcaster, service):
        """The object the server dispatches to: the service itself, or the
        broadcaster's router facade when the broadcast strategy needs to see
        inbound envelopes (gossip relay)."""
        if broadcaster is not None and hasattr(broadcaster, "router"):
            return broadcaster.router(service)
        return service

    @classmethod
    async def join(
        cls,
        seed_address: Endpoint,
        listen_address: Endpoint,
        settings: Optional[Settings] = None,
        network: Optional[InProcessNetwork] = None,
        client: Optional[MessagingClient] = None,
        server: Optional[MessagingServer] = None,
        fd_factory: Optional[EdgeFailureDetectorFactory] = None,
        metadata: FrozenMetadata = (),
        subscriptions: Optional[Dict[ClusterEvents, List]] = None,
        clock: Optional[Clock] = None,
        rng: Optional[random.Random] = None,
        cut_detector_factory=None,
        vote_tally_factory=None,
        broadcaster_factory=None,
        node_id: Optional[NodeId] = None,
    ) -> "Cluster":
        """Two-phase join through ``seed_address`` with retries
        (Cluster.java:303-344)."""
        settings = settings if settings is not None else Settings()
        settings.validate()
        client, server = cls._make_transport(listen_address, settings, network, client, server)
        fd_factory = fd_factory or PingPongFailureDetectorFactory(listen_address, client)
        # Injected identity: see start(). The UUID_ALREADY_IN_RING retry
        # below still re-mints — identity reuse is rejected by the protocol
        # whatever the caller supplied.
        node_id = node_id if node_id is not None else NodeId.from_uuid()
        # The server starts before the service exists; probes are answered
        # with BOOTSTRAPPING in the meantime (Cluster.java:312).
        await server.start()

        try:
            for attempt in range(settings.join_attempts):
                try:
                    return await cls._join_attempt(
                        seed_address, listen_address, node_id, settings, client, server,
                        fd_factory, metadata, subscriptions, clock, rng,
                        cut_detector_factory, vote_tally_factory, broadcaster_factory,
                    )
                except JoinPhaseOneError as exc:
                    status = exc.join_response.status_code
                    LOG.warning("%s join phase 1 rejected: %s (attempt %d)",
                                listen_address, status.name, attempt)
                    if status == JoinStatusCode.UUID_ALREADY_IN_RING:
                        node_id = NodeId.from_uuid()
                    elif status not in (
                        JoinStatusCode.CONFIG_CHANGED,
                        JoinStatusCode.MEMBERSHIP_REJECTED,
                    ):
                        break
                except (
                    JoinPhaseTwoError,
                    ConnectionError,
                    OSError,
                    asyncio.TimeoutError,
                ) as exc:
                    LOG.warning("%s join attempt %d failed: %r", listen_address, attempt, exc)
        except BaseException:
            # Unexpected failure (codec error, cancellation, ...): never leak
            # the already-started server/client.
            await server.shutdown()
            await client.shutdown()
            raise

        await server.shutdown()
        await client.shutdown()
        raise JoinError(f"join attempt unsuccessful for {listen_address}")

    # ------------------------------------------------------------------

    @staticmethod
    def _make_transport(listen_address, settings, network, client, server):
        if client is not None and server is not None:
            return client, server
        if network is None:
            raise ValueError(
                "provide either (client, server) or an InProcessNetwork to attach to"
            )
        return (
            client or InProcessClient(network, listen_address, settings),
            server or InProcessServer(network, listen_address),
        )

    @classmethod
    async def _join_attempt(
        cls, seed_address, listen_address, node_id, settings, client, server,
        fd_factory, metadata, subscriptions, clock, rng, cut_detector_factory=None,
        vote_tally_factory=None, broadcaster_factory=None,
    ) -> "Cluster":
        """One join attempt: phase 1 at the seed, phase 2 at the observers
        (Cluster.java:352-401)."""
        phase1 = await client.send(
            seed_address, PreJoinMessage(sender=listen_address, node_id=node_id)
        )
        assert isinstance(phase1, JoinResponse)
        if phase1.status_code not in (
            JoinStatusCode.SAFE_TO_JOIN,
            JoinStatusCode.HOSTNAME_ALREADY_IN_RING,
        ):
            raise JoinPhaseOneError(phase1)

        # HOSTNAME_ALREADY_IN_RING: a previous attempt's consensus admitted us
        # while our phase 2 timed out; join with config -1 so any observer
        # streams the configuration back (Cluster.java:374-381).
        config_to_join = (
            -1
            if phase1.status_code == JoinStatusCode.HOSTNAME_ALREADY_IN_RING
            else phase1.configuration_id
        )

        # Group ring numbers per observer so each observer gets one message
        # for all rings it gatekeeps (Cluster.java:406-419).
        ring_numbers_per_observer: Dict[Endpoint, List[int]] = {}
        for ring_number, observer in enumerate(phase1.endpoints):
            ring_numbers_per_observer.setdefault(observer, []).append(ring_number)

        sends = [
            client.send(
                observer,
                JoinMessage(
                    sender=listen_address,
                    node_id=node_id,
                    ring_numbers=tuple(ring_numbers),
                    configuration_id=config_to_join,
                    metadata=metadata,
                ),
            )
            for observer, ring_numbers in ring_numbers_per_observer.items()
        ]
        responses = await asyncio.gather(*sends, return_exceptions=True)
        for response in responses:
            if (
                isinstance(response, JoinResponse)
                and response.status_code == JoinStatusCode.SAFE_TO_JOIN
                and response.configuration_id != config_to_join
            ):
                return cls._from_join_response(
                    response, listen_address, settings, client, server,
                    fd_factory, subscriptions, clock, rng, cut_detector_factory,
                    vote_tally_factory, broadcaster_factory, node_id=node_id,
                )
        raise JoinPhaseTwoError()

    @classmethod
    def _from_join_response(
        cls, response: JoinResponse, listen_address, settings, client, server,
        fd_factory, subscriptions, clock, rng, cut_detector_factory=None,
        vote_tally_factory=None, broadcaster_factory=None, node_id=None,
    ) -> "Cluster":
        """Build the node from a streamed configuration (Cluster.java:442-474)."""
        assert response.endpoints and response.identifiers
        view = MembershipView(
            settings.k,
            node_ids=response.identifiers,
            endpoints=response.endpoints,
            topology=settings.topology,
        )
        metadata_map = dict(zip(response.metadata_keys, response.metadata_values))
        detector_factory = cut_detector_factory or MultiNodeCutDetector
        cut_detector = detector_factory(settings.k, settings.h, settings.l)
        broadcaster = (
            broadcaster_factory(client, listen_address, rng) if broadcaster_factory else None
        )
        service = cls._service_class(settings)(
            my_addr=listen_address,
            cut_detector=cut_detector,
            view=view,
            settings=settings,
            client=client,
            fd_factory=fd_factory,
            metadata_map=metadata_map,
            subscriptions=subscriptions,
            clock=clock,
            rng=rng,
            vote_tally_factory=vote_tally_factory,
            broadcaster=broadcaster,
            node_id=node_id,
        )
        server.set_membership_service(cls._server_handler(broadcaster, service))
        cluster = cls(listen_address, service, server, client)
        # This builder is sync (called from the join response loop), so the
        # service start is scheduled rather than awaited — but retained on
        # the cluster: an untracked task could be garbage-collected by the
        # loop before running, and shutdown() awaits it so the background
        # loops it spawns are fully armed before being torn down.
        cluster._start_task = asyncio.ensure_future(service.start())
        return cluster
