"""Epidemic (gossip) broadcaster — the alternate broadcast strategy the
reference's SPI documents but never ships (``IBroadcaster.java:24-29``: "one
can plug in alternate implementations, such as gossip").

Instead of the origin unicasting to all N members
(``UnicastToAllBroadcaster.java:46-53``, origin egress O(N)), the origin
pushes a :class:`~rapid_tpu_torch.types.GossipMessage` envelope to ``fanout``
random members; every member relays a FIRST-SEEN envelope to ``fanout``
random members of its own and drops redeliveries. With fanout ~ ln N + c,
push-once epidemics reach all N members with high probability while each
node's egress stays O(log N) — the load-spreading the paper's §7 points at
for vote/alert traffic at scale.

The relay layer lives entirely in messaging: the protocol core still hands
requests to its ``Broadcaster`` and receives them through ``handle_message``;
the unwrap/dedup/relay happens in a router facade wrapped around the service
(``GossipBroadcaster.router``), so transports and the membership service are
untouched. Wire framing is first-class (codec tag 11).
"""

from __future__ import annotations

import math
import random
from collections import OrderedDict
from typing import List, Optional, Tuple

from rapid_tpu_torch.messaging.base import Broadcaster, MessagingClient
from rapid_tpu_torch.types import Endpoint, GossipMessage, RapidRequest, Response

# Remembered (origin, msg_id) pairs; beyond this the oldest are forgotten.
# A forgotten-then-redelivered envelope re-relays once — wasteful, never
# incorrect (the protocol's handlers are all idempotent / config-id gated).
_SEEN_CAP = 8192


class GossipBroadcaster(Broadcaster):
    """Push gossip with first-seen relay.

    ``fanout``/``ttl``: explicit values, or None to size from the current
    membership at each broadcast (fanout = ceil(ln N) + 4, ttl =
    ceil(log2 N) + 4 — w.h.p. full coverage with O(N log N) total
    transmissions, each node sending O(log N)).
    """

    def __init__(
        self,
        client: MessagingClient,
        self_endpoint: Endpoint,
        fanout: Optional[int] = None,
        ttl: Optional[int] = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        if ttl is not None and not 0 <= ttl <= 255:
            # The wire encodes ttl as u8; catching it here beats a
            # struct.error inside a fire-and-forget send task.
            raise ValueError(f"gossip ttl must be in [0, 255], got {ttl}")
        if fanout is not None and fanout < 1:
            raise ValueError(f"gossip fanout must be >= 1, got {fanout}")
        if getattr(client, "supports_gossip", True) is False:
            # e.g. the reference-schema interop transport: GossipMessage has
            # no rapid.proto representation (deliberately — see PARITY.md),
            # and failing at wiring time beats every broadcast vanishing
            # into per-send KeyErrors inside fire-and-forget tasks.
            raise ValueError(
                f"{type(client).__name__} cannot carry gossip envelopes; "
                "use the framework-native transports (in-process/TCP/UDP)"
            )
        self._client = client
        self._self = self_endpoint
        self._fanout = fanout
        self._ttl = ttl
        # Identity-seeded default: relay fan-out picks stay decorrelated
        # across members (different endpoints) but reproducible across runs
        # (determinism audit, tools/analysis/determinism.py).
        self._rng = rng if rng is not None else random.Random(f"gossip:{self_endpoint}")
        # Relay state is event-loop-confined (tools/analysis/concurrency.py):
        # broadcast/accept/_relay are synchronous, so every dedup
        # check-then-remember runs atomically under cooperative scheduling —
        # the annotation keeps it that way (an await slipped between a _seen
        # lookup and its _remember would re-relay duplicate envelopes).
        #: Optional fan-out scope (set by the hierarchical service,
        #: rapid_tpu_torch/hier): maps the full membership to the subset this
        #: node relays to — gossip then spreads within the cohort instead of
        #: cluster-wide, keeping the epidemic's per-node egress O(log c).
        self.scope_fn = None  # guarded-by: event-loop
        self._members: List[Endpoint] = []  # guarded-by: event-loop
        self._seen: "OrderedDict[Tuple[Endpoint, int], None]" = OrderedDict()  # guarded-by: event-loop
        self.relays_sent = 0  # observability: total envelope transmissions

    @classmethod
    def factory(cls, fanout: Optional[int] = None, ttl: Optional[int] = None):
        """A ``broadcaster_factory`` for ``Cluster.start/join``:
        ``factory(client, listen_address, rng) -> GossipBroadcaster``."""

        def make(client: MessagingClient, listen_address: Endpoint, rng):
            return cls(client, listen_address, fanout=fanout, ttl=ttl, rng=rng)

        return make

    # -- Broadcaster SPI ------------------------------------------------

    def broadcast(self, request: RapidRequest) -> None:
        n = len(self._members)
        msg_id = self._rng.getrandbits(64)
        self._remember((self._self, msg_id))
        envelope = GossipMessage(
            origin=self._self, msg_id=msg_id, ttl=self._ttl_for(n), payload=request
        )
        self._relay(envelope)
        if self._self in self._members:
            # Deliver to self directly (UnicastToAllBroadcaster includes the
            # sender in its fan-out; the envelope never loops back to us —
            # its msg_id is already remembered).
            self._client.send_nowait(self._self, request)

    def set_membership(self, members: List[Endpoint]) -> None:
        scoped = self.scope_fn(members) if self.scope_fn is not None else members
        self._members = list(scoped)

    # -- relay side (called by the router facade) -----------------------

    def accept(self, envelope: GossipMessage) -> Optional[RapidRequest]:
        """First delivery: relay onward and return the payload for local
        handling. Redelivery: None."""
        key = (envelope.origin, envelope.msg_id)
        if key in self._seen:
            return None
        self._remember(key)
        if envelope.ttl > 0:
            self._relay(
                GossipMessage(
                    origin=envelope.origin,
                    msg_id=envelope.msg_id,
                    ttl=envelope.ttl - 1,
                    payload=envelope.payload,
                )
            )
        return envelope.payload

    def router(self, service) -> "GossipRouter":
        """Wrap the membership service for ``set_membership_service``."""
        return GossipRouter(self, service)

    # -- internals ------------------------------------------------------

    def _ttl_for(self, n: int) -> int:
        if self._ttl is not None:
            return self._ttl
        return math.ceil(math.log2(max(n, 2))) + 4

    def _fanout_for(self, n: int) -> int:
        if self._fanout is not None:
            return self._fanout
        return math.ceil(math.log(max(n, 2))) + 4

    def _relay(self, envelope: GossipMessage) -> None:
        candidates = [m for m in self._members if m != self._self]
        if not candidates:
            return
        k = min(self._fanout_for(len(self._members)), len(candidates))
        for target in self._rng.sample(candidates, k):
            self.relays_sent += 1
            self._client.send_nowait(target, envelope)

    def _remember(self, key: Tuple[Endpoint, int]) -> None:
        self._seen[key] = None
        if len(self._seen) > _SEEN_CAP:
            self._seen.popitem(last=False)


class GossipRouter:
    """Duck-typed stand-in for the membership service at the server seam:
    unwraps gossip envelopes (dedup + relay via the broadcaster), forwards
    everything else — and first deliveries — to the real service."""

    def __init__(self, broadcaster: GossipBroadcaster, service) -> None:
        self._broadcaster = broadcaster
        self._service = service

    async def handle_message(self, request: RapidRequest):
        if isinstance(request, GossipMessage):
            payload = self._broadcaster.accept(request)
            if payload is not None:
                await self._service.handle_message(payload)
            return Response()
        return await self._service.handle_message(request)
