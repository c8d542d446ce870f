"""Messaging plugin SPI.

The critical design seam of the reference, reproduced exactly: the protocol
core never touches sockets. All sends go through ``MessagingClient``
(``messaging/IMessagingClient.java:25-49``), all receives enter through a
``MessagingServer`` that forwards to ``MembershipService.handle_message``
(``messaging/IMessagingServer.java:24-40``), and broadcast fan-out is a
``Broadcaster`` (``messaging/IBroadcaster.java:26-29``). Transports are
swapped via ``Cluster`` builder arguments.

A copy of ``rapid_tpu/messaging/base.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

import abc
import asyncio
import functools
import logging
import random
from typing import List, Optional, Set, TYPE_CHECKING

from rapid_tpu_torch.errors import ShuttingDownError
from rapid_tpu_torch.types import Endpoint, RapidRequest, RapidResponse

if TYPE_CHECKING:
    from rapid_tpu_torch.protocol.service import MembershipService

LOG = logging.getLogger(__name__)


def _reap_nowait_task(tasks: "Set[asyncio.Task]", task: asyncio.Task) -> None:
    tasks.discard(task)
    if task.cancelled():
        return
    exc = task.exception()
    if exc is None:
        return
    # Best-effort sends absorb transport failures and return None; the only
    # EXPECTED escapee is ShuttingDownError racing a late broadcast. Anything
    # else is a transport bug that must stay as visible as the loop's old
    # "exception was never retrieved" message, not quieter.
    if isinstance(exc, ShuttingDownError):
        LOG.debug("send_nowait raced transport shutdown: %r", exc)
    else:
        LOG.warning("send_nowait task failed: %r", exc)


class MessagingClient(abc.ABC):
    """Send messages to remote endpoints.

    ``send`` retransmits per the transport's retry policy and raises on final
    failure; ``send_best_effort`` makes one attempt and returns None on
    failure (IMessagingClient.java:25-49).
    """

    @abc.abstractmethod
    async def send(self, remote: Endpoint, request: RapidRequest) -> RapidResponse:
        ...

    @abc.abstractmethod
    async def send_best_effort(
        self, remote: Endpoint, request: RapidRequest
    ) -> Optional[RapidResponse]:
        ...

    def send_nowait(self, remote: Endpoint, request: RapidRequest) -> None:
        """Fire-and-forget best-effort send (broadcasts, consensus traffic).
        The task is tracked in a per-client strong-reference set — the event
        loop holds tasks weakly, so an untracked send could be garbage-
        collected mid-flight — and its outcome is observed by the reaper
        callback (``send_best_effort`` returns None on failure by contract,
        but a transport shutting down underneath the send re-raises). The
        set lives on the client instance (lazily, so abstract subclasses
        need no ``super().__init__``): when the client is dropped after
        shutdown, any entry stranded by a loop that closed mid-flight is
        released with it instead of accumulating for the process lifetime."""
        tasks: Set[asyncio.Task] = self.__dict__.setdefault("_nowait_tasks", set())
        task = asyncio.ensure_future(self.send_best_effort(remote, request))
        tasks.add(task)
        task.add_done_callback(functools.partial(_reap_nowait_task, tasks))

    @abc.abstractmethod
    async def shutdown(self) -> None:
        ...


class MessagingServer(abc.ABC):
    """Receive messages and hand them to the membership service. The server
    starts before the service exists (join protocol); probes received in that
    window answer BOOTSTRAPPING (GrpcServer.java:77-96)."""

    @abc.abstractmethod
    async def start(self) -> None:
        ...

    @abc.abstractmethod
    async def shutdown(self) -> None:
        ...

    @abc.abstractmethod
    def set_membership_service(self, service: "MembershipService") -> None:
        ...


class Broadcaster(abc.ABC):
    """Fan a request out to all members (IBroadcaster.java:26-29)."""

    @abc.abstractmethod
    def broadcast(self, request: RapidRequest) -> None:
        ...

    @abc.abstractmethod
    def set_membership(self, members: List[Endpoint]) -> None:
        ...


class UnicastToAllBroadcaster(Broadcaster):
    """Default broadcaster: best-effort unicast to every member, in an order
    shuffled once per configuration to spread load
    (UnicastToAllBroadcaster.java:46-62)."""

    def __init__(self, client: MessagingClient, rng: Optional[random.Random] = None) -> None:
        self._client = client
        self._members: List[Endpoint] = []
        # The service always threads its identity-seeded rng; this SPI layer
        # has no identity of its own to derive a seed from, so a bare
        # standalone construction keeps the stdlib default.
        self._rng = rng if rng is not None else random.Random()  # unseeded-ok: no identity at this layer; every in-library caller injects the service's seeded rng

    def broadcast(self, request: RapidRequest) -> None:
        for member in self._members:
            self._client.send_nowait(member, request)

    def set_membership(self, members: List[Endpoint]) -> None:
        members = list(members)
        self._rng.shuffle(members)
        self._members = members
