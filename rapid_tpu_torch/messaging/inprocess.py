"""In-process transport: many virtual endpoints in one event loop.

The reference's tests run whole clusters over in-process gRPC
(``GrpcServer.java:132-148`` in-process mode, ``settings.setUseInProcessTransport``);
this module is the equivalent first-class transport, plus the fault-injection
interceptor seam its test fixtures provide (``MessageDropInterceptor.java:24-73``:
drop-first-N-of-type at the server, latch-delay-by-type at the client).

This transport is also how co-located virtual nodes talk on a TPU host in the
hybrid host/device deployment: message passing is a Python method call, so the
whole cluster's protocol traffic stays in one process.

A copy of ``rapid_tpu/messaging/inprocess.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Type

from rapid_tpu_torch.errors import ShuttingDownError
from rapid_tpu_torch.messaging.base import MessagingClient, MessagingServer
from rapid_tpu_torch.messaging.codec import encode_request, encode_response
from rapid_tpu_torch.messaging.retries import call_with_retries
from rapid_tpu_torch.messaging.stats import TransportStats
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import (
    Endpoint,
    JoinMessage,
    PreJoinMessage,
    ProbeMessage,
    ProbeResponse,
    NodeStatus,
    RapidRequest,
    RapidResponse,
)


class InProcessNetwork:
    """A registry of in-process servers, shared by the clients of one test or
    one co-located deployment."""

    def __init__(self, count_wire_bytes: bool = False) -> None:
        self.servers: Dict[Endpoint, "InProcessServer"] = {}
        # Endpoints listed here are unreachable (simulated crash/partition).
        self.blackholed: set = set()
        # Directional blackholes: (src, dst) pairs that drop.
        self.blackholed_links: set = set()
        # Statistical link shaping (seeded loss/delay/duplication), consulted
        # per attempt when set — the sim subsystem's LinkShaper
        # (rapid_tpu/sim/faults.py) plugs in here. None = a perfect network,
        # zero overhead on the common path.
        self.shaper = None
        # One-shot message-triggered callbacks, consulted on every server
        # handle — the chaos runner's ``committee_crash`` arming point: a
        # fault that must land at an exact PROTOCOL moment (e.g. between
        # cohort-cut forwarding and the global decision) hooks the first
        # sighting of the message that opens the window. Empty on the
        # common path.
        self.tripwires: List["RequestTripwire"] = []
        # Account wire-EQUIVALENT bytes (what the codec would put on a TCP
        # frame) in every client/server TransportStats. Off by default: no
        # bytes actually move in-process, and encoding every message only
        # to measure it would tax the big cluster tests. Message counts are
        # always kept.
        self.count_wire_bytes = count_wire_bytes

    def server_for(self, endpoint: Endpoint) -> Optional["InProcessServer"]:
        return self.servers.get(endpoint)


class ServerDropFirstN:
    """Drop the first N messages of a type at the server
    (ServerDropInterceptors.FirstN, MessageDropInterceptor.java:24-49)."""

    def __init__(self, message_type: Type, count: int) -> None:
        self._type = message_type
        self._remaining = count

    def should_drop(self, request: RapidRequest) -> bool:
        if isinstance(request, self._type) and self._remaining > 0:
            self._remaining -= 1
            return True
        return False


class RequestTripwire:
    """Fire a callback ONCE when the first message of a type is observed at
    any server — the in-process analog of an interceptor that reacts to a
    protocol moment rather than a wall-clock one. The callback runs
    synchronously BEFORE the triggering message is handled, so a fault it
    injects (e.g. crashing the recipient) affects the triggering delivery
    itself, exactly like a process dying as the datagram arrives."""

    def __init__(self, message_type: Type, callback) -> None:
        self._type = message_type
        self._callback = callback
        self.fired = False

    def observe(self, request: RapidRequest) -> None:
        if not self.fired and isinstance(request, self._type):
            self.fired = True
            self._callback()


class ClientDelayer:
    """Hold messages of a type until a latch opens
    (ClientInterceptors.Delayer, MessageDropInterceptor.java:51-73)."""

    def __init__(self, message_type: Type) -> None:
        self._type = message_type
        self._event = asyncio.Event()
        # Messages currently parked on the latch — tests sequence on this
        # instead of sleeping (a fixed sleep can miss the interleaving and
        # silently skip the path under test).
        self.held = 0

    def open(self) -> None:
        self._event.set()

    async def maybe_delay(self, request: RapidRequest) -> None:
        if isinstance(request, self._type) and not self._event.is_set():
            self.held += 1
            try:
                await self._event.wait()
            finally:
                self.held -= 1


class InProcessServer(MessagingServer):
    def __init__(self, network: InProcessNetwork, listen_address: Endpoint) -> None:
        self._network = network
        self.listen_address = listen_address
        self._service = None
        self._started = False
        self.drop_interceptors: List[ServerDropFirstN] = []
        self.stats = TransportStats()  # paper Table 2 accounting

    def set_membership_service(self, service) -> None:
        self._service = service

    async def start(self) -> None:
        self._network.servers[self.listen_address] = self
        self._started = True

    async def shutdown(self) -> None:
        self._network.servers.pop(self.listen_address, None)
        self._started = False

    async def handle(self, request: RapidRequest) -> RapidResponse:
        if not self._started:
            raise ConnectionError(f"server {self.listen_address} not started")
        self.stats.rx(
            len(encode_request(request)) if self._network.count_wire_bytes else 0
        )
        for tripwire in self._network.tripwires:
            tripwire.observe(request)
        if self.listen_address in self._network.blackholed:
            # A tripwire (or a concurrent fault) crashed THIS server while
            # the message was in flight: the triggering delivery is lost
            # with the process, like a real crash mid-arrival.
            raise ConnectionError(f"server {self.listen_address} crashed")
        for interceptor in self.drop_interceptors:
            if interceptor.should_drop(request):
                raise ConnectionError("dropped by interceptor")
        if self._service is None:
            # Answer probes while bootstrapping; joiners' FDs tolerate this
            # status (GrpcServer.java:77-96).
            if isinstance(request, ProbeMessage):
                response: RapidResponse = ProbeResponse(status=NodeStatus.BOOTSTRAPPING)
            else:
                raise ConnectionError(
                    f"server {self.listen_address} has no service yet"
                )
        else:
            response = await self._service.handle_message(request)
        # Account the response direction too (TCP counts both ways; without
        # this the in-process Table 2 numbers omit all response traffic).
        self.stats.tx(
            len(encode_response(response)) if self._network.count_wire_bytes else 0
        )
        return response


class InProcessClient(MessagingClient):
    def __init__(
        self,
        network: InProcessNetwork,
        my_addr: Endpoint,
        settings: Optional[Settings] = None,
    ) -> None:
        self._network = network
        self.my_addr = my_addr
        self._settings = settings if settings is not None else Settings()
        self._shut_down = False
        self.delayers: List[ClientDelayer] = []
        self.stats = TransportStats()  # paper Table 2 accounting

    def _timeout_ms_for(self, request: RapidRequest) -> float:
        # Per-message-type deadlines (GrpcClient.java:194-203).
        if isinstance(request, (JoinMessage, PreJoinMessage)):
            return self._settings.rpc_join_timeout_ms
        if isinstance(request, ProbeMessage):
            return self._settings.rpc_probe_timeout_ms
        return self._settings.rpc_timeout_ms

    async def _attempt(self, remote: Endpoint, request: RapidRequest) -> RapidResponse:
        if self._shut_down:
            raise ShuttingDownError(f"client {self.my_addr} is shut down")
        for delayer in self.delayers:
            await delayer.maybe_delay(request)
        if remote in self._network.blackholed or self.my_addr in self._network.blackholed:
            raise ConnectionError(f"{remote} unreachable (blackholed)")
        if (self.my_addr, remote) in self._network.blackholed_links:
            raise ConnectionError(f"link {self.my_addr}->{remote} blackholed")
        shaper = self._network.shaper
        duplicated = False
        if shaper is not None:
            plan = shaper.plan(self.my_addr, remote)
            if plan.drop:
                raise ConnectionError(
                    f"link {self.my_addr}->{remote} dropped (shaper)"
                )
            if plan.delay_ms > 0:
                await shaper.hold_ms(plan.delay_ms)
            duplicated = plan.duplicate
        server = self._network.server_for(remote)
        if server is None:
            raise ConnectionError(f"no server at {remote}")
        self.stats.tx(
            len(encode_request(request)) if self._network.count_wire_bytes else 0
        )
        # Yield to the loop so in-process delivery preserves async semantics.
        await asyncio.sleep(0)
        if duplicated:
            # A duplicated datagram: the server handles the request twice
            # (exercising receiver-side dedup — gossip first-seen, alert
            # report idempotency); the caller sees the second response, as a
            # real retransmit's caller would. The first copy's fate is
            # independent of the second's: a server-side drop (interceptor)
            # or timeout on one copy must not fail the other.
            try:
                await asyncio.wait_for(
                    server.handle(request),
                    timeout=self._timeout_ms_for(request) / 1000.0,
                )
            except (ConnectionError, asyncio.TimeoutError):
                pass
        response = await asyncio.wait_for(
            server.handle(request), timeout=self._timeout_ms_for(request) / 1000.0
        )
        self.stats.rx(
            len(encode_response(response)) if self._network.count_wire_bytes else 0
        )
        return response

    async def send(self, remote: Endpoint, request: RapidRequest) -> RapidResponse:
        return await call_with_retries(
            lambda: self._attempt(remote, request), self._settings.rpc_default_retries
        )

    async def send_best_effort(
        self, remote: Endpoint, request: RapidRequest
    ) -> Optional[RapidResponse]:
        try:
            return await self._attempt(remote, request)
        except ShuttingDownError:
            raise
        except Exception:  # noqa: BLE001 — the best-effort contract
            # (IMessagingClient.java:25-49): one attempt, None on any
            # transport failure; only shutdown races propagate (above).
            return None

    async def shutdown(self) -> None:
        self._shut_down = True
