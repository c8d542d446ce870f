"""Hybrid TCP+UDP transport: datagrams for one-way best-effort traffic.

The reference routes everything over unary gRPC, but the paper notes that
alert gossip and consensus vote counting are one-way and loss-tolerant and
"can run over UDP" (paper §7). This transport implements that: broadcast-fan
messages (batched alerts, fast-round votes, phase2b echoes, leaves) travel
as single datagrams — no connection setup, no response path — while
request/response traffic (joins, probes, coordinator-bound phase1b) stays on
the reliable TCP path. Both listeners share the endpoint's port.

Protocol safety and liveness: the protocol treats everything routed over UDP
as best-effort and replaces the reference transport's delivery guarantee at
the protocol level (see settings.py): alert batches are re-broadcast while
their cut is unresolved, undecided consensus re-arms (vote re-offer plus
escalating classic rounds, ``fast_paxos.py``), and a node that misses a
decision entirely pulls the configuration from a peer over the reliable TCP
path (``service._config_sync_loop``). Datagram loss therefore costs
convergence latency, never liveness or correctness. Even the historically
worst case — a decision naming a joiner whose every UP alert datagram was
lost — now resolves by pulling the decided configuration (identifiers
included) from a peer instead of forcing a rejoin
(``service._recover_from_unknown_joiners``). tests/test_udp_loss.py pins the
envelope; tests/test_delivery_liveness.py pins each mechanism.
"""

from __future__ import annotations

import asyncio
import ipaddress
import logging
import random
from typing import Dict, Optional

from rapid_tpu_torch.messaging.codec import decode_request, encode_request
from rapid_tpu_torch.messaging.tcp import TcpClient, TcpServer
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import (
    BatchedAlertMessage,
    Endpoint,
    GossipMessage,
    FastRoundPhase2bMessage,
    LeaveMessage,
    Phase1aMessage,
    Phase2aMessage,
    Phase2bMessage,
    RapidRequest,
    RapidResponse,
    Response,
)

LOG = logging.getLogger(__name__)

# One-way message types: no caller consumes their response. GossipMessage
# envelopes are fire-and-forget relays (GossipRouter discards the response),
# so --transport udp --broadcast gossip keeps the datagram fast path.
ONEWAY_TYPES = (
    BatchedAlertMessage,
    FastRoundPhase2bMessage,
    GossipMessage,
    Phase1aMessage,
    Phase2aMessage,
    Phase2bMessage,
    LeaveMessage,
)

_MAX_DATAGRAM = 60 * 1024


class _ServerProtocol(asyncio.DatagramProtocol):
    def __init__(self, server: "UdpHybridServer") -> None:
        self._server = server
        # Strong references: the loop only weakly references tasks, and a
        # collected handler task silently drops the datagram.
        self._tasks: set = set()

    def datagram_received(self, data: bytes, addr) -> None:
        task = asyncio.ensure_future(self._server._handle_datagram(data))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)


class UdpHybridServer(TcpServer):
    """TCP server plus a UDP listener on the same port for one-way traffic."""

    def __init__(self, listen_address: Endpoint) -> None:
        super().__init__(listen_address)
        self._udp_transport: Optional[asyncio.DatagramTransport] = None

    async def start(self) -> None:
        await super().start()
        loop = asyncio.get_event_loop()
        try:
            self._udp_transport, _ = await loop.create_datagram_endpoint(
                lambda: _ServerProtocol(self),
                local_addr=(self.listen_address.hostname, self.listen_address.port),
            )
        except BaseException:
            # Don't leak the already-accepting TCP listener.
            await super().shutdown()
            raise

    async def shutdown(self) -> None:
        if self._udp_transport is not None:
            self._udp_transport.close()
            self._udp_transport = None
        await super().shutdown()

    async def _handle_datagram(self, data: bytes) -> None:
        try:
            self.stats.rx(len(data))
            request = decode_request(data)
            if self._service is not None:
                await self._service.handle_message(request)
        except Exception as exc:  # noqa: BLE001 — datagram-level fault isolation
            LOG.debug("server %s dropped bad datagram: %r", self.listen_address, exc)


class _ClientProtocol(asyncio.DatagramProtocol):
    def datagram_received(self, data: bytes, addr) -> None:
        pass  # one-way: responses never arrive

    def error_received(self, exc: Exception) -> None:
        # sendto errors surface here asynchronously, not at the call site.
        LOG.debug("udp send error: %r", exc)


class UdpHybridClient(TcpClient):
    """TCP client whose best-effort sends of one-way message types go as
    single datagrams (everything else rides the TCP correlation path)."""

    def __init__(self, my_addr: Endpoint, settings: Optional[Settings] = None) -> None:
        super().__init__(my_addr, settings)
        self._udp_transports: Dict[int, asyncio.DatagramTransport] = {}  # guarded-by: _udp_lock
        self._udp_lock = asyncio.Lock()

    async def _udp(self, ip_version: int) -> asyncio.DatagramTransport:
        # Guarded like TcpClient._connection_for: concurrent first sends must
        # share one socket, not race to create and leak several.
        transport = self._udp_transports.get(ip_version)
        if transport is not None and not transport.is_closing():
            return transport
        async with self._udp_lock:
            transport = self._udp_transports.get(ip_version)
            if transport is None or transport.is_closing():
                loop = asyncio.get_event_loop()
                local = ("0.0.0.0", 0) if ip_version == 4 else ("::", 0)
                transport, _ = await loop.create_datagram_endpoint(
                    _ClientProtocol, local_addr=local
                )
                self._udp_transports[ip_version] = transport
            return transport

    async def send_best_effort(
        self, remote: Endpoint, request: RapidRequest
    ) -> Optional[RapidResponse]:
        # The datagram fast path applies only to literal-IP endpoints:
        # transport.sendto never raises to the caller (errors land in
        # error_received), so a hostname that resolves differently — or not
        # at all — would be a silent drop with a fake success. Non-IP
        # hostnames take the reliable TCP path.
        if isinstance(request, ONEWAY_TYPES):
            try:
                ip = ipaddress.ip_address(remote.hostname)
            except ValueError:
                ip = None
            if ip is not None:
                payload = encode_request(request)
                if len(payload) <= _MAX_DATAGRAM:
                    if await self._send_datagram(ip.version, remote, payload):
                        return Response()  # fire-and-forget: no ack exists
        return await super().send_best_effort(remote, request)

    async def _send_datagram(self, ip_version: int, remote: Endpoint, payload: bytes) -> bool:
        """Put one datagram on the wire; False routes the caller to the TCP
        fallback. The seam LossyDatagramClient injects network loss at."""
        try:
            transport = await self._udp(ip_version)
            transport.sendto(payload, (remote.hostname, remote.port))
            self.stats.tx(len(payload))
            return True
        except Exception as exc:  # noqa: BLE001 — fall back to TCP
            LOG.debug("udp send to %s failed (%r); falling back to tcp", remote, exc)
            return False

    async def shutdown(self) -> None:
        # Under the same lock _udp() creates through: a shutdown racing a
        # concurrent first send could otherwise clear the map mid-create and
        # leak the freshly-opened datagram transport past shutdown
        # (surfaced by the unguarded-mutation analysis).
        async with self._udp_lock:
            for transport in self._udp_transports.values():
                transport.close()
            self._udp_transports.clear()
        await super().shutdown()


class LossyDatagramClient(UdpHybridClient):
    """Fault-injection client: a seeded fraction of outbound datagrams is
    dropped AFTER the sender commits to the datagram path — exactly where
    network loss strikes (the sender believes it sent; no TCP fallback
    engages). This is the instrument that quantifies the hybrid transport's
    admitted tradeoff (module docstring above): datagram loss costs
    convergence latency — lost votes and alerts ride out the redelivery and
    fallback timers, and in the limit a node catches up by config pull.
    tests/test_udp_loss.py pins the rejoin-free envelope;
    examples/udp_loss_curve.py measures the latency curve."""

    def __init__(
        self,
        my_addr: Endpoint,
        settings: Optional[Settings] = None,
        loss_rate: float = 0.0,
        rng: Optional[random.Random] = None,
    ) -> None:
        if not 0.0 <= loss_rate <= 1.0:
            raise ValueError(f"loss_rate must be in [0, 1], got {loss_rate}")
        super().__init__(my_addr, settings)
        self.loss_rate = loss_rate
        self._rng = rng if rng is not None else random.Random(0)
        self.datagrams_dropped = 0
        self.datagrams_delivered = 0

    async def _send_datagram(self, ip_version: int, remote: Endpoint, payload: bytes) -> bool:
        if self._rng.random() < self.loss_rate:
            self.datagrams_dropped += 1
            self.stats.tx(len(payload))  # the sender transmitted; the network ate it
            return True
        self.datagrams_delivered += 1
        return await super()._send_datagram(ip_version, remote, payload)
