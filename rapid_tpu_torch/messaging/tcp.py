"""TCP transport: the real-network implementation of the messaging SPI.

Plays the role of the reference's socket transports (default gRPC,
``GrpcClient.java``/``GrpcServer.java``, and the raw-TCP alternate,
``NettyClientServer.java``): length-framed request/response over persistent
connections, correlation by a per-message counter, per-message-type deadlines
and bounded retries, BOOTSTRAPPING probe answers before the service exists.

Frame layout (little-endian): u32 payload length | u64 correlation id |
u8 kind (0=request, 1=response) | codec payload.

A copy of ``rapid_tpu/messaging/tcp.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import struct
from typing import Dict, Optional, Tuple

from rapid_tpu_torch.errors import ShuttingDownError
from rapid_tpu_torch.messaging.base import MessagingClient, MessagingServer
from rapid_tpu_torch.messaging.codec import (
    decode_request,
    decode_response,
    encode_request,
    encode_response,
)
from rapid_tpu_torch.messaging.retries import call_with_retries
from rapid_tpu_torch.messaging.stats import TransportStats
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import (
    Endpoint,
    JoinMessage,
    NodeStatus,
    PreJoinMessage,
    ProbeMessage,
    ProbeResponse,
    RapidRequest,
    RapidResponse,
)

LOG = logging.getLogger(__name__)

_HEADER = struct.Struct("<IQB")
_MAX_FRAME = 64 * 1024 * 1024


async def _read_frame(reader: asyncio.StreamReader) -> Tuple[int, int, bytes]:
    header = await reader.readexactly(_HEADER.size)
    length, correlation_id, kind = _HEADER.unpack(header)
    if length > _MAX_FRAME:
        raise ConnectionError(f"oversized frame: {length}")
    payload = await reader.readexactly(length)
    return correlation_id, kind, payload


def _write_frame(
    writer: asyncio.StreamWriter, correlation_id: int, kind: int, payload: bytes
) -> None:
    writer.write(_HEADER.pack(len(payload), correlation_id, kind) + payload)


class TcpServer(MessagingServer):
    def __init__(self, listen_address: Endpoint) -> None:
        self.listen_address = listen_address
        self._service = None
        self._server: Optional[asyncio.AbstractServer] = None
        # Event-loop-confined (tools/analysis/concurrency.py): mutated only
        # in cooperative straight-line sections, no lock needed — but no
        # read->await->write may straddle an await.
        self._connections: set = set()  # guarded-by: event-loop
        self.stats = TransportStats()  # paper Table 2 accounting
        # Strong references to in-flight handlers: the event loop only holds
        # tasks weakly, so without this a handler can be garbage-collected
        # mid-flight and the request silently dropped.
        self._handler_tasks: set = set()  # guarded-by: event-loop

    def set_membership_service(self, service) -> None:
        self._service = service

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connection, host=self.listen_address.hostname, port=self.listen_address.port
        )
        if self.listen_address.port == 0:
            # Ephemeral bind: adopt the kernel-assigned port so callers can
            # advertise a real, reachable address.
            port = self._server.sockets[0].getsockname()[1]
            self.listen_address = Endpoint(self.listen_address.hostname, port)

    async def shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
            # Close live connections first: wait_closed() blocks until every
            # per-connection reader loop returns.
            for writer in list(self._connections):
                writer.close()
            await self._server.wait_closed()
            # Reader loops are done now, so no NEW handler tasks can appear
            # (cancelling before wait_closed would race buffered frames
            # spawning fresh handlers). Reap the stragglers: they must not
            # outlive shutdown (they would write to closed writers and leak
            # "Task was destroyed but it is pending" at loop close).
            if self._handler_tasks:
                tasks = list(self._handler_tasks)
                for task in tasks:
                    task.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
            self._server = None

    async def _on_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._connections.add(writer)
        try:
            while True:
                correlation_id, kind, payload = await _read_frame(reader)
                self.stats.rx(_HEADER.size + len(payload))
                if kind != 0:
                    raise ConnectionError("client sent non-request frame")
                task = asyncio.ensure_future(
                    self._handle_one(correlation_id, payload, writer)
                )
                self._handler_tasks.add(task)
                task.add_done_callback(self._handler_tasks.discard)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self._connections.discard(writer)
            writer.close()

    async def _handle_one(
        self, correlation_id: int, payload: bytes, writer: asyncio.StreamWriter
    ) -> None:
        try:
            request = decode_request(payload)
            if self._service is None:
                if isinstance(request, ProbeMessage):
                    response: RapidResponse = ProbeResponse(status=NodeStatus.BOOTSTRAPPING)
                else:
                    return  # no service yet; let the sender time out and retry
            else:
                response = await self._service.handle_message(request)
            payload_out = encode_response(response)
            _write_frame(writer, correlation_id, 1, payload_out)
            self.stats.tx(_HEADER.size + len(payload_out))
            await writer.drain()
        except Exception as exc:  # noqa: BLE001 — connection-level fault isolation
            LOG.debug("server %s failed handling request: %r", self.listen_address, exc)


class _Connection:
    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        stats: TransportStats,
    ) -> None:
        self.reader = reader
        self.writer = writer
        self.stats = stats
        self.pending: Dict[int, asyncio.Future] = {}
        self.reader_task = asyncio.ensure_future(self._read_loop())

    async def _read_loop(self) -> None:
        try:
            while True:
                correlation_id, kind, payload = await _read_frame(self.reader)
                # Count at the frame-read site: a response that lands after
                # its request timed out still crossed the wire (exactly the
                # slow-RPC regime Table 2 measures).
                self.stats.rx(_HEADER.size + len(payload))
                future = self.pending.pop(correlation_id, None)
                if future is not None and not future.done():
                    future.set_result(payload)
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as exc:
            for future in self.pending.values():
                if not future.done():
                    future.set_exception(ConnectionError(f"connection lost: {exc!r}"))
            self.pending.clear()

    def close(self) -> None:
        self.reader_task.cancel()
        self.writer.close()


class TcpClient(MessagingClient):
    """Persistent-connection client with correlation ids (the reference's
    channel cache + outstandingRequests future map, NettyClientServer.java:70-137)."""

    def __init__(self, my_addr: Endpoint, settings: Optional[Settings] = None) -> None:
        self.my_addr = my_addr
        self._settings = settings if settings is not None else Settings()
        # The check-then-connect in _connection_for is serialized by the
        # PER-REMOTE locks below (a dict of locks is beyond what the
        # guarded-by analysis can prove held, so the map itself carries the
        # event-loop discipline: no read->await->write outside those locks).
        self._connections: Dict[Endpoint, _Connection] = {}  # guarded-by: event-loop
        self._connect_locks: Dict[Endpoint, asyncio.Lock] = {}  # guarded-by: event-loop
        self._correlation = itertools.count(1)
        self._shut_down = False  # guarded-by: event-loop
        self.stats = TransportStats()  # paper Table 2 accounting

    def _timeout_ms_for(self, request: RapidRequest) -> float:
        if isinstance(request, (JoinMessage, PreJoinMessage)):
            return self._settings.rpc_join_timeout_ms
        if isinstance(request, ProbeMessage):
            return self._settings.rpc_probe_timeout_ms
        return self._settings.rpc_timeout_ms

    async def _connection_for(self, remote: Endpoint) -> _Connection:
        # Per-remote connect lock: concurrent first sends must share one
        # connection, not race to open several and leak the losers.
        lock = self._connect_locks.setdefault(remote, asyncio.Lock())
        async with lock:
            conn = self._connections.get(remote)
            if conn is not None and not conn.writer.is_closing():
                return conn
            reader, writer = await asyncio.open_connection(remote.hostname, remote.port)
            conn = _Connection(reader, writer, self.stats)
            self._connections[remote] = conn
            return conn

    def _invalidate(self, remote: Endpoint, conn: _Connection) -> None:
        if self._connections.get(remote) is conn:
            self._connections.pop(remote, None)
        conn.close()

    async def _attempt(self, remote: Endpoint, request: RapidRequest) -> RapidResponse:
        if self._shut_down:
            raise ShuttingDownError(f"client {self.my_addr} is shut down")
        timeout_s = self._timeout_ms_for(request) / 1000.0
        conn = await asyncio.wait_for(self._connection_for(remote), timeout=timeout_s)
        correlation_id = next(self._correlation)
        future: asyncio.Future = asyncio.get_event_loop().create_future()
        conn.pending[correlation_id] = future
        try:
            payload_out = encode_request(request)
            _write_frame(conn.writer, correlation_id, 0, payload_out)
            self.stats.tx(_HEADER.size + len(payload_out))
            await conn.writer.drain()
            payload = await asyncio.wait_for(future, timeout=timeout_s)
            return decode_response(payload)
        except asyncio.TimeoutError:
            # A slow RPC is not a transport failure: drop only this request's
            # correlation slot and leave the shared connection (and everyone
            # else's in-flight requests) alone.
            conn.pending.pop(correlation_id, None)
            raise
        except Exception:  # noqa: BLE001 — cleanup-and-reraise, not a catch:
            # any transport-level failure invalidates the cached connection
            # (GrpcClient.java:106-115's channel invalidation) and then
            # propagates unchanged to the caller's retry policy.
            conn.pending.pop(correlation_id, None)
            self._invalidate(remote, conn)
            raise

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
        for conn in self._connections.values():
            conn.close()
        self._connections.clear()
