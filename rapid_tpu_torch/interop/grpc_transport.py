"""gRPC transport speaking the reference's wire protocol (a copy of
``rapid_tpu/interop/grpc_transport.py`` over the port's messaging SPI).

Implements the messaging SPI over the exact RPC the reference serves —
``remoting.MembershipService/sendRequest`` (rapid.proto:9-11) with
protobuf-encoded ``RapidRequest``/``RapidResponse`` envelopes. By default
compatibility is at the RPC/wire layer only, because the tpu-native topology
orders rings differently from Java (our ``ring_key`` hashes the port as
8 bytes and sorts keys/identifiers unsigned; the reference hashes 4-byte
ints and compares signed, ``MembershipView.java:579-587``), so configuration
ids and observer sets would diverge. ``Settings(topology="java")`` closes
that gap: it switches the ring ordering and configuration-id fold to
reference-exact semantics (rapid_tpu_torch.protocol.view.TOPOLOGY_JAVA, pinned in
tests/test_view_java_compat.py), making mixed Java/rapid_tpu clusters over
this transport possible in principle. Either way the transport buys the
reference's operational surface — gRPC tooling, interceptors, proxies.
Built on grpc.aio with a generic method handler (no generated stubs; the
schema is materialized at runtime, rapid_tpu_torch.interop.proto_schema).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

import grpc
import grpc.aio

from rapid_tpu_torch.errors import ShuttingDownError
from rapid_tpu_torch.interop.convert import (
    request_from_proto,
    request_to_proto,
    response_from_proto,
    response_to_proto,
)
from rapid_tpu_torch.interop.proto_schema import GRPC_METHOD, proto_class
from rapid_tpu_torch.messaging.base import MessagingClient, MessagingServer
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

_SERVICE = "remoting.MembershipService"
_METHOD = "sendRequest"

#: Trace-context header. rapid.proto has no trace field and its descriptors
#: are frozen by the golden wire fixtures (tests/test_wire_fixtures.py), so
#: the correlation key travels as gRPC metadata — invisible to the message
#: schema, ignored by a reference peer, re-attached to the native request on
#: our side.
TRACE_METADATA_KEY = "rapid-trace-id"


def _trace_metadata(request: RapidRequest):
    trace_id = getattr(request, "trace_id", None)
    if trace_id is None:
        return None
    return ((TRACE_METADATA_KEY, str(trace_id)),)


def _attach_trace(request: RapidRequest, invocation_metadata) -> RapidRequest:
    if not hasattr(request, "trace_id") or invocation_metadata is None:
        return request
    for key, value in invocation_metadata:
        if key == TRACE_METADATA_KEY:
            try:
                return dataclasses.replace(request, trace_id=int(value))
            except (ValueError, TypeError):
                return request
    return request


def _serialize_response(response_proto) -> bytes:
    return response_proto.SerializeToString()


def _deserialize_request(data: bytes):
    msg = proto_class("RapidRequest")()
    msg.ParseFromString(data)
    return msg


class GrpcServer(MessagingServer):
    """grpc.aio server exposing the reference's single unary RPC."""

    def __init__(self, listen_address: Endpoint) -> None:
        self.listen_address = listen_address
        self._service = None
        self._server: Optional[grpc.aio.Server] = None
        self.stats = TransportStats()  # paper Table 2 accounting

    def set_membership_service(self, service) -> None:
        self._service = service

    async def start(self) -> None:
        server = grpc.aio.server()

        async def send_request(request_proto, context):
            self.stats.rx(request_proto.ByteSize())
            request = _attach_trace(
                request_from_proto(request_proto), context.invocation_metadata()
            )
            if self._service is None:
                if isinstance(request, ProbeMessage):
                    # BOOTSTRAPPING probes before the service exists
                    # (GrpcServer.java:77-96).
                    out = response_to_proto(ProbeResponse(status=NodeStatus.BOOTSTRAPPING))
                    self.stats.tx(out.ByteSize())
                    return out
                await context.abort(grpc.StatusCode.UNAVAILABLE, "bootstrapping")
            response = await self._service.handle_message(request)
            out = response_to_proto(response)
            self.stats.tx(out.ByteSize())
            return out

        handler = grpc.unary_unary_rpc_method_handler(
            send_request,
            request_deserializer=_deserialize_request,
            response_serializer=_serialize_response,
        )
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, {_METHOD: handler}),)
        )
        bound = server.add_insecure_port(
            f"{self.listen_address.hostname}:{self.listen_address.port}"
        )
        if bound == 0:
            # Match the TCP transport's contract: bind failures raise.
            raise OSError(f"could not bind gRPC server to {self.listen_address}")
        await server.start()
        self._server = server

    async def shutdown(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=0.5)
            self._server = None


class GrpcClient(MessagingClient):
    """grpc.aio client with a channel cache and per-message-type deadlines
    (GrpcClient.java:85-95, 194-203)."""

    # The reference's rapid.proto has no gossip envelope; GossipBroadcaster
    # refuses this transport at wiring time (see rapid_tpu_torch.messaging.gossip).
    supports_gossip = False

    def __init__(self, my_addr: Endpoint, settings: Optional[Settings] = None) -> None:
        self.my_addr = my_addr
        self._settings = settings if settings is not None else Settings()
        self._channels: Dict[Endpoint, grpc.aio.Channel] = {}
        self._shut_down = False
        self.stats = TransportStats()  # paper Table 2 accounting

    def _timeout_s_for(self, request: RapidRequest) -> float:
        if isinstance(request, (JoinMessage, PreJoinMessage)):
            return self._settings.rpc_join_timeout_ms / 1000.0
        if isinstance(request, ProbeMessage):
            return self._settings.rpc_probe_timeout_ms / 1000.0
        return self._settings.rpc_timeout_ms / 1000.0

    def _channel(self, remote: Endpoint) -> grpc.aio.Channel:
        channel = self._channels.get(remote)
        if channel is None:
            channel = grpc.aio.insecure_channel(f"{remote.hostname}:{remote.port}")
            self._channels[remote] = channel
        return channel

    async def _attempt(self, remote: Endpoint, request: RapidRequest) -> RapidResponse:
        if self._shut_down:
            raise ShuttingDownError(f"client {self.my_addr} is shut down")
        channel = self._channel(remote)
        call = channel.unary_unary(
            GRPC_METHOD,
            request_serializer=lambda r: r.SerializeToString(),
            response_deserializer=lambda data: _parse_response(data),
        )
        request_proto = request_to_proto(request)
        self.stats.tx(request_proto.ByteSize())
        response_proto = await call(
            request_proto,
            timeout=self._timeout_s_for(request),
            metadata=_trace_metadata(request),
        )
        self.stats.rx(response_proto.ByteSize())
        return response_from_proto(response_proto)

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
        for channel in self._channels.values():
            await channel.close()
        self._channels.clear()


def _parse_response(data: bytes):
    msg = proto_class("RapidResponse")()
    msg.ParseFromString(data)
    return msg
