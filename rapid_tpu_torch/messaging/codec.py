"""Binary wire codec for the protocol messages.

The framework's wire schema (the equivalent of ``rapid.proto``): one request
envelope carrying exactly one tagged protocol message, one response envelope.
Explicit fixed-layout encoding — no pickling (untrusted peers), no schema
compiler dependency. Layout: little-endian, u8 type tags, u32 lengths/counts,
u64 identifiers.

A copy of ``rapid_tpu/messaging/codec.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

import functools
import struct
from typing import Dict, List, Tuple, Type

from rapid_tpu_torch.utils.xxhash import to_signed64 as _signed64
from rapid_tpu_torch.types import (
    AlertMessage,
    BatchedAlertMessage,
    CohortCutMessage,
    ConsensusResponse,
    DelegateDecisionMessage,
    EdgeStatus,
    Endpoint,
    FastRoundPhase2bMessage,
    GlobalTierMessage,
    GossipMessage,
    JoinMessage,
    JoinResponse,
    JoinStatusCode,
    LeaveMessage,
    NodeId,
    NodeStatus,
    Phase1aMessage,
    Phase1bMessage,
    Phase2aMessage,
    Phase2bMessage,
    PreJoinMessage,
    ProbeMessage,
    ProbeResponse,
    Rank,
    RapidRequest,
    RapidResponse,
    Response,
)


class CodecError(ValueError):
    pass


# Public field-codec surface for other modules that persist in this layout
# (rapid_tpu_torch.utils.checkpoint); the underscore classes remain as aliases.


class _Writer:
    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def u8(self, v: int) -> None:
        self._parts.append(struct.pack("<B", v))

    def u32(self, v: int) -> None:
        self._parts.append(struct.pack("<I", v))

    def i64(self, v: int) -> None:
        self._parts.append(struct.pack("<q", _signed64(v)))

    def u64(self, v: int) -> None:
        self._parts.append(struct.pack("<Q", v & ((1 << 64) - 1)))

    def blob(self, b: bytes) -> None:
        self.u32(len(b))
        self._parts.append(b)

    def string(self, s: str) -> None:
        self.blob(s.encode("utf-8"))

    def raw(self, b: bytes) -> None:
        """Append bytes verbatim (headers/magic for codec-layout consumers)."""
        self._parts.append(b)

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


class _Reader:
    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise CodecError("truncated message")
        out = self._data[self._pos : self._pos + n]
        self._pos += n
        return out

    def u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def blob(self) -> bytes:
        return self._take(self.u32())

    def string(self) -> str:
        return self.blob().decode("utf-8")

    def done(self) -> bool:
        return self._pos == len(self._data)


# -- field codecs ----------------------------------------------------------


def _w_endpoint(w: _Writer, ep: Endpoint) -> None:
    w.string(ep.hostname)
    w.u32(ep.port)


def _r_endpoint(r: _Reader) -> Endpoint:
    return Endpoint(r.string(), r.u32())


def _w_endpoints(w: _Writer, eps) -> None:
    w.u32(len(eps))
    for ep in eps:
        _w_endpoint(w, ep)


def _r_endpoints(r: _Reader) -> Tuple[Endpoint, ...]:
    return tuple(_r_endpoint(r) for _ in range(r.u32()))


def _w_node_id(w: _Writer, nid: NodeId) -> None:
    w.u64(nid.high)
    w.u64(nid.low)


def _r_node_id(r: _Reader) -> NodeId:
    return NodeId(r.u64(), r.u64())


def _w_opt_node_id(w: _Writer, nid) -> None:
    w.u8(1 if nid is not None else 0)
    if nid is not None:
        _w_node_id(w, nid)


def _r_opt_node_id(r: _Reader):
    return _r_node_id(r) if r.u8() else None


def _w_metadata(w: _Writer, md) -> None:
    w.u32(len(md))
    for key, value in md:
        w.string(key)
        w.blob(value)


def _r_metadata(r: _Reader) -> Tuple[Tuple[str, bytes], ...]:
    return tuple((r.string(), r.blob()) for _ in range(r.u32()))


def _w_rank(w: _Writer, rank: Rank) -> None:
    w.u32(rank.round)
    w.u32(rank.node_index)


def _r_rank(r: _Reader) -> Rank:
    return Rank(r.u32(), r.u32())


def _w_rings(w: _Writer, rings) -> None:
    w.u32(len(rings))
    for ring in rings:
        w.u32(ring)


def _r_rings(r: _Reader) -> Tuple[int, ...]:
    return tuple(r.u32() for _ in range(r.u32()))


# Optional trailing trace-context field (alert batches + consensus messages):
# written ONLY when present, so a frame without a trace id is byte-identical
# to the pre-trace layout — old recordings and golden fixtures stay valid,
# and a peer that never stamps traces interoperates unchanged. On decode the
# message body consumes an exact prefix, so any remainder IS the extension.


def _w_opt_trace(w: _Writer, trace_id) -> None:
    if trace_id is not None:
        w.u64(trace_id)


def _r_opt_trace(r: _Reader):
    return None if r.done() else r.u64()


def _w_alert(w: _Writer, a: AlertMessage) -> None:
    _w_endpoint(w, a.edge_src)
    _w_endpoint(w, a.edge_dst)
    w.u8(int(a.edge_status))
    w.i64(a.configuration_id)
    _w_rings(w, a.ring_numbers)
    _w_opt_node_id(w, a.node_id)
    _w_metadata(w, a.metadata)


def _r_alert(r: _Reader) -> AlertMessage:
    return AlertMessage(
        edge_src=_r_endpoint(r),
        edge_dst=_r_endpoint(r),
        edge_status=EdgeStatus(r.u8()),
        configuration_id=r.i64(),
        ring_numbers=_r_rings(r),
        node_id=_r_opt_node_id(r),
        metadata=_r_metadata(r),
    )


# -- message codecs --------------------------------------------------------

_REQUEST_TAGS: Dict[Type, int] = {
    PreJoinMessage: 1,
    JoinMessage: 2,
    BatchedAlertMessage: 3,
    ProbeMessage: 4,
    FastRoundPhase2bMessage: 5,
    Phase1aMessage: 6,
    Phase1bMessage: 7,
    Phase2aMessage: 8,
    Phase2bMessage: 9,
    LeaveMessage: 10,
    GossipMessage: 11,
    CohortCutMessage: 12,
    DelegateDecisionMessage: 13,
    GlobalTierMessage: 14,
}

_RESPONSE_TAGS: Dict[Type, int] = {
    JoinResponse: 1,
    Response: 2,
    ConsensusResponse: 3,
    ProbeResponse: 4,
}


def encode_request(request: RapidRequest) -> bytes:
    """Encode a request envelope. Memoized when the request is hashable:
    broadcast fan-out sends the SAME (frozen) request to every member, and a
    cache hit costs ~1/5 of re-packing — the bytes are immutable, so sharing
    them is safe. A request built with unhashable sequence fields (e.g.
    lists) still encodes, just uncached."""
    try:
        # trace_id is compare=False (types.py): two protocol-equal requests
        # with different trace stamps hash alike, so the stamp must join the
        # cache key explicitly or one message's bytes would carry the other's
        # trace id.
        return _encode_request_cached(request, getattr(request, "trace_id", None))
    except TypeError:  # unhashable field values — encode without the cache
        return _encode_request_impl(request)


# Deliberately tiny cache: the reuse window is the handful of broadcasts
# whose fan-out futures are interleaved on the loop at once, and a small LRU
# avoids pinning dead request batches for the process lifetime.
@functools.lru_cache(maxsize=8)
def _encode_request_cached(request: RapidRequest, _trace_id) -> bytes:
    return _encode_request_impl(request)


def _encode_request_impl(request: RapidRequest) -> bytes:
    w = _Writer()
    tag = _REQUEST_TAGS.get(type(request))
    if tag is None:
        raise CodecError(f"unknown request type {type(request)!r}")
    w.u8(tag)
    if isinstance(request, PreJoinMessage):
        _w_endpoint(w, request.sender)
        _w_node_id(w, request.node_id)
    elif isinstance(request, JoinMessage):
        _w_endpoint(w, request.sender)
        _w_node_id(w, request.node_id)
        _w_rings(w, request.ring_numbers)
        w.i64(request.configuration_id)
        _w_metadata(w, request.metadata)
    elif isinstance(request, BatchedAlertMessage):
        _w_endpoint(w, request.sender)
        w.u32(len(request.messages))
        for alert in request.messages:
            _w_alert(w, alert)
        _w_opt_trace(w, request.trace_id)
    elif isinstance(request, ProbeMessage):
        _w_endpoint(w, request.sender)
    elif isinstance(request, FastRoundPhase2bMessage):
        _w_endpoint(w, request.sender)
        w.i64(request.configuration_id)
        _w_endpoints(w, request.endpoints)
        _w_opt_trace(w, request.trace_id)
    elif isinstance(request, Phase1aMessage):
        _w_endpoint(w, request.sender)
        w.i64(request.configuration_id)
        _w_rank(w, request.rank)
        _w_opt_trace(w, request.trace_id)
    elif isinstance(request, Phase1bMessage):
        _w_endpoint(w, request.sender)
        w.i64(request.configuration_id)
        _w_rank(w, request.rnd)
        _w_rank(w, request.vrnd)
        _w_endpoints(w, request.vval)
        _w_opt_trace(w, request.trace_id)
    elif isinstance(request, Phase2aMessage):
        _w_endpoint(w, request.sender)
        w.i64(request.configuration_id)
        _w_rank(w, request.rnd)
        _w_endpoints(w, request.vval)
        _w_opt_trace(w, request.trace_id)
    elif isinstance(request, Phase2bMessage):
        _w_endpoint(w, request.sender)
        w.i64(request.configuration_id)
        _w_rank(w, request.rnd)
        _w_endpoints(w, request.endpoints)
        _w_opt_trace(w, request.trace_id)
    elif isinstance(request, LeaveMessage):
        _w_endpoint(w, request.sender)
    elif isinstance(request, CohortCutMessage):
        _w_endpoint(w, request.sender)
        w.i64(request.configuration_id)
        w.u32(request.cohort)
        _w_endpoints(w, request.endpoints)
        _w_endpoints(w, request.joiner_eps)
        w.u32(len(request.joiner_ids))
        for nid in request.joiner_ids:
            _w_node_id(w, nid)
        _w_opt_trace(w, request.trace_id)
    elif isinstance(request, DelegateDecisionMessage):
        _w_endpoint(w, request.sender)
        w.i64(request.configuration_id)
        _w_endpoints(w, request.endpoints)
        _w_endpoints(w, request.joiner_eps)
        w.u32(len(request.joiner_ids))
        for nid in request.joiner_ids:
            _w_node_id(w, nid)
        _w_opt_trace(w, request.trace_id)
    elif isinstance(request, GlobalTierMessage):
        if isinstance(request.payload, (GlobalTierMessage, GossipMessage)):
            raise CodecError("nested envelope in GlobalTierMessage payload")
        _w_endpoint(w, request.sender)
        # Nested envelope: the payload is a complete request of its own
        # (the GossipMessage framing precedent).
        w.blob(_encode_request_impl(request.payload))
    elif isinstance(request, GossipMessage):
        if isinstance(request.payload, GossipMessage):
            raise CodecError("nested GossipMessage payload")
        if not 0 <= request.ttl <= 255:
            raise CodecError(f"gossip ttl out of u8 range: {request.ttl}")
        _w_endpoint(w, request.origin)
        w.u64(request.msg_id)
        w.u8(request.ttl)
        # Nested envelope: the payload is a complete request of its own.
        w.blob(_encode_request_impl(request.payload))
    return w.getvalue()


def decode_request(data: bytes) -> RapidRequest:
    r = _Reader(data)
    tag = r.u8()
    if tag == 1:
        out: RapidRequest = PreJoinMessage(_r_endpoint(r), _r_node_id(r))
    elif tag == 2:
        out = JoinMessage(
            sender=_r_endpoint(r),
            node_id=_r_node_id(r),
            ring_numbers=_r_rings(r),
            configuration_id=r.i64(),
            metadata=_r_metadata(r),
        )
    elif tag == 3:
        sender = _r_endpoint(r)
        messages = tuple(_r_alert(r) for _ in range(r.u32()))
        out = BatchedAlertMessage(sender, messages, trace_id=_r_opt_trace(r))
    elif tag == 4:
        out = ProbeMessage(_r_endpoint(r))
    elif tag == 5:
        out = FastRoundPhase2bMessage(
            _r_endpoint(r), r.i64(), _r_endpoints(r), trace_id=_r_opt_trace(r)
        )
    elif tag == 6:
        out = Phase1aMessage(_r_endpoint(r), r.i64(), _r_rank(r), trace_id=_r_opt_trace(r))
    elif tag == 7:
        out = Phase1bMessage(
            _r_endpoint(r), r.i64(), _r_rank(r), _r_rank(r), _r_endpoints(r),
            trace_id=_r_opt_trace(r),
        )
    elif tag == 8:
        out = Phase2aMessage(
            _r_endpoint(r), r.i64(), _r_rank(r), _r_endpoints(r), trace_id=_r_opt_trace(r)
        )
    elif tag == 9:
        out = Phase2bMessage(
            _r_endpoint(r), r.i64(), _r_rank(r), _r_endpoints(r), trace_id=_r_opt_trace(r)
        )
    elif tag == 10:
        out = LeaveMessage(_r_endpoint(r))
    elif tag == 11:
        origin = _r_endpoint(r)
        msg_id = r.u64()
        ttl = r.u8()
        payload = decode_request(r.blob())
        if isinstance(payload, GossipMessage):
            # One level of nesting only: a gossiped gossip envelope is
            # meaningless and unbounded recursion is a parser DoS.
            raise CodecError("nested GossipMessage payload")
        out = GossipMessage(origin, msg_id, ttl, payload)
    elif tag == 12:
        out = CohortCutMessage(
            sender=_r_endpoint(r),
            configuration_id=r.i64(),
            cohort=r.u32(),
            endpoints=_r_endpoints(r),
            joiner_eps=_r_endpoints(r),
            joiner_ids=tuple(_r_node_id(r) for _ in range(r.u32())),
            trace_id=_r_opt_trace(r),
        )
    elif tag == 13:
        out = DelegateDecisionMessage(
            sender=_r_endpoint(r),
            configuration_id=r.i64(),
            endpoints=_r_endpoints(r),
            joiner_eps=_r_endpoints(r),
            joiner_ids=tuple(_r_node_id(r) for _ in range(r.u32())),
            trace_id=_r_opt_trace(r),
        )
    elif tag == 14:
        sender = _r_endpoint(r)
        payload = decode_request(r.blob())
        if isinstance(payload, (GlobalTierMessage, GossipMessage)):
            # One level of nesting only, as for gossip: an envelope inside
            # the envelope is meaningless and unbounded recursion is a
            # parser DoS.
            raise CodecError("nested envelope in GlobalTierMessage payload")
        out = GlobalTierMessage(sender, payload)
    else:
        raise CodecError(f"unknown request tag {tag}")
    if not r.done():
        raise CodecError("trailing bytes in request")
    return out


def encode_response(response: RapidResponse) -> bytes:
    w = _Writer()
    tag = _RESPONSE_TAGS.get(type(response))
    if tag is None:
        raise CodecError(f"unknown response type {type(response)!r}")
    w.u8(tag)
    if isinstance(response, JoinResponse):
        _w_endpoint(w, response.sender)
        w.u8(int(response.status_code))
        w.i64(response.configuration_id)
        _w_endpoints(w, response.endpoints)
        w.u32(len(response.identifiers))
        for nid in response.identifiers:
            _w_node_id(w, nid)
        _w_endpoints(w, response.metadata_keys)
        w.u32(len(response.metadata_values))
        for md in response.metadata_values:
            _w_metadata(w, md)
    elif isinstance(response, ProbeResponse):
        w.u8(int(response.status))
    return w.getvalue()


def decode_response(data: bytes) -> RapidResponse:
    r = _Reader(data)
    tag = r.u8()
    if tag == 1:
        out: RapidResponse = JoinResponse(
            sender=_r_endpoint(r),
            status_code=JoinStatusCode(r.u8()),
            configuration_id=r.i64(),
            endpoints=_r_endpoints(r),
            identifiers=tuple(_r_node_id(r) for _ in range(r.u32())),
            metadata_keys=_r_endpoints(r),
            metadata_values=tuple(_r_metadata(r) for _ in range(r.u32())),
        )
    elif tag == 2:
        out = Response()
    elif tag == 3:
        out = ConsensusResponse()
    elif tag == 4:
        out = ProbeResponse(NodeStatus(r.u8()))
    else:
        raise CodecError(f"unknown response tag {tag}")
    if not r.done():
        raise CodecError("trailing bytes in response")
    return out


Writer = _Writer
Reader = _Reader
write_endpoint = _w_endpoint
read_endpoint = _r_endpoint
write_node_id = _w_node_id
read_node_id = _r_node_id
