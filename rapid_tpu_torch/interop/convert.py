"""Framework dataclasses <-> reference-wire protobuf messages (a copy of
``rapid_tpu/interop/convert.py`` over the port's ``types``)."""

from __future__ import annotations

from typing import Tuple

from rapid_tpu_torch.interop.proto_schema import proto_class
from rapid_tpu_torch import types as t

_REQUEST_FIELDS = {
    t.PreJoinMessage: "preJoinMessage",
    t.JoinMessage: "joinMessage",
    t.BatchedAlertMessage: "batchedAlertMessage",
    t.ProbeMessage: "probeMessage",
    t.FastRoundPhase2bMessage: "fastRoundPhase2bMessage",
    t.Phase1aMessage: "phase1aMessage",
    t.Phase1bMessage: "phase1bMessage",
    t.Phase2aMessage: "phase2aMessage",
    t.Phase2bMessage: "phase2bMessage",
    t.LeaveMessage: "leaveMessage",
    t.CohortCutMessage: "cohortCutMessage",
    t.DelegateDecisionMessage: "delegateDecisionMessage",
    t.GlobalTierMessage: "globalTierMessage",
}

_RESPONSE_FIELDS = {
    t.JoinResponse: "joinResponse",
    t.Response: "response",
    t.ConsensusResponse: "consensusResponse",
    t.ProbeResponse: "probeResponse",
}

_S64 = 1 << 63
_U64 = 1 << 64


def _i64(value: int) -> int:
    value &= _U64 - 1
    return value - _U64 if value >= _S64 else value


def _u64(value: int) -> int:
    return value & (_U64 - 1)


def _ep(ep: t.Endpoint):
    out = proto_class("Endpoint")()
    out.hostname = ep.hostname.encode("utf-8")
    out.port = ep.port
    return out


def _ep_back(msg) -> t.Endpoint:
    return t.Endpoint(bytes(msg.hostname).decode("utf-8"), msg.port)


def _nid(nid: t.NodeId):
    out = proto_class("NodeId")()
    out.high = _i64(nid.high)
    out.low = _i64(nid.low)
    return out


def _nid_back(msg) -> t.NodeId:
    return t.NodeId(_u64(msg.high), _u64(msg.low))


def _md(metadata: Tuple[Tuple[str, bytes], ...]):
    out = proto_class("Metadata")()
    for key, value in metadata:
        out.metadata[key] = value
    return out


def _md_back(msg) -> Tuple[Tuple[str, bytes], ...]:
    return tuple(sorted((k, bytes(v)) for k, v in msg.metadata.items()))


def _rank(rank: t.Rank):
    out = proto_class("Rank")()
    out.round = rank.round
    out.nodeIndex = rank.node_index
    return out


def _rank_back(msg) -> t.Rank:
    return t.Rank(msg.round, msg.nodeIndex)


def _alert(a: t.AlertMessage):
    out = proto_class("AlertMessage")()
    out.edgeSrc.CopyFrom(_ep(a.edge_src))
    out.edgeDst.CopyFrom(_ep(a.edge_dst))
    out.edgeStatus = int(a.edge_status)
    out.configurationId = _i64(a.configuration_id)
    out.ringNumber.extend(a.ring_numbers)
    if a.node_id is not None:
        out.nodeId.CopyFrom(_nid(a.node_id))
    if a.metadata:
        out.metadata.CopyFrom(_md(a.metadata))
    return out


def _alert_back(msg) -> t.AlertMessage:
    return t.AlertMessage(
        edge_src=_ep_back(msg.edgeSrc),
        edge_dst=_ep_back(msg.edgeDst),
        edge_status=t.EdgeStatus(msg.edgeStatus),
        configuration_id=msg.configurationId,
        ring_numbers=tuple(msg.ringNumber),
        node_id=_nid_back(msg.nodeId) if msg.HasField("nodeId") else None,
        metadata=_md_back(msg.metadata),
    )


def request_to_proto(request: t.RapidRequest):
    envelope = proto_class("RapidRequest")()
    field = _REQUEST_FIELDS[type(request)]
    sub = getattr(envelope, field)
    if isinstance(request, t.PreJoinMessage):
        sub.sender.CopyFrom(_ep(request.sender))
        sub.nodeId.CopyFrom(_nid(request.node_id))
    elif isinstance(request, t.JoinMessage):
        sub.sender.CopyFrom(_ep(request.sender))
        sub.nodeId.CopyFrom(_nid(request.node_id))
        sub.ringNumber.extend(request.ring_numbers)
        sub.configurationId = _i64(request.configuration_id)
        sub.metadata.CopyFrom(_md(request.metadata))
    elif isinstance(request, t.BatchedAlertMessage):
        sub.sender.CopyFrom(_ep(request.sender))
        for alert in request.messages:
            sub.messages.add().CopyFrom(_alert(alert))
    elif isinstance(request, t.ProbeMessage):
        sub.sender.CopyFrom(_ep(request.sender))
    elif isinstance(request, t.FastRoundPhase2bMessage):
        sub.sender.CopyFrom(_ep(request.sender))
        sub.configurationId = _i64(request.configuration_id)
        for ep in request.endpoints:
            sub.endpoints.add().CopyFrom(_ep(ep))
    elif isinstance(request, t.Phase1aMessage):
        sub.sender.CopyFrom(_ep(request.sender))
        sub.configurationId = _i64(request.configuration_id)
        sub.rank.CopyFrom(_rank(request.rank))
    elif isinstance(request, t.Phase1bMessage):
        sub.sender.CopyFrom(_ep(request.sender))
        sub.configurationId = _i64(request.configuration_id)
        sub.rnd.CopyFrom(_rank(request.rnd))
        sub.vrnd.CopyFrom(_rank(request.vrnd))
        for ep in request.vval:
            sub.vval.add().CopyFrom(_ep(ep))
    elif isinstance(request, t.Phase2aMessage):
        sub.sender.CopyFrom(_ep(request.sender))
        sub.configurationId = _i64(request.configuration_id)
        sub.rnd.CopyFrom(_rank(request.rnd))
        for ep in request.vval:
            sub.vval.add().CopyFrom(_ep(ep))
    elif isinstance(request, t.Phase2bMessage):
        sub.sender.CopyFrom(_ep(request.sender))
        sub.configurationId = _i64(request.configuration_id)
        sub.rnd.CopyFrom(_rank(request.rnd))
        for ep in request.endpoints:
            sub.endpoints.add().CopyFrom(_ep(ep))
    elif isinstance(request, t.LeaveMessage):
        sub.sender.CopyFrom(_ep(request.sender))
    elif isinstance(request, t.CohortCutMessage):
        sub.sender.CopyFrom(_ep(request.sender))
        sub.configurationId = _i64(request.configuration_id)
        sub.cohort = request.cohort
        for ep in request.endpoints:
            sub.endpoints.add().CopyFrom(_ep(ep))
        for ep in request.joiner_eps:
            sub.joinerEps.add().CopyFrom(_ep(ep))
        for nid in request.joiner_ids:
            sub.joinerIds.add().CopyFrom(_nid(nid))
    elif isinstance(request, t.DelegateDecisionMessage):
        sub.sender.CopyFrom(_ep(request.sender))
        sub.configurationId = _i64(request.configuration_id)
        for ep in request.endpoints:
            sub.endpoints.add().CopyFrom(_ep(ep))
        for ep in request.joiner_eps:
            sub.joinerEps.add().CopyFrom(_ep(ep))
        for nid in request.joiner_ids:
            sub.joinerIds.add().CopyFrom(_nid(nid))
    elif isinstance(request, t.GlobalTierMessage):
        if isinstance(request.payload, (t.GlobalTierMessage, t.GossipMessage)):
            # One level of nesting only — the same contract the native codec
            # enforces; serializing deeper here would emit frames a
            # native-codec peer refuses to decode.
            raise ValueError("nested envelope in GlobalTierMessage payload")
        sub.sender.CopyFrom(_ep(request.sender))
        sub.payload.CopyFrom(request_to_proto(request.payload))
    else:  # pragma: no cover
        raise TypeError(type(request))
    return envelope


def request_from_proto(envelope) -> t.RapidRequest:
    which = envelope.WhichOneof("content")
    if which is None:
        raise ValueError("empty RapidRequest envelope (no content set)")
    sub = getattr(envelope, which)
    if which == "preJoinMessage":
        return t.PreJoinMessage(_ep_back(sub.sender), _nid_back(sub.nodeId))
    if which == "joinMessage":
        return t.JoinMessage(
            sender=_ep_back(sub.sender),
            node_id=_nid_back(sub.nodeId),
            ring_numbers=tuple(sub.ringNumber),
            configuration_id=sub.configurationId,
            metadata=_md_back(sub.metadata),
        )
    if which == "batchedAlertMessage":
        return t.BatchedAlertMessage(
            _ep_back(sub.sender), tuple(_alert_back(m) for m in sub.messages)
        )
    if which == "probeMessage":
        return t.ProbeMessage(_ep_back(sub.sender))
    if which == "fastRoundPhase2bMessage":
        return t.FastRoundPhase2bMessage(
            _ep_back(sub.sender), sub.configurationId,
            tuple(_ep_back(e) for e in sub.endpoints),
        )
    if which == "phase1aMessage":
        return t.Phase1aMessage(_ep_back(sub.sender), sub.configurationId, _rank_back(sub.rank))
    if which == "phase1bMessage":
        return t.Phase1bMessage(
            _ep_back(sub.sender), sub.configurationId, _rank_back(sub.rnd),
            _rank_back(sub.vrnd), tuple(_ep_back(e) for e in sub.vval),
        )
    if which == "phase2aMessage":
        return t.Phase2aMessage(
            _ep_back(sub.sender), sub.configurationId, _rank_back(sub.rnd),
            tuple(_ep_back(e) for e in sub.vval),
        )
    if which == "phase2bMessage":
        return t.Phase2bMessage(
            _ep_back(sub.sender), sub.configurationId, _rank_back(sub.rnd),
            tuple(_ep_back(e) for e in sub.endpoints),
        )
    if which == "leaveMessage":
        return t.LeaveMessage(_ep_back(sub.sender))
    if which == "cohortCutMessage":
        return t.CohortCutMessage(
            sender=_ep_back(sub.sender),
            configuration_id=sub.configurationId,
            cohort=sub.cohort,
            endpoints=tuple(_ep_back(e) for e in sub.endpoints),
            joiner_eps=tuple(_ep_back(e) for e in sub.joinerEps),
            joiner_ids=tuple(_nid_back(n) for n in sub.joinerIds),
        )
    if which == "delegateDecisionMessage":
        return t.DelegateDecisionMessage(
            sender=_ep_back(sub.sender),
            configuration_id=sub.configurationId,
            endpoints=tuple(_ep_back(e) for e in sub.endpoints),
            joiner_eps=tuple(_ep_back(e) for e in sub.joinerEps),
            joiner_ids=tuple(_nid_back(n) for n in sub.joinerIds),
        )
    if which == "globalTierMessage":
        if sub.payload.WhichOneof("content") == "globalTierMessage":
            # One level of nesting only, mirroring the native codec's decode
            # guard (unbounded recursion is a parser DoS).
            raise ValueError("nested envelope in GlobalTierMessage payload")
        return t.GlobalTierMessage(
            sender=_ep_back(sub.sender),
            payload=request_from_proto(sub.payload),
        )
    raise ValueError(f"empty or unknown RapidRequest content: {which}")


def response_to_proto(response: t.RapidResponse):
    envelope = proto_class("RapidResponse")()
    field = _RESPONSE_FIELDS[type(response)]
    sub = getattr(envelope, field)
    if isinstance(response, t.JoinResponse):
        sub.sender.CopyFrom(_ep(response.sender))
        sub.statusCode = int(response.status_code)
        sub.configurationId = _i64(response.configuration_id)
        for ep in response.endpoints:
            sub.endpoints.add().CopyFrom(_ep(ep))
        for nid in response.identifiers:
            sub.identifiers.add().CopyFrom(_nid(nid))
        for ep in response.metadata_keys:
            sub.metadataKeys.add().CopyFrom(_ep(ep))
        for md in response.metadata_values:
            sub.metadataValues.add().CopyFrom(_md(md))
    elif isinstance(response, t.ProbeResponse):
        sub.status = int(response.status)
    else:
        sub.SetInParent()  # Response / ConsensusResponse are empty
    return envelope


def response_from_proto(envelope) -> t.RapidResponse:
    which = envelope.WhichOneof("content")
    if which is None:
        raise ValueError("empty RapidResponse envelope (no content set)")
    sub = getattr(envelope, which)
    if which == "joinResponse":
        return t.JoinResponse(
            sender=_ep_back(sub.sender),
            status_code=t.JoinStatusCode(sub.statusCode),
            configuration_id=sub.configurationId,
            endpoints=tuple(_ep_back(e) for e in sub.endpoints),
            identifiers=tuple(_nid_back(n) for n in sub.identifiers),
            metadata_keys=tuple(_ep_back(e) for e in sub.metadataKeys),
            metadata_values=tuple(_md_back(m) for m in sub.metadataValues),
        )
    if which == "response":
        return t.Response()
    if which == "consensusResponse":
        return t.ConsensusResponse()
    if which == "probeResponse":
        return t.ProbeResponse(t.NodeStatus(sub.status))
    raise ValueError(f"empty or unknown RapidResponse content: {which}")
