"""Runtime-built protobuf schema for reference interop (a copy of
``rapid_tpu/interop/proto_schema.py``; the descriptors live in a pool of
their own, so both packages' schemas load in one process).

The reference's wire protocol is protobuf over gRPC: one unary RPC
``remoting.MembershipService/sendRequest(RapidRequest) -> RapidResponse``
with the message/field layout documented in SURVEY §2.4 (source IDL:
``rapid/src/main/proto/rapid.proto``). To interoperate on the wire, field
numbers and types must match exactly — they are reproduced here as a
programmatic ``FileDescriptorProto`` (no copied .proto file, no protoc
dependency), from which real protobuf message classes are materialized at
import time via ``message_factory``.
"""

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

_F = descriptor_pb2.FieldDescriptorProto

_POOL = descriptor_pool.DescriptorPool()


def _msg(name, *fields):
    m = descriptor_pb2.DescriptorProto()
    m.name = name
    for f in fields:
        m.field.add().CopyFrom(f)
    return m


def _field(name, number, ftype, label=_F.LABEL_OPTIONAL, type_name=None, oneof=None):
    f = _F()
    f.name = name
    f.number = number
    f.type = ftype
    f.label = label
    if type_name:
        f.type_name = type_name
    if oneof is not None:
        f.oneof_index = oneof
    return f


def _build_file() -> descriptor_pb2.FileDescriptorProto:
    fd = descriptor_pb2.FileDescriptorProto()
    fd.name = "rapid_interop.proto"
    fd.package = "remoting"
    fd.syntax = "proto3"

    T, L = _F, _F  # noqa: N806 — terse aliases for the table below

    # Endpoint { bytes hostname = 1; int32 port = 2; }
    fd.message_type.add().CopyFrom(_msg(
        "Endpoint",
        _field("hostname", 1, T.TYPE_BYTES),
        _field("port", 2, T.TYPE_INT32),
    ))
    # NodeId { int64 high = 1; int64 low = 2; }
    fd.message_type.add().CopyFrom(_msg(
        "NodeId",
        _field("high", 1, T.TYPE_INT64),
        _field("low", 2, T.TYPE_INT64),
    ))
    # Metadata { map<string, bytes> metadata = 1; }  (map = repeated nested entry)
    metadata = _msg(
        "Metadata",
        _field("metadata", 1, T.TYPE_MESSAGE, L.LABEL_REPEATED,
               ".remoting.Metadata.MetadataEntry"),
    )
    entry = _msg(
        "MetadataEntry",
        _field("key", 1, T.TYPE_STRING),
        _field("value", 2, T.TYPE_BYTES),
    )
    entry.options.map_entry = True
    metadata.nested_type.add().CopyFrom(entry)
    fd.message_type.add().CopyFrom(metadata)

    # Enums
    for enum_name, values in (
        ("JoinStatusCode", ["HOSTNAME_ALREADY_IN_RING", "UUID_ALREADY_IN_RING",
                            "SAFE_TO_JOIN", "CONFIG_CHANGED", "MEMBERSHIP_REJECTED"]),
        ("EdgeStatus", ["UP", "DOWN"]),
        ("NodeStatus", ["OK", "BOOTSTRAPPING"]),
    ):
        e = fd.enum_type.add()
        e.name = enum_name
        for i, value_name in enumerate(values):
            v = e.value.add()
            v.name = value_name
            v.number = i

    ep = ".remoting.Endpoint"
    nid = ".remoting.NodeId"
    md = ".remoting.Metadata"

    fd.message_type.add().CopyFrom(_msg(
        "PreJoinMessage",
        _field("sender", 1, T.TYPE_MESSAGE, type_name=ep),
        _field("nodeId", 2, T.TYPE_MESSAGE, type_name=nid),
        _field("ringNumber", 3, T.TYPE_INT32, L.LABEL_REPEATED),
        _field("configurationId", 4, T.TYPE_INT64),
    ))
    fd.message_type.add().CopyFrom(_msg(
        "JoinMessage",
        _field("sender", 1, T.TYPE_MESSAGE, type_name=ep),
        _field("nodeId", 2, T.TYPE_MESSAGE, type_name=nid),
        _field("ringNumber", 3, T.TYPE_INT32, L.LABEL_REPEATED),
        _field("configurationId", 4, T.TYPE_INT64),
        _field("metadata", 5, T.TYPE_MESSAGE, type_name=md),
    ))
    fd.message_type.add().CopyFrom(_msg(
        "JoinResponse",
        _field("sender", 1, T.TYPE_MESSAGE, type_name=ep),
        _field("statusCode", 2, T.TYPE_ENUM, type_name=".remoting.JoinStatusCode"),
        _field("configurationId", 3, T.TYPE_INT64),
        _field("endpoints", 4, T.TYPE_MESSAGE, L.LABEL_REPEATED, ep),
        _field("identifiers", 5, T.TYPE_MESSAGE, L.LABEL_REPEATED, nid),
        _field("metadataKeys", 6, T.TYPE_MESSAGE, L.LABEL_REPEATED, ep),
        _field("metadataValues", 7, T.TYPE_MESSAGE, L.LABEL_REPEATED, md),
    ))
    fd.message_type.add().CopyFrom(_msg(
        "AlertMessage",
        _field("edgeSrc", 1, T.TYPE_MESSAGE, type_name=ep),
        _field("edgeDst", 2, T.TYPE_MESSAGE, type_name=ep),
        _field("edgeStatus", 3, T.TYPE_ENUM, type_name=".remoting.EdgeStatus"),
        _field("configurationId", 4, T.TYPE_INT64),
        _field("ringNumber", 5, T.TYPE_INT32, L.LABEL_REPEATED),
        _field("nodeId", 6, T.TYPE_MESSAGE, type_name=nid),
        _field("metadata", 7, T.TYPE_MESSAGE, type_name=md),
    ))
    fd.message_type.add().CopyFrom(_msg(
        "BatchedAlertMessage",
        _field("sender", 1, T.TYPE_MESSAGE, type_name=ep),
        _field("messages", 3, T.TYPE_MESSAGE, L.LABEL_REPEATED, ".remoting.AlertMessage"),
    ))
    fd.message_type.add().CopyFrom(_msg(
        "ProbeMessage",
        _field("sender", 1, T.TYPE_MESSAGE, type_name=ep),
        _field("payload", 3, T.TYPE_BYTES, L.LABEL_REPEATED),
    ))
    fd.message_type.add().CopyFrom(_msg(
        "ProbeResponse",
        _field("status", 1, T.TYPE_ENUM, type_name=".remoting.NodeStatus"),
    ))
    fd.message_type.add().CopyFrom(_msg(
        "FastRoundPhase2bMessage",
        _field("sender", 1, T.TYPE_MESSAGE, type_name=ep),
        _field("configurationId", 2, T.TYPE_INT64),
        _field("endpoints", 3, T.TYPE_MESSAGE, L.LABEL_REPEATED, ep),
    ))
    fd.message_type.add().CopyFrom(_msg(
        "Rank",
        _field("round", 1, T.TYPE_INT32),
        _field("nodeIndex", 2, T.TYPE_INT32),
    ))
    rank = ".remoting.Rank"
    fd.message_type.add().CopyFrom(_msg(
        "Phase1aMessage",
        _field("sender", 1, T.TYPE_MESSAGE, type_name=ep),
        _field("configurationId", 2, T.TYPE_INT64),
        _field("rank", 3, T.TYPE_MESSAGE, type_name=rank),
    ))
    fd.message_type.add().CopyFrom(_msg(
        "Phase1bMessage",
        _field("sender", 1, T.TYPE_MESSAGE, type_name=ep),
        _field("configurationId", 2, T.TYPE_INT64),
        _field("rnd", 3, T.TYPE_MESSAGE, type_name=rank),
        _field("vrnd", 4, T.TYPE_MESSAGE, type_name=rank),
        _field("vval", 5, T.TYPE_MESSAGE, L.LABEL_REPEATED, ep),
    ))
    fd.message_type.add().CopyFrom(_msg(
        "Phase2aMessage",
        _field("sender", 1, T.TYPE_MESSAGE, type_name=ep),
        _field("configurationId", 2, T.TYPE_INT64),
        _field("rnd", 3, T.TYPE_MESSAGE, type_name=rank),
        _field("vval", 5, T.TYPE_MESSAGE, L.LABEL_REPEATED, ep),
    ))
    fd.message_type.add().CopyFrom(_msg(
        "Phase2bMessage",
        _field("sender", 1, T.TYPE_MESSAGE, type_name=ep),
        _field("configurationId", 2, T.TYPE_INT64),
        _field("rnd", 3, T.TYPE_MESSAGE, type_name=rank),
        _field("endpoints", 4, T.TYPE_MESSAGE, L.LABEL_REPEATED, ep),
    ))
    fd.message_type.add().CopyFrom(_msg("LeaveMessage",
        _field("sender", 1, T.TYPE_MESSAGE, type_name=ep),
    ))
    fd.message_type.add().CopyFrom(_msg("Response"))
    fd.message_type.add().CopyFrom(_msg("ConsensusResponse"))

    # Hierarchical-membership extension (rapid_tpu_torch/hier): not part of the
    # reference IDL — a reference JVM peer never speaks these — but mirrored
    # here so the wire surface has exactly one schema story and the
    # wire_schema/staticcheck gate can cross-check all four mirrors. The
    # envelope field numbers equal the native codec tags (12-14), continuing
    # the reference's numbering convention.
    fd.message_type.add().CopyFrom(_msg(
        "CohortCutMessage",
        _field("sender", 1, T.TYPE_MESSAGE, type_name=ep),
        _field("configurationId", 2, T.TYPE_INT64),
        _field("cohort", 3, T.TYPE_INT32),
        _field("endpoints", 4, T.TYPE_MESSAGE, L.LABEL_REPEATED, ep),
        _field("joinerEps", 5, T.TYPE_MESSAGE, L.LABEL_REPEATED, ep),
        _field("joinerIds", 6, T.TYPE_MESSAGE, L.LABEL_REPEATED, nid),
    ))
    fd.message_type.add().CopyFrom(_msg(
        "DelegateDecisionMessage",
        _field("sender", 1, T.TYPE_MESSAGE, type_name=ep),
        _field("configurationId", 2, T.TYPE_INT64),
        _field("endpoints", 3, T.TYPE_MESSAGE, L.LABEL_REPEATED, ep),
        _field("joinerEps", 4, T.TYPE_MESSAGE, L.LABEL_REPEATED, ep),
        _field("joinerIds", 5, T.TYPE_MESSAGE, L.LABEL_REPEATED, nid),
    ))
    fd.message_type.add().CopyFrom(_msg(
        "GlobalTierMessage",
        _field("sender", 1, T.TYPE_MESSAGE, type_name=ep),
        _field("payload", 2, T.TYPE_MESSAGE, type_name=".remoting.RapidRequest"),
    ))

    # RapidRequest / RapidResponse oneof envelopes.
    request = _msg(
        "RapidRequest",
        _field("preJoinMessage", 1, T.TYPE_MESSAGE, type_name=".remoting.PreJoinMessage", oneof=0),
        _field("joinMessage", 2, T.TYPE_MESSAGE, type_name=".remoting.JoinMessage", oneof=0),
        _field("batchedAlertMessage", 3, T.TYPE_MESSAGE,
               type_name=".remoting.BatchedAlertMessage", oneof=0),
        _field("probeMessage", 4, T.TYPE_MESSAGE, type_name=".remoting.ProbeMessage", oneof=0),
        _field("fastRoundPhase2bMessage", 5, T.TYPE_MESSAGE,
               type_name=".remoting.FastRoundPhase2bMessage", oneof=0),
        _field("phase1aMessage", 6, T.TYPE_MESSAGE, type_name=".remoting.Phase1aMessage", oneof=0),
        _field("phase1bMessage", 7, T.TYPE_MESSAGE, type_name=".remoting.Phase1bMessage", oneof=0),
        _field("phase2aMessage", 8, T.TYPE_MESSAGE, type_name=".remoting.Phase2aMessage", oneof=0),
        _field("phase2bMessage", 9, T.TYPE_MESSAGE, type_name=".remoting.Phase2bMessage", oneof=0),
        _field("leaveMessage", 10, T.TYPE_MESSAGE, type_name=".remoting.LeaveMessage", oneof=0),
        # 11 is the native gossip envelope (no proto mirror by design).
        _field("cohortCutMessage", 12, T.TYPE_MESSAGE,
               type_name=".remoting.CohortCutMessage", oneof=0),
        _field("delegateDecisionMessage", 13, T.TYPE_MESSAGE,
               type_name=".remoting.DelegateDecisionMessage", oneof=0),
        _field("globalTierMessage", 14, T.TYPE_MESSAGE,
               type_name=".remoting.GlobalTierMessage", oneof=0),
    )
    request.oneof_decl.add().name = "content"
    fd.message_type.add().CopyFrom(request)

    response = _msg(
        "RapidResponse",
        _field("joinResponse", 1, T.TYPE_MESSAGE, type_name=".remoting.JoinResponse", oneof=0),
        _field("response", 2, T.TYPE_MESSAGE, type_name=".remoting.Response", oneof=0),
        _field("consensusResponse", 3, T.TYPE_MESSAGE,
               type_name=".remoting.ConsensusResponse", oneof=0),
        _field("probeResponse", 4, T.TYPE_MESSAGE, type_name=".remoting.ProbeResponse", oneof=0),
    )
    response.oneof_decl.add().name = "content"
    fd.message_type.add().CopyFrom(response)
    return fd


# Register the runtime-built descriptor file; the pool retains it (the
# binding would never be read — registration is the point).
_POOL.Add(_build_file())

_CLASSES = {
    name: message_factory.GetMessageClass(_POOL.FindMessageTypeByName(f"remoting.{name}"))
    for name in (
        "Endpoint", "NodeId", "Metadata", "PreJoinMessage", "JoinMessage", "JoinResponse",
        "AlertMessage", "BatchedAlertMessage", "ProbeMessage", "ProbeResponse",
        "FastRoundPhase2bMessage", "Rank", "Phase1aMessage", "Phase1bMessage",
        "Phase2aMessage", "Phase2bMessage", "LeaveMessage", "Response",
        "ConsensusResponse", "CohortCutMessage", "DelegateDecisionMessage",
        "GlobalTierMessage", "RapidRequest", "RapidResponse",
    )
}


def proto_class(name: str):
    """The materialized protobuf class for ``remoting.<name>``."""
    return _CLASSES[name]


GRPC_METHOD = "/remoting.MembershipService/sendRequest"
