"""The port's reference-wire interop (``rapid_tpu_torch/interop``) against
the JAX package's, on the CPU.

- Every request and response type's frame equals the committed golden
  frame (``tests/fixtures/wire_frames.json``) and decodes back.
- Each package decodes the other's frames, and both write the same bytes,
  on the seeded message grid of ``tests/test_torch_protocol.py``.
- ``tests/test_interop_grpc.py``'s field-number layout, the descriptors of
  both schemas equal field by field, and its round trips.
- A mixed JAX/port 5-node cluster over gRPC converges, loses one node and
  converges again.

Needs ``protobuf`` (and ``grpc`` for the cluster); skips without them. The
interop is host code and has no card phase.
"""

import asyncio
import dataclasses
import enum
import json
import random
from pathlib import Path

import pytest

pytest.importorskip("google.protobuf")

import rapid_tpu.types as jt  # noqa: E402
import rapid_tpu_torch.types as tt  # noqa: E402
from helpers import free_endpoints, wait_until  # noqa: E402
from rapid_tpu.interop import convert as j_convert  # noqa: E402
from rapid_tpu.interop import proto_schema as j_schema  # noqa: E402
from rapid_tpu_torch.interop import convert as t_convert  # noqa: E402
from rapid_tpu_torch.interop import proto_schema as t_schema  # noqa: E402
from test_torch_protocol import _wire_samples  # noqa: E402
from test_wire_fixtures import canonical_requests, canonical_responses  # noqa: E402

FIXTURES = json.loads((Path(__file__).parent / "fixtures" / "wire_frames.json").read_text())


def to_port(obj):
    """A JAX package message as the port's (types matched by name)."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(tt, type(obj).__name__)
        return cls(**{f.name: to_port(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, enum.Enum):
        return getattr(tt, type(obj).__name__)[obj.name]
    if isinstance(obj, tuple):
        return tuple(to_port(x) for x in obj)
    return obj


def _frame(message, to_proto):
    return to_proto(message).SerializeToString(deterministic=True)


@pytest.mark.parametrize("name", sorted(FIXTURES["requests"]))
def test_request_frame_equals_the_golden_frame(name):
    message = to_port(canonical_requests()[name])
    golden = bytes.fromhex(FIXTURES["requests"][name])
    assert _frame(message, t_convert.request_to_proto) == golden
    envelope = t_schema.proto_class("RapidRequest").FromString(golden)
    assert t_convert.request_from_proto(envelope) == message


@pytest.mark.parametrize("name", sorted(FIXTURES["responses"]))
def test_response_frame_equals_the_golden_frame(name):
    message = to_port(canonical_responses()[name])
    golden = bytes.fromhex(FIXTURES["responses"][name])
    assert _frame(message, t_convert.response_to_proto) == golden
    envelope = t_schema.proto_class("RapidResponse").FromString(golden)
    assert t_convert.response_from_proto(envelope) == message


def test_golden_frames_cover_every_reference_type():
    names = {c.__name__ for c in tt.RapidRequest.__args__} - {"GossipMessage"}
    assert set(FIXTURES["requests"]) == names
    assert set(FIXTURES["responses"]) == {c.__name__ for c in tt.RapidResponse.__args__}


@pytest.mark.parametrize("seed", range(4))
def test_each_package_decodes_the_others_frames(seed):
    j_req, j_resp = _wire_samples(jt, seed)
    t_req, t_resp = _wire_samples(tt, seed)
    for jm, tm in zip(j_req, t_req):
        if isinstance(tm, tt.GossipMessage):
            continue
        jb = _frame(jm, j_convert.request_to_proto)
        tb = _frame(tm, t_convert.request_to_proto)
        assert tb == jb, type(tm).__name__
        assert j_convert.request_from_proto(
            j_schema.proto_class("RapidRequest").FromString(tb)) == jm
        assert t_convert.request_from_proto(
            t_schema.proto_class("RapidRequest").FromString(jb)) == tm
    for jm, tm in zip(j_resp, t_resp):
        jb = _frame(jm, j_convert.response_to_proto)
        tb = _frame(tm, t_convert.response_to_proto)
        assert tb == jb, type(tm).__name__
        assert j_convert.response_from_proto(
            j_schema.proto_class("RapidResponse").FromString(tb)) == jm
        assert t_convert.response_from_proto(
            t_schema.proto_class("RapidResponse").FromString(jb)) == tm


def _layout(schema, name):
    return [(f.name, f.number, f.type, f.is_repeated,
             f.message_type.full_name if f.message_type else None,
             f.containing_oneof.name if f.containing_oneof else None)
            for f in schema.proto_class(name).DESCRIPTOR.fields]


def test_field_numbers_match_the_reference_layout():
    assert sorted(t_schema._CLASSES) == sorted(j_schema._CLASSES)
    for name in j_schema._CLASSES:
        assert _layout(t_schema, name) == _layout(j_schema, name), name
    assert t_schema.GRPC_METHOD == j_schema.GRPC_METHOD == "/remoting.MembershipService/sendRequest"
    req = t_schema.proto_class("RapidRequest").DESCRIPTOR
    assert [f.number for f in req.oneofs[0].fields] == list(range(1, 11)) + [12, 13, 14]
    assert [f.name for f in t_schema.proto_class("JoinResponse").DESCRIPTOR.fields] == [
        "sender", "statusCode", "configurationId", "endpoints",
        "identifiers", "metadataKeys", "metadataValues",
    ]
    alert = t_schema.proto_class("AlertMessage").DESCRIPTOR
    assert alert.fields_by_name["nodeId"].number == 6
    assert alert.fields_by_name["metadata"].number == 7
    assert t_schema.proto_class("BatchedAlertMessage").DESCRIPTOR.fields_by_name[
        "messages"].number == 3
    assert t_schema.proto_class("ProbeMessage").DESCRIPTOR.fields_by_name["payload"].number == 3


def test_gossip_envelope_is_not_representable():
    envelope = tt.GossipMessage(tt.Endpoint("127.0.0.1", 1), 1, 1,
                                tt.ProbeMessage(tt.Endpoint("127.0.0.1", 2)))
    with pytest.raises(KeyError):
        t_convert.request_to_proto(envelope)


def test_sign_handling_of_64_bit_fields_equals_jax():
    for value in (0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, -1, -(1 << 63), 1 << 64):
        assert t_convert._i64(value) == j_convert._i64(value)
        assert t_convert._u64(value) == j_convert._u64(value)
    nid = tt.NodeId((1 << 64) - 1, 1 << 63)
    wire = t_convert._nid(nid)
    assert (wire.high, wire.low) == (-1, -(1 << 63))
    assert t_convert._nid_back(wire) == nid


@pytest.mark.parametrize("seed_pkg", ["jax", "port"])
def test_mixed_cluster_over_grpc_converges_through_a_crash(seed_pkg):
    pytest.importorskip("grpc")
    from rapid_tpu.interop import grpc_transport as j_grpc
    from rapid_tpu.monitoring import static_fd as j_static
    from rapid_tpu.protocol import cluster as j_cluster
    from rapid_tpu import settings as j_settings
    from rapid_tpu_torch.interop import grpc_transport as t_grpc
    from rapid_tpu_torch.monitoring import static_fd as t_static
    from rapid_tpu_torch.protocol import cluster as t_cluster
    from rapid_tpu_torch import settings as t_settings

    jax = dict(t=jt, grpc=j_grpc, cluster=j_cluster, settings=j_settings)
    port = dict(t=tt, grpc=t_grpc, cluster=t_cluster, settings=t_settings)
    pkgs = [jax, port, jax, port, jax] if seed_pkg == "jax" else [port, jax, port, jax, port]
    # One failure detector per package, fed the same failed node.
    detectors = [j_static.StaticFailureDetectorFactory(), t_static.StaticFailureDetectorFactory()]

    async def main():
        addrs = [(e.hostname, e.port) for e in free_endpoints(5)]
        clusters = []

        async def converged(members, size):
            def same():
                views = {(c.service.view.configuration_id, tuple(str(e) for e in c.membership))
                         for c in members}
                return len(views) == 1 and all(c.membership_size == size for c in members)
            return await wait_until(same, timeout_s=30)

        try:
            for i, (pkg, (host, port_no)) in enumerate(zip(pkgs, addrs)):
                ep = pkg["t"].Endpoint(host, port_no)
                settings = pkg["settings"].Settings()
                settings.batching_window_ms = 20
                settings.failure_detector_interval_ms = 50
                settings.rpc_timeout_ms = 500
                settings.rpc_join_timeout_ms = 2000
                settings.rpc_probe_timeout_ms = 200
                kw = dict(settings=settings, client=pkg["grpc"].GrpcClient(ep, settings),
                          server=pkg["grpc"].GrpcServer(ep),
                          fd_factory=detectors[pkg is port], rng=random.Random(i))
                if i == 0:
                    clusters.append(await pkg["cluster"].Cluster.start(ep, **kw))
                else:
                    seed = pkg["t"].Endpoint(*addrs[0])
                    clusters.append(await pkg["cluster"].Cluster.join(seed, ep, **kw))
            assert await converged(clusters, 5)
            victim = clusters[2]
            await victim.shutdown()
            detectors[0].add_failed_nodes([jt.Endpoint(*addrs[2])])
            detectors[1].add_failed_nodes([tt.Endpoint(*addrs[2])])
            survivors = [c for c in clusters if c is not victim]
            assert await converged(survivors, 4)
            assert all(str(victim.listen_address) not in map(str, c.membership) for c in survivors)
        finally:
            await asyncio.gather(*(c.shutdown() for c in clusters), return_exceptions=True)

    asyncio.run(asyncio.wait_for(main(), 90))
