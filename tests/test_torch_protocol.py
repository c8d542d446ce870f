"""The port's host protocol modules against the JAX package's, exactly.

- The plain copies (errors, types, clock, metadata, events, the view, the
  cut detector, Paxos and Fast Paxos, the service, the cluster, the
  transports with UDP and gossip, the failure detectors with the windowed
  one, the hierarchical service, the chaos runner, faults, oracles and
  fuzzer, the native library's bridge and the reference-wire interop) have
  the JAX modules' code: their syntax trees are equal once docstrings are
  dropped and the package name is read as one. The ``Configuration`` path
  of ``utils/checkpoint.py`` is pinned name by name. The port's own
  departures are named where they are made: Fast Paxos takes its quorum
  rule from ``ops/consensus.py``; the chaos modules take a trailing
  ``device`` wherever they reach the engine replay; the engine half of
  the oracles reads the card through the port's own calls (held by
  ``tests/test_torch_chaos.py`` and ``tests/test_torch_host_sim.py``); and
  the native bridge builds its library into the port's ``build/``.
- Types, ``NodeId`` round-trips, ``MembershipView`` (both topologies, the
  java golden fixtures) and the wire codec (bytes equal for every message
  and response type, and each package decoding the other's frames).
- ``MultiNodeCutDetector``, and the port's ``DeviceCutDetector`` on the CPU
  against JAX's and against ``MultiNodeCutDetector`` on the grid of
  ``tests/test_device_cut_detector.py``.
- The port's ``DeviceVoteTally`` on the CPU against JAX's, a proposal whose
  high hash lane is 2**31 or above included.
- The Paxos interleaving fuzzer of ``tests/test_paxos_interleavings.py``
  through both packages: the same decisions.
"""

import ast
import dataclasses
import functools
import json
import random
import uuid
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import rapid_tpu.errors as j_errors
import rapid_tpu.types as jt
import rapid_tpu_torch.errors as t_errors
import rapid_tpu_torch.types as tt
from rapid_tpu import settings as j_settings
from rapid_tpu.messaging import codec as j_codec
from rapid_tpu.protocol import cut_detector as j_cut
from rapid_tpu.protocol import device_cut_detector as j_dcut
from rapid_tpu.protocol import device_vote_tally as j_tally
from rapid_tpu.protocol import fast_paxos as j_fp
from rapid_tpu.protocol import view as j_view
from rapid_tpu.utils import clock as j_clock
from rapid_tpu_torch import _host, settings as t_settings
from rapid_tpu_torch.messaging import codec as t_codec
from rapid_tpu_torch.ops.consensus import fast_paxos_quorum
from rapid_tpu_torch.protocol import cut_detector as t_cut
from rapid_tpu_torch.protocol import device_cut_detector as t_dcut
from rapid_tpu_torch.protocol import device_vote_tally as t_tally
from rapid_tpu_torch.protocol import fast_paxos as t_fp
from rapid_tpu_torch.protocol import view as t_view
from rapid_tpu_torch.utils import clock as t_clock

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures"

JAX = SimpleNamespace(
    name="jax", t=jt, view=j_view, cut=j_cut, dcut=j_dcut, tally=j_tally, fp=j_fp,
    clock=j_clock, codec=j_codec,
)
PORT = SimpleNamespace(
    name="port", t=tt, view=t_view, cut=t_cut,
    dcut=SimpleNamespace(DeviceCutDetector=functools.partial(t_dcut.DeviceCutDetector, device="cpu")),
    tally=SimpleNamespace(DeviceVoteTally=functools.partial(t_tally.DeviceVoteTally, device="cpu")),
    fp=t_fp, clock=t_clock, codec=t_codec,
)


# -- the copies: equal code -------------------------------------------------

_COPIES = [
    "errors.py", "types.py", "settings.py", "utils/clock.py",
    "protocol/metadata.py", "protocol/events.py", "protocol/cut_detector.py",
    "protocol/paxos.py", "protocol/fast_paxos.py", "protocol/service.py",
    "protocol/cluster.py",
    "messaging/__init__.py", "messaging/base.py", "messaging/codec.py",
    "messaging/inprocess.py", "messaging/retries.py", "messaging/stats.py",
    "messaging/tcp.py", "messaging/udp.py", "messaging/gossip.py",
    "monitoring/__init__.py", "monitoring/base.py", "monitoring/ping_pong.py",
    "monitoring/static_fd.py", "monitoring/windowed.py",
    "hier/__init__.py", "hier/cohorts.py", "hier/broadcast.py", "hier/service.py",
    "sim/__init__.py", "sim/faults.py", "sim/scenario.py", "sim/oracles.py", "sim/fuzz.py",
    "protocol/view.py", "utils/_native.py",
    "interop/__init__.py", "interop/proto_schema.py", "interop/convert.py",
    "interop/grpc_transport.py",
]

#: The ``Configuration`` path of ``utils/checkpoint.py``, pinned name by
#: name: the rest of the module is the engine and serving half.
_CHECKPOINT_CONFIGURATION = [
    "CheckpointCorruptError", "_seal", "_unseal", "_atomic_write", "_MAGIC", "_VERSION",
    "_TOPOLOGY_CODES", "_TOPOLOGY_NAMES", "configuration_to_bytes", "configuration_from_bytes",
    "save_configuration", "load_configuration", "view_from_configuration",
]

#: The engine half of the oracles: the port reads the card through its own
#: calls (``_host.read``, ``alive_mask``), so these are held by behaviour.
_ENGINE_ORACLES = {"inject_engine_event", "replay_through_engine", "check_differential"}


class _NoDevice(ast.NodeTransformer):
    """Takes out a ``device`` parameter and every ``device`` argument: the
    port's chaos modules thread one to the engine replay."""

    def visit_arguments(self, node):
        keep = [i for i, a in enumerate(node.args) if a.arg != "device"]
        cut = len(node.args) - len(node.defaults)
        node.defaults = [d for i, d in enumerate(node.defaults) if cut + i in keep]
        node.args = [node.args[i] for i in keep]
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        node.args = [a for a in node.args if not (isinstance(a, ast.Name) and a.id == "device")]
        node.keywords = [k for k in node.keywords if k.arg != "device"]
        return node


def _is_docstring(node):
    return (isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str))


def _drop(body, pred):
    return [n for n in body if not pred(n)] or [ast.Pass()]


def _without_docstrings(path: Path) -> ast.Module:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.body and _is_docstring(node.body[0]):
                node.body = node.body[1:] or [ast.Pass()]
    return tree


def _normalized(path: Path, package: str, rel: str) -> str:
    """The module's syntax tree without docstrings, with ``package`` read as
    ``rapid_tpu``, and with the port's named departures taken out of both
    sides."""
    tree = _without_docstrings(path)
    if rel == "protocol/fast_paxos.py":
        # One quorum rule in the port: ops/consensus.fast_paxos_quorum.
        tree.body = _drop(tree.body, lambda n: (
            isinstance(n, ast.FunctionDef) and n.name == "fast_paxos_quorum"
            or isinstance(n, ast.ImportFrom) and n.module.endswith("ops.consensus")))
    if rel.startswith("sim/"):
        tree = _NoDevice().visit(tree)
    if rel == "sim/oracles.py":
        tree.body = _drop(tree.body, lambda n: (
            isinstance(n, ast.FunctionDef) and n.name in _ENGINE_ORACLES
            or isinstance(n, ast.Import) and [a.name for a in n.names] == ["numpy"]
            or isinstance(n, ast.ImportFrom) and [a.name for a in n.names] == ["_host"]))
    if rel == "settings.py":
        # The port's settings own the topology names (no host view to ask).
        tree.body = _drop(tree.body, lambda n: isinstance(n, ast.Assign) and any(
            getattr(t, "id", None) == "TOPOLOGIES" for t in n.targets))
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef):
                node.body = _drop(node.body, lambda n: isinstance(n, ast.ImportFrom))
    if rel == "utils/_native.py":
        # The port builds csrc/rapid_native.cpp into its own build/
        # (_build.build_host), never under native/.
        tree.body = _drop(tree.body, lambda n: (
            isinstance(n, ast.Assign) and any(
                getattr(t, "id", None) in ("_REPO_NATIVE_DIR", "_LIB_PATH") for t in n.targets)
            or isinstance(n, ast.FunctionDef) and n.name == "_try_build"
            or isinstance(n, ast.Import) and [a.name for a in n.names] == ["subprocess"]
            or isinstance(n, ast.ImportFrom) and n.module in ("pathlib", package)))
    return ast.dump(tree).replace(package, "rapid_tpu")


@pytest.mark.parametrize("rel", _COPIES)
def test_copy_has_the_jax_modules_code(rel):
    port = _normalized(REPO / "rapid_tpu_torch" / rel, "rapid_tpu_torch", rel)
    ref = _normalized(REPO / "rapid_tpu" / rel, "rapid_tpu_torch", rel)
    assert port == ref, f"rapid_tpu_torch/{rel} drifted from rapid_tpu/{rel}"


def _top_level(path: Path, name: str) -> str:
    """The syntax tree of the top-level class, function or assignment that
    defines ``name``, without docstrings."""
    found = [ast.dump(node) for node in _without_docstrings(path).body
             if getattr(node, "name", None) == name
             or isinstance(node, ast.Assign) and any(getattr(t, "id", None) == name
                                                     for t in node.targets)]
    assert len(found) == 1, f"{path.name} defines {name} {len(found)} times"
    return found[0]


@pytest.mark.parametrize("name", _CHECKPOINT_CONFIGURATION)
def test_checkpoint_configuration_path_has_the_jax_code(name):
    rel = "utils/checkpoint.py"
    assert (_top_level(REPO / "rapid_tpu_torch" / rel, name)
            == _top_level(REPO / "rapid_tpu" / rel, name))


def test_quorum_rule_is_the_consensus_ops_one():
    assert t_fp.fast_paxos_quorum is fast_paxos_quorum
    assert all(fast_paxos_quorum(n) == j_fp.fast_paxos_quorum(n) for n in range(1, 5001))


# -- types ----------------------------------------------------------------


def _dataclasses(mod):
    return {name: obj for name, obj in vars(mod).items()
            if dataclasses.is_dataclass(obj) and obj.__module__ == mod.__name__}


def test_types_have_the_same_fields_and_enums():
    jd, td = _dataclasses(jt), _dataclasses(tt)
    assert sorted(jd) == sorted(td)
    assert len(jd) >= 19
    for name, cls in jd.items():
        jf = [(f.name, f.default, f.compare) for f in dataclasses.fields(cls)]
        tf = [(f.name, f.default, f.compare) for f in dataclasses.fields(td[name])]
        assert [f[0] for f in jf] == [f[0] for f in tf], name
        assert [(f[2], repr(f[1])) for f in jf] == [(f[2], repr(f[1])) for f in tf], name
        assert cls.__dataclass_params__.frozen == td[name].__dataclass_params__.frozen
        assert cls.__dataclass_params__.order == td[name].__dataclass_params__.order
    for name in ("EdgeStatus", "JoinStatusCode", "NodeStatus"):
        assert [(m.name, m.value) for m in getattr(jt, name)] == [
            (m.name, m.value) for m in getattr(tt, name)]
    assert [c.__name__ for c in jt.RapidRequest.__args__] == [
        c.__name__ for c in tt.RapidRequest.__args__]
    assert [c.__name__ for c in jt.RapidResponse.__args__] == [
        c.__name__ for c in tt.RapidResponse.__args__]
    errs = [n for n, o in vars(j_errors).items() if isinstance(o, type)]
    assert errs == [n for n, o in vars(t_errors).items() if isinstance(o, type)]


@pytest.mark.parametrize("seed", range(4))
def test_node_id_round_trips(seed):
    rng = random.Random(seed)
    for _ in range(50):
        u = uuid.UUID(int=rng.getrandbits(128))
        a, b = jt.NodeId.from_uuid(u), tt.NodeId.from_uuid(u)
        assert (a.high, a.low) == (b.high, b.low)
        assert uuid.UUID(int=(b.high << 64) | b.low) == u
    ep = tt.Endpoint.parse("host.example:7001")
    assert (ep.hostname, ep.port, str(ep)) == ("host.example", 7001, "host.example:7001")


# -- the view ---------------------------------------------------------------


def _members(n, seed):
    """Seeded endpoints (hostnames of many lengths, non-ASCII ones too) and
    identifiers spanning the signed/unsigned boundaries."""
    rng = np.random.default_rng(seed)
    names = ["10.1.%d.%d", "node-%d-%d.rapid", "köln-%d.%d", "节点%d-%d", "h%d%d"]
    hosts = [names[i % len(names)] % (i // 7, int(rng.integers(0, 300))) for i in range(n)]
    ports = rng.choice(np.arange(1, 65536), size=n, replace=False)
    ids = [(int(x) & ((1 << 64) - 1), int(y) & ((1 << 64) - 1))
           for x, y in rng.integers(-(1 << 63), (1 << 63) - 1, size=(n, 2), dtype=np.int64)]
    return list(zip(hosts, (int(p) for p in ports))), ids


def _view_facts(pkg, k, hosts, ids, topology):
    t = pkg.t
    eps = [t.Endpoint(h, p) for h, p in hosts]
    nids = [t.NodeId(a, b) for a, b in ids]
    bulk = pkg.view.MembershipView(k, node_ids=nids[:-3], endpoints=eps[:-3], topology=topology)
    incr = pkg.view.MembershipView(k, topology=topology)
    for ep, nid in zip(eps[:-3], nids[:-3]):
        incr.ring_add(ep, nid)
    facts = []
    for view in (bulk, incr):
        joiner = eps[-1]
        facts.append((
            [[str(e) for e in view.ring(r)] for r in range(k)],
            [view.ring_keys(r) for r in range(k)],
            [[str(o) for o in view.observers_of(e)] for e in eps[:-3]],
            [[str(o) for o in view.subjects_of(e)] for e in eps[:-3]],
            [str(o) for o in view.expected_observers_of(joiner)],
            view.ring_numbers(view.observers_of(eps[0])[0], eps[0]),
            view.configuration_id,
            view.is_safe_to_join(eps[0], nids[-1]).name,
            view.is_safe_to_join(joiner, nids[0]).name,
            view.is_safe_to_join(joiner, nids[-1]).name,
        ))
    view = bulk
    view.ring_add(eps[-2], nids[-2])
    view.ring_delete(eps[1])
    facts.append((
        [[str(e) for e in view.ring(r)] for r in range(k)],
        view.configuration_id,
        [str(e) for e in view.ring_zero_sorted(eps[-3:])],
        pkg.view.configuration_id_of(sorted(nids, key=lambda n: pkg.view.node_id_sort_key(n, topology)),
                                     view.ring(0), topology),
    ))
    return facts


@pytest.mark.parametrize("topology", ["native", "java"])
@pytest.mark.parametrize("k,n,seed", [(10, 40, 0), (3, 9, 1), (7, 120, 2)])
def test_view_matches_jax(topology, k, n, seed):
    hosts, ids = _members(n, seed)
    ours = _view_facts(PORT, k, hosts, ids, topology)
    assert ours == _view_facts(JAX, k, hosts, ids, topology)
    assert ours[0] == ours[1]  # bulk and incremental construction agree


def test_view_ring_keys_match_jax_one_by_one():
    hosts, _ = _members(60, 3)
    for h, p in hosts:
        for seed in range(4):
            assert t_view.ring_key(tt.Endpoint(h, p), seed) == j_view.ring_key(jt.Endpoint(h, p), seed)
            assert t_view.ring_key_java(tt.Endpoint(h, p), seed) == j_view.ring_key_java(
                jt.Endpoint(h, p), seed)


def test_view_java_golden_fixtures():
    golden = json.loads((FIXTURES / "java_topology.json").read_text())
    ids = [tt.NodeId(h, l) for h, l in [(1, 2), ((1 << 63) + 7, 3), (42, (1 << 63) + 1)]]
    eps = [tt.Endpoint("alpha.rapid", 50001), tt.Endpoint("beta.rapid", 50002),
           tt.Endpoint("gamma.rapid", 50003)]
    for ep, expect in zip(eps, golden["ring_keys"]):
        assert [t_view.ring_key_java(ep, seed) for seed in range(3)] == expect
    view = t_view.MembershipView(3, node_ids=ids, endpoints=eps, topology="java")
    assert [str(e) for e in view.ring(0)] == golden["ring0_order"]
    assert view.configuration_id == golden["configuration_id"]

    wide = json.loads((FIXTURES / "java_topology_wide.json").read_text())
    m = 1 << 64
    ids = [tt.NodeId(0, 0), tt.NodeId(m - 1, m - 1), tt.NodeId(1 << 63, (1 << 63) - 1),
           tt.NodeId(1, 1), tt.NodeId(5, (1 << 63) + 5), tt.NodeId(1 << 32, 1 << 32)]
    eps = [tt.Endpoint("köln-node.example", 1), tt.Endpoint("рапид.бг", 65535),
           tt.Endpoint("节点七", 7), tt.Endpoint("a", 80), tt.Endpoint("delta.rapid", 50004),
           tt.Endpoint("z-very-long-hostname-segment-z-very-long-hostname-segment", 32768)]
    k = wide["k"]
    for ep, expect in zip(eps, wide["ring_keys"]):
        assert [t_view.ring_key_java(ep, seed) for seed in range(k)] == expect
    view = t_view.MembershipView(k, node_ids=ids, endpoints=eps, topology="java")
    assert [[str(e) for e in view.ring(r)] for r in range(k)] == wide["ring_orders"]
    assert view.configuration_id == wide["configuration_id"]


def test_view_rejects_what_jax_rejects():
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError):
            pkg.view.MembershipView(3, topology="jvm")
        with pytest.raises(ValueError):
            pkg.view.MembershipView(0)
    view = t_view.MembershipView(3)
    view.ring_add(tt.Endpoint("a", 1), tt.NodeId(1, 1))
    with pytest.raises(t_errors.NodeAlreadyInRingError):
        view.ring_add(tt.Endpoint("a", 1), tt.NodeId(2, 2))
    with pytest.raises(t_errors.UUIDAlreadySeenError):
        view.ring_add(tt.Endpoint("b", 1), tt.NodeId(1, 1))
    with pytest.raises(t_errors.NodeNotInRingError):
        view.ring_delete(tt.Endpoint("c", 1))


# -- the wire codec -----------------------------------------------------------


def _wire_samples(t, seed):
    """Every request and response type, with seeded field values (negative
    and 64-bit configuration ids, both NodeId halves past 2**63, metadata,
    trace ids on and off, nested envelopes)."""
    rng = random.Random(seed)

    def ep():
        return t.Endpoint(rng.choice(["10.0.0.%d", "host-%d.example", "节点%d"]) % rng.randrange(256),
                          rng.randrange(1, 65536))

    def eps(n=None):
        return tuple(ep() for _ in range(rng.randrange(0, 6) if n is None else n))

    def nid():
        return t.NodeId(rng.getrandbits(64), rng.getrandbits(64))

    def cid():
        return rng.randrange(-(1 << 63), 1 << 63)

    def md():
        return tuple((f"k{i}", bytes(rng.getrandbits(8) for _ in range(rng.randrange(4))))
                     for i in range(rng.randrange(3)))

    def rank():
        return t.Rank(rng.randrange(1 << 31), rng.randrange(1 << 31))

    def trace():
        return rng.choice([None, rng.getrandbits(64) or 1])

    def alert():
        up = rng.random() < 0.5
        return t.AlertMessage(ep(), ep(), t.EdgeStatus.UP if up else t.EdgeStatus.DOWN, cid(),
                              tuple(sorted(rng.sample(range(10), rng.randrange(1, 5)))),
                              nid() if up else None, md() if up else ())

    consensus = [
        t.FastRoundPhase2bMessage(ep(), cid(), eps(), trace()),
        t.Phase1aMessage(ep(), cid(), rank(), trace()),
        t.Phase1bMessage(ep(), cid(), rank(), rank(), eps(), trace()),
        t.Phase2aMessage(ep(), cid(), rank(), eps(), trace()),
        t.Phase2bMessage(ep(), cid(), rank(), eps(), trace()),
    ]
    requests = [
        t.PreJoinMessage(ep(), nid()),
        t.JoinMessage(ep(), nid(), (0, 3, 9), cid(), md()),
        t.BatchedAlertMessage(ep(), tuple(alert() for _ in range(rng.randrange(1, 5))), trace()),
        t.BatchedAlertMessage(ep(), (), None),
        t.ProbeMessage(ep()),
        *consensus,
        t.LeaveMessage(ep()),
        t.CohortCutMessage(ep(), cid(), rng.randrange(64), eps(), eps(2), (nid(), nid()), trace()),
        t.DelegateDecisionMessage(ep(), cid(), eps(), eps(1), (nid(),), trace()),
        t.GlobalTierMessage(ep(), consensus[rng.randrange(5)]),
        t.GossipMessage(ep(), rng.getrandbits(64), rng.randrange(8), consensus[0]),
        t.GossipMessage(ep(), rng.getrandbits(64), 0, t.BatchedAlertMessage(ep(), (alert(),))),
    ]
    responses = [
        t.JoinResponse(ep(), rng.choice(list(t.JoinStatusCode)), cid(), eps(3), (nid(),) * 3,
                       eps(2), (md(), md())),
        t.JoinResponse(ep(), t.JoinStatusCode.SAFE_TO_JOIN, cid()),
        t.Response(),
        t.ConsensusResponse(),
        t.ProbeResponse(t.NodeStatus.BOOTSTRAPPING),
        t.ProbeResponse(),
    ]
    return requests, responses


@pytest.mark.parametrize("seed", range(6))
def test_codec_bytes_equal_and_cross_decode(seed):
    j_req, j_resp = _wire_samples(jt, seed)
    t_req, t_resp = _wire_samples(tt, seed)
    covered = {type(m).__name__ for m in t_req + t_resp}
    assert covered == {c.__name__ for c in tt.RapidRequest.__args__ + tt.RapidResponse.__args__}
    for jm, tm in zip(j_req, t_req):
        jb, tb = j_codec.encode_request(jm), t_codec.encode_request(tm)
        assert tb == jb, type(tm).__name__
        assert j_codec.decode_request(tb) == jm  # JAX reads the port's frame
        assert t_codec.decode_request(jb) == tm  # and the port reads JAX's
        assert type(t_codec.decode_request(jb)) is type(tm)
    for jm, tm in zip(j_resp, t_resp):
        jb, tb = j_codec.encode_response(jm), t_codec.encode_response(tm)
        assert tb == jb, type(tm).__name__
        assert j_codec.decode_response(tb) == jm
        assert t_codec.decode_response(jb) == tm


def test_codec_rejects_what_jax_rejects():
    frame = t_codec.encode_request(tt.ProbeMessage(tt.Endpoint("a", 1)))
    for bad in (frame[:-1], b"", b"\xff" + frame[1:], frame + b"\x00"):
        errors = []
        for codec in (j_codec, t_codec):
            try:
                codec.decode_request(bad)
                errors.append(None)
            except Exception as exc:  # noqa: BLE001 — the class names are compared
                errors.append(type(exc).__name__)
        assert errors[0] == errors[1]


# -- cut detectors -------------------------------------------------------------

K, H, L = 10, 8, 3


def _make_view(pkg, n, seed=0, k=K):
    rng = np.random.default_rng(seed)
    ports = rng.choice(40000, size=n, replace=False) + 1
    endpoints = [pkg.t.Endpoint(f"10.5.{i % 256}.{i // 256}", int(p)) for i, p in enumerate(ports)]
    view = pkg.view.MembershipView(k)
    for i, ep in enumerate(endpoints):
        view.ring_add(ep, pkg.t.NodeId(0, i))
    return view, endpoints


def _alerts_for(pkg, view, subject, count, status=None):
    status = pkg.t.EdgeStatus.DOWN if status is None else status
    observers = (view.observers_of(subject) if view.is_host_present(subject)
                 else view.expected_observers_of(subject))
    return [pkg.t.AlertMessage(observers[r], subject, status, 0, (r,)) for r in range(count)]


def _random_batches(pkg, seed):
    """The randomized grid of tests/test_device_cut_detector.py, ordered
    flux-enders first (the host oracle's order-insensitive form)."""
    view, endpoints = _make_view(pkg, 35, seed)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(3):
        batch = []
        for _ in range(rng.integers(1, 4)):
            subject = endpoints[rng.integers(0, len(endpoints) - 1)]
            batch.extend(_alerts_for(pkg, view, subject, int(rng.integers(1, K + 1))))
        batches.append(batch)
    batches.append(_alerts_for(pkg, view, endpoints[-1], K))
    ordered = []
    for batch in batches:
        by_dst = {}
        for a in batch:
            by_dst.setdefault(a.edge_dst, []).append(a)
        flux, other = [], []
        for msgs in by_dst.values():
            rings = {r for m in msgs for r in m.ring_numbers}
            (flux if L <= len(rings) < H else other).append(msgs)
        ordered.append([m for msgs in flux + other for m in msgs])
    return view, ordered


def _names(eps):
    return sorted(str(e) for e in eps)


def _run_detector(pkg, make, seed):
    view, batches = _random_batches(pkg, seed)
    det = make(pkg)
    return [_names(det.aggregate_batch(b, view)) for b in batches] + [det.num_proposals]


@pytest.mark.parametrize("seed", range(12))
def test_multi_node_cut_detector_matches_jax(seed):
    def make(pkg):
        return pkg.cut.MultiNodeCutDetector(K, H, L)

    assert _run_detector(PORT, make, seed) == _run_detector(JAX, make, seed)
    # The single-alert form, in a seeded interleaving of UP and DOWN alerts.
    outs = []
    for pkg in (JAX, PORT):
        view, endpoints = _make_view(pkg, 30, seed)
        rng = random.Random(seed)
        det = pkg.cut.MultiNodeCutDetector(K, H, L)
        out = []
        for _ in range(60):
            subject = endpoints[rng.randrange(len(endpoints))]
            status = pkg.t.EdgeStatus(rng.randrange(2))
            for a in _alerts_for(pkg, view, subject, rng.randrange(1, K + 1), status):
                out.append(_names(det.aggregate(a)))
            if rng.random() < 0.2:
                out.append(_names(det.invalidate_failing_edges(view)))
            out.append(det.has_pending_reports())
        outs.append(out + [det.num_proposals])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("seed", range(6))
def test_device_cut_detector_matches_jax_and_the_host_detector(seed):
    def device(pkg):
        return pkg.dcut.DeviceCutDetector(K, H, L, max_slots=256)

    ours = _run_detector(PORT, device, seed)
    assert ours == _run_detector(JAX, device, seed)
    host = _run_detector(PORT, lambda pkg: pkg.cut.MultiNodeCutDetector(K, H, L), seed)
    # Cumulatively both release exactly the same members (per batch the
    # device's releases are a subset: see tests/test_device_cut_detector.py).
    assert sorted(sum(ours[:-1], [])) == sorted(sum(host[:-1], []))


def _invalidation_case(pkg):
    view, endpoints = _make_view(pkg, 30, 42)
    det = pkg.dcut.DeviceCutDetector(K, H, L, max_slots=128)
    dst = endpoints[0]
    observers = view.observers_of(dst)
    batch = [pkg.t.AlertMessage(observers[i], dst, pkg.t.EdgeStatus.DOWN, 0, (i,))
             for i in range(H - 1)]
    failed = {dst}
    for i in range(H - 1, K):
        failed.add(observers[i])
        oo = view.observers_of(observers[i])
        batch += [pkg.t.AlertMessage(oo[j], observers[i], pkg.t.EdgeStatus.DOWN, 0, (j,))
                  for j in range(K)]
    return _names(det.aggregate_batch(batch, view)), _names(failed), det.num_proposals


def test_device_cut_detector_implicit_invalidation():
    ours = _invalidation_case(PORT)
    assert ours == _invalidation_case(JAX)
    assert ours[0] == ours[1] and ours[2] == 1


def _clear_and_overflow(pkg):
    view, endpoints = _make_view(pkg, 20, 7)
    det = pkg.dcut.DeviceCutDetector(K, H, L, max_slots=64)
    out = [_names(det.aggregate_batch(_alerts_for(pkg, view, endpoints[3], K), view))]
    det.clear()
    out += [det.num_proposals, det.has_pending_reports()]
    out.append(_names(det.aggregate_batch(_alerts_for(pkg, view, endpoints[3], K), view)))
    view, endpoints = _make_view(pkg, 20, 9)
    det = pkg.dcut.DeviceCutDetector(K, H, L, max_slots=16)
    det.aggregate_batch(_alerts_for(pkg, view, endpoints[0], 2), view)
    for ep in endpoints[1:]:
        out.append(_names(det.aggregate_batch(_alerts_for(pkg, view, ep, 2), view)))
    out.append(_names(det.aggregate_batch(_alerts_for(pkg, view, endpoints[0], K), view)))
    out.append(_names(det.aggregate(_alerts_for(pkg, view, endpoints[1], 1)[0])))
    out.append(_names(det.invalidate_failing_edges(view)))
    return out


def test_device_cut_detector_clear_and_slot_overflow(caplog):
    with caplog.at_level("WARNING"):
        ours = _clear_and_overflow(PORT)
    assert ours == _clear_and_overflow(JAX)
    assert ours[0] == ours[3] and len(ours[0]) == 1
    assert ours[-3]  # the slotted subject still reaches a release
    warned = [r for r in caplog.records if "slot capacity" in r.getMessage()
              and r.name == t_dcut.LOG.name]
    assert len(warned) == 1  # warned once, exactly as JAX does


def test_device_cut_detector_reads_once_per_pass_and_stages_one_buffer():
    view, endpoints = _make_view(PORT, 40, 3)
    det = PORT.dcut.DeviceCutDetector(K, H, L, max_slots=128)
    before = _host.read.count
    assert det.aggregate_batch([], view) == set()  # nothing to do: no pass
    assert (det.batches, _host.read.count - before) == (0, 0)
    det.aggregate_batch(_alerts_for(PORT, view, endpoints[5], 4), view)
    det.aggregate_batch(_alerts_for(PORT, view, endpoints[5], K)[4:], view)
    assert (det.batches, _host.read.count - before) == (2, 2)
    # After a DOWN alert an empty batch still runs the invalidation pass.
    det.aggregate_batch([], view)
    assert (det.batches, _host.read.count - before) == (3, 3)
    assert det.bytes_uploaded > 0 and det.device.type == "cpu"


# -- the vote tally -----------------------------------------------------------


def _high_lane_proposal(t):
    for port in range(1, 1000):
        proposal = (t.Endpoint("10.9.0.1", port),)
        if j_tally._proposal_hash_lanes((jt.Endpoint("10.9.0.1", port),))[0] >= 1 << 31:
            return proposal
    raise AssertionError("no high-lane proposal")


def _tally_run(pkg, n, plan, **kw):
    """Feed ``plan`` (sender index, proposal index) votes; returns each
    vote's answer as names."""
    tally = pkg.tally.DeviceVoteTally(n, **kw)
    proposals = [(pkg.t.Endpoint("10.9.0.1", 4000 + i),) for i in range(3)]
    proposals.append(_high_lane_proposal(pkg.t))
    out = []
    for sender, p in plan:
        got = tally.add_vote(pkg.t.Endpoint("10.8.0.1", 100 + sender), proposals[p])
        out.append(None if got is None else _names(got))
    return out


@pytest.mark.parametrize("n", [5, 6, 10, 20, 102])
@pytest.mark.parametrize("winner", [0, 3])
def test_vote_tally_decides_at_the_same_vote_as_jax(n, winner):
    quorum = fast_paxos_quorum(n)
    plan = [(i, winner) for i in range(quorum + 2)]
    ours = _tally_run(PORT, n, plan)
    assert ours == _tally_run(JAX, n, plan)
    assert ours.index(ours[quorum - 1]) == quorum - 1 and ours[quorum - 1] is not None


def test_high_lane_winner_is_widened_before_lookup():
    proposal = _high_lane_proposal(tt)
    hi, _ = t_tally._proposal_hash_lanes(proposal)
    assert hi >= 1 << 31
    tally = t_tally.DeviceVoteTally(4, device="cpu")
    assert [tally.add_vote(tt.Endpoint("s", i), proposal) for i in range(4)][-1] == proposal


@pytest.mark.parametrize("seed", range(6))
def test_vote_tally_conflicts_duplicates_and_overflow_match_jax(seed):
    rng = random.Random(seed)
    n = rng.choice([7, 10, 33])
    plan = [(rng.randrange(n + 3), rng.choice([0, 0, 0, 1, 2, 3])) for _ in range(3 * n)]
    for kw in ({}, {"max_slots": 4}, {"max_proposals": 2}):
        assert _tally_run(PORT, n, plan, **kw) == _tally_run(JAX, n, plan, **kw)


def test_vote_tally_reads_once_per_tally_and_none_before_quorum():
    n = 20
    tally = t_tally.DeviceVoteTally(n, device="cpu")
    quorum = fast_paxos_quorum(n)
    before = _host.read.count
    for i in range(quorum - 1):
        assert tally.add_vote(tt.Endpoint("s", i), (tt.Endpoint("x", 1),)) is None
    assert (tally.tallies, tally.bytes_uploaded, _host.read.count) == (0, 0, before)
    tally.add_vote(tt.Endpoint("s", 99), (tt.Endpoint("y", 1),))
    tally.add_vote(tt.Endpoint("s", 100), (tt.Endpoint("x", 1),))
    assert (tally.tallies, _host.read.count - before) == (2, 2)


def test_fast_paxos_with_device_tally_matches_jax():
    outs = []
    for pkg in (JAX, PORT):
        n, decided = 8, []
        fp = pkg.fp.FastPaxos(
            my_addr=pkg.t.Endpoint("127.0.0.1", 0), configuration_id=1, membership_size=n,
            broadcast_fn=lambda r: None, send_fn=lambda d, r: None,
            on_decide=lambda hosts: decided.append(_names(hosts)), clock=pkg.clock.ManualClock(),
            rng=random.Random(0), vote_tally=pkg.tally.DeviceVoteTally(n),
        )
        proposal = (pkg.t.Endpoint("127.0.0.1", 7777),)
        trail = []
        for i in range(fast_paxos_quorum(n) + 2):
            fp.handle_message(pkg.t.FastRoundPhase2bMessage(
                sender=pkg.t.Endpoint("127.0.0.1", 100 + i), configuration_id=1,
                endpoints=proposal))
            trail.append(list(decided))
        outs.append((trail, fp.decided_path))
    assert outs[0] == outs[1] and outs[1][1] == "fast"


# -- Paxos interleavings --------------------------------------------------------


def _adversarial_schedule(pkg, seed, n=5, drop_p=0.15, dup_p=0.2):
    """tests/test_paxos_interleavings.py's run_adversarial_schedule over
    ``pkg``: a seeded pool that reorders, duplicates and drops consensus
    messages across escalating classic rounds. Returns each node's decision
    and the delivery trail."""
    t = pkg.t
    rng = random.Random(seed)
    clock = pkg.clock.ManualClock()
    pool, nodes, decisions, trail = [], [], {}, []

    def ep(i):
        return t.Endpoint("10.5.0.1", 9000 + i)

    def enqueue(target, message):
        if rng.random() < drop_p:
            return
        pool.append((target, message))
        if rng.random() < dup_p:
            pool.append((target, message))

    def deliver_some(max_messages):
        delivered = 0
        while pool and delivered < max_messages:
            target, message = pool.pop(rng.randrange(len(pool)))
            trail.append((target, type(message).__name__))
            nodes[target].handle_message(message)
            delivered += 1

    def on_decide_for(i):
        return lambda value: decisions.__setitem__(i, _names(value))

    for i in range(n):
        nodes.append(pkg.fp.FastPaxos(
            my_addr=ep(i), configuration_id=77, membership_size=n,
            broadcast_fn=lambda m: [enqueue(j, m) for j in range(n)],
            send_fn=lambda remote, m: enqueue(remote.port - 9000, m),
            on_decide=on_decide_for(i), clock=clock,
            consensus_fallback_base_delay_ms=100, rng=random.Random(seed + i),
        ))
    proposals = [(ep(100),), (ep(100), ep(101))]
    split = min(fast_paxos_quorum(n) - 1, n - 1)
    for i, fp in enumerate(nodes):
        fp.propose(proposals[0 if i < split else 1], recovery_delay_ms=50 + rng.random() * 200)
    for _ in range(400):
        clock.advance_ms(rng.choice([0, 10, 40, 150]))
        deliver_some(rng.randrange(1, 12))
        if len(decisions) == n:
            break
    while pool:
        deliver_some(len(pool))
    return decisions, trail, [fp.decided_path for fp in nodes]


@pytest.mark.parametrize("seed", [0, 3, 7, 11, 19, 23, 31, 37])
@pytest.mark.parametrize("drop_p", [0.15, 0.0])
def test_paxos_interleavings_decide_as_jax(seed, drop_p):
    ours = _adversarial_schedule(PORT, seed, drop_p=drop_p)
    assert ours == _adversarial_schedule(JAX, seed, drop_p=drop_p)
    assert len({tuple(v) for v in ours[0].values()}) <= 1  # agreement
    if drop_p == 0.0:
        assert len(ours[0]) == 5  # lossless: every node decides


def test_settings_copy_matches_jax_defaults():
    ours, ref = t_settings.Settings(), j_settings.Settings()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_adapters_default_to_cuda_and_raise_without_a_card():
    import torch

    for build in (lambda: t_dcut.DeviceCutDetector(K, H, L),
                  lambda: t_tally.DeviceVoteTally(10)):
        if torch.cuda.is_available():
            assert build().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no card"):
                build()
    # The factory contracts hold through the trailing keyword.
    assert t_dcut.DeviceCutDetector(K, H, L, device="cpu").max_slots == 4096
    assert t_tally.DeviceVoteTally(10, device="cpu").max_slots == 4096
