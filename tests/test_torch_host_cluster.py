"""The port's host membership path end to end, on the CPU.

- A deterministic service-level differential: N=50 ``MembershipService``s
  on one ``InProcessNetwork`` under a ``ManualClock``, with seeded ``rng``
  and injected ``NodeId``s, crashing 1 and then 5 members, once with the
  host detector and tally and once with the device adapters (on the CPU).
  The JAX package and the port give the same view changes (configuration
  ids and memberships), the same flight recordings (decision paths
  included) and the same message and wire-byte counts.
- ``Cluster`` scenarios of ``tests/test_cluster.py`` through the port.
- The README's Quick start through the port over loopback TCP, and mixed
  clusters where a port node joins a JAX seed and the reverse.
- A hierarchical configuration builds the hierarchical service through
  ``Cluster.start`` and ``Cluster.join``; the service itself refuses a flat
  configuration with JAX's named error.
"""

import asyncio
import contextlib
import functools
import random

import pytest
import torch

import rapid_tpu.types as jt
import rapid_tpu_torch.types as tt
from helpers import free_endpoints, wait_until
from rapid_tpu.messaging import inprocess as j_inproc
from rapid_tpu.messaging import tcp as j_tcp
from rapid_tpu.monitoring import static_fd as j_static
from rapid_tpu.protocol import cluster as j_cluster
from rapid_tpu.protocol import cut_detector as j_cut
from rapid_tpu.protocol import device_cut_detector as j_dcut
from rapid_tpu.protocol import device_vote_tally as j_tally
from rapid_tpu.protocol import events as j_events
from rapid_tpu.protocol import service as j_service
from rapid_tpu.protocol import view as j_view
from rapid_tpu import settings as j_settings
from rapid_tpu.utils import clock as j_clock
from rapid_tpu_torch.messaging import inprocess as t_inproc
from rapid_tpu_torch.messaging import tcp as t_tcp
from rapid_tpu_torch.monitoring import static_fd as t_static
from rapid_tpu_torch.protocol import Cluster, DeviceCutDetector, DeviceVoteTally, MembershipService
from rapid_tpu_torch.protocol import cluster as t_cluster
from rapid_tpu_torch.protocol import cut_detector as t_cut
from rapid_tpu_torch.protocol import events as t_events
from rapid_tpu_torch.protocol import service as t_service
from rapid_tpu_torch.protocol import view as t_view
from rapid_tpu_torch import settings as t_settings
from rapid_tpu_torch.utils import clock as t_clock

JAX = dict(t=jt, inproc=j_inproc, tcp=j_tcp, static=j_static, cluster=j_cluster, cut=j_cut,
           events=j_events, service=j_service, view=j_view, settings=j_settings, clock=j_clock,
           dcut=j_dcut.DeviceCutDetector, tally=j_tally.DeviceVoteTally)
PORT = dict(t=tt, inproc=t_inproc, tcp=t_tcp, static=t_static, cluster=t_cluster, cut=t_cut,
            events=t_events, service=t_service, view=t_view, settings=t_settings, clock=t_clock,
            dcut=functools.partial(DeviceCutDetector, device="cpu"),
            tally=functools.partial(DeviceVoteTally, device="cpu"))


def _run(coro, timeout=90):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@contextlib.contextmanager
def one_torch_thread():
    """The adapters' CPU ops are tiny. On a loaded host torch's intra-op
    pool, whose threads spin while they wait, makes each op wait for cores:
    one N=50 crash with the adapters took 68 s on 8 threads and 1.4 s on
    one, beside 8 busy processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# -- the service differential -------------------------------------------------


async def _service_crash(pkg, n, crashes, device, seed=0):
    """``examples/host_scale_ceiling.py``'s crash over ``pkg``: n services
    on one network and one ManualClock, all from one pre-built view, then
    ``crashes`` members crash together. Returns what every survivor saw."""
    p = pkg
    settings = p["settings"].Settings()
    # The transports' RPC deadlines are wall-clock (asyncio.wait_for): set
    # past any host's pace, so that the run is a function of its seeds alone.
    settings.rpc_timeout_ms = settings.rpc_probe_timeout_ms = 3_600_000
    settings.rpc_join_timeout_ms = 3_600_000
    endpoints = [p["t"].Endpoint(f"10.20.{i // 250}.{i % 250}", 6000 + i) for i in range(n)]
    node_ids = [p["t"].NodeId(1000 + i, (seed << 32) + i) for i in range(n)]
    network = p["inproc"].InProcessNetwork(count_wire_bytes=True)
    clock = p["clock"].ManualClock()
    fd = p["static"].StaticFailureDetectorFactory()
    services, servers, seen = [], [], {}
    for i in range(n):
        view = p["view"].MembershipView(settings.k, node_ids=node_ids, endpoints=endpoints)
        client = p["inproc"].InProcessClient(network, endpoints[i], settings)
        detector = (p["dcut"] if device else p["cut"].MultiNodeCutDetector)(
            settings.k, settings.h, settings.l)
        seen[i] = []
        service = p["service"].MembershipService(
            my_addr=endpoints[i], cut_detector=detector, view=view, settings=settings,
            client=client, fd_factory=fd, clock=clock, rng=random.Random(seed + i),
            node_id=node_ids[i], vote_tally_factory=p["tally"] if device else None,
            subscriptions={p["events"].ClusterEvents.VIEW_CHANGE: [
                functools.partial(lambda i, c: seen[i].append(
                    (c.configuration_id, [str(e) for e in c.membership])), i)]},
        )
        server = p["inproc"].InProcessServer(network, endpoints[i])
        server.set_membership_service(service)
        await server.start()
        await service.start()
        services.append(service)
        servers.append(server)

    victims = [endpoints[(n // 2 + 7 * j) % n] for j in range(crashes)]
    fd.add_failed_nodes(victims)
    network.blackholed.update(victims)
    live = [i for i, s in enumerate(services) if s.my_addr not in victims]
    sim_ms = 0
    while not all(services[i].membership_size == n - crashes for i in live):
        clock.advance_ms(50)
        sim_ms += 50
        for _ in range(40):
            await asyncio.sleep(0)
        assert sim_ms <= 60_000, "no convergence in 60 s of simulated time"
    # A quiet second after convergence: late traffic lands in the counts too.
    for _ in range(20):
        clock.advance_ms(50)
        for _ in range(40):
            await asyncio.sleep(0)
    out = {
        "sim_ms": sim_ms,
        "views": [seen[i] for i in live],
        "recordings": [[e.to_dict() for e in services[i].recorder.events()] for i in live],
        "paths": sorted({e.fields.get("path") for i in live for e in services[i].recorder.events()
                         if e.name.name == "CONSENSUS_DECIDED"}),
        "counters": [dict(services[i].metrics.counters) for i in live],
        "wire": [(s.client.stats.msgs_tx, s.client.stats.bytes_tx, srv.stats.msgs_rx,
                  srv.stats.bytes_rx) for s, srv in zip(services, servers)],
        "final": [(services[i].view.configuration_id, [str(e) for e in services[i].membership])
                  for i in live],
        "adapters": {(type(s.cut_detector).__name__, type(s._fast_paxos._vote_tally).__name__)
                     for s in services},
        "passes": sum(getattr(s.cut_detector, "batches", 0) for s in services),
    }
    for server in servers:
        await server.shutdown()
    for service in services:
        await service.shutdown()
    return out


@pytest.fixture(scope="module")
def service_runs():
    """Every (package, adapters, crash size) run once, shared by the tests."""
    runs = {}
    with one_torch_thread():
        for name, pkg in (("jax", JAX), ("port", PORT)):
            for device in (False, True):
                for crashes in (1, 5):
                    runs[name, device, crashes] = _run(
                        _service_crash(pkg, 50, crashes, device), timeout=300)
    return runs


@pytest.mark.parametrize("crashes", [1, 5])
@pytest.mark.parametrize("device", [False, True], ids=["host_adapters", "device_adapters"])
def test_service_crash_matches_jax(service_runs, device, crashes):
    ours, ref = service_runs["port", device, crashes], service_runs["jax", device, crashes]
    assert ours["views"] == ref["views"]
    assert ours["paths"] == ref["paths"] == ["fast"]
    assert ours["counters"] == ref["counters"]
    assert ours["wire"] == ref["wire"]
    assert ours["recordings"] == ref["recordings"]
    assert ours["sim_ms"] == ref["sim_ms"]
    # One decided view change: every survivor holds the same configuration.
    assert len({(cid, tuple(m)) for cid, m in ours["final"]}) == 1
    assert len(ours["final"][0][1]) == 50 - crashes
    assert all(len(v) == 2 for v in ours["views"])  # startup, then the crash
    assert ours["adapters"] == ref["adapters"]
    if device:
        assert ours["adapters"] == {("DeviceCutDetector", "DeviceVoteTally")}
        assert ours["passes"] >= 50 - crashes  # every survivor tallied its alerts in a pass


@pytest.mark.parametrize("crashes", [1, 5])
def test_device_adapters_reach_the_host_adapters_configuration(service_runs, crashes):
    host, device = service_runs["port", False, crashes], service_runs["port", True, crashes]
    assert device["final"] == host["final"]


# -- Cluster scenarios --------------------------------------------------------


def _fast_settings():
    s = t_settings.Settings()
    s.batching_window_ms = 20
    s.failure_detector_interval_ms = 50
    s.rpc_timeout_ms = 500
    s.rpc_join_timeout_ms = 2000
    s.rpc_probe_timeout_ms = 200
    s.consensus_fallback_base_delay_ms = 2000
    return s


def _ep(i):
    return tt.Endpoint("127.0.0.1", 1234 + i)


def _converged(clusters, size):
    return all(c.membership_size == size for c in clusters) and (
        len({tuple(c.membership) for c in clusters}) == 1)


async def _shutdown(clusters):
    await asyncio.gather(*(c.shutdown() for c in clusters), return_exceptions=True)


async def _bring_up(n, network, fd, settings, parallel, adapters=None, metadata=None):
    """n nodes through ``Cluster.start`` / ``Cluster.join`` (joins in
    parallel or one by one), converged."""
    kw = dict(settings=settings, network=network, fd_factory=fd, **(adapters or {}))
    seed = await Cluster.start(_ep(0), rng=random.Random(0), **kw)
    if parallel:
        joiners = list(await asyncio.gather(*(
            Cluster.join(_ep(0), _ep(i), rng=random.Random(i), **kw) for i in range(1, n))))
    else:
        joiners = []
        for i in range(1, n):
            joiners.append(await Cluster.join(
                _ep(0), _ep(i), rng=random.Random(i), metadata=(metadata or {}).get(i, ()), **kw))
    clusters = [seed] + joiners
    try:
        assert await wait_until(lambda: _converged(clusters, n), timeout_s=40)
    except BaseException:
        await _shutdown(clusters)
        raise
    return clusters


async def _scenario(name):
    network = t_inproc.InProcessNetwork()
    fd = t_static.StaticFailureDetectorFactory()
    settings = _fast_settings()
    if name == "ten_sequential_joins":
        clusters = await _bring_up(10, network, fd, settings, parallel=False)
        await _shutdown(clusters)
    elif name == "six_nodes_one_failure_device_adapters":
        # tests/test_device_vote_tally.py's bridge cluster, adapters on the CPU.
        adapters = dict(cut_detector_factory=functools.partial(DeviceCutDetector, device="cpu"),
                        vote_tally_factory=functools.partial(DeviceVoteTally, device="cpu"))
        clusters = await _bring_up(6, network, fd, settings, parallel=False, adapters=adapters)
        try:
            victim = clusters[3]
            network.blackholed.add(victim.listen_address)
            fd.add_failed_nodes([victim.listen_address])
            survivors = [c for c in clusters if c is not victim]
            assert await wait_until(lambda: _converged(survivors, 5), timeout_s=40)
            assert sum(c.service.cut_detector.batches for c in survivors) > 0
        finally:
            await _shutdown(clusters)
    elif name == "fifty_multi_failure":
        clusters = await _bring_up(50, network, fd, settings, parallel=True)
        try:
            victims = [clusters[7], clusters[21], clusters[33], clusters[44]]
            network.blackholed.update(v.listen_address for v in victims)
            fd.add_failed_nodes([v.listen_address for v in victims])
            survivors = [c for c in clusters if c not in victims]
            assert await wait_until(lambda: _converged(survivors, 46), timeout_s=40)
        finally:
            await _shutdown(clusters)
    elif name == "sixteen_of_fifty_classic_fallback":
        settings.batching_window_ms = 300
        settings.consensus_fallback_base_delay_ms = 500
        clusters = await _bring_up(50, network, fd, settings, parallel=True)
        try:
            victims = clusters[1:49:3]
            engaged = []
            for c in clusters:
                if c not in victims:
                    c.register_subscription(t_events.ClusterEvents.VIEW_CHANGE_ONE_STEP_FAILED,
                                            engaged.append)
            network.blackholed.update(v.listen_address for v in victims)
            fd.add_failed_nodes([v.listen_address for v in victims])
            survivors = [c for c in clusters if c not in victims]
            assert await wait_until(lambda: _converged(survivors, 34), timeout_s=90)
            gone = {v.listen_address for v in victims}
            assert all(gone.isdisjoint(c.membership) for c in survivors)
            assert engaged, "no survivor reported one-step failure"
        finally:
            await _shutdown(clusters)
    elif name == "graceful_leave":
        clusters = await _bring_up(8, network, fd, settings, parallel=False)
        try:
            leaver = clusters[5]
            await leaver.leave_gracefully()
            survivors = [c for c in clusters if c is not leaver]
            assert await wait_until(lambda: _converged(survivors, 7))
            assert all(leaver.listen_address not in c.membership for c in survivors)
        finally:
            await _shutdown(clusters)
    elif name == "kicked_node":
        clusters = await _bring_up(10, network, fd, settings, parallel=False)
        try:
            victim, kicked = clusters[6], []
            victim.register_subscription(t_events.ClusterEvents.KICKED, kicked.append)
            fd.add_failed_nodes([victim.listen_address])
            survivors = [c for c in clusters if c is not victim]
            assert await wait_until(lambda: _converged(survivors, 9))
            assert await wait_until(lambda: len(kicked) == 1)
            assert victim.listen_address not in kicked[0].membership
        finally:
            await _shutdown(clusters)
    elif name == "metadata_propagates":
        clusters = await _bring_up(2, network, fd, settings, parallel=False,
                                   metadata={1: (("role", b"worker"),)})
        try:
            seed = clusters[0]
            assert await wait_until(lambda: seed.metadata.get(_ep(1)) == (("role", b"worker"),))
            late = await Cluster.join(_ep(0), _ep(2), settings=settings, network=network,
                                      fd_factory=fd)
            clusters.append(late)
            assert await wait_until(lambda: late.metadata.get(_ep(1)) == (("role", b"worker"),))
        finally:
            await _shutdown(clusters)
    else:
        raise AssertionError(name)


@pytest.mark.parametrize("name", [
    "ten_sequential_joins", "fifty_multi_failure", "six_nodes_one_failure_device_adapters",
    "sixteen_of_fifty_classic_fallback", "graceful_leave", "kicked_node", "metadata_propagates",
])
def test_cluster_scenario(name):
    with one_torch_thread():
        _run(_scenario(name), timeout=180)


# -- TCP ------------------------------------------------------------------------


def test_readme_quick_start_over_tcp():
    async def main():
        a, b = (tt.Endpoint(e.hostname, e.port) for e in free_endpoints(2))
        seed = await Cluster.start(a, client=t_tcp.TcpClient(a), server=t_tcp.TcpServer(a))
        changes = []
        seed.register_subscription(t_events.ClusterEvents.VIEW_CHANGE, changes.append)
        node = await Cluster.join(a, b, client=t_tcp.TcpClient(b), server=t_tcp.TcpServer(b))
        try:
            assert await wait_until(lambda: _converged([seed, node], 2))
            assert sorted(node.membership) == sorted([a, b])
            assert changes and set(changes[-1].membership) == {a, b}
            assert seed.service.view.configuration_id == node.service.view.configuration_id
        finally:
            await _shutdown([node, seed])

    _run(main(), timeout=60)


@pytest.mark.parametrize("seed_pkg", ["jax", "port"])
def test_mixed_cluster_over_tcp(seed_pkg):
    """A port node joins a JAX seed (and the reverse) over TCP: one wire
    format, one protocol, the same view on both sides."""
    async def main():
        addrs = [(e.hostname, e.port) for e in free_endpoints(3)]
        pkgs = [JAX, PORT, JAX] if seed_pkg == "jax" else [PORT, JAX, PORT]
        clusters = []
        try:
            for i, (pkg, (host, port)) in enumerate(zip(pkgs, addrs)):
                ep = pkg["t"].Endpoint(host, port)
                settings = pkg["settings"].Settings()
                settings.batching_window_ms = 20
                settings.failure_detector_interval_ms = 50
                kw = dict(settings=settings, client=pkg["tcp"].TcpClient(ep, settings),
                          server=pkg["tcp"].TcpServer(ep), rng=random.Random(i))
                if i == 0:
                    clusters.append(await pkg["cluster"].Cluster.start(ep, **kw))
                else:
                    seed = pkg["t"].Endpoint(*addrs[0])
                    clusters.append(await pkg["cluster"].Cluster.join(seed, ep, **kw))

            def same_view():
                views = {(c.service.view.configuration_id, tuple(str(e) for e in c.membership))
                         for c in clusters}
                return len(views) == 1 and all(c.membership_size == 3 for c in clusters)

            assert await wait_until(same_view)
        finally:
            await _shutdown(clusters)

    _run(main(), timeout=60)


# -- the hierarchical configuration -------------------------------------------


def test_hierarchical_configuration_builds_the_hier_service():
    from rapid_tpu.hier import service as j_hier
    from rapid_tpu_torch.hier import HierMembershipService

    async def main():
        settings = _fast_settings()
        settings.hier_target_cohort_size = 8
        network = t_inproc.InProcessNetwork()
        fd = t_static.StaticFailureDetectorFactory()
        seed = await Cluster.start(_ep(0), settings=settings, network=network, fd_factory=fd)
        joiner = await Cluster.join(_ep(0), _ep(1), settings=settings, network=network,
                                    fd_factory=fd)
        try:
            assert type(seed.service) is HierMembershipService
            assert type(joiner.service) is HierMembershipService
            assert await wait_until(lambda: joiner.membership_size == 2)
        finally:
            await _shutdown([seed, joiner])
        assert Cluster._service_class(settings) is HierMembershipService
        assert Cluster._service_class(_fast_settings()) is MembershipService
        # The hierarchical service refuses a flat configuration by name.
        errors = []
        for pkg, cls in ((JAX, j_hier.HierMembershipService), (PORT, HierMembershipService)):
            flat = pkg["settings"].Settings()
            endpoint = pkg["t"].Endpoint("10.1.1.1", 1)
            view = pkg["view"].MembershipView(flat.k, node_ids=[pkg["t"].NodeId(1, 1)],
                                              endpoints=[endpoint])
            with pytest.raises(ValueError) as err:
                cls(my_addr=endpoint, cut_detector=pkg["cut"].MultiNodeCutDetector(
                    flat.k, flat.h, flat.l), view=view, settings=flat, client=None,
                    fd_factory=None)
            errors.append(str(err.value))
        assert errors[0] == errors[1] and "hier_target_cohort_size > 0" in errors[1]

    _run(main(), timeout=30)
