"""The port's hierarchical service, UDP and gossip transports and windowed
detector against the JAX package's, on the CPU.

- The 2-cohort scenarios of ``tests/test_hier.py`` (a cohort-local crash,
  a crash in each cohort, and the single-cohort bypass) through both
  packages' ``SimHarness`` under a ``ManualClock``: equal configuration
  chains, cuts, cohort counters and per-node ``TransportStats`` counts.
- A service-level crash over 4 cohorts (``HierMembershipService`` on one
  ``InProcessNetwork``): JAX, the port with the host detector and the port
  with ``DeviceCutDetector`` on the CPU end in one configuration with the
  same message counts.
- ``WindowedFailureDetector`` fires on JAX's probe index for seeded probe
  scripts, and on the index of the port's engine ``_fd_tick`` with
  ``fd_window``.
- ``GossipBroadcaster``'s relay and dedup decisions equal JAX's under the
  same rng; a mesh and a cluster over gossip end as JAX's do.
- UDP: a 6-node hybrid cluster with a failure converges; mixed JAX/port
  UDP clusters converge; a datagram is JAX's bytes; ``LossyDatagramClient``
  drops the frames JAX's drops for the same rng.
"""

import asyncio
import functools
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import rapid_tpu.types as jt
import rapid_tpu_torch.types as tt
from helpers import free_endpoints, wait_until
from rapid_tpu.hier import service as j_hier
from rapid_tpu.messaging import codec as j_codec
from rapid_tpu.messaging import gossip as j_gossip
from rapid_tpu.messaging import inprocess as j_inproc
from rapid_tpu.messaging import udp as j_udp
from rapid_tpu.monitoring import static_fd as j_static
from rapid_tpu.monitoring import windowed as j_windowed
from rapid_tpu.protocol import cluster as j_cluster
from rapid_tpu.protocol import cut_detector as j_cut
from rapid_tpu.protocol import view as j_view
from rapid_tpu.settings import Settings as JaxSettings
from rapid_tpu.sim import scenario as j_scenario
from rapid_tpu.utils.clock import ManualClock as JaxClock
from rapid_tpu_torch import _u32
from rapid_tpu_torch.hier import service as t_hier
from rapid_tpu_torch.messaging import codec as t_codec
from rapid_tpu_torch.messaging import gossip as t_gossip
from rapid_tpu_torch.messaging import inprocess as t_inproc
from rapid_tpu_torch.messaging import udp as t_udp
from rapid_tpu_torch.models.state import EngineConfig, FaultInputs, initial_state
from rapid_tpu_torch.models.virtual_cluster import _fd_tick, _one
from rapid_tpu_torch.monitoring import static_fd as t_static
from rapid_tpu_torch.monitoring import windowed as t_windowed
from rapid_tpu_torch.protocol import DeviceCutDetector
from rapid_tpu_torch.protocol import cluster as t_cluster
from rapid_tpu_torch.protocol import cut_detector as t_cut
from rapid_tpu_torch.protocol import view as t_view
from rapid_tpu_torch.settings import Settings as PortSettings
from rapid_tpu_torch.sim import scenario as t_scenario
from rapid_tpu_torch.utils.clock import ManualClock as PortClock
from test_torch_host_cluster import one_torch_thread

JAX = SimpleNamespace(
    name="jax", t=jt, hier=j_hier, codec=j_codec, gossip=j_gossip, inproc=j_inproc, udp=j_udp,
    static=j_static, windowed=j_windowed, cluster=j_cluster, cut=j_cut, view=j_view,
    Settings=JaxSettings, scenario=j_scenario, clock=JaxClock,
    detector=j_cut.MultiNodeCutDetector)
PORT = SimpleNamespace(
    name="port", t=tt, hier=t_hier, codec=t_codec, gossip=t_gossip, inproc=t_inproc, udp=t_udp,
    static=t_static, windowed=t_windowed, cluster=t_cluster, cut=t_cut, view=t_view,
    Settings=PortSettings, scenario=t_scenario, clock=PortClock,
    detector=t_cut.MultiNodeCutDetector)
PORT_DEVICE = SimpleNamespace(**{**vars(PORT), "name": "port-device",
                                 "detector": functools.partial(DeviceCutDetector, device="cpu")})


def _run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# -- the 2-cohort scenarios -----------------------------------------------------


async def _two_cohort(pkg, case):
    """One scenario of ``tests/test_hier.py`` through ``pkg``'s harness: 8
    members in two cohorts of 4 (``case`` "local": one plain member crashes;
    "cross": one member of each cohort), or 5 members in one cohort
    ("bypass"), under the hierarchical sim profile. Returns what the run
    saw, as strings."""
    sc = pkg.scenario
    endpoints = [pkg.t.Endpoint(f"10.77.5.{i}", 7900 + i) for i in range(12)]
    harness = sc.SimHarness(endpoints, settings=sc.hier_sim_settings(), id_seed=11)
    n0 = 5 if case == "bypass" else 8
    await harness.bootstrap(n0)
    cmap = harness.clusters[0].service._cohort_map
    assert cmap.n_cohorts == (1 if case == "bypass" else 2)
    committee = set(cmap.committee())
    plain = [i for i in range(1, n0) if endpoints[i] not in committee]
    if case == "cross":
        victims = [next(i for i in range(1, n0) if cmap.cohort_of(endpoints[i]) == c)
                   for c in range(cmap.n_cohorts)]
    else:
        victims = plain[:1]
    for cluster in harness.clusters.values():
        cluster.service.client.stats.reset_window()
    harness.crash(victims)
    await harness.converge_members(n0 - len(victims), budget_ms=60_000)
    out = {
        "victims": victims,
        "configs": {slot: [(cid, [str(m) for m in members]) for cid, members in history]
                    for slot, history in harness.configs.items()},
        "cuts": [sorted((str(ep), status.name) for ep, status in cut) for cut in harness.cuts],
        "stats": {slot: (c.service.client.stats.msgs_tx, c.service.client.stats.msgs_rx)
                  for slot, c in harness.clusters.items()},
        "counters": {slot: {k: v for k, v in c.service.metrics.counters.items()
                            if k.startswith("cohort_")}
                     for slot, c in harness.clusters.items()},
        "sim_ms": harness.clock.now_ms(),
    }
    await harness.shutdown()
    return out


@pytest.mark.parametrize("case", ["local", "cross", "bypass"])
def test_two_cohort_scenario_is_jax(case):
    jax_run, port_run = (_run(_two_cohort(pkg, case)) for pkg in (JAX, PORT))
    assert port_run == jax_run
    assert port_run["cuts"] and all(len(h) >= 2 for h in port_run["configs"].values())
    decided = sum(c.get("cohort_global_decisions", 0) for c in port_run["counters"].values())
    # The global tier decides every cut of two cohorts; one cohort bypasses it.
    assert (decided == 0) == (case == "bypass")


# -- a service-level crash over four cohorts ------------------------------------


async def _service_crash(pkg, n=16, cohort=4):
    """``n`` ``HierMembershipService``s on one in-process network under one
    ``ManualClock`` (cohorts of ``cohort``), one member crashed."""
    settings = pkg.Settings()
    settings.hier_target_cohort_size = cohort
    endpoints = [pkg.t.Endpoint(f"10.22.0.{i}", 6000 + i) for i in range(n)]
    node_ids = [pkg.t.NodeId(0, i) for i in range(n)]
    network, clock = pkg.inproc.InProcessNetwork(), pkg.clock()
    fd = pkg.static.StaticFailureDetectorFactory()
    services, servers = [], []
    for i in range(n):
        view = pkg.view.MembershipView(settings.k, node_ids=node_ids, endpoints=endpoints)
        service = pkg.hier.HierMembershipService(
            my_addr=endpoints[i], cut_detector=pkg.detector(settings.k, settings.h, settings.l),
            view=view, settings=settings,
            client=pkg.inproc.InProcessClient(network, endpoints[i], settings), fd_factory=fd,
            clock=clock, rng=random.Random(i), node_id=node_ids[i])
        server = pkg.inproc.InProcessServer(network, endpoints[i])
        server.set_membership_service(service)
        await server.start()
        await service.start()
        services.append(service)
        servers.append(server)
    victim = endpoints[n // 2]
    fd.add_failed_nodes([victim])
    network.blackholed.add(victim)
    live = [s for s in services if s.my_addr != victim]
    sim_ms = 0
    while not all(s.membership_size == n - 1 for s in live):
        clock.advance_ms(50)
        sim_ms += 50
        for _ in range(40):
            await asyncio.sleep(0)
        assert sim_ms <= 60_000
    out = {
        "final": sorted({(s.view.configuration_id, tuple(str(e) for e in s.membership))
                         for s in live}),
        "cohorts": live[0]._cohort_map.n_cohorts, "sim_ms": sim_ms,
        "msgs": [(s.client.stats.msgs_tx, s.client.stats.msgs_rx) for s in services],
        "detector": {type(s.cut_detector).__name__ for s in live},
    }
    for server in servers:
        await server.shutdown()
    for service in services:
        await service.shutdown()
    return out


def test_four_cohort_service_crash_is_jax_with_either_detector():
    with one_torch_thread():
        runs = {pkg.name: _run(_service_crash(pkg)) for pkg in (JAX, PORT, PORT_DEVICE)}
    assert runs["port-device"]["detector"] == {"DeviceCutDetector"}
    for run in runs.values():
        run.pop("detector")
    assert len(runs["jax"]["final"]) == 1 and runs["jax"]["cohorts"] == 4
    assert runs["port"] == runs["jax"] == runs["port-device"]


# -- the windowed detector ----------------------------------------------------


class _ScriptedClient:
    """Probe responses from a script: True = OK, False = no response."""

    def __init__(self, t, script):
        self.t, self.script = t, list(script)

    async def send_best_effort(self, remote, request):
        ok = self.script.pop(0) if self.script else True
        return self.t.ProbeResponse(status=self.t.NodeStatus.OK) if ok else None


def _host_fire(pkg, failed, window, threshold):
    """The probe index at which ``pkg``'s windowed detector fires on the
    script (True = the probe failed), or None."""
    fired = []
    fd = pkg.windowed.WindowedFailureDetector(
        my_addr=pkg.t.Endpoint("127.0.0.1", 1), subject=pkg.t.Endpoint("127.0.0.1", 2),
        client=_ScriptedClient(pkg.t, [not f for f in failed]),
        notifier=lambda: fired.append(True), window=window, fail_fraction=threshold / window)

    async def drive():
        for i in range(len(failed)):
            await fd.tick()
            if fired:
                return i
        return None

    return asyncio.run(drive()), len(fired)


def _engine_fire(failed, window, threshold):
    """The probe index at which the port's engine ``_fd_tick`` (windowed
    policy) fires on one edge for the same script."""
    n, k = 4, 3
    cfg = EngineConfig(n=n, k=k, h=3, l=1, c=1, fd_threshold=threshold, fd_window=window)
    rng = np.random.default_rng(5)
    key = _u32.from_numpy(rng.integers(0, 2**32, size=(k, n), dtype=np.uint32), "cpu")
    ids = _u32.from_numpy(rng.integers(0, 2**32, size=(n,), dtype=np.uint32), "cpu")
    state = _one(initial_state(cfg, key, key, ids, ids, torch.ones(n, dtype=torch.bool)))
    observer_active = torch.ones((1, n, k), dtype=torch.bool)
    for i, f in enumerate(failed):
        faults = FaultInputs.none(cfg, "cpu")
        probe_fail = faults.probe_fail.clone()
        probe_fail[1, 0] = bool(f)
        faults = _one(faults._replace(probe_fail=probe_fail))
        fd_count, fd_hist, fd_fired, fire = _fd_tick(cfg, state, faults, observer_active)
        state = state._replace(fd_count=fd_count, fd_hist=fd_hist, fd_fired=fd_fired)
        if bool(fire[0, 1, 0]):
            return i
    return None


@pytest.mark.parametrize("window,threshold", [(10, 4), (6, 3), (4, 2)])
def test_windowed_detector_fires_with_jax_and_the_engine(window, threshold):
    rng = np.random.default_rng(window * 100 + threshold)
    fires = 0
    for trial in range(25):
        failed = (rng.random(40) < rng.choice([0.2, 0.35, 0.5])).tolist()
        port, port_count = _host_fire(PORT, failed, window, threshold)
        jax, jax_count = _host_fire(JAX, failed, window, threshold)
        assert (port, port_count) == (jax, jax_count), f"trial {trial}"
        assert port == _engine_fire(failed, window, threshold), f"trial {trial}"
        fires += port is not None
    assert 0 < fires < 25


def test_windowed_factory_builds_jax_detectors():
    made = []
    for pkg in (JAX, PORT):
        factory = pkg.windowed.WindowedFailureDetectorFactory(
            pkg.t.Endpoint("127.0.0.1", 1), client=None, window=7, fail_fraction=0.3)
        fd = factory.create_instance(pkg.t.Endpoint("127.0.0.1", 2), lambda: None)
        made.append({k: v for k, v in vars(fd).items()
                     if isinstance(v, (int, float, bool)) and not isinstance(v, type)})
    assert made[0] == made[1]
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError):
            pkg.windowed.WindowedFailureDetector(
                my_addr=pkg.t.Endpoint("127.0.0.1", 1), subject=pkg.t.Endpoint("127.0.0.1", 2),
                client=None, notifier=lambda: None, window=0)


# -- gossip ---------------------------------------------------------------------


class _RecordingClient:
    def __init__(self):
        self.sent = []

    def send_nowait(self, remote, request):
        self.sent.append((str(remote), repr(request)))


def _gossip_decisions(pkg, seed, fanout, ttl, scope):
    """``pkg``'s broadcaster driven by a seeded script of broadcasts and
    envelopes (redeliveries included): what it sent and what it
    delivered."""
    t = pkg.t
    members = [t.Endpoint("10.5.0.%d" % i, 7000 + i) for i in range(20)]
    client = _RecordingClient()
    g = pkg.gossip.GossipBroadcaster(client, members[0], fanout=fanout, ttl=ttl,
                                     rng=random.Random(seed))
    if scope:
        g.scope_fn = lambda all_members: all_members[:9]
    g.set_membership(members)
    script = random.Random(seed + 1)
    delivered = []
    envelopes = []
    for step in range(60):
        roll = script.random()
        if roll < 0.2:
            g.broadcast(t.ProbeMessage(members[script.randrange(20)]))
        elif roll < 0.5 and envelopes:
            delivered.append(repr(g.accept(script.choice(envelopes))))  # a redelivery
        else:
            env = t.GossipMessage(members[script.randrange(1, 20)], script.getrandbits(64),
                                  script.randrange(0, 4), t.ProbeMessage(members[step % 20]))
            envelopes.append(env)
            delivered.append(repr(g.accept(env)))
    return client.sent, delivered, g.relays_sent, [str(m) for m in g._members]


@pytest.mark.parametrize("seed,fanout,ttl,scope", [(1, None, None, False), (2, 3, 2, False),
                                                    (3, 4, None, True), (4, 2, 0, False)])
def test_gossip_relay_and_dedup_decisions_are_jax(seed, fanout, ttl, scope):
    port = _gossip_decisions(PORT, seed, fanout, ttl, scope)
    jax = _gossip_decisions(JAX, seed, fanout, ttl, scope)
    assert port == jax
    assert port[2] > 0 and "None" in port[1]
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError):
            pkg.gossip.GossipBroadcaster(_RecordingClient(), pkg.t.Endpoint("h", 1), ttl=256)


async def _gossip_mesh(pkg, n=24):
    """``tests/test_gossip.py``'s mesh: one broadcast over n in-process
    nodes, each a broadcaster behind its router."""
    class Recording:
        def __init__(self):
            self.received = []

        async def handle_message(self, request):
            self.received.append(request)
            return pkg.t.Response()

    network = pkg.inproc.InProcessNetwork()
    members = [pkg.t.Endpoint("127.0.0.1", 7200 + i) for i in range(n)]
    nodes = []
    for i in range(n):
        client = pkg.inproc.InProcessClient(network, members[i], pkg.Settings())
        server = pkg.inproc.InProcessServer(network, members[i])
        service = Recording()
        broadcaster = pkg.gossip.GossipBroadcaster(client, members[i], rng=random.Random(1000 + i))
        broadcaster.set_membership(members)
        server.set_membership_service(broadcaster.router(service))
        await server.start()
        nodes.append((client, server, service, broadcaster))
    payload = pkg.t.ProbeMessage(members[0])
    nodes[0][3].broadcast(payload)
    assert await wait_until(lambda: all(payload in s.received for _, _, s, _ in nodes), 10)
    await asyncio.sleep(0.1)
    out = [(len(s.received), b.relays_sent) for _, _, s, b in nodes]
    for client, server, _, _ in nodes:
        await server.shutdown()
        await client.shutdown()
    return out


def test_gossip_mesh_spreads_as_jax():
    port, jax = _run(_gossip_mesh(PORT)), _run(_gossip_mesh(JAX))
    assert all(received == 1 for received, _ in port)
    assert port == jax


def _gossip_settings(pkg):
    s = pkg.Settings()
    s.batching_window_ms = 20
    s.failure_detector_interval_ms = 50
    s.rpc_timeout_ms = 500
    s.rpc_join_timeout_ms = 2000
    s.rpc_probe_timeout_ms = 200
    s.consensus_fallback_base_delay_ms = 2000
    return s


async def _gossip_cluster(pkg, n=8):
    """``tests/test_gossip.py``'s cluster over gossip with injected node
    ids: n nodes, one crashed. Returns the survivors' final view."""
    network, fd = pkg.inproc.InProcessNetwork(), pkg.static.StaticFailureDetectorFactory()
    factory = pkg.gossip.GossipBroadcaster.factory()
    eps = [pkg.t.Endpoint("127.0.0.1", 7300 + i) for i in range(n)]
    kw = dict(settings=_gossip_settings(pkg), network=network, fd_factory=fd,
              broadcaster_factory=factory)
    clusters = [await pkg.cluster.Cluster.start(eps[0], rng=random.Random(0),
                                                node_id=pkg.t.NodeId(5, 0), **kw)]
    try:
        for i in range(1, n):
            clusters.append(await pkg.cluster.Cluster.join(
                eps[0], eps[i], rng=random.Random(i), node_id=pkg.t.NodeId(5, i), **kw))
        assert await wait_until(lambda: all(c.membership_size == n for c in clusters), 30)
        assert isinstance(clusters[0].service.broadcaster, pkg.gossip.GossipBroadcaster)
        assert clusters[0].service.broadcaster.relays_sent > 0
        victim = clusters[5]
        network.blackholed.add(victim.listen_address)
        fd.add_failed_nodes([victim.listen_address])
        survivors = [c for c in clusters if c is not victim]
        assert await wait_until(lambda: all(c.membership_size == n - 1 for c in survivors), 30)
        return {(c.service.view.configuration_id, tuple(str(e) for e in c.membership))
                for c in survivors}
    finally:
        await asyncio.gather(*(c.shutdown() for c in clusters), return_exceptions=True)


def test_cluster_over_gossip_reaches_jax_configuration():
    port, jax = _run(_gossip_cluster(PORT)), _run(_gossip_cluster(JAX))
    assert len(port) == 1 and port == jax


# -- UDP ------------------------------------------------------------------------


def test_six_nodes_over_hybrid_udp_with_failure():
    async def main():
        settings = _gossip_settings(PORT)
        fd = t_static.StaticFailureDetectorFactory()
        sent_udp = []

        class CountingClient(t_udp.UdpHybridClient):
            async def send_best_effort(self, remote, request):
                if isinstance(request, t_udp.ONEWAY_TYPES):
                    sent_udp.append(type(request).__name__)
                return await super().send_best_effort(remote, request)

        eps = [tt.Endpoint(e.hostname, e.port) for e in free_endpoints(6)]
        kw = [dict(settings=settings, client=CountingClient(eps[i], settings),
                   server=t_udp.UdpHybridServer(eps[i]), fd_factory=fd, rng=random.Random(i))
              for i in range(6)]
        clusters = [await t_cluster.Cluster.start(eps[0], **kw[0])]
        try:
            for i in range(1, 6):
                clusters.append(await t_cluster.Cluster.join(eps[0], eps[i], **kw[i]))
            assert await wait_until(lambda: all(c.membership_size == 6 for c in clusters)
                                    and len({tuple(c.membership) for c in clusters}) == 1)
            assert {"BatchedAlertMessage", "FastRoundPhase2bMessage"} <= set(sent_udp)
            victim = clusters[4]
            await victim.shutdown()
            fd.add_failed_nodes([victim.listen_address])
            survivors = [c for c in clusters if c is not victim]
            assert await wait_until(lambda: all(c.membership_size == 5 for c in survivors))
            assert all(victim.listen_address not in c.membership for c in survivors)
        finally:
            await asyncio.gather(*(c.shutdown() for c in clusters), return_exceptions=True)

    _run(main())


@pytest.mark.parametrize("seed_pkg", ["jax", "port"])
def test_mixed_cluster_over_udp(seed_pkg):
    """Port nodes join a JAX seed over the hybrid transport (and the
    reverse), alerts and votes as datagrams both ways; a crash resolves."""
    async def main():
        addrs = [(e.hostname, e.port) for e in free_endpoints(4)]
        pkgs = [JAX, PORT, JAX, PORT] if seed_pkg == "jax" else [PORT, JAX, PORT, JAX]
        fds = {pkg.name: pkg.static.StaticFailureDetectorFactory() for pkg in (JAX, PORT)}
        clusters = []
        try:
            for i, (pkg, (host, port)) in enumerate(zip(pkgs, addrs)):
                ep = pkg.t.Endpoint(host, port)
                settings = _gossip_settings(pkg)
                kw = dict(settings=settings, client=pkg.udp.UdpHybridClient(ep, settings),
                          server=pkg.udp.UdpHybridServer(ep), rng=random.Random(i),
                          fd_factory=fds[pkg.name])
                if i == 0:
                    clusters.append(await pkg.cluster.Cluster.start(ep, **kw))
                else:
                    seed = pkg.t.Endpoint(*addrs[0])
                    clusters.append(await pkg.cluster.Cluster.join(seed, ep, **kw))

            def same_view(members, size):
                views = {(c.service.view.configuration_id, tuple(str(e) for e in c.membership))
                         for c in members}
                return len(views) == 1 and all(c.membership_size == size for c in members)

            assert await wait_until(lambda: same_view(clusters, 4))
            victim = clusters[3]
            await victim.shutdown()
            for pkg in (JAX, PORT):
                fds[pkg.name].add_failed_nodes([pkg.t.Endpoint(*addrs[3])])
            assert await wait_until(lambda: same_view(clusters[:3], 3))
        finally:
            await asyncio.gather(*(c.shutdown() for c in clusters), return_exceptions=True)

    _run(main())


def _oneway_requests(t, a):
    return [
        t.FastRoundPhase2bMessage(sender=a, configuration_id=-7, endpoints=(a,)),
        t.BatchedAlertMessage(a, (t.AlertMessage(a, a, t.EdgeStatus.DOWN, 3, (0, 4)),)),
        t.LeaveMessage(sender=a),
        t.GossipMessage(a, 0xFEDCBA9876543210, 3, t.ProbeMessage(a)),
    ] * 10


def test_datagrams_are_jax_bytes_on_the_wire():
    async def main():
        (target,) = free_endpoints(1)
        loop = asyncio.get_running_loop()
        received = []

        class Sink(asyncio.DatagramProtocol):
            def datagram_received(self, data, addr):
                received.append(data)

        sink, _ = await loop.create_datagram_endpoint(
            Sink, local_addr=(target.hostname, target.port))
        try:
            frames = {}
            for pkg in (JAX, PORT):
                a = pkg.t.Endpoint("127.0.0.1", 1)
                client = pkg.udp.UdpHybridClient(a, pkg.Settings())
                requests = _oneway_requests(pkg.t, a)[:4]
                received.clear()
                for request in requests:
                    await client.send_best_effort(pkg.t.Endpoint(target.hostname, target.port),
                                                  request)
                assert await wait_until(lambda: len(received) == len(requests))
                assert not client._connections  # every one went as a datagram
                frames[pkg.name] = list(received)
                await client.shutdown()
            assert frames["port"] == frames["jax"]
            assert frames["port"] == [j_codec.encode_request(r)
                                      for r in _oneway_requests(jt, jt.Endpoint("127.0.0.1", 1))[:4]]
        finally:
            sink.close()

    _run(main())


@pytest.mark.parametrize("loss_rate,seed", [(0.2, 1), (0.5, 9), (0.0, 3), (1.0, 4)])
def test_lossy_client_drops_jax_frames(monkeypatch, loss_rate, seed):
    async def drops(pkg):
        delivered = []

        async def put(self, ip_version, remote, payload):
            delivered.append(payload)
            return True

        monkeypatch.setattr(pkg.udp.UdpHybridClient, "_send_datagram", put)
        a = pkg.t.Endpoint("127.0.0.1", 1)
        client = pkg.udp.LossyDatagramClient(a, pkg.Settings(), loss_rate=loss_rate,
                                             rng=random.Random(seed))
        for request in _oneway_requests(pkg.t, a):
            assert isinstance(await client.send_best_effort(pkg.t.Endpoint("127.0.0.2", 9),
                                                            request), pkg.t.Response)
        return (delivered, client.datagrams_dropped, client.datagrams_delivered,
                client.stats.msgs_tx, client.stats.bytes_tx)

    port, jax = _run(drops(PORT)), _run(drops(JAX))
    assert port == jax
    assert port[1] + port[2] == 40
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError):
            pkg.udp.LossyDatagramClient(pkg.t.Endpoint("127.0.0.1", 1), loss_rate=1.5)
