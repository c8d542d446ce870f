"""Builders shared by the port's tests and its card smoke scripts: seeded
clusters, fleets and streams at the benchmark-era shapes (:data:`HEADLINE`,
:data:`FLEET`, :data:`STREAM`), the delivery kernel's inputs, drive
helpers, and the oracle of the single-device fleet wave's exit
(:func:`wave_exit`).

Nothing on the engine's path imports this module (as ``torch.testing``
is to ``torch``). It runs on the CPU and on a card alike; a builder that
holds what it drives raises ``RuntimeError``.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

# bench.py's 5%-churn headline: N members, n_join joins and n_crash
# crashes, K=10, 64 cohorts, spread 2.
HEADLINE = dict(n=100_000, n_join=2_500, n_crash=2_500, k=10, cohorts=64, spread=2)
# bench.py's fleet point: B tenants of N members, n_extra = N // 50 extra
# slots, 8 cohorts, K=10, fd_threshold 3, spread 2, one 96-round wave.
FLEET = dict(tenants=256, n=1_024, n_extra=20, k=10, cohorts=8, spread=2, max_steps=96)
# bench.py's stream stage as it writes it for an accelerator: N=4,096 members
# (2 x 64 spare slots for the joins), K=10, H=9, L=4, 8 cohorts, fd_threshold
# 3, spread 2, the plane and a ring of the whole stage's 512 rounds on, 64
# waves of 8 rounds 2 deep; a fleet of 4 such tenants.
STREAM = dict(n=4_096, cohorts=8, waves=64, rounds=8, depth=2, tenants=4, rate=2.0,
              fleet_rate=0.5, cpu_waves=8)


def delivery_inputs(c, k, n, seed, dev, t=None):
    """Seeded delivery inputs for one cluster, or with ``t`` for a fleet of
    ``t`` tenants with distinct epochs."""
    from rapid_tpu_torch import _u32

    rng = np.random.default_rng(seed)
    w = (c + 31) // 32
    lead = () if t is None else (t,)
    blocked = rng.integers(0, 2**32, size=lead + (w * k, n), dtype=np.uint32)
    blocked &= rng.integers(0, 2**32, size=lead + (w * k, n), dtype=np.uint32)  # ~1/4 bits set
    age = rng.integers(-3, 6, size=lead + (k, n)).astype(np.int32)
    age[rng.random(lead + (k, n)) < 0.2] = -(1 << 30)  # edges that never fired
    epoch = [seed % 7] if t is None else rng.permutation(4 * t)[:t]
    return (
        _u32.from_numpy(blocked, dev),
        torch.from_numpy(age).to(dev),
        torch.tensor(epoch, dtype=torch.int32, device=dev),
    )


def skip_edge_inputs(kind, c, k, n, spread, seed, dev, t=None):
    """:func:`delivery_inputs` moved to the edges of the kernel's skips.
    ``edges``: ages -2^30, -1, 0, spread - 1, spread, spread + 1 in turn
    along tenants, rings and slots; ``all_blocked`` / ``none_blocked``: the
    same ages with every or no cohort blocked; ``all_pending``: every age in
    ``[0, spread)`` (needs spread >= 1); ``misaligned``: the seeded inputs
    one element past a 16-byte boundary."""
    blocked, age, epoch = delivery_inputs(c, k, n, seed, dev, t=t)
    if kind == "misaligned":
        def shifted(x):
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
            buf[1:] = x.reshape(-1)
            return buf[1:].view(x.shape)
        return shifted(blocked), shifted(age), epoch
    if kind == "all_pending":
        rng = np.random.default_rng(seed)
        age = torch.from_numpy(rng.integers(0, spread, size=age.shape).astype(np.int32)).to(dev)
        return blocked, age, epoch
    edges = torch.tensor([-(1 << 30), -1, 0, spread - 1, spread, spread + 1], dtype=torch.int32)
    lead = age.shape[:-2]
    pos = torch.arange(k)[:, None] + torch.arange(n)[None, :]
    if lead:
        pos = pos + torch.arange(lead[0])[:, None, None]
    age = edges[pos % len(edges)].to(dev).contiguous()
    if kind == "all_blocked":
        blocked = torch.full_like(blocked, -1)
    elif kind == "none_blocked":
        blocked = torch.zeros_like(blocked)
    return blocked, age, epoch


def churn_cluster(n, n_join, n_crash, cohorts, seed, device, delivery_spread=HEADLINE["spread"],
                  delivery_prob_permille=1000, **planes):
    """bench.py's 5%-churn build: round-robin cohorts, FD counters staggered
    over 3 rounds, ``n_crash`` crashes and ``n_join`` joins, with the
    delivery knobs given (bench.py's clean churn by default, its loss
    variant with ``loss_as_engine_delivery``'s). ``planes``: ``telemetry`` /
    ``trace`` for ``VirtualCluster.create``."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    vc = VirtualCluster.create(
        n, n_slots=n + n_join, k=HEADLINE["k"], h=9, l=4, cohorts=cohorts, fd_threshold=3,
        seed=seed, delivery_spread=delivery_spread, concurrent_coordinators=2,
        delivery_prob_permille=delivery_prob_permille, device=device, **planes,
    )
    vc.assign_cohorts_roundrobin()
    rng = np.random.default_rng(seed + 1000)
    vc.stagger_fd_counts(rng, spread_rounds=3)
    victims = rng.choice(n, size=n_crash, replace=False)
    vc.crash(victims)
    vc.inject_join_wave(np.arange(n, n + n_join))
    return vc, victims


def resolve(vc, n):
    return vc.run_until_membership(n, max_steps=96 * 4, max_cuts=4, min_cuts=1)


def endpoint_list(count):
    """``count`` endpoints with hostnames of mixed lengths and varied ports."""
    from rapid_tpu_torch.types import Endpoint

    return [Endpoint(f"node-{i}.r{i % 97}.dc{i % 3}.example", 7000 + (i * 7919) % 50_000)
            for i in range(count)]


def endpoint_churn(endpoints, n, n_join, n_crash, device):
    """A compact endpoint cluster of ``n`` members and ``n_join`` keyed
    joiner slots (the churn's geometry), its cohorts assigned, ``n_crash``
    seeded crashes and the joiners injected. Returns (cluster, victims)."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    vc = VirtualCluster.from_endpoints(
        endpoints, n_members=n, n_slots=n + n_join, k=HEADLINE["k"], h=9, l=4,
        cohorts=HEADLINE["cohorts"], fd_threshold=3, delivery_spread=HEADLINE["spread"],
        concurrent_coordinators=2, compact=True, device=device,
    )
    vc.assign_cohorts_roundrobin()
    victims = np.random.default_rng(n).choice(n, size=n_crash, replace=False)
    vc.crash(victims)
    vc.inject_join_wave(np.arange(n, n + n_join))
    return vc, victims


def seeded_node_ids(count, seed):
    from rapid_tpu_torch.types import NodeId

    words = np.random.default_rng(seed).integers(0, 2**64, size=(count, 2), dtype=np.uint64)
    return [NodeId(int(hi), int(lo)) for hi, lo in words.tolist()]


def fleet_clusters(tenants, n, n_extra, cohorts, seed0, device, knobs=((9, 4), (8, 3)), **planes):
    """``bench.py``'s ``build_fleet``: tenants cycling the crash-wave,
    join-wave and equal-churn families by ``i % 3``, (H, L) cycling
    ``knobs``, seeds ``seed0 + i``; ``planes`` (``telemetry`` / ``trace``)
    go to ``VirtualCluster.create``. Returns (clusters, targets)."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    clusters, targets = [], []
    for i in range(tenants):
        h, l = knobs[i % len(knobs)]
        vc = VirtualCluster.create(
            n, n_slots=n + n_extra, k=FLEET["k"], h=h, l=l, cohorts=cohorts, fd_threshold=3,
            seed=seed0 + i, delivery_spread=FLEET["spread"], device=device, **planes,
        )
        vc.assign_cohorts_roundrobin()
        rng = np.random.default_rng(seed0 + 10_000 + i)
        vc.stagger_fd_counts(rng, spread_rounds=3)
        family = i % 3
        if family != 1:  # crash wave, or the crash half of equal churn
            vc.crash(rng.choice(n, size=n_extra, replace=False))
        if family != 0:  # join wave, or the join half of equal churn
            vc.inject_join_wave(np.arange(n, n + n_extra))
        targets.append(n + n_extra * (int(family == 1) - int(family == 0)))
        clusters.append(vc)
    return clusters, targets


def fleet_on(fleet, dev):
    """The same fleet with every lane, plane lanes included, copied to ``dev``."""
    from rapid_tpu_torch.models.state import map_lanes
    from rapid_tpu_torch.tenancy import TenantFleet

    def move(tree):
        return map_lanes(lambda x: x.to(dev), tree)

    moved = TenantFleet(fleet.cfg, move(fleet.state), move(fleet.faults), move(fleet.knobs))
    moved.telem, moved.trace_ring = move(fleet.telem), move(fleet.trace_ring)
    return moved


def wave_exit(steps, max_steps):
    """``(iterations, reads)`` of a single-device fleet wave whose tenants
    stepped ``steps`` (``tenancy/fleet.py::_chunked_wave``): the parts up to
    the first part boundary at which no tenant is active, one part more
    where that boundary is read a part late (from the third part on), and
    the ``fleet_wave_active`` reads waited for."""
    from rapid_tpu_torch.tenancy.fleet import WAVE_GRAPH_CHUNK

    bounds = [*range(0, max_steps, WAVE_GRAPH_CHUNK), max_steps]
    parts = len(bounds) - 1
    slowest = int(max(steps, default=0))  # host-read-ok: the oracle's one read, after the wave
    idle = next(j for j, b in enumerate(bounds) if b >= slowest)
    ran = idle if idle < 2 else min(idle + 1, parts)
    return bounds[ran], min(idle + 1, parts - (parts >= 3))


def sync_checked_wave(fleet, targets, max_steps, max_cuts, min_cuts):
    """``fleet_wave`` over the fleet's lanes (its planes included) with every
    synchronizing call turned into an error: the wave loop must make none.
    ``min_cuts``: one value, or one per tenant. Returns what ``fleet_wave``
    returns."""
    from rapid_tpu_torch.tenancy.fleet import fleet_wave

    target_t = torch.tensor(targets, dtype=torch.int32, device=fleet.device)
    min_t = torch.tensor(np.broadcast_to(min_cuts, target_t.shape), dtype=torch.int32,
                         device=fleet.device)
    torch.cuda.synchronize(fleet.device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fleet_wave(fleet.cfg, fleet.state, fleet.faults, fleet.knobs, target_t,
                          max_steps, max_cuts, min_t, fleet.telem, fleet.trace_ring)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def fleet_records(result):
    """Every tenant's phase records, final slots and soak cuts, and the
    run's totals, as plain values."""
    return dict(
        phases=[[(r.resolved, r.cuts, r.config_id, r.config_epoch, r.members) for r in records]
                for records in result.phases],
        final_slots=[sorted(slots) for slots in result.final_slots],
        soak_cuts=None if result.soak_cuts is None else result.soak_cuts.tolist(),
        total_rounds=result.total_rounds, total_cuts=result.total_cuts,
        dispatches=result.dispatches,
    )


def stream_cluster(n, n_slots, cohorts, trace, seed, device, telemetry=True):
    """bench.py's stream cluster (its recovery cluster with the planes off)."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    vc = VirtualCluster.create(
        n, n_slots=n_slots, k=HEADLINE["k"], h=9, l=4, cohorts=cohorts, fd_threshold=3, seed=seed,
        delivery_spread=HEADLINE["spread"], telemetry=telemetry, trace=trace if telemetry else 0,
        device=device,
    )
    vc.assign_cohorts_roundrobin()
    return vc


def plane_lanes(tree):
    """Every lane of a state, fault, telemetry or ring tree as numpy."""
    from rapid_tpu_torch.convert import state_to_numpy

    return {} if tree is None else state_to_numpy(tree)


def all_lanes(target):
    return {**plane_lanes(target.state), **plane_lanes(target.faults),
            **{f"telem.{k}": v for k, v in plane_lanes(target.telem).items()},
            **{f"trace.{k}": v for k, v in plane_lanes(target.trace_ring).items()}}


def sync_checked_stream(target, **shape):
    """A StreamDriver over ``target`` whose every wave application and every
    streamed round run with each synchronizing call an error, and whose
    submits make no counted read: only the ticket waits may block."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.serving import StreamDriver

    def checked(fn, *args):
        reads = _host.read.count
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if _host.read.count != reads:
            raise RuntimeError(f"{fn.__name__} read the host on the stream path")
        return out

    class Checked(StreamDriver):
        def submit(self, wave):
            reads = _host.read.count
            super().submit(wave)
            if _host.read.count != reads:
                raise RuntimeError("a submit read the host")

        def _apply(self, wave):
            checked(super()._apply, wave)

    step = target.stream_step
    target.stream_step = lambda: checked(step)
    return Checked(target, **shape)


def batch_drive(target, waves, rounds):
    """The batch spelling of a stream schedule: the injection seams (the
    join's admissibility read included) and ``step()`` rounds."""
    from rapid_tpu_torch.serving import FleetWave

    for wave in waves:
        if isinstance(wave, FleetWave):
            if wave.crash:
                target.stream_crash(wave.crash)
        else:
            if wave.crash:
                target.crash(list(wave.crash))
            if wave.join:
                target.inject_join_wave(list(wave.join))
        for _ in range(rounds):
            target.step()


def run_stream(dev, target, waves, checked=True):
    """``waves`` through a (sync-checked) driver 8 rounds, 2 deep; returns
    (driver, StreamResult as a dict, delivery launches)."""
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.serving import StreamDriver

    shape = dict(rounds_per_wave=STREAM["rounds"], depth=STREAM["depth"])
    driver = sync_checked_stream(target, **shape) if checked else StreamDriver(target, **shape)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    delivery_new_bits.launches = 0
    for wave in waves:
        driver.submit(wave)
    result = driver.drain()
    launches = delivery_new_bits.launches
    if not (result.waves == len(waves) and result.cuts > 0):
        raise RuntimeError(f"stream result {result}")
    return driver, result._asdict(), launches


def comparable_snapshot(snap):
    """``snap`` as plain JSON without what may rightly differ between two
    runs of the same drive (a card and the CPU, or the port and the JAX
    package): the ``compile`` and ``memory`` sections, each ``*_ms``
    histogram but its count, and the stream's drained rates and the
    recovery MTTR (wall clock) but whether they are set."""
    snap = json.loads(json.dumps(snap))
    engine = snap["engine"]
    engine.pop("compile")
    engine.pop("memory")
    for name, value in snap["metrics"].items():
        if isinstance(value, dict):
            snap["metrics"][name] = (
                value["count"] if "count" in value
                else {phase: hist["count"] for phase, hist in value.items()}
            )
    for section, keys in (("stream", ("view_changes_per_sec", "overlap_efficiency",
                                      "p99_alert_to_commit_ms")),
                          ("recovery", ("mttr_ms",))):
        for key in keys:
            if section in engine:
                engine[section][key] = engine[section][key] is None
    return snap


def decided_paths(services):
    return sorted({e.fields.get("path") for s in services for e in s.recorder.events()
                   if e.name.name == "CONSENSUS_DECIDED"})


async def host_service_crash(dev, adapters, n, cohort=0):
    """Phase 20 (c) and phase 21 (b), the service-level crash as
    ``examples/host_scale_ceiling.py`` builds it: n services on one
    ``InProcessNetwork`` under a ``ManualClock``, one crash. ``cohort`` > 0
    sets ``hier_target_cohort_size``, so ``Cluster._service_class`` gives
    ``HierMembershipService`` (which passes no vote tally on)."""
    import asyncio
    import random

    from rapid_tpu_torch.messaging.inprocess import (
        InProcessClient, InProcessNetwork, InProcessServer,
    )
    from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
    from rapid_tpu_torch.protocol import (
        Cluster, DeviceCutDetector, DeviceVoteTally, MembershipView, MultiNodeCutDetector,
    )
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.types import Endpoint, NodeId
    from rapid_tpu_torch.utils.clock import ManualClock

    settings = Settings()
    settings.hier_target_cohort_size = cohort
    service_class = Cluster._service_class(settings)
    endpoints = [Endpoint(f"10.20.{i // 250}.{i % 250}", 6000 + i) for i in range(n)]
    node_ids = [NodeId(0, i) for i in range(n)]
    network, clock, fd = InProcessNetwork(), ManualClock(), StaticFailureDetectorFactory()
    services, servers, tallies = [], [], []

    def tally_factory(size):
        tallies.append(DeviceVoteTally(size, device=dev))
        return tallies[-1]

    for i in range(n):
        view = MembershipView(settings.k, node_ids=node_ids, endpoints=endpoints)
        client = InProcessClient(network, endpoints[i], settings)
        detector = (DeviceCutDetector(settings.k, settings.h, settings.l, device=dev) if adapters
                    else MultiNodeCutDetector(settings.k, settings.h, settings.l))
        service = service_class(
            my_addr=endpoints[i], cut_detector=detector, view=view, settings=settings,
            client=client, fd_factory=fd, clock=clock, rng=random.Random(i), node_id=node_ids[i],
            vote_tally_factory=tally_factory if adapters else None)
        server = InProcessServer(network, endpoints[i])
        server.set_membership_service(service)
        await server.start()
        await service.start()
        services.append(service)
        servers.append(server)
    victim = endpoints[n // 2]
    fd.add_failed_nodes([victim])
    network.blackholed.add(victim)
    live = [s for s in services if s.my_addr != victim]
    msgs0 = sum(s.client.stats.msgs_tx for s in services)
    start, sim_ms = time.perf_counter(), 0
    while not all(s.membership_size == n - 1 for s in live):
        clock.advance_ms(50)
        sim_ms += 50
        for _ in range(40):
            await asyncio.sleep(0)
        if sim_ms > 120_000:
            raise RuntimeError(f"n={n}: no convergence in 120 s of simulated time")
    wall_ms = (time.perf_counter() - start) * 1e3
    final = {(s.view.configuration_id, tuple(str(e) for e in s.membership)) for s in live}
    if len(final) != 1:
        raise RuntimeError(f"n={n}: the survivors hold different configurations")
    counters = {}
    for s in live:
        for key, value in s.metrics.counters.items():
            if key.startswith("cohort_"):
                counters[key] = counters.get(key, 0) + value
    out = {"crash_wall_ms": wall_ms, "sim_ms": sim_ms,
           "msgs": sum(s.client.stats.msgs_tx for s in services) - msgs0,
           "decision_paths": decided_paths(live), "final": final.pop(),
           "cohort_counters": counters}
    if cohort:
        out["cohorts"] = live[0]._cohort_map.n_cohorts
    if adapters:
        kinds = {type(s.cut_detector).__name__ for s in live}
        if kinds != {"DeviceCutDetector"}:
            raise RuntimeError(f"the services ran {kinds}")
        out["cut_passes"] = sum(s.cut_detector.batches for s in live)
        out["tallies"] = sum(t.tallies for t in tallies)
    for server in servers:
        await server.shutdown()
    for service in services:
        await service.shutdown()
    return out
