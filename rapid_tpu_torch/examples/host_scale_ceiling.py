"""Locate the host protocol path's scale ceiling vs the device engine.

The port's counterpart of the JAX package's
``examples/host_scale_ceiling.py``, with its arguments and JSON lines. The
framework ships two implementations of the same protocol: the asyncio host
path (one ``MembershipService`` per node, the reference architecture) and
the fused device engine (``models/virtual_cluster.py``, one program for all
N). The host path's cost per view change is dominated by the O(N^2) vote
fan-out plus asyncio scheduling overhead per message; the engine turns the
same work into a handful of batched tensor ops. This instrument measures
where the curves cross.

Method: for each N, wire N ``MembershipService`` instances directly on one
``InProcessNetwork`` (identical pre-built views), crash one member, and
pump a ``ManualClock`` until every service applies the view change. Wall
time around the pumping loop is pure host CPU cost (simulated time never
sleeps). The host column stays on the host, as in JAX's script. The engine
column runs the identical crash on a ``VirtualCluster`` of the same size
and membership on ``--device`` (CUDA unless another device is named; CUDA
without a card raises), where JAX's script forces its CPU platform.

One JSON line per N:

    {"n": 200, "broadcast": "unicast", "host_crash_wall_ms": ...,
     "host_msgs": ..., "gossip_relays": ...,  # gossip mode only
     "engine_crash_wall_ms": ..., "sim_ms": ...}

    python -m rapid_tpu_torch.examples.host_scale_ceiling [--sizes 50,100,200,350,500]
                                          [--broadcast unicast|gossip] [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import sys
import time
from typing import List, Optional

from rapid_tpu_torch import _cli
from rapid_tpu_torch.messaging.inprocess import InProcessClient, InProcessNetwork, InProcessServer
from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
from rapid_tpu_torch.protocol.cut_detector import MultiNodeCutDetector
from rapid_tpu_torch.protocol.service import MembershipService
from rapid_tpu_torch.protocol.view import MembershipView
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import Endpoint, NodeId
from rapid_tpu_torch.utils.clock import ManualClock


async def host_crash_convergence(n: int, seed: int = 0, broadcast: str = "unicast"):
    """Wall-clock cost of one crash view-change across n host services.
    ``broadcast="gossip"`` swaps the O(N) unicast-to-all fan-out for the
    epidemic relay (ln-N fanout) at every node — same protocol, different
    egress shape."""
    if broadcast not in ("unicast", "gossip"):
        raise ValueError(f"broadcast must be 'unicast' or 'gossip', got {broadcast!r}")
    settings = Settings()  # reference defaults: 1 s FD, 100 ms batching
    endpoints = [Endpoint(f"10.20.{i // 250}.{i % 250}", 6000 + i) for i in range(n)]
    node_ids = [NodeId(0, i) for i in range(n)]
    network = InProcessNetwork()
    clock = ManualClock()
    fd = StaticFailureDetectorFactory()

    services = []
    servers = []
    for i in range(n):
        view = MembershipView(settings.k, node_ids=node_ids, endpoints=endpoints)
        client = InProcessClient(network, endpoints[i], settings)
        broadcaster = None
        if broadcast == "gossip":
            from rapid_tpu_torch.messaging.gossip import GossipBroadcaster

            broadcaster = GossipBroadcaster(client, endpoints[i], rng=random.Random(seed + i))
        service = MembershipService(
            my_addr=endpoints[i],
            cut_detector=MultiNodeCutDetector(settings.k, settings.h, settings.l),
            view=view,
            settings=settings,
            client=client,
            fd_factory=fd,
            clock=clock,
            rng=random.Random(seed + i),
            node_id=node_ids[i],
            broadcaster=broadcaster,
        )
        server = InProcessServer(network, endpoints[i])
        server.set_membership_service(
            broadcaster.router(service) if broadcaster is not None else service
        )
        await server.start()
        await service.start()
        services.append(service)
        servers.append(server)

    victim = endpoints[n // 2]
    fd.add_failed_nodes([victim])
    network.blackholed.add(victim)
    live = [s for s in services if s.my_addr != victim]

    async def drain(rounds=40):
        for _ in range(rounds):
            await asyncio.sleep(0)

    t0 = time.perf_counter()
    sim_ms = 0.0
    while not all(s.membership_size == n - 1 for s in live):
        clock.advance_ms(50)
        sim_ms += 50
        await drain()
        if sim_ms > 120_000:
            raise TimeoutError(f"host n={n} did not converge in 120 s sim")
    wall_ms = (time.perf_counter() - t0) * 1000.0

    msgs = sum(s.metrics.counters.get("alerts_received", 0) for s in live)
    relays = sum(
        getattr(s.broadcaster, "relays_sent", 0) for s in services
    )
    for server in servers:
        await server.shutdown()
    for service in services:
        await service.shutdown()
    return wall_ms, sim_ms, msgs, relays


def engine_crash_convergence(n: int, device=None):
    """The same crash on the fused engine, on ``device`` (CUDA unless
    another device is named)."""
    from rapid_tpu_torch.models.state import resolve_device
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    device = resolve_device(device)
    endpoints = [Endpoint(f"10.20.{i // 250}.{i % 250}", 6000 + i) for i in range(n)]

    def crashed():
        vc = VirtualCluster.from_endpoints(
            endpoints, n_slots=n, fd_threshold=1, delivery_spread=0, device=device
        )
        vc.crash([n // 2])
        return vc

    crashed().run_to_decision(max_steps=64)  # warm-up: the kernel build, the allocator
    # Re-create for the measured run (state was consumed by the decision).
    vc = crashed()
    _cli.synchronize(device)
    t0 = time.perf_counter()
    _, decided, _, _ = vc.run_to_decision(max_steps=64)
    wall_ms = (time.perf_counter() - t0) * 1000.0
    assert decided
    return wall_ms


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sizes", default="50,100,200,350,500")
    parser.add_argument("--skip-engine", action="store_true")
    parser.add_argument("--broadcast", default="unicast", choices=["unicast", "gossip"])
    _cli.add_device_argument(parser)
    args = parser.parse_args(argv)
    device = None if args.skip_engine else _cli.device_of(args)
    for n in (int(s) for s in args.sizes.split(",")):
        wall_ms, sim_ms, msgs, relays = asyncio.run(
            host_crash_convergence(n, broadcast=args.broadcast)
        )
        row = {
            "n": n,
            "broadcast": args.broadcast,
            "host_crash_wall_ms": round(wall_ms, 1),
            "host_msgs": msgs,
            "sim_ms": sim_ms,
        }
        if args.broadcast == "gossip":
            row["gossip_relays"] = relays
        if not args.skip_engine:
            row["engine_crash_wall_ms"] = round(engine_crash_convergence(n, device), 1)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_cli.run_main(main))
