"""Measure the hybrid TCP+UDP transport's datagram-loss cost curve.

The port's counterpart of the JAX package's ``examples/udp_loss_curve.py``,
with its arguments and JSON lines. For each loss rate, brings up a cluster
over the hybrid transport with seeded datagram loss injected at the sender
(``messaging.udp.LossyDatagramClient``, the post-commit drop point where
real network loss strikes), drives the same churn scenario (join wave, then
a crash), and reports convergence wall-clock plus the forced-rejoin count
(service metric ``decision_missing_joiner_uuid``). One JSON line per point:

    {"loss_pct": 10, "join_wave_ms": ..., "crash_ms": ..., "forced_rejoins": 0,
     "kicked": 0, "datagrams_dropped": ..., "datagrams_delivered": ...}

It runs on the host only (the host's cut detector and vote tally) and takes
no ``--device``.

    python -m rapid_tpu_torch.examples.udp_loss_curve [--rates 0,1,5,10,20] [--nodes 8] [--seed 42]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import socket
import sys
import time
from typing import List, Optional

from rapid_tpu_torch import _cli
from rapid_tpu_torch.messaging.udp import LossyDatagramClient, UdpHybridServer
from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
from rapid_tpu_torch.protocol.cluster import Cluster
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import Endpoint


def _settings() -> Settings:
    s = Settings()
    s.batching_window_ms = 20
    s.failure_detector_interval_ms = 50
    s.rpc_timeout_ms = 500
    s.rpc_join_timeout_ms = 4000
    s.rpc_probe_timeout_ms = 200
    s.consensus_fallback_base_delay_ms = 1000
    s.join_attempts = 10
    return s


def _free_ports(count: int) -> list:
    """Kernel-assigned free ports, reserved briefly then released: avoids
    collisions with anything else running on the host."""
    socks, ports = [], []
    for _ in range(count):
        sk = socket.socket()
        sk.bind(("127.0.0.1", 0))
        socks.append(sk)
        ports.append(sk.getsockname()[1])
    for sk in socks:
        sk.close()
    return ports


async def measure(loss_rate: float, n_nodes: int, seed: int) -> dict:
    settings = _settings()
    fd = StaticFailureDetectorFactory()
    rng = random.Random(seed)
    ports = _free_ports(n_nodes)
    eps = [Endpoint("127.0.0.1", p) for p in ports]
    clients = {}

    def client(i: int) -> LossyDatagramClient:
        c = LossyDatagramClient(
            eps[i], settings, loss_rate=loss_rate,
            rng=random.Random(rng.randrange(1 << 30)),
        )
        clients[i] = c
        return c

    n_seed = n_nodes - 3
    clusters = [
        await Cluster.start(eps[0], settings=settings, client=client(0),
                            server=UdpHybridServer(eps[0]), fd_factory=fd,
                            rng=random.Random(seed))
    ]
    for i in range(1, n_seed):
        clusters.append(
            await Cluster.join(eps[0], eps[i], settings=settings, client=client(i),
                               server=UdpHybridServer(eps[i]), fd_factory=fd,
                               rng=random.Random(seed + i))
        )

    async def converged(size: int, members) -> float:
        t0 = time.perf_counter()
        while not all(c.membership_size == size for c in members):
            await asyncio.sleep(0.02)
            if time.perf_counter() - t0 > 120:
                raise TimeoutError(f"no convergence to {size}")
        return (time.perf_counter() - t0) * 1000.0

    await converged(n_seed, clusters)

    # Join wave: 3 concurrent joiners (UP alerts + votes on lossy datagrams).
    t0 = time.perf_counter()
    joiners = await asyncio.gather(*(
        Cluster.join(eps[0], eps[i], settings=settings, client=client(i),
                     server=UdpHybridServer(eps[i]), fd_factory=fd,
                     rng=random.Random(seed + i))
        for i in range(n_seed, n_nodes)
    ))
    clusters.extend(joiners)
    await converged(n_nodes, clusters)
    join_wave_ms = (time.perf_counter() - t0) * 1000.0

    # Crash (DOWN alerts on lossy datagrams).
    victim = clusters[2]
    await victim.shutdown()
    fd.add_failed_nodes([victim.listen_address])
    survivors = [c for c in clusters if c is not victim]
    t0 = time.perf_counter()
    await converged(n_nodes - 1, survivors)
    crash_ms = (time.perf_counter() - t0) * 1000.0

    result = {
        "loss_pct": round(loss_rate * 100, 1),
        "n_nodes": n_nodes,
        "join_wave_ms": round(join_wave_ms, 1),
        "crash_ms": round(crash_ms, 1),
        "forced_rejoins": sum(
            c.service.metrics.counters["decision_missing_joiner_uuid"] for c in survivors
        ),
        "kicked": sum(c.service.metrics.counters["kicked"] for c in survivors),
        "datagrams_dropped": sum(c.datagrams_dropped for c in clients.values()),
        "datagrams_delivered": sum(c.datagrams_delivered for c in clients.values()),
    }
    await asyncio.gather(*(c.shutdown() for c in survivors), return_exceptions=True)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rates", default="0,1,5,10,20",
                        help="comma-separated loss percentages")
    parser.add_argument("--nodes", type=int, default=8)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)
    for pct in (float(r) for r in args.rates.split(",")):
        result = asyncio.run(measure(pct / 100.0, args.nodes, args.seed))
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_cli.run_main(main))
