"""Standalone cluster agent over the TCP transport.

The port's counterpart of the JAX package's ``examples/standalone_agent.py``,
with the same flags (``--transport tcp|udp``, ``--fd pingpong|windowed``,
``--broadcast unicast|gossip``, ``--health``, ``--metrics-dump``,
``--role``) and the same log lines, health lines and snapshot files. The
seed starts a cluster, everyone else joins it; three subscriptions log view
changes; the membership size prints every report interval.

One departure: the cut detector and the fast-round vote tally are the
device adapters (``DeviceCutDetector``, ``DeviceVoteTally``) on
``--device`` (CUDA unless another device is named; CUDA without a card
raises). Their decisions equal the host hash maps', so this agent's views
and configuration ids equal a JAX agent's, and the two share one cluster.

Run a 3-node cluster on localhost:

    python -m rapid_tpu_torch.examples.standalone_agent \\
        --listen-address 127.0.0.1:9001 --seed-address 127.0.0.1:9001 &
    python -m rapid_tpu_torch.examples.standalone_agent \\
        --listen-address 127.0.0.1:9002 --seed-address 127.0.0.1:9001 &
    python -m rapid_tpu_torch.examples.standalone_agent \\
        --listen-address 127.0.0.1:9003 --seed-address 127.0.0.1:9001 &
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import json
import logging
import os
import signal
import sys
from typing import List, Optional

from rapid_tpu_torch import _cli
from rapid_tpu_torch.messaging.tcp import TcpClient, TcpServer
from rapid_tpu_torch.messaging.udp import UdpHybridClient, UdpHybridServer
from rapid_tpu_torch.monitoring.windowed import WindowedFailureDetectorFactory
from rapid_tpu_torch.protocol.cluster import Cluster
from rapid_tpu_torch.protocol.device_cut_detector import DeviceCutDetector
from rapid_tpu_torch.protocol.device_vote_tally import DeviceVoteTally
from rapid_tpu_torch.protocol.events import ClusterEvents
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import Endpoint
from rapid_tpu_torch.utils import exposition

LOG = logging.getLogger("standalone_agent")


def subscription_logger(event: ClusterEvents):
    def callback(change):
        LOG.info(
            "%s: config %d, %d members, delta: %s",
            event.name,
            change.configuration_id,
            len(change.membership),
            [(str(sc.endpoint), sc.status.name) for sc in change.status_changes],
        )

    return callback


async def run(args, device) -> None:
    listen = Endpoint.parse(args.listen_address)
    seed = Endpoint.parse(args.seed_address)
    settings = Settings()
    metadata = (("role", args.role.encode()),) if args.role else ()
    if args.transport == "udp":
        # Hybrid: joins/probes over TCP, alerts/votes as datagrams.
        client, server = UdpHybridClient(listen, settings), UdpHybridServer(listen)
    else:
        client, server = TcpClient(listen, settings), TcpServer(listen)

    fd_factory = None  # default: ping-pong consecutive-failure counter
    if args.fd == "windowed":
        # The paper's stated policy: >=40% of the last 10 probes failed.
        fd_factory = WindowedFailureDetectorFactory(listen, client)

    broadcaster_factory = None  # default: unicast-to-all
    if args.broadcast == "gossip":
        # Epidemic relay: per-node egress O(log N) instead of origin O(N).
        from rapid_tpu_torch.messaging.gossip import GossipBroadcaster

        broadcaster_factory = GossipBroadcaster.factory()

    # Both halves of the protocol's hot path on the device.
    adapters = dict(
        cut_detector_factory=functools.partial(DeviceCutDetector, device=device),
        vote_tally_factory=functools.partial(DeviceVoteTally, device=device),
    )
    if listen == seed:
        LOG.info("starting cluster as seed at %s", listen)
        cluster = await Cluster.start(
            listen, settings=settings, client=client, server=server,
            metadata=metadata, fd_factory=fd_factory,
            broadcaster_factory=broadcaster_factory, **adapters,
        )
    else:
        LOG.info("joining cluster at %s from %s", seed, listen)
        cluster = await Cluster.join(
            seed, listen, settings=settings, client=client, server=server,
            metadata=metadata, fd_factory=fd_factory,
            broadcaster_factory=broadcaster_factory, **adapters,
        )

    for event in (
        ClusterEvents.VIEW_CHANGE_PROPOSAL,
        ClusterEvents.VIEW_CHANGE,
        ClusterEvents.KICKED,
    ):
        cluster.register_subscription(event, subscription_logger(event))

    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)

    def dump_metrics() -> None:
        # The unified telemetry snapshot: metrics + transport accounting +
        # the full flight recording, one file per node (the input traceview
        # merges), written atomically so a concurrent reader never sees a
        # torn JSON.
        tmp = args.metrics_dump + ".tmp"
        with open(tmp, "w") as f:
            f.write(exposition.snapshot_json(cluster.telemetry_snapshot(), indent=2))
            f.write("\n")
        os.replace(tmp, args.metrics_dump)

    def print_health() -> None:
        # One JSON line per report interval: the node's health state and
        # its phase-decomposed convergence quantiles.
        snap = cluster.telemetry_snapshot(recorder_tail=0)
        family = snap["metrics"].get("view_change_phase_ms") or {}
        print(json.dumps({
            "node": snap["node"],
            "health": snap["health"],
            "configuration_id": snap["configuration_id"],
            "membership_size": snap["membership_size"],
            "phases": {
                phase: {k: hist[k] for k in ("count", "p50", "p90", "p99", "max")}
                for phase, hist in family.items()
            },
        }), flush=True)

    async def reporter():
        while not stop.is_set():
            LOG.info("membership size: %d (config %d)",
                     cluster.membership_size, cluster.service.view.configuration_id)
            if args.metrics_dump:
                dump_metrics()
            if args.health:
                print_health()
            await asyncio.sleep(args.report_interval)

    reporter_task = asyncio.ensure_future(reporter())
    await stop.wait()
    reporter_task.cancel()
    if args.metrics_dump:
        dump_metrics()  # final recording survives the shutdown
    LOG.info("leaving gracefully")
    await cluster.leave_gracefully()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="rapid_tpu_torch standalone agent")
    parser.add_argument("--listen-address", required=True, help="host:port to listen on")
    parser.add_argument("--seed-address", required=True,
                        help="host:port of the seed (same as listen-address to bootstrap)")
    parser.add_argument("--role", default="", help="role metadata tag shared with the cluster")
    parser.add_argument("--transport", choices=("tcp", "udp"), default="tcp",
                        help="tcp: everything over TCP; udp: hybrid with datagram alerts/votes")
    parser.add_argument("--fd", choices=("pingpong", "windowed"), default="pingpong",
                        help="failure-detection policy: pingpong = consecutive-failure "
                        "counter (the reference code's); windowed = fraction of the "
                        "last-N probes (the paper's)")
    parser.add_argument("--broadcast", choices=("unicast", "gossip"), default="unicast",
                        help="broadcast strategy: unicast-to-all or epidemic gossip relay")
    parser.add_argument("--report-interval", type=float, default=1.0)
    parser.add_argument("--health", action="store_true",
                        help="print the node's health state and phase-decomposed "
                        "convergence quantiles as one JSON line per report interval")
    parser.add_argument("--metrics-dump", default="", metavar="PATH",
                        help="write the node's unified telemetry snapshot (metrics, "
                        "transport stats, flight recording) to PATH as JSON every "
                        "report interval and on shutdown; feed one file per node to "
                        "rapid_tpu_torch.tools.traceview to merge a timeline")
    _cli.add_device_argument(parser)
    args = parser.parse_args(argv)
    device = _cli.device_of(args)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    asyncio.run(run(args, device))
    return 0


if __name__ == "__main__":
    sys.exit(_cli.run_main(main))
