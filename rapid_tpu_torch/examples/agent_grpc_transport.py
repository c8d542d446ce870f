"""Cluster agent over the interop gRPC transport — the transport-swap example.

The port's counterpart of the JAX package's
``examples/agent_grpc_transport.py``, with the same flags and log lines:
the alternate client and server (``rapid_tpu_torch.interop``'s
``GrpcClient`` / ``GrpcServer``, serving the reference's
``remoting.MembershipService/sendRequest``) are built explicitly and handed
to the cluster builder, so the protocol stack runs unchanged under gRPC.

It runs on the host only and takes no ``--device``: it needs ``grpc`` and
``protobuf``, which a machine with a card may lack, so its cut detector and
vote tally are the host's.

Run a 3-node cluster on localhost:

    python -m rapid_tpu_torch.examples.agent_grpc_transport \\
        --listen-address 127.0.0.1:9101 --seed-address 127.0.0.1:9101 &
    python -m rapid_tpu_torch.examples.agent_grpc_transport \\
        --listen-address 127.0.0.1:9102 --seed-address 127.0.0.1:9101 &
    python -m rapid_tpu_torch.examples.agent_grpc_transport \\
        --listen-address 127.0.0.1:9103 --seed-address 127.0.0.1:9101 &
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys
from typing import List, Optional

from rapid_tpu_torch import _cli
from rapid_tpu_torch.protocol.cluster import Cluster
from rapid_tpu_torch.protocol.events import ClusterEvents
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import Endpoint

LOG = logging.getLogger("agent_grpc")


async def run(args) -> None:
    from rapid_tpu_torch.interop.grpc_transport import GrpcClient, GrpcServer

    listen = Endpoint.parse(args.listen_address)
    seed = Endpoint.parse(args.seed_address)
    settings = Settings()

    # The transport swap: build the alternate client/server explicitly and
    # hand them to the cluster builder (the messaging SPI seam).
    client = GrpcClient(listen, settings)
    server = GrpcServer(listen)

    if listen == seed:
        LOG.info("starting cluster as seed at %s (gRPC transport)", listen)
        cluster = await Cluster.start(
            listen, settings=settings, client=client, server=server
        )
    else:
        LOG.info("joining cluster at %s from %s (gRPC transport)", seed, listen)
        cluster = await Cluster.join(
            seed, listen, settings=settings, client=client, server=server
        )

    def log_event(event):
        def callback(change):
            LOG.info(
                "%s: config %d, %d members, delta: %s",
                event.name,
                change.configuration_id,
                len(change.membership),
                [(str(sc.endpoint), sc.status.name) for sc in change.status_changes],
            )

        return callback

    for event in (
        ClusterEvents.VIEW_CHANGE_PROPOSAL,
        ClusterEvents.VIEW_CHANGE,
        ClusterEvents.KICKED,
    ):
        cluster.register_subscription(event, log_event(event))

    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)

    async def reporter():
        while not stop.is_set():
            LOG.info(
                "membership size: %d (config %d)",
                cluster.membership_size,
                cluster.service.view.configuration_id,
            )
            await asyncio.sleep(args.report_interval)

    reporter_task = asyncio.ensure_future(reporter())
    await stop.wait()
    reporter_task.cancel()
    LOG.info("leaving gracefully")
    await cluster.leave_gracefully()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="rapid_tpu_torch agent on the gRPC transport")
    parser.add_argument("--listen-address", required=True, help="host:port to listen on")
    parser.add_argument("--seed-address", required=True,
                        help="host:port of the seed (same as listen-address to bootstrap)")
    parser.add_argument("--report-interval", type=float, default=1.0)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    asyncio.run(run(args))
    return 0


if __name__ == "__main__":
    sys.exit(_cli.run_main(main))
