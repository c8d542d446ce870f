"""The host transports (copies of ``rapid_tpu/messaging``): the messaging
SPI and broadcaster, the wire codec, the in-process network with its fault
tools, TCP, and the UDP hybrid. The gossip broadcaster is
:mod:`rapid_tpu_torch.messaging.gossip`."""

from rapid_tpu_torch.messaging.base import (
    Broadcaster,
    MessagingClient,
    MessagingServer,
    UnicastToAllBroadcaster,
)
from rapid_tpu_torch.messaging.inprocess import (
    ClientDelayer,
    InProcessClient,
    InProcessNetwork,
    InProcessServer,
    ServerDropFirstN,
)
from rapid_tpu_torch.messaging.retries import call_with_retries
from rapid_tpu_torch.messaging.tcp import TcpClient, TcpServer
from rapid_tpu_torch.messaging.udp import UdpHybridClient, UdpHybridServer

__all__ = [
    "Broadcaster",
    "MessagingClient",
    "MessagingServer",
    "UnicastToAllBroadcaster",
    "ClientDelayer",
    "InProcessClient",
    "InProcessNetwork",
    "InProcessServer",
    "ServerDropFirstN",
    "call_with_retries",
    "TcpClient",
    "TcpServer",
    "UdpHybridClient",
    "UdpHybridServer",
]
