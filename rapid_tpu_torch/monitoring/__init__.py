"""Edge failure detectors of the host path (copies of
``rapid_tpu/monitoring``): the SPI, ping-pong and the static detector. The
windowed detector is not ported yet (ROADMAP, the host-stack queue)."""

from rapid_tpu_torch.monitoring.base import (
    EdgeFailureDetector,
    EdgeFailureDetectorFactory,
    EdgeFailureNotifier,
)
from rapid_tpu_torch.monitoring.ping_pong import (
    PingPongFailureDetector,
    PingPongFailureDetectorFactory,
)
from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetector, StaticFailureDetectorFactory

__all__ = [
    "EdgeFailureDetector",
    "EdgeFailureDetectorFactory",
    "EdgeFailureNotifier",
    "PingPongFailureDetector",
    "PingPongFailureDetectorFactory",
    "StaticFailureDetector",
    "StaticFailureDetectorFactory",
]
