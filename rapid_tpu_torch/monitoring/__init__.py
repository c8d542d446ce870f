"""Edge failure detectors of the host path (copies of
``rapid_tpu/monitoring``): the SPI, ping-pong, the static detector and the
windowed detector."""

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
from rapid_tpu_torch.monitoring.windowed import (
    WindowedFailureDetector,
    WindowedFailureDetectorFactory,
)

__all__ = [
    "EdgeFailureDetector",
    "EdgeFailureDetectorFactory",
    "EdgeFailureNotifier",
    "PingPongFailureDetector",
    "PingPongFailureDetectorFactory",
    "StaticFailureDetector",
    "StaticFailureDetectorFactory",
    "WindowedFailureDetector",
    "WindowedFailureDetectorFactory",
]
