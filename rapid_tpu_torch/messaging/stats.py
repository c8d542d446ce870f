"""Per-node network accounting — the paper's Table 2 instrument.

The reference's evaluation reports per-process network use (mean/p99/max
KB/s received and transmitted during the crash experiment: Rapid mean
0.71/0.71, max 9.56/11.37 — paper Table 2) but ships no counters; the
numbers came from external OS instrumentation. Here every transport
carries a ``TransportStats`` so the same measurement is a library call:
``client.stats.snapshot()`` / ``server.stats.snapshot()``.

What counts: the TCP paths count real wire bytes (header + payload) per
frame; the UDP datagram path counts datagram payloads; the in-process
transport counts messages always and wire-EQUIVALENT bytes (the codec
encoding the message would have on the TCP transport) when constructed
with ``count_wire_bytes=True``. Request encoding is memoized (small LRU,
hashable messages only) so accounting a broadcast fan-out costs one
encode, not N; responses are not fanned out and are encoded per send.

A copy of ``rapid_tpu/messaging/stats.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

import time
from typing import Dict


class TransportStats:
    """Monotonic tx/rx message and byte counters with a rate window."""

    __slots__ = ("msgs_tx", "bytes_tx", "msgs_rx", "bytes_rx", "_window_start")

    def __init__(self) -> None:
        self.msgs_tx = 0
        self.bytes_tx = 0
        self.msgs_rx = 0
        self.bytes_rx = 0
        self._window_start = time.monotonic()

    def tx(self, nbytes: int = 0) -> None:
        self.msgs_tx += 1
        self.bytes_tx += nbytes

    def rx(self, nbytes: int = 0) -> None:
        self.msgs_rx += 1
        self.bytes_rx += nbytes

    def reset_window(self) -> None:
        """Zero the counters and restart the rate window (e.g. after
        bootstrap, to measure steady state the way Table 2 does)."""
        self.msgs_tx = self.bytes_tx = self.msgs_rx = self.bytes_rx = 0
        self._window_start = time.monotonic()

    def snapshot(self) -> Dict[str, float]:
        elapsed_s = max(time.monotonic() - self._window_start, 1e-9)
        return {
            "msgs_tx": self.msgs_tx,
            "bytes_tx": self.bytes_tx,
            "msgs_rx": self.msgs_rx,
            "bytes_rx": self.bytes_rx,
            "elapsed_s": round(elapsed_s, 3),
            "kbps_tx": round(self.bytes_tx / 1024.0 / elapsed_s, 3),
            "kbps_rx": round(self.bytes_rx / 1024.0 / elapsed_s, 3),
        }
