"""Counted device-to-host reads, and host-to-device uploads that do not wait.

The JAX engine runs its loops and ``lax.cond`` gates on the device. The port
runs them in Python, so every gate it branches on is a read that waits for
the device. All such reads in the engine go through :func:`read`, whose
``count`` attribute says how many were made (``chip_smoke.py`` reports it
per round); :func:`upload` counts its calls the same way.

The other way, a plain ``torch.from_numpy(arr).to("cuda")`` copies from
pageable memory and synchronizes the stream: every upload would wait for
all the work queued before it. :func:`upload` is the streaming path's
spelling, which does not wait.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def read(t: torch.Tensor):
    """``t.tolist()`` (a Python scalar for a 0-d tensor), counted."""
    read.count += 1
    return t.tolist()


read.count = 0


def upload(arr: np.ndarray, device: torch.device, keep: List[torch.Tensor]) -> torch.Tensor:
    """``arr`` as a tensor on ``device``, queued behind the work already on
    the current stream without waiting for it. On a card the array is copied
    into a fresh pinned host buffer, which is uploaded with
    ``non_blocking=True`` and appended to ``keep``: the caller holds it
    until the stream has passed the copy (the streaming driver keeps each
    wave's buffers with its completion ticket). On the CPU it is an ordinary
    copy and ``keep`` is untouched."""
    upload.count += 1
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return host.to(device, copy=True)
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    keep.append(pinned)
    return pinned.to(device, non_blocking=True)


upload.count = 0
