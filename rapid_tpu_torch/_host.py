"""Counted device-to-host reads.

The JAX engine runs its loops and ``lax.cond`` gates on the device. The port
runs them in Python, so every gate it branches on is a read that waits for
the device. All such reads in the engine go through :func:`read`, whose
``count`` attribute says how many were made (``chip_smoke.py`` reports it
per round).
"""

from __future__ import annotations

import torch


def read(t: torch.Tensor):
    """``t.tolist()`` (a Python scalar for a 0-d tensor), counted."""
    read.count += 1
    return t.tolist()


read.count = 0
