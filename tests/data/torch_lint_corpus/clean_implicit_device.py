"""Torch lint corpus (clean): every constructor names its device, a
device=None default is resolved first, a pinned host buffer is meant for
the host, and a constructor moved at once names its device in the move."""

import torch

from rapid_tpu_torch.models.state import resolve_device


def lanes(n, dev):
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    idx = torch.arange(n).to(dev)
    pinned = torch.empty((n,), dtype=torch.int64, pin_memory=True)
    ranks = torch.tensor([0, 1])  # device-ok: a host tensor of mesh ranks
    return zeros, idx, pinned, ranks


def build(n, device=None):
    device = resolve_device(device)
    return torch.full((n,), -1, dtype=torch.int32, device=device)
