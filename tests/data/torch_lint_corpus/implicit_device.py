"""Torch lint corpus: tensors built with no device, and a device=None
default that reaches a constructor unresolved."""

import torch


def lanes(n):
    zeros = torch.zeros(n, dtype=torch.int32)  # expect: implicit-device
    idx = torch.arange(n)  # expect: implicit-device
    return zeros, idx


def build(n, device=None):
    return torch.full((n,), -1, dtype=torch.int32, device=device)  # expect: implicit-device
