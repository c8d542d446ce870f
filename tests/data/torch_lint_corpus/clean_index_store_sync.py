"""Torch lint corpus (clean): the same stores with index_fill_ and
torch.where, and basic indexing, which never waits."""

import torch


def mark(state, idx: torch.Tensor, value: bool, i: int):
    crashed = state.crashed.clone().index_fill_(0, idx, value)
    alive = torch.where(state.fire_round > 3, False, state.alive)
    counts = state.fd_count.clone()
    counts[0] = 1
    counts[i] = 2
    counts[1:3] = 0
    counts[idx] = state.fd_count[idx] + 1
    return crashed, alive, counts
