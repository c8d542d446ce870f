"""Torch lint corpus: stores through advanced indexing that wait for the
card."""

import torch


def mark(state, idx: torch.Tensor, value: bool):
    crashed = state.crashed.clone()
    crashed[idx] = True  # expect: index-store-sync
    crashed[idx] = value  # expect: index-store-sync
    alive = state.alive.clone()
    alive[state.fire_round > 3] = False  # expect: index-store-sync
    hot = state.fd_count > 2
    counts = state.fd_count.clone()
    counts[hot] = state.fd_count[hot] + 1  # expect: index-store-sync
    return crashed, alive, counts
