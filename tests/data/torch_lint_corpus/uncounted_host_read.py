"""Torch lint corpus: blocking reads the engine's counted funnel does not
see."""

import torch


def members(state, mask: torch.Tensor):
    count = state.n_members.item()  # expect: uncounted-host-read
    host = state.alive.cpu()  # expect: uncounted-host-read
    arr = mask.numpy()  # expect: uncounted-host-read
    total = int(torch.sum(state.alive))  # expect: uncounted-host-read
    if state.alive.any():  # expect: uncounted-host-read
        pass
    rows = torch.nonzero(mask).tolist()  # expect: uncounted-host-read
    return count, host, arr, total, rows
