"""Torch lint corpus: blocking reads inside the hot set (``*_impl`` round
pieces), each spelling once, and one declared boundary."""

import torch

from rapid_tpu_torch import _host


def round_impl(state, faults):
    alive = state.alive.sum().item()  # expect: host-sync-in-hot-path
    mask = state.alive.tolist()  # expect: host-sync-in-hot-path
    host = faults.crashed.cpu()  # expect: host-sync-in-hot-path
    torch.cuda.synchronize()  # expect: host-sync-in-hot-path
    total = int(torch.sum(state.alive))  # expect: host-sync-in-hot-path
    members = _host.read(state.n_members, "membership_predicate")  # expect: host-sync-in-hot-path
    decided = _host.read(state.decided, "branch_point")  # host-sync-ok: the round's one branch point
    return alive, mask, host, total, members, decided


def cold_helper(state):
    return state.alive.sum().item()
