"""Torch lint corpus (clean): the hot set keeps its values on the device;
the one read it makes is a declared boundary, and numpy's ``tolist`` is no
device read."""

import numpy as np
import torch

from rapid_tpu_torch import _host


def round_impl(state, faults):
    alive = state.alive.sum()
    live = torch.where(faults.crashed, 0, state.alive.to(torch.int32))
    slots = np.arange(4).tolist()
    decided = _host.read(state.decided, "branch_point")  # host-sync-ok: the round's one branch point
    return alive, live, slots, decided
