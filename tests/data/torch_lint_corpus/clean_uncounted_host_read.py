"""Torch lint corpus (clean): reads through the counted funnel, host-side
numpy, host copies of the lanes, and a declared boundary."""

import numpy as np

from rapid_tpu_torch import _host


def members(state, tree, np_of):
    count = _host.read(state.n_members, "membership_predicate")
    slots = np.arange(8).tolist()
    host = np_of(tree)
    copy = map(np_of, tree)
    members = int(host.n_members)
    first = int(next(copy))
    snapshot = state.alive.cpu()  # host-read-ok: one report, outside any round
    return count, slots, members, first, snapshot
