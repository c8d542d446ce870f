"""Torch lint corpus: blocking reads anywhere in a serving module, and an
implicit bool of a torch call."""

import torch

from rapid_tpu_torch import _host


class Driver:
    def wait(self, event):
        event.synchronize()  # expect: host-sync-in-stream

    def drain(self):
        state = self.target.state
        members = _host.read(state.n_members, "membership_predicate")  # expect: host-sync-in-stream
        snapshot = state.alive.cpu().numpy()  # expect: host-sync-in-stream
        if torch.any(state.alive):  # expect: host-sync-in-stream
            pass
        epoch = int(torch.sum(state.config_epoch))  # expect: host-sync-in-stream
        return members, snapshot, epoch
