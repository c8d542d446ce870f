"""Torch lint corpus (clean): the pipeline's fetches are declared
boundaries, and host-side numpy work is no device read."""

import numpy as np

from rapid_tpu_torch import _host


class Driver:
    def wait(self, event):
        event.synchronize()  # host-sync-ok: the explicit fetch boundary

    def drain(self, poisoned):
        state = self.target.state
        total = _host.read(state.config_epoch.sum(), "stream_fetch")  # host-sync-ok: fetch boundary
        fresh = [int(t) for t in np.nonzero(poisoned)[0].tolist()]
        return total, fresh
