"""Torch lint corpus (clean): uploads through the pinned funnel, dtype
casts, host copies, and a declared exception."""

import numpy as np
import torch

from rapid_tpu_torch import _host


class Driver:
    def submit(self, slots):
        arr = np.asarray(slots, dtype=np.int64)
        idx = _host.upload(arr, self.device, self._staged)
        wide = torch.from_numpy(arr).to(torch.int32)
        host = torch.from_numpy(arr).to("cpu")
        mask = torch.from_numpy(arr).to(self.device)  # upload-ok: at the fetch boundary
        return idx, wide, host, mask
