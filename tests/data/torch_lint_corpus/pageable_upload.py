"""Torch lint corpus: pageable uploads on the streaming path."""

import numpy as np
import torch


class Driver:
    def submit(self, slots):
        arr = np.asarray(slots, dtype=np.int64)
        idx = torch.from_numpy(arr).to(self.device)  # expect: pageable-upload
        ids = torch.tensor(arr, device=self.device)  # expect: pageable-upload
        ticket = torch.as_tensor(arr).cuda()  # expect: pageable-upload
        return idx, ids, ticket
