"""Torch lint corpus: arithmetic stored into policy-narrowed lanes without
a cast (torch promotes silently)."""

import torch


def tick(state, heard):
    return state._replace(
        fd_count=state.fd_count + heard.to(torch.int32),  # expect: dtype-widening
        fire_round=torch.where(heard, state.fire_round, 0) + 1,  # expect: dtype-widening
    )
