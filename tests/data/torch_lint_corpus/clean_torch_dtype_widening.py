"""Torch lint corpus (clean): every narrowed store goes through a cast."""

import torch

from rapid_tpu_torch import _narrow


def tick(state, heard):
    count = (state.fd_count + heard.to(torch.int32)).to(state.fd_count.dtype)
    return state._replace(
        fd_count=count,
        fire_round=(state.fire_round + 1).to(state.fire_round.dtype),
        report_bits=_narrow.keep_bits(state.report_bits | 1, state.report_bits),
    )
