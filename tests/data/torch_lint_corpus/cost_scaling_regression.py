"""Torch lint corpus: eager cost that grew past its frozen scaling class.

Four miniature calls the ``cost_model`` family must fail, each a distinct
drift mode. ``quadratic_probe`` takes an [n, n] lane, so its lane bytes
fit O(N^2) while the inline ``COST_LOCK`` claims O(N): a scaling
REGRESSION by name (its ceiling is raised to O(N^2) so only the
regression fires). ``per_slot_loop`` walks the slots in a Python loop, so
its aten operators (the eager program's launches) grow with N where the
lock claims O(1): the port's own regression. ``runaway_probe`` locks the
honest O(N^2) class but keeps the default O(N*K) ceiling, which still
refuses it. ``stepped_probe`` widens its dtype halfway up the ladder, a
policy step and no scaling law, and the fitter must refuse to classify it.
"""

from typing import NamedTuple

import torch

COST_LADDER = (8, 16, 32, 64)


class Lanes(NamedTuple):
    matrix: torch.Tensor
    vector: torch.Tensor


def _spec(lanes, call):
    return {"call": lambda: call(lanes), "inputs": {"state": lanes},
            "outputs": lambda res: {}, "context": None, "tenants": 1}


def _quadratic_probe(n):
    # THE defect: the per-round lane is a full [n, n] matrix.
    lanes = Lanes(torch.ones((n, n)), torch.ones((n,)))
    return _spec(lanes, lambda lanes: lanes.matrix @ lanes.vector)


def _per_slot_loop(n):
    # THE defect: one operator per slot, where one over the lane would do.
    lanes = Lanes(torch.ones((n, 1)), torch.ones((n,)))

    def call(lanes):
        return [lanes.vector[i] + 1 for i in range(n)]

    return _spec(lanes, call)


def _runaway_probe(n):
    lanes = Lanes(torch.ones((n, n)), torch.ones((1,)))
    return _spec(lanes, lambda lanes: lanes.matrix.sum(dim=1))


def _stepped_probe(n):
    # Bytes per element step at n=32, so no scaling class explains them.
    dtype = torch.int8 if n < 32 else torch.int16
    lanes = Lanes(torch.zeros((n,), dtype=dtype), torch.zeros((n,), dtype=dtype))
    return _spec(lanes, lambda lanes: lanes.matrix + 1)


COST_AUDIT_PROGRAMS = {
    "quadratic_probe": _quadratic_probe,  # expect: cost-scaling-regression
    "per_slot_loop": _per_slot_loop,  # expect: cost-scaling-regression
    "runaway_probe": _runaway_probe,  # expect: cost-superlinear
    "stepped_probe": _stepped_probe,  # expect: cost-unexplained
}

#: What these calls CLAIM.
COST_LOCK = {
    "quadratic_probe": {"ceiling": "O(N^2)", "facts": {"lane_bytes": {"class": "O(N)"}}},
    "per_slot_loop": {"facts": {"aten_ops": {"class": "O(1)"}}},
    "runaway_probe": {"facts": {"lane_bytes": {"class": "O(N^2)"}}},
    "stepped_probe": {"ceiling": "O(N^2)", "facts": {"lane_bytes": {"class": "O(N)"}}},
}
