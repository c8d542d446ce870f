"""Torch lint corpus: the silent twin of ``cost_scaling_regression.py``:
the same four calls written to the classes their lock claims."""

from typing import NamedTuple

import torch

COST_LADDER = (8, 16, 32, 64)


class Lanes(NamedTuple):
    matrix: torch.Tensor
    vector: torch.Tensor


def _spec(lanes, call):
    return {"call": lambda: call(lanes), "inputs": {"state": lanes},
            "outputs": lambda res: {}, "context": None, "tenants": 1}


def _linear_probe(n):
    lanes = Lanes(torch.ones((n, 4)), torch.ones((4,)))
    return _spec(lanes, lambda lanes: lanes.matrix @ lanes.vector)


def _whole_lane_op(n):
    lanes = Lanes(torch.ones((n, 1)), torch.ones((n,)))
    return _spec(lanes, lambda lanes: lanes.vector + 1)


def _bounded_probe(n):
    lanes = Lanes(torch.ones((n, 8)), torch.ones((1,)))
    return _spec(lanes, lambda lanes: lanes.matrix.sum(dim=1))


def _one_dtype_probe(n):
    lanes = Lanes(torch.zeros((n,), dtype=torch.int16), torch.zeros((n,), dtype=torch.int16))
    return _spec(lanes, lambda lanes: lanes.matrix + 1)


COST_AUDIT_PROGRAMS = {
    "linear_probe": _linear_probe,
    "whole_lane_op": _whole_lane_op,
    "bounded_probe": _bounded_probe,
    "one_dtype_probe": _one_dtype_probe,
}

COST_LOCK = {
    "linear_probe": {"facts": {"lane_bytes": {"class": "O(N)"}}},
    "whole_lane_op": {"facts": {"aten_ops": {"class": "O(1)"}}},
    "bounded_probe": {"facts": {"lane_bytes": {"class": "O(N)"}}},
    "one_dtype_probe": {"facts": {"lane_bytes": {"class": "O(N)"}}},
}
