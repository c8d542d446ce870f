"""The benchmark's one traffic generator: it reads a mix's data file
(``benchmark/traffic/<mix>.json``) and draws every input of a run from the
run's seed.

The ``burst`` loop reads a mix (``"loop"`` in the file): each request
crashes ``crash`` live members and joins ``join`` spare slots of every
tenant at once, and the port resolves the burst to its committed view. The
other keys of a mix file: ``max_steps``, ``max_cuts`` and ``min_cuts`` (the
driver's budget), ``warmup`` (requests made in set-up), ``ring_share`` (the
share of requests whose K rings are compared) and ``trace_requests``
(requests of the traced stretch). The failure detectors' stagger is drawn
once, at set-up, and every request starts from it.

The cluster's ring keys and identities are drawn from the run seed too
(:func:`identities`), by the same four draws with which the program builds a
synthetic cluster from that seed, so the reference gets the same inputs.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

#: The run seed is any whole number; its low 64 bits seed every stream.
SEED_MASK = (1 << 64) - 1


def rng(seed: int, *path: int) -> np.random.Generator:
    """The numpy stream of one use (``path``) of the run seed."""
    return np.random.default_rng([seed & SEED_MASK, *path])


def cluster_seed(seed: int, tenant: int) -> int:
    """The seed of tenant ``tenant``'s ring keys and identities."""
    return int(rng(seed, 0, tenant).integers(1 << 62))


def identities(cluster_seed_: int, n: int, k: int) -> Tuple[np.ndarray, ...]:
    """``(key_hi [k, n], key_lo [k, n], id_hi [n], id_lo [n])`` uint32 of the
    cluster of ``n`` slots built from ``cluster_seed_``."""
    draw = np.random.default_rng(cluster_seed_)
    key_hi = draw.integers(0, 2**32, size=(k, n), dtype=np.uint32)
    key_lo = draw.integers(0, 2**32, size=(k, n), dtype=np.uint32)
    id_hi = draw.integers(0, 2**32, size=(n,), dtype=np.uint32)
    id_lo = draw.integers(0, 2**32, size=(n,), dtype=np.uint32)
    return key_hi, key_lo, id_hi, id_lo


class Churn(NamedTuple):
    """One tenant's churn: slots crashed and slots joined."""

    crash: np.ndarray
    join: np.ndarray


def burst(mix: dict, config: dict, seed: int, request: int) -> List[Churn]:
    """Request ``request``'s churn, one entry per tenant: ``mix["crash"]``
    members drawn without replacement, and the first ``mix["join"]`` spare
    slots."""
    n, slots = config["n_members"], config["n_slots"]
    if n + mix["join"] > slots:
        raise ValueError(f"{mix['join']} joins do not fit {slots - n} spare slots")
    draw = rng(seed, 1, request)
    joined = np.arange(n, n + mix["join"], dtype=np.int64)
    return [Churn(np.sort(draw.choice(n, size=mix["crash"], replace=False)), joined)
            for _ in range(config["tenants"])]
