"""Online per-tenant K/H/L autotune: the knob sweep AS a tenant fleet (port
of ``rapid_tpu/tenancy/autotune.py``).

B tenants run the IDENTICAL scenario (same seed, same victims, same
delivery jitter), one knob setting per tenant, one fleet round per round.
Score per knob: ``(conflict, rounds)`` lexicographic. A conflict is the
khl_sensitivity metric at tenant grain: the first decided cut is not the
full victim set. A clean setting beats any conflicted one; among clean
settings, faster decisions win.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
from rapid_tpu_torch.tenancy.fleet import TenantFleet

#: The default candidate grid: the paper's H sweep at sane L, highest-H
#: first (grid order is the tie-break, so equal scores prefer the safest
#: watermark).
DEFAULT_KNOB_GRID: Tuple[Tuple[int, int], ...] = (
    (9, 4), (8, 3), (7, 2), (6, 2), (5, 1),
)


def sweep_khl(
    n: int = 256,
    f: int = 4,
    knob_grid: Sequence[Tuple[int, int]] = DEFAULT_KNOB_GRID,
    k: int = 10,
    cohorts: int = 8,
    seed: int = 0,
    fd_threshold: int = 1,
    delivery_spread: int = 8,
    stagger_rounds: int = 2,
    max_rounds: int = 96,
    device=None,
) -> Dict:
    """One batched knob sweep: ``len(knob_grid)`` tenants, identical
    F-failure scenario, per-tenant (H, L). Returns the autotune artifact::

        {"n", "f", "seed", "tenants", "objective",
         "per_knob": {"H/L": {"decided", "rounds", "conflict"}},
         "best_knob": "H/L" | None}

    ``best_knob`` is None only when no candidate decided in budget. Runs on
    CUDA unless ``device`` names another device."""
    knob_grid = [tuple(kn) for kn in knob_grid]
    rng = np.random.default_rng(seed + 1000)
    victims = np.sort(rng.choice(n, size=f, replace=False))

    clusters = []
    for h, l in knob_grid:
        vc = VirtualCluster.create(
            n, k=k, h=h, l=l, cohorts=cohorts, fd_threshold=fd_threshold,
            seed=seed, delivery_spread=delivery_spread, device=device,
        )
        vc.assign_cohorts_roundrobin()
        if stagger_rounds:
            # Identical per-edge detection jitter across tenants: the same
            # rng seed per tenant means ONLY the knobs differ.
            vc.stagger_fd_counts(np.random.default_rng(seed + 2000), stagger_rounds)
        vc.crash(victims)
        clusters.append(vc)
    fleet = TenantFleet.from_clusters(clusters)

    b = fleet.b
    victims_mask = np.zeros(fleet.cfg.n, dtype=bool)
    victims_mask[victims] = True
    first_winner = np.zeros((b, fleet.cfg.n), dtype=bool)
    decided_round = np.full(b, -1, dtype=np.int64)
    for round_idx in range(max_rounds):
        events = fleet.step()
        decided = events.decided.cpu().numpy()  # host-read-ok: the sweep's per-round decision record
        fresh = decided & (decided_round < 0)
        if fresh.any():
            decided_round[fresh] = round_idx + 1
            first_winner[fresh] = events.winner_mask.cpu().numpy()[fresh]  # host-read-ok: first winners, once per tenant
        if (decided_round >= 0).all():
            break

    per_knob: Dict[str, Dict] = {}
    scores = []
    for i, (h, l) in enumerate(knob_grid):
        decided = bool(decided_round[i] >= 0)
        conflict = decided and bool((first_winner[i] != victims_mask).any())
        per_knob[f"{h}/{l}"] = {
            "decided": decided,
            "rounds": int(decided_round[i]) if decided else None,
            "conflict": conflict if decided else None,
        }
        if decided:
            # Tie-break by GRID ORDER (i), not by knob name: equal scores
            # prefer the caller's safest-first ordering.
            scores.append(((int(conflict), int(decided_round[i])), i, f"{h}/{l}"))
    best: Optional[str] = min(scores)[2] if scores else None
    return {
        "n": n,
        "f": f,
        "seed": seed,
        "tenants": b,
        "objective": "first-cut conflict (khl_sensitivity metric), then decision rounds",
        "per_knob": per_knob,
        "best_knob": best,
    }
