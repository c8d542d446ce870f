"""Two-level hierarchical membership (ROADMAP item 3).

Flat Rapid fans every alert and consensus vote out O(N) cluster-wide; at
planet scale that is the wall. This package lifts the device engine's cohort
idea into the host protocol, following the two-tier split of "Fast Raft for
Hierarchical Consensus" (arXiv:2506.17793) and the small-reconfiguration-tier
stitching of "Reconfigurable Atomic Transaction Commit" (arXiv:1906.01365):

- :mod:`rapid_tpu_torch.hier.cohorts` — a deterministic, seeded cohort map over
  the membership view (rebalanced only at reconfiguration) plus
  cohort-scoped expander monitoring rings;
- :mod:`rapid_tpu_torch.hier.broadcast` — the cohort-scoped broadcaster (alert
  batches and cohort fast-round votes fan out O(cohort), not O(N));
- :mod:`rapid_tpu_torch.hier.service` — :class:`HierMembershipService`: the
  cohort-local fast path (cut detection + Fast Paxos inside the cohort) and
  the global reconfiguration tier (a small delegate committee running the
  existing Fast-Paxos/classic machinery over cohort cut proposals,
  serializing them into the single cluster-wide configuration chain).

Every node still observes strongly-consistent, totally-ordered view changes
— the chain-consistency oracle of :mod:`rapid_tpu_torch.sim.oracles` holds
unchanged over the hierarchy.
"""

from rapid_tpu_torch.hier.cohorts import CohortMap, CohortTopology
from rapid_tpu_torch.hier.broadcast import CohortBroadcaster
from rapid_tpu_torch.hier.service import HierMembershipService

__all__ = [
    "CohortMap",
    "CohortTopology",
    "CohortBroadcaster",
    "HierMembershipService",
]
