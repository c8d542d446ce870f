"""Two-level hierarchical membership: the part the port needs (port of
``rapid_tpu/hier``).

Only the deterministic cohort map is ported
(:mod:`rapid_tpu_torch.hier.cohorts`): the hierarchical chaos families aim
their faults at its cohorts, and the fleet chaos compiler maps it onto the
engine's receiver-cohort axis. The cohort-scoped monitoring rings, the
broadcaster and the hierarchical membership service run the host protocol,
which the port does not have.
"""

from rapid_tpu_torch.hier.cohorts import COMMITTEE_PER_COHORT, CohortMap, cohort_key

__all__ = ["COMMITTEE_PER_COHORT", "CohortMap", "cohort_key"]
