"""Scenario geometry and settings profiles (port of the jax-free helpers of
``rapid_tpu/sim/scenario.py``: ``endpoints_for``, ``sim_settings``,
``HIER_SIM_COHORT_SIZE`` and ``hier_sim_settings``). ``SimHarness``,
``ScenarioRunner`` and ``RunResult`` run the host stack and are not ported.
"""

from __future__ import annotations

from typing import List

from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import Endpoint


def endpoints_for(seed: int, n_slots: int) -> List[Endpoint]:
    """THE slot->endpoint derivation for generated scenarios — one
    definition, shared by the runner and by family generators that need to
    reason about endpoint-dependent structure (the hierarchical families
    compute the cohort map of the initial cluster to pick delegates and
    cross-cohort links deterministically)."""
    return [
        Endpoint(f"10.83.{seed % 250}.{i % 250}", 7800 + i)
        for i in range(n_slots)
    ]


def sim_settings() -> Settings:
    """The chaos-simulation settings profile: reference protocol defaults,
    with the anti-entropy idle pull fast enough that members healed out of a
    symmetric partition re-join the configuration within a few simulated
    seconds (the 30 s production default would dominate every scenario's
    convergence tail)."""
    settings = Settings()
    settings.config_sync_idle_interval_ms = 2_000
    return settings


#: Cohort size for hierarchical simulation profiles: 4 over the shared
#: 8-member geometry gives exactly two cohorts — the smallest topology where
#: the global reconfiguration tier does real work (cross-cohort stitching,
#: delegate failover) while every cohort stays big enough to self-detect.
HIER_SIM_COHORT_SIZE = 4


def hier_sim_settings() -> Settings:
    """The chaos settings profile for two-level hierarchical membership:
    the flat sim profile plus cohort mode."""
    settings = sim_settings()
    settings.hier_target_cohort_size = HIER_SIM_COHORT_SIZE
    return settings
