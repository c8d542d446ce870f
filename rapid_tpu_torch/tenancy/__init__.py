"""Multi-tenant batched serving (port of ``rapid_tpu/tenancy``): step
hundreds of independent clusters per round.

``fleet`` holds the batched engine: :class:`~rapid_tpu_torch.tenancy.fleet.TenantFleet`
runs the engine's round body over a leading tenant axis with per-tenant
knobs; ``autotune`` sweeps per-tenant H/L knobs online with the
khl_sensitivity conflict metric as the objective.
"""

from rapid_tpu_torch.tenancy.fleet import TenantFleet, TenantKnobs  # noqa: F401

__all__ = ["TenantFleet", "TenantKnobs"]
