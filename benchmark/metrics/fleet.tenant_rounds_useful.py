"""fleet.tenant_rounds_useful: the rounds tenants stepped over the rounds the
lockstep fleet wave computed for every tenant, in %, summed over the
program's unprofiled fleet_wave dispatch records
(rapid_tpu_torch.utils.dispatch.records), with no device trace. None where
the program keeps no such record."""


def read(run):
    try:
        from rapid_tpu_torch.utils.dispatch import records
    except ImportError:
        return None
    waves = [r for r in records() if r.entry == "fleet_wave" and not r.profiled]
    computed = sum(r.tenant_rounds_computed for r in waves)
    if not computed:
        return None
    return 100.0 * sum(r.tenant_rounds_active for r in waves) / computed
