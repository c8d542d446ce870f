"""join.admitted_per_cut: joiners a committed view change admits: the joiners
the program's unprofiled inject_join_wave dispatch records injected over the
cuts its unprofiled run_until_membership records committed
(rapid_tpu_torch.utils.dispatch.records), counted from the first join wave the
ring holds, so that each wave is paired with the run that drives it. A run is
judged correct only with every joiner admitted and none pending, so in a
correct run the joiners injected are the joiners admitted. None where the
program keeps no such record."""


def read(run):
    try:
        from rapid_tpu_torch.utils.dispatch import records
    except ImportError:
        return None
    ring = [r for r in records() if not r.profiled]
    first = next((i for i, r in enumerate(ring) if r.entry == "inject_join_wave"), None)
    if first is None:
        return None
    ring = ring[first:]
    cuts = sum(r.cuts for r in ring if r.entry == "run_until_membership")
    if not cuts:
        return None
    return sum(r.joiners for r in ring if r.entry == "inject_join_wave") / cuts
