"""fleet.useful_rounds: the rounds each tenant needed (the wave's steps[t]) over
the rounds the wave computed (the delivery kernel's launches in the traced
stretch), averaged over the traced waves' tenants, in %."""

from benchmark import readers


def read(run):
    rounds = readers.traced_rounds_per_request(run)
    if rounds is None:
        return None
    steps = [s for r in run.traced for s in r["tenant_steps"]]
    return 100.0 * sum(steps) / len(steps) / rounds
