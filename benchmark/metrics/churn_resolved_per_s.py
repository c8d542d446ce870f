"""churn_resolved_per_s: crashes and joins of the window's requests, summed over
tenants, per s of the window."""

from benchmark import readers


def read(run):
    return readers.churn_resolved_per_s(run)
