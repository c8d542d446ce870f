"""fleet.cuts_per_burst: the view changes the program committed per tenant
burst (its own count, the wave's cuts[t]), over the window's waves."""


def read(run):
    bursts = sum(len(r["churn"]) for r in run.records)
    return sum(r["view_changes"] for r in run.records) / bursts
