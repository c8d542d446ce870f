"""view_change_p95_ms: 95th percentile of the request wall times over all requests."""

from benchmark import readers


def read(run):
    return readers.latency_ms(run, 95)
