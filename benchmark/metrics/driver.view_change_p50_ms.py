"""driver.view_change_p50_ms: median request wall time, injection to the
committed view. It swings with the share of the window in which the host runs
slow, so it is read per layer; ``view_change_p95_ms`` is the cell's tail."""

from benchmark import readers


def read(run):
    return readers.latency_ms(run, 50)
