"""round.kernels.bootstrap: device operations (kernels and copies) per round in the
fenced profiler session of the traced stretch."""

from benchmark import readers


def read(run):
    return readers.per_round(run, "device_ops")
