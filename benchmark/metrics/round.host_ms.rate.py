"""round.host_ms.rate: host self time of every host event inside the fenced
session but the waits for the device, per round, in ms."""

from benchmark import readers


def read(run):
    return readers.per_round(run, "host_self_s", 1e3)
