"""device.idle.rate: 1 - device busy time over the fenced session's wall, in %."""

from benchmark import readers


def read(run):
    return readers.device_idle(run)
