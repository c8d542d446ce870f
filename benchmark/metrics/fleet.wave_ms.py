"""fleet.wave_ms: the window's wall time over the waves it ran, in ms."""


def read(run):
    return run.window_s / len(run.records) * 1e3
