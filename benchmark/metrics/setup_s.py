"""setup_s: process start to the first measured request, in s."""


def read(run):
    return run.setup_s
