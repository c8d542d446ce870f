"""delivery_roofline.bootstrap: the delivery kernel's share of its roofline
(benchmark/roofline.py) over the traced stretch, in %."""

from benchmark import readers


def read(run):
    return readers.delivery_roofline(run)
