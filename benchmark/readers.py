"""What the metric readers (``benchmark/metrics/<metric>.py``) share: each
takes the run (:func:`benchmark.core.measure`'s namespace) and returns a
number, or None where the run holds nothing to read."""

from __future__ import annotations

import numpy as np


def latency_ms(run, q: float):
    """The ``q``-th percentile of the window's request wall times, in ms."""
    return float(np.percentile([r["seconds"] for r in run.records], q)) * 1e3


def churn_events(record) -> int:
    """The crashes and joins a request carried, summed over its tenants."""
    return sum(len(c.crash) + len(c.join) for c in record["churn"])


def churn_resolved_per_s(run):
    """Every churn event of the window's requests, summed over tenants, over
    the window's whole wall time (restores included). The count is the
    traffic's: how many view changes the program takes to resolve it does
    not enter, and the comparison holds each request to its events being
    resolved."""
    return sum(churn_events(r) for r in run.records) / run.window_s


def traced_rounds_per_request(run):
    """The rounds the program computed per request of the traced stretch
    (the delivery kernel's launches in its sessions over its requests)."""
    if run.profile is None or not run.profile["rounds"] or not run.traced:
        return None
    return run.profile["rounds"] / len(run.traced)


def per_round(run, key: str, scale: float = 1.0):
    """A quantity of the traced stretch's profile per round the program
    computed there."""
    if run.profile is None or not run.profile["rounds"]:
        return None
    return run.profile[key] / run.profile["rounds"] * scale


def delivery_roofline(run):
    """The delivery kernel's share of its roofline, in %: the summed bound
    of each captured call over the kernel's summed device time."""
    if run.profile is None or not run.profile["delivery_s"]:
        return None
    return 100.0 * run.profile["delivery_bound_s"] / run.profile["delivery_s"]


def device_idle(run):
    """The device's idle share of the traced stretch, in %."""
    if run.profile is None or not run.profile["wall_s"]:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["wall_s"])
