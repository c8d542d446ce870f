"""The loops that drive the program's entry points, one request at a time,
chosen by the mix file's ``"loop"``. Each loop draws the request, restores
the settled state (not timed) and returns the timed part, a function that
makes the request and returns its record.

- ``burst``: inject the request's crashes and joins and drive the committed
  view change, by ``VirtualCluster.run_until_membership`` for a cluster and
  by one ``TenantFleet`` wave (``fleet_wave``) for a fleet.

A record holds the request's wall seconds, the view changes the program
says it committed, the rounds each tenant needed, the counted host reads it
made, its answer (the committed view's lanes; :func:`finish` copies them to
the host) and the churn it carried, which the reference reads.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generator
from benchmark.targets import RING_LANES, host_answer


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(target, rings: bool, body):
    """``body()``'s record, timed from a synchronized device to a
    synchronized device, with the host reads it made and the answer's lanes
    on the device (:func:`finish` copies them to the host)."""
    from rapid_tpu_torch import _host

    def request() -> dict:
        sync(target.device)
        reads = _host.read.count
        start = time.perf_counter()
        record = body()
        sync(target.device)
        record["seconds"] = time.perf_counter() - start
        record["host_reads"] = _host.read.count - reads
        record["answer"] = target.answer(RING_LANES if rings else ())
        return record

    return request


def finish(record: dict) -> dict:
    """The record with its answer copied to the host, after the request:
    a run holds no request's lanes on the device, so the allocator's pool
    stays as the warm-up left it."""
    record["answer"] = host_answer(record["answer"])
    return record


def burst(target, mix: dict, seed: int, index: int, rings: bool):
    """Request ``index`` of a burst mix."""
    config, system = target.config, target.system
    churn = generator.burst(mix, config, seed, index)
    members = [config["n_members"] - len(c.crash) + len(c.join) for c in churn]
    wave = dict(max_steps=mix["max_steps"], max_cuts=mix["max_cuts"], min_cuts=mix["min_cuts"])
    if target.fleet and mix["join"]:
        raise ValueError("a fleet's burst carries crashes only")
    pairs = np.stack([np.repeat(np.arange(len(churn)), [len(c.crash) for c in churn]),
                      np.concatenate([c.crash for c in churn])], 1)
    target.restore()

    def fleet_wave():
        system.stream_crash(pairs)
        steps, cuts, resolved, _ = system.run_until_membership(members, **wave)
        return {"view_changes": int(cuts.sum()), "tenant_steps": steps.tolist(),
                "resolved": resolved.tolist(), "churn": churn}

    def cluster_burst():
        system.crash(churn[0].crash)
        if mix["join"]:
            system.inject_join_wave(churn[0].join)
        steps, cuts, resolved, _ = system.run_until_membership(members[0], **wave)
        return {"view_changes": cuts, "tenant_steps": [steps], "resolved": [resolved],
                "churn": churn}

    return _timed(target, rings, fleet_wave if target.fleet else cluster_burst)


LOOPS = {"burst": burst}
