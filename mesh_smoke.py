#!/usr/bin/env python3
"""The port's sharded engine across several cards (``rapid_tpu_torch.parallel``
over NCCL, one rank per card).

Run from the root of a checkout on a machine with at least ``--ranks`` cards
(default 4): ``python3 mesh_smoke.py``. It builds the kernels once, spawns one
process per card (NCCL, a rendezvous file in a temporary directory, the
loopback interface for NCCL's bootstrap) and drives three of
``chip_smoke.py``'s paths at full size through the sharded entry points:

- the N=100,000 5% churn (phase 4's recipe, C=64) through
  ``make_sharded_wave`` on ``('cohort', 'nodes') = (1, R)`` and ``(2, R/2)``
  (each rank of the 2-D mesh holds 32 of the 64 cohorts, one whole word);
- the N=1,000,000 crash-1% point (phase 5, C=8) through ``make_sharded_step``
  to decision on ``('nodes',) = (R,)``;
- the 256x1,024 fleet's 96-round wave (phase 8) through ``make_fleet_wave``
  on ``('tenant', 'cohort', 'nodes') = (R, 1, 1)`` and ``(1, 1, R)``.

Each is held against the unsharded engine on rank 0's card, lane for lane
(the sharded state gathered whole with ``full_pytree``), with rounds, cuts,
sizes, host reads and delivery launches equal. Its wall ms (rank 0's clock
between barriers, a warm-up first) stands beside the unsharded run's, with
the collectives a round by site, kind and payload class. One JSON line per
path, the card's name and power limit, and last ``{"ok": true, "device":
{...}}``. Any mismatch or failed rank exits non-zero; so does a machine with
fewer cards than ranks. ``chip_smoke.py`` is the one-card proof; this script
is the multi-card one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch

#: (mesh shape as a function of the rank count R) per path.
MESHES = {
    "churn": lambda r: [(1, r), (2, r // 2)],
    "scale_point": lambda r: [None],
    "fleet_wave": lambda r: [(r, 1, 1), (1, 1, r)],
}


class _Results(NamedTuple):
    steps: torch.Tensor
    cuts: torch.Tensor
    resolved: torch.Tensor
    sizes: torch.Tensor


def _counted(dev, fn, barrier=True):
    """``fn()``'s result, its wall ms (between two barriers of all ranks
    with ``barrier``, else on this rank alone), and the delivery launches
    and host reads it made on this rank."""
    import torch.distributed as dist

    from rapid_tpu_torch import _host
    from rapid_tpu_torch.ops.kernels import delivery_new_bits

    torch.cuda.synchronize(dev)
    if barrier:
        dist.barrier()
    delivery_new_bits.launches, reads0 = 0, _host.read.count
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    if barrier:
        dist.barrier()
    ms = (time.perf_counter() - start) * 1e3
    return out, ms, delivery_new_bits.launches, _host.read.count - reads0


def _unsharded_on_rank0(dev, rank, build, run):
    """``run(build())`` on rank 0 alone, once to warm up and once counted
    (the build outside the clock), while the other ranks wait; None
    elsewhere."""
    import torch.distributed as dist

    out = None
    if rank == 0:
        run(build())
        built = build()
        out = _counted(dev, lambda: run(built), barrier=False)
    dist.barrier()
    return out


def _compare(want, got, what):
    import chip_smoke as cs

    cs.check(want[0] == got[0], f"{what}: sharded {got[0]} differs from unsharded {want[0]}")
    cs.check_same_lanes(got[1], want[1], what)


def churn(dev, rank, ranks, report):
    import chip_smoke as cs
    from rapid_tpu_torch.models.virtual_cluster import run_until_membership
    from rapid_tpu_torch.parallel.mesh import (
        full_pytree, make_mesh, make_sharded_wave, shard_faults, shard_state,
    )

    h = cs.HEADLINE

    def build():
        vc, _ = cs.churn_cluster(h["n"], h["n_join"], h["n_crash"], h["cohorts"], 4, dev)
        return vc

    def unsharded(vc):
        state, steps, cuts, resolved, sizes, _, _ = run_until_membership(
            vc.cfg, vc.state, vc.faults, h["n"], 384, 4, 1)
        return state, (steps, cuts, resolved, tuple(sizes) + (-1,) * (4 - len(sizes)))

    base = _unsharded_on_rank0(dev, rank, build, unsharded)
    if rank == 0:
        (state, result), ms, launches, reads = base
        want = (result, cs.plane_lanes(state))
        report["unsharded"] = dict(ms=ms, rounds=result[0], launches=launches, host_reads=reads)
    for shape in MESHES["churn"](ranks):
        mesh = make_mesh(shape=shape, device_type=dev.type)
        runs = []
        for _ in range(2):  # a warm-up, then the timed run
            vc = build()
            wave = make_sharded_wave(vc.cfg, mesh, max_cuts=4)
            state, faults = shard_state(vc.state, mesh), shard_faults(vc.faults, mesh)
            (state, *result), ms, launches, reads = _counted(
                dev, lambda: wave(state, faults, h["n"], 384, 1))
            runs.append(dict(ms=ms, launches=launches, host_reads=reads))
        lanes = cs.plane_lanes(full_pytree(state))
        if rank == 0:
            _compare(want, (tuple(result), lanes), f"churn on {shape}")
            cs.check(reads == report["unsharded"]["host_reads"], f"churn on {shape}: reads {reads}")
            cs.check(launches == result[0], f"churn on {shape}: {launches} launches")
            report[str(shape)] = dict(
                runs=runs, collectives=cs.collective_summary(wave.context, result[0], vc.cfg.n,
                                                             vc.cfg.c))


def scale_point(dev, rank, ranks, report):
    import chip_smoke as cs
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster, engine_step
    from rapid_tpu_torch.parallel.mesh import (
        full_pytree, make_mesh, make_sharded_step, shard_faults, shard_state,
    )

    n, cohorts = cs.SCALE["n"], cs.SCALE["cohorts"]

    def build(seed):
        vc = VirtualCluster.create(n, k=cs.HEADLINE["k"], h=9, l=4, cohorts=cohorts,
                                   fd_threshold=3, seed=seed,
                                   delivery_spread=cs.HEADLINE["spread"], device=dev)
        vc.assign_cohorts_roundrobin()
        vc.crash(np.random.default_rng(seed).choice(n, size=n // 100, replace=False))
        return vc

    def to_decision(advance, state):
        rounds, decided = 0, False
        while not decided and rounds < 96:
            state, decided = advance(state)
            rounds += 1
        return state, rounds

    def unsharded(vc):
        def advance(s):
            s, _, decided, _, _ = engine_step(vc.cfg, s, vc.faults)
            return s, decided

        return to_decision(advance, vc.state)

    base = _unsharded_on_rank0(dev, rank, lambda: build(8), unsharded)
    if rank == 0:
        (state, rounds), ms, launches, reads = base
        want = ((rounds,), cs.plane_lanes(state))
        report["unsharded"] = dict(ms=ms, rounds=rounds, launches=launches, host_reads=reads)
    mesh = make_mesh(device_type=dev.type)
    for _ in range(2):  # a warm-up, then the timed run
        vc = build(8)
        step = make_sharded_step(vc.cfg, mesh)
        state, faults = shard_state(vc.state, mesh), shard_faults(vc.faults, mesh)

        def advance(s):
            s, _ = step(s, faults)
            return s, step.decided

        (state, rounds), ms, launches, reads = _counted(dev, lambda: to_decision(advance, state))
    lanes = cs.plane_lanes(full_pytree(state))
    if rank == 0:
        _compare(want, ((rounds,), lanes), f"1M point on {(ranks,)}")
        cs.check(reads == report["unsharded"]["host_reads"], f"1M point: reads {reads}")
        report[str((ranks,))] = dict(
            ms=ms, rounds=rounds, launches=launches, host_reads=reads,
            collectives=cs.collective_summary(step.context, rounds, n, cohorts))


def fleet_wave(dev, rank, ranks, report):
    import chip_smoke as cs
    from rapid_tpu_torch.parallel.mesh import (
        full_pytree, make_mesh, shard_fleet_faults, shard_fleet_state,
    )
    from rapid_tpu_torch.tenancy import TenantFleet
    from rapid_tpu_torch.tenancy.fleet import fleet_wave as unsharded_wave
    from rapid_tpu_torch.tenancy.fleet import make_fleet_wave

    f = cs.FLEET
    clusters, targets = cs.fleet_clusters(f["tenants"], f["n"], f["n_extra"], f["cohorts"], 80_000,
                                          torch.device("cpu"))
    cpu = TenantFleet.from_clusters(clusters)
    target = torch.tensor(targets, dtype=torch.int32, device=dev)
    min_cuts = torch.ones_like(target)
    def unsharded(fleet):
        return unsharded_wave(fleet.cfg, fleet.state, fleet.faults, fleet.knobs, target,
                              f["max_steps"], 4, min_cuts)

    base = _unsharded_on_rank0(dev, rank, lambda: cs.fleet_on(cpu, dev), unsharded)
    if rank == 0:
        (state, *res, _, _), ms, launches, _ = base
        want = ([r.tolist() for r in res], cs.plane_lanes(state))
        report["unsharded"] = dict(ms=ms, launches=launches, view_changes=int(res[1].sum()))
    for shape in MESHES["fleet_wave"](ranks):
        mesh = make_mesh(shape=shape, device_type=dev.type)
        runs = []
        for _ in range(2):
            fleet = cs.fleet_on(cpu, dev)
            wave = make_fleet_wave(fleet.cfg, mesh, max_cuts=4)
            state = shard_fleet_state(fleet.state, mesh)
            faults = shard_fleet_faults(fleet.faults, mesh)
            (state, *res), ms, launches, _ = _counted(dev, lambda: wave(
                state, faults, fleet.knobs, target, f["max_steps"], min_cuts))
            runs.append(dict(ms=ms, launches=launches))
        whole = full_pytree(_Results(*res))
        lanes = cs.plane_lanes(full_pytree(state))
        if rank == 0:
            _compare(want, ([r.tolist() for r in whole], lanes), f"fleet wave on {shape}")
            cs.check(launches == f["max_steps"], f"fleet wave on {shape}: {launches} launches")
            report[str(shape)] = dict(
                runs=runs, collectives=cs.collective_summary(
                    wave.context, f["max_steps"], fleet.cfg.n, fleet.cfg.c, tenants=f["tenants"]))


PATHS = {"churn": churn, "scale_point": scale_point, "fleet_wave": fleet_wave}


def _worker(rank, ranks, store, out_dir, device_type):
    import torch.distributed as dist

    from rapid_tpu_torch.parallel.multihost import initialize_multihost

    try:
        initialize_multihost(f"file://{store}", ranks, rank, device_type=device_type)
        dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
        reports = {}
        for name, path in PATHS.items():
            reports[name] = {}
            start = time.perf_counter()
            path(dev, rank, ranks, reports[name])
            reports[name]["seconds"] = time.perf_counter() - start
        if rank == 0:
            with open(os.path.join(out_dir, "report.json"), "w") as f:
                json.dump(reports, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)  # the parent ends the other ranks


def run(ranks, device_type="cuda"):
    """Spawn the ranks and return rank 0's reports (raises if a rank
    failed)."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="mesh_smoke_")
    try:
        mp.start_processes(_worker, args=(ranks, os.path.join(tmp, "store"), tmp, device_type),
                           nprocs=ranks, start_method="spawn")
        with open(os.path.join(tmp, "report.json")) as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4, help="ranks, one card each (even)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.ranks:
        print(f"mesh_smoke: needs {args.ranks} CUDA cards", file=sys.stderr)
        return 2
    if args.ranks < 2 or args.ranks % 2:
        print("mesh_smoke: --ranks must be even and at least 2", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from rapid_tpu_torch import _build

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_IB_DISABLE", "1")
    start = time.perf_counter()
    _build.build_all()
    reports = run(args.ranks)
    for name, report in reports.items():
        cs.emit({"phase": f"mesh_{name}", "ranks": args.ranks, **report})
    cs.emit({"phase": "mesh_timing", "total_seconds": time.perf_counter() - start})
    print(cs.smi("name,power.limit"), flush=True)
    cs.emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                    "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
