"""Multi-rank jobs of the port's sharded engine on CPU gloo groups, for
``tests/test_torch_parallel.py``.

A job is ``world`` spawned processes that rendezvous through a file in the
test's ``tmp_path`` (``initialize_multihost("file://...")``, never a fixed
port), build the meshes of their plan, drive every scenario of it through
the port's sharded entry points, and write what they saw (whole lanes
gathered with ``full_pytree``, the rounds and the collective log) to one
pickle per rank. :func:`reference` drives the same scenario through the
unsharded engine in the calling process. Only torch and the port are
imported here: the spawned interpreters never load JAX.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

#: Scenario -> (VirtualCluster.create args, kwargs, set-up, drive, target / rounds).
#: Every slot count divides 4 and every cohort count 2 (the meshes below).
STEP_ROUNDS = 8
TRACE_RING = 6


def _host(lane):
    """A lane of either package as numpy."""
    return np.asarray(lane.cpu() if isinstance(lane, torch.Tensor) else lane)


def _roundrobin_crash(victims):
    def setup(vc):
        vc.assign_cohorts_roundrobin()
        vc.crash(victims)
    return setup


def _multi_cut(vc):
    vc.assign_cohorts_roundrobin()
    vc.crash([7, 31])
    vc.stagger_fd_counts(np.random.default_rng(5), spread_rounds=8)
    vc.inject_join_wave(list(range(60, 72)))


def _join(vc):
    vc.assign_cohorts_roundrobin()
    vc.inject_join_wave(list(range(48, 60)))


def _contested(vc):
    cohort_of = np.zeros(120, dtype=np.int32)
    cohort_of[80:] = 1
    vc.assign_cohorts(cohort_of)
    vc.crash([10, 60])
    rx = np.zeros((2, 120), dtype=bool)
    rx[1, _host(vc.state.obs_idx)[:, 60]] = True
    vc.set_rx_block(rx)


def _partitioned(vc):
    # Coordinators racing (two), the higher-ranked one heard by nobody.
    n, victim = 60, 25
    cohort_of = np.zeros(n, dtype=np.int32)
    cohort_of[40:] = 1
    vc.assign_cohorts(cohort_of)
    vc.crash([victim])
    rx = np.zeros((2, n), dtype=bool)
    rx[1, _host(vc.state.obs_idx)[:, victim]] = True
    rx[:, 59] = True
    vc.set_rx_block(rx)


def _churn(vc):
    vc.assign_cohorts_roundrobin()
    rng = np.random.default_rng(3)
    vc.stagger_fd_counts(rng, spread_rounds=3)
    vc.crash(rng.choice(240, size=6, replace=False))
    vc.inject_join_wave(list(range(240, 246)))


SCENARIOS = {
    "crash": ((60,), dict(n_slots=64, fd_threshold=2, seed=0, cohorts=8),
              _roundrobin_crash([3, 17, 40]), "step", STEP_ROUNDS),
    "crash_compact": ((60,), dict(n_slots=64, fd_threshold=2, seed=0, cohorts=8, compact=True),
                      _roundrobin_crash([3, 17, 40]), "step", STEP_ROUNDS),
    "multi_cut": ((60,), dict(n_slots=72, cohorts=16, fd_threshold=2, seed=11,
                              delivery_spread=1), _multi_cut, "wave", 70),
    "join": ((48,), dict(n_slots=64, fd_threshold=2, seed=1, delivery_spread=1, cohorts=4),
             _join, "wave", 60),
    "contested": ((120,), dict(fd_threshold=2, seed=11), _contested, "step", 24),
    "partitioned": ((60,), dict(h=7, l=3, fd_threshold=2, seed=13, fallback_rounds=3,
                                concurrent_coordinators=2), _partitioned, "step", 24),
    "jitter": ((256,), dict(cohorts=40, fd_threshold=2, seed=3, delivery_spread=3),
               _roundrobin_crash([7, 100, 201]), "wave", 253),
    "crash_telem": ((60,), dict(n_slots=64, fd_threshold=2, seed=0, cohorts=8, telemetry=True),
                    _roundrobin_crash([3, 17, 40]), "telem", STEP_ROUNDS),
    "crash_trace": ((60,), dict(n_slots=64, fd_threshold=2, seed=6, cohorts=8, telemetry=True,
                                trace=TRACE_RING), _roundrobin_crash([2, 7]), "trace", STEP_ROUNDS),
    "join_telem": ((48,), dict(n_slots=64, fd_threshold=2, seed=1, delivery_spread=1, cohorts=4,
                               telemetry=True), _join, "wave_telem", 60),
    # The audit's geometry: 64 cohorts (two words), spread 2, a 5% churn.
    "audit": ((240,), dict(n_slots=256, cohorts=64, fd_threshold=2, delivery_spread=2, seed=0,
                           concurrent_coordinators=2), _churn, "wave", 240),
}
FLEET_TENANTS = 4


def _port_create(*args, **kwargs):
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    return VirtualCluster.create(*args, device="cpu", **kwargs)


def build(name, create=_port_create):
    """The scenario's cluster, set up; ``create``: a ``VirtualCluster.create``
    (the port's on the CPU by default, or the JAX package's)."""
    args, kwargs, setup, _, _ = SCENARIOS[name]
    vc = create(*args, **kwargs)
    setup(vc)
    return vc


def fleet_clusters(create=_port_create):
    """Four 64-slot tenants with different victims and knobs, and each
    tenant's target."""
    clusters, targets = [], []
    for i in range(FLEET_TENANTS):
        vc = create(60, n_slots=64, h=9 - i % 2, l=4 - i % 2, fd_threshold=2, seed=20 + i,
                    cohorts=4, delivery_spread=1)
        vc.assign_cohorts_roundrobin()
        vc.crash([1 + i, 30 + i])
        if i % 2:
            vc.inject_join_wave([60, 61])
        clusters.append(vc)
        targets.append(58 + 2 * (i % 2))
    return clusters, targets


def build_fleet():
    from rapid_tpu_torch.tenancy import TenantFleet

    clusters, targets = fleet_clusters()
    return TenantFleet.from_clusters(clusters), targets


def _np(tree):
    """Every lane of a tree as numpy at the JAX package's dtypes (None stays
    None)."""
    from rapid_tpu_torch.convert import state_to_numpy

    return None if tree is None else state_to_numpy(tree)


def _config_id(state) -> int:
    from rapid_tpu_torch import _u32

    hi, lo = _u32.widen(torch.stack([state.config_hi.reshape(()), state.config_lo.reshape(())])).tolist()
    return (hi << 32) | lo


def reference(name):
    """The scenario through the unsharded port: a dict of what its drive
    saw (rounds, results, whole lanes)."""
    from rapid_tpu_torch.models.virtual_cluster import engine_step, run_until_membership

    vc = build(name)
    _, _, _, drive, arg = SCENARIOS[name]
    cfg, state, faults = vc.cfg, vc.state, vc.faults
    telem, trace = vc.telem, vc.trace_ring
    out = {}
    if drive in ("step", "telem", "trace"):
        rounds = []
        for _ in range(arg):
            state, events, decided, telem, trace = engine_step(cfg, state, faults, telem, trace)
            rounds.append((bool(decided), _config_id(state), events.winner_mask.numpy().copy()))
        out["rounds"] = rounds
    else:
        state, steps, cuts, resolved, sizes, telem, _ = run_until_membership(
            cfg, state, faults, arg, 192, 8, 1, telem
        )
        out["wave"] = (steps, cuts, resolved, tuple(sizes) + (-1,) * (8 - len(sizes)))
    out["state"] = _np(state)
    out["telem"] = _np(telem) if drive in ("telem", "trace", "wave_telem") else None
    out["trace"] = _np(trace) if drive == "trace" else None
    return out


def fleet_reference():
    from rapid_tpu_torch.tenancy.fleet import fleet_step, fleet_wave

    out = {}
    fleet, targets = build_fleet()
    state = fleet.state
    for _ in range(STEP_ROUNDS):
        state, _, _, _ = fleet_step(fleet.cfg, state, fleet.faults, fleet.knobs)
    out["fleet_step"] = _np(state)
    fleet, targets = build_fleet()
    t = torch.tensor(targets, dtype=torch.int32)
    state, *res, _, _ = fleet_wave(fleet.cfg, fleet.state, fleet.faults, fleet.knobs, t, 40, 8,
                                   torch.ones_like(t))
    out["fleet_wave"] = (_np(state), [r.numpy().copy() for r in res])
    return out


def run_sharded(mesh, name):
    """The scenario through the sharded entry points on ``mesh``: what
    :func:`reference` returns, with the rank's collective log."""
    from rapid_tpu_torch.parallel import mesh as pm

    vc = build(name)
    _, _, _, drive, arg = SCENARIOS[name]
    cfg = vc.cfg
    state, faults = pm.shard_state(vc.state, mesh), pm.shard_faults(vc.faults, mesh)
    telem = pm.shard_pytree(vc.telem, pm.telemetry_shardings(mesh), mesh)
    trace = pm.shard_pytree(vc.trace_ring, pm.trace_shardings(mesh), mesh)
    out = {}
    if drive in ("step", "telem", "trace"):
        fn = {"step": pm.make_sharded_step, "telem": pm.make_sharded_step_telem,
              "trace": pm.make_sharded_step_trace}[drive](cfg, mesh)
        rounds = []
        for _ in range(arg):
            if drive == "step":
                state, events = fn(state, faults)
            elif drive == "telem":
                state, telem, events = fn(state, telem, faults)
            else:
                state, telem, trace, events = fn(state, telem, trace, faults)
            winner = pm.full_pytree(events).winner_mask
            rounds.append((bool(events.decided.to_local()), _config_id(pm.local_tree(state)),
                           winner.numpy().copy()))
        out["rounds"] = rounds
    elif drive == "wave":
        fn = pm.make_sharded_wave(cfg, mesh)
        state, *wave = fn(state, faults, arg, 192, 1)
        out["wave"] = tuple(wave)
    else:
        fn = pm.make_sharded_wave_telem(cfg, mesh)
        state, telem, *wave = fn(state, telem, faults, arg, 192, 1)
        out["wave"] = tuple(wave)
    out["state"] = _np(pm.full_pytree(state))
    out["telem"] = _np(pm.full_pytree(telem)) if drive in ("telem", "trace", "wave_telem") else None
    out["trace"] = _np(pm.full_pytree(trace)) if drive == "trace" else None
    out["log"] = fn.context.log
    return out


def run_fleet_sharded(mesh):
    from rapid_tpu_torch.parallel import mesh as pm
    from rapid_tpu_torch.tenancy.fleet import make_fleet_step, make_fleet_wave

    out = {}
    fleet, targets = build_fleet()
    step = make_fleet_step(fleet.cfg, mesh)
    state = pm.shard_fleet_state(fleet.state, mesh)
    faults = pm.shard_fleet_faults(fleet.faults, mesh)
    for _ in range(STEP_ROUNDS):
        state, _ = step(state, faults, fleet.knobs)
    out["fleet_step"] = _np(pm.full_pytree(state))
    out["fleet_step_log"] = step.context.log
    fleet, targets = build_fleet()
    wave = make_fleet_wave(fleet.cfg, mesh)
    t = torch.tensor(targets, dtype=torch.int32)
    state, *res = wave(pm.shard_fleet_state(fleet.state, mesh),
                       pm.shard_fleet_faults(fleet.faults, mesh), fleet.knobs, t, 40,
                       torch.ones_like(t))
    res = pm.full_pytree(_Results(*res))
    out["fleet_wave"] = (_np(pm.full_pytree(state)), [r.numpy().copy() for r in res])
    out["fleet_wave_log"] = wave.context.log
    return out


class _Results(NamedTuple):
    steps: torch.Tensor
    cuts: torch.Tensor
    resolved: torch.Tensor
    sizes: torch.Tensor


def spec_of(placements, ndim, mesh_dim_names):
    """Placements as a spec: per tensor dimension, the mesh axes that split
    it (None, one name, or a tuple of names)."""
    from torch.distributed.tensor import Shard

    axes = [[] for _ in range(ndim)]
    for name, p in zip(mesh_dim_names, placements):
        if isinstance(p, Shard):
            axes[p.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a) for a in axes)


def placements_of(mesh):
    """Every rule-table function's placements on ``mesh``, as specs."""
    from rapid_tpu_torch.models.state import initial_telemetry, initial_trace
    from rapid_tpu_torch.parallel import mesh as pm
    from rapid_tpu_torch.tenancy.fleet import knob_shardings

    vc = build("crash_trace")
    trees = {"state": vc.state, "faults": vc.faults,
             "telem": initial_telemetry(vc.cfg, "cpu"), "trace": initial_trace(vc.cfg, "cpu")}
    fns = {"state": (pm.state_shardings, pm.fleet_state_shardings),
           "faults": (pm.fault_shardings, pm.fleet_fault_shardings),
           "telem": (pm.telemetry_shardings, pm.fleet_telemetry_shardings),
           "trace": (pm.trace_shardings, pm.fleet_trace_shardings)}
    names = mesh.mesh_dim_names
    out = {}
    for key, tree in trees.items():
        single, fleet = (fn(mesh) for fn in fns[key])
        out[key] = {f: spec_of(p, x.dim(), names) for f, p, x in zip(tree._fields, single, tree)}
        out["fleet_" + key] = {f: spec_of(p, x.dim() + 1, names)
                               for f, p, x in zip(tree._fields, fleet, tree)}
    out["knobs"] = {f: spec_of(p, 1, names) for f, p in knob_shardings(mesh)._asdict().items()}
    return out


def sharding_errors(mesh):
    """The messages :func:`shard_pytree` raises for lanes that do not
    divide ``mesh`` (a 2-D or 3-D mesh with no axis of size 1): 50 slots
    and 5 cohorts, a packed 40-slot lane, and a fleet of 3 tenants."""
    from rapid_tpu_torch.models.state import pack_masks
    from rapid_tpu_torch.parallel import mesh as pm

    out = {}

    def caught(key, fn):
        try:
            fn()
        except pm.ShardingShapeError as err:
            out[key] = str(err)

    if len(mesh.mesh_dim_names) == 2:
        caught("slots", lambda: pm.shard_state(
            _port_create(50, n_slots=51, fd_threshold=2, seed=0, cohorts=5).state, mesh))
        caught("packed", lambda: pm.shard_state(
            pack_masks(_port_create(40, fd_threshold=2, seed=0, cohorts=2).state), mesh))
        caught("no_mesh", lambda: pm.shard_pytree(build("crash").state, pm.state_shardings(mesh)))
        vc = _port_create(50, n_slots=pm.pad_to_multiple(51, 2), fd_threshold=2, seed=0,
                          cohorts=pm.pad_to_multiple(5, 2))
        out["padded_shape"] = tuple(pm.shard_state(vc.state, mesh).report_bits.shape)
    else:
        from rapid_tpu_torch.tenancy import TenantFleet

        clusters, _ = fleet_clusters()
        caught("tenants", lambda: pm.shard_fleet_state(
            TenantFleet.from_clusters(clusters[:3]).state, mesh))
    return out


def _worker(rank, world, store, out_dir, plan):
    import torch.distributed as dist

    from rapid_tpu_torch.parallel import multihost
    from rapid_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    multihost.initialize_multihost(f"file://{store}", world, rank, device_type="cpu")
    results = {"multihost": {
        "is_coordinator": multihost.is_coordinator(),
        "local_device_count": multihost.local_device_count(),
        "global_mesh": (tuple(multihost.global_mesh().mesh_dim_names),
                        multihost.global_mesh().size()),
    }}
    for shape, names in plan:
        mesh = make_mesh(shape=shape, device_type="cpu")
        tasks = {"fleet": run_fleet_sharded, "placements": placements_of,
                 "errors": sharding_errors}
        for name in names:
            task = tasks.get(name)
            results[(shape, name)] = task(mesh) if task else run_sharded(mesh, name)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


def start_job(world, tmp, plan):
    """Spawn the ``world`` ranks of one job (not waiting); ``plan`` is a
    list of (mesh shape, scenario names, "fleet" among them). Returns the
    process context, whose ``join()`` ends the job."""
    import torch.multiprocessing as mp

    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    return mp.start_processes(
        _worker, args=(world, str(tmp / "store"), str(tmp), plan), nprocs=world,
        join=False, start_method="spawn",
    )


def finish_job(context, world, tmp):
    """Wait for a job and return each rank's results."""
    while not context.join():
        pass
    return [pickle.loads((Path(tmp) / f"rank{r}.pkl").read_bytes()) for r in range(world)]
