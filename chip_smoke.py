#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rapid_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``, and imports neither JAX nor the ``rapid_tpu`` package.
Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. build: compile every ``rapid_tpu_torch/csrc/*.cu`` (one ``nvcc`` each,
   started together) and report the build time and ptxas's register report;
2. kernel: the delivery kernel against its plain PyTorch version on the
   card, bit for bit, at the headline shape (64 cohorts, K=10, n=102,500) in
   all three delay modes and at ragged small shapes, with timings and the
   kernel's bound;
3. engine: one seeded churn at N=4,096 with C=40 on the card and on the
   CPU; every lane of the final state and every returned count must match;
4. main path: the 5%-churn resolution at N=100,000 (``bench.py``'s recipe:
   2,500 crashes and 2,500 joins, 64 cohorts, spread 2, two racing
   coordinators), one warm-up and three timed samples on fresh state;
5. scale point: ``bench.py``'s crash-1% point at N=1,000,000 (8 cohorts,
   10,000 crashes, one ``run_to_decision``), a warm-up and one timed run;
6. kernel_fleet: the delivery kernel with a tenant axis against its plain
   version, bit for bit, at the fleet shape (256 tenants, 8 cohorts, K=10,
   n=1,044) with distinct per-tenant epochs in all three delay modes, and
   at a ragged shape, with timings and the bound;
7. fleet_engine: a fleet of 6 tenants (N=256, 262 slots, 40 cohorts, the
   three ``bench.py`` families, a knob mix) through ``run_until_membership``
   on the card and on the CPU: every stacked lane and result must match,
   each tenant must match its own single cluster on the card, and the wave
   loop must make no synchronizing call (``torch.cuda.set_sync_debug_mode``);
8. fleet_path: ``bench.py``'s fleet point on the port, 256 tenants x 1,024
   members resolved in one 96-round lockstep wave (telemetry off), a
   warm-up and three timed samples on fresh fleets, then one profiled wave.

The delivery kernel's launch count is zeroed just before each of the
paths 4, 5 and 8 and read just after. Then the kernels line, the card's
name and power limit from ``nvidia-smi``, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s of HBM; 67 TFLOP/s
# fp32 outside the tensor cores, which counts an FMA as two operations on
# 128 lanes per SM. Hopper has 64 INT32 lanes per SM, so its int32 issue
# peak is a quarter of that figure.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

HEADLINE = dict(n=100_000, n_join=2_500, n_crash=2_500, k=10, cohorts=64, spread=2)
TIMED_SAMPLES = 3
# bench.py's fleet point: B tenants of N members, n_extra = N // 50 extra
# slots, 8 cohorts, K=10, fd_threshold 3, spread 2, one 96-round wave.
FLEET = dict(tenants=256, n=1_024, n_extra=20, k=10, cohorts=8, spread=2, max_steps=96)
FLEET_TIMED_SAMPLES = 3


def check(cond, message):
    if not cond:
        raise RuntimeError(message)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=30, warmup=5, runs=3):
    """Milliseconds of one call of ``fn`` on the card: after ``warmup``
    calls, the median over ``runs`` of one pair of CUDA events around
    ``reps`` calls back to back, divided by ``reps``. Queued calls keep the
    device busy, so a short kernel's launch gap does not count."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def delivery_ops_per_draw(spread, permille):
    """Integer operations of one (cohort, slot, ring) draw, counted from
    csrc/delivery.cu: the blocked-bit test, age compare and accumulate (7);
    plus, when delays are drawn, the ring salt (2), a mix32 (8) and a modulus
    (1); plus, in the gated mode, the second stream's xor, mix32, modulus and
    compare (11) and the magnitude's add and select (2)."""
    ops = 7
    if spread > 0:
        ops += 11
        if permille < 1000:
            ops += 13
    return ops


def delivery_bound(c, k, n, spread, permille, t=1):
    """(bound_ms, bound_by) of one delivery call over ``t`` tenants: each
    input read once, the output written once, against the operations its
    draws make."""
    w = (c + 31) // 32
    nbytes = 4 * t * (w * k * n + k * n + 1 + c * n)
    ops = t * c * n * k * delivery_ops_per_draw(spread, permille)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def delivery_inputs(c, k, n, seed, dev, t=None):
    """Seeded delivery inputs for one cluster, or with ``t`` for a fleet of
    ``t`` tenants with distinct epochs."""
    from rapid_tpu_torch import _u32

    rng = np.random.default_rng(seed)
    w = (c + 31) // 32
    lead = () if t is None else (t,)
    blocked = rng.integers(0, 2**32, size=lead + (w * k, n), dtype=np.uint32)
    blocked &= rng.integers(0, 2**32, size=lead + (w * k, n), dtype=np.uint32)  # ~1/4 bits set
    age = rng.integers(-3, 6, size=lead + (k, n)).astype(np.int32)
    age[rng.random(lead + (k, n)) < 0.2] = -(1 << 30)  # edges that never fired
    epoch = [seed % 7] if t is None else rng.permutation(4 * t)[:t]
    return (
        _u32.from_numpy(blocked, dev),
        torch.from_numpy(age).to(dev),
        torch.tensor(epoch, dtype=torch.int32, device=dev),
    )


def phase_kernel(dev):
    from rapid_tpu_torch import _u32
    from rapid_tpu_torch.ops.kernels import delivery_new_bits, delivery_new_bits_ref

    k, n, c = HEADLINE["k"], HEADLINE["n"] + HEADLINE["n_join"], HEADLINE["cohorts"]
    modes = []
    for spread, permille in ((0, 1000), (2, 1000), (3, 300)):
        blocked, age, epoch = delivery_inputs(c, k, n, spread * 10 + 1, dev)
        args = (blocked, age, epoch, k, c, spread, permille)
        got, want = delivery_new_bits(*args), delivery_new_bits_ref(*args)
        torch.cuda.synchronize()
        err = int((_u32.widen(got) - _u32.widen(want)).abs().max())
        check(torch.equal(got, want), f"delivery kernel differs (spread={spread}, permille={permille})")
        bound_ms, bound_by = delivery_bound(c, k, n, spread, permille)
        modes.append(dict(
            spread=spread, permille=permille, max_abs_err=err,
            ms=cuda_ms(lambda: delivery_new_bits(*args)),
            plain_ms=cuda_ms(lambda: delivery_new_bits_ref(*args), reps=20),
            bound_ms=bound_ms, bound_by=bound_by,
        ))
    ragged = []
    for rc, rn, spread, permille in ((33, 1000, 1, 250), (5, 37, 2, 1000), (64, 129, 3, 300)):
        blocked, age, epoch = delivery_inputs(rc, k, rn, rn, dev)
        args = (blocked, age, epoch, k, rc, spread, permille)
        same = torch.equal(delivery_new_bits(*args), delivery_new_bits_ref(*args))
        check(same, f"delivery kernel differs at c={rc} n={rn}")
        ragged.append([rc, rn, spread, permille])
    emit({"phase": "kernel", "shape": {"c": c, "k": k, "n": n}, "modes": modes,
          "ragged_bit_exact": ragged})
    return modes


def churn_cluster(n, n_join, n_crash, cohorts, seed, device):
    """bench.py's 5%-churn build: round-robin cohorts, FD counters staggered
    over 3 rounds, ``n_crash`` crashes and ``n_join`` joins."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    vc = VirtualCluster.create(
        n, n_slots=n + n_join, k=HEADLINE["k"], h=9, l=4, cohorts=cohorts, fd_threshold=3,
        seed=seed, delivery_spread=HEADLINE["spread"], concurrent_coordinators=2,
        device=device,
    )
    vc.assign_cohorts_roundrobin()
    rng = np.random.default_rng(seed + 1000)
    vc.stagger_fd_counts(rng, spread_rounds=3)
    victims = rng.choice(n, size=n_crash, replace=False)
    vc.crash(victims)
    vc.inject_join_wave(np.arange(n, n + n_join))
    return vc, victims


def resolve(vc, n):
    return vc.run_until_membership(n, max_steps=96 * 4, max_cuts=4, min_cuts=1)


def phase_engine(dev):
    from rapid_tpu_torch.convert import state_to_numpy

    n, n_churn = 4096, 102
    results, lanes = {}, {}
    for device in (dev, torch.device("cpu")):
        vc, _ = churn_cluster(n, n_churn, n_churn, 40, 7, device)
        results[device.type] = resolve(vc, n)
        lanes[device.type] = {**state_to_numpy(vc.state), **state_to_numpy(vc.faults)}
    check(results["cuda"] == results["cpu"], f"engine results differ: {results}")
    check(results["cuda"][2], f"N={n} churn did not resolve: {results['cuda']}")
    for field, want in lanes["cpu"].items():
        check(np.array_equal(lanes["cuda"][field], want), f"lane {field} differs cuda vs cpu")
    rounds, cuts, _, sizes = results["cuda"]
    emit({"phase": "engine", "n": n, "cohorts": 40, "rounds": rounds, "cuts": cuts,
          "sizes": list(sizes), "lanes_bit_exact": len(lanes["cpu"])})


def phase_main_path(dev):
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.ops.kernels import delivery_new_bits

    n, n_join = HEADLINE["n"], HEADLINE["n_join"]
    delivery_new_bits.launches = 0
    samples = []
    torch.cuda.reset_peak_memory_stats(dev)
    for rep in range(1 + TIMED_SAMPLES):
        vc, victims = churn_cluster(n, n_join, HEADLINE["n_crash"], HEADLINE["cohorts"], rep, dev)
        torch.cuda.synchronize(dev)
        launches0, reads0 = delivery_new_bits.launches, _host.read.count
        start = time.perf_counter()
        rounds, cuts, resolved, sizes = resolve(vc, n)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - start) * 1e3
        reads = _host.read.count - reads0
        launches = delivery_new_bits.launches - launches0
        check(resolved, f"churn unresolved: {cuts} cuts in {rounds} rounds, sizes {sizes}")
        check(vc.membership_size == n, "membership is not N after the churn")
        alive = vc.alive_mask
        check(not alive[victims].any(), "a crashed member survived the churn")
        check(alive[n:n + n_join].all(), "a joiner was not admitted")
        check(launches > 0, "the main path never launched the delivery kernel")
        samples.append(dict(warmup=rep == 0, ms=ms, rounds=rounds, cuts=cuts, sizes=list(sizes),
                            host_reads=reads, host_reads_per_round=reads / rounds,
                            kernel_launches=launches))
    total_launches = delivery_new_bits.launches
    timed = [s["ms"] for s in samples if not s["warmup"]]
    emit({"phase": "main_path", "n": n, "n_slots": n + n_join, "churn": "2500 crashes + 2500 joins",
          "cohorts": HEADLINE["cohorts"], "samples": samples, "median_ms": statistics.median(timed),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
          "profile": profile_churn(dev)})
    return total_launches


def profile_run(dev, run):
    """``run()`` once under torch.profiler: the device busy share of the
    profiled wall clock, the delivery kernel's share of device time and the
    kernels that take the most device time. Returns (run's result,
    profile)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        result = run()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - start) * 1e3
    # Kernel rows only: CPU-side op rows carry their kernels' device time too.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    delivery_ms = sum(e.self_device_time_total for e in kernels
                      if "delivery_new_bits_kernel" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return result, {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "delivery_device_ms": delivery_ms,
        "delivery_share": delivery_ms / device_ms if device_ms else None,
        "device_kernels": sum(e.count for e in kernels),
        "top": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top],
    }


def profile_churn(dev):
    """One more main-path sample under torch.profiler."""
    vc, _ = churn_cluster(HEADLINE["n"], HEADLINE["n_join"], HEADLINE["n_crash"],
                          HEADLINE["cohorts"], 9, dev)
    (rounds, _, resolved, _), prof = profile_run(dev, lambda: resolve(vc, HEADLINE["n"]))
    check(resolved, "profiled churn did not resolve")
    return {"rounds": rounds, **prof}


def phase_scale_point(dev):
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
    from rapid_tpu_torch.ops.kernels import delivery_new_bits

    n, cohorts = 1_000_000, 8
    n_crash = n // 100
    runs = []
    delivery_new_bits.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    for seed in (7, 8):  # bench.py's warm-up seed, then its timed seed
        vc = VirtualCluster.create(
            n, k=HEADLINE["k"], h=9, l=4, cohorts=cohorts, fd_threshold=3, seed=seed,
            delivery_spread=HEADLINE["spread"], device=dev,
        )
        vc.assign_cohorts_roundrobin()
        vc.crash(np.random.default_rng(seed).choice(n, size=n_crash, replace=False))
        torch.cuda.synchronize(dev)
        launches0, reads0 = delivery_new_bits.launches, _host.read.count
        start = time.perf_counter()
        rounds, decided, _, members = vc.run_to_decision(max_steps=96)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - start) * 1e3
        check(decided and members == n - n_crash, f"N={n} crash-1% point: {decided}, {members}")
        runs.append(dict(warmup=seed == 7, ms=ms, rounds=rounds,
                         host_reads=_host.read.count - reads0,
                         kernel_launches=delivery_new_bits.launches - launches0))
    launches = delivery_new_bits.launches
    emit({"phase": "scale_point", "n": n, "cohorts": cohorts, "crashes": n_crash, "runs": runs,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)})
    return launches


def phase_kernel_fleet(dev, headline_modes):
    from rapid_tpu_torch import _u32
    from rapid_tpu_torch.ops.kernels import delivery_new_bits, delivery_new_bits_ref

    t, c, k, n = FLEET["tenants"], FLEET["cohorts"], FLEET["k"], FLEET["n"] + FLEET["n_extra"]
    modes = []
    for spread, permille in ((0, 1000), (2, 1000), (3, 300)):
        blocked, age, epoch = delivery_inputs(c, k, n, spread * 10 + 2, dev, t=t)
        args = (blocked, age, epoch, k, c, spread, permille)
        got, want = delivery_new_bits(*args), delivery_new_bits_ref(*args)
        torch.cuda.synchronize()
        err = int((_u32.widen(got) - _u32.widen(want)).abs().max())
        check(torch.equal(got, want),
              f"batched delivery kernel differs (spread={spread}, permille={permille})")
        bound_ms, bound_by = delivery_bound(c, k, n, spread, permille, t=t)
        headline = next(m for m in headline_modes if m["spread"] == spread)
        modes.append(dict(
            spread=spread, permille=permille, max_abs_err=err,
            ms=cuda_ms(lambda: delivery_new_bits(*args)),
            plain_ms=cuda_ms(lambda: delivery_new_bits_ref(*args), reps=20),
            bound_ms=bound_ms, bound_by=bound_by,
            headline_ms=headline["ms"], headline_bound_ms=headline["bound_ms"],
        ))
    rt, rc, rn = 3, 40, 77
    blocked, age, epoch = delivery_inputs(rc, k, rn, 5, dev, t=rt)
    args = (blocked, age, epoch, k, rc, 2, 1000)
    check(torch.equal(delivery_new_bits(*args), delivery_new_bits_ref(*args)),
          f"batched delivery kernel differs at t={rt} c={rc} n={rn}")
    emit({"phase": "kernel_fleet", "shape": {"t": t, "c": c, "k": k, "n": n}, "modes": modes,
          "ragged_bit_exact": [rt, rc, rn, 2, 1000]})
    return modes


def fleet_clusters(tenants, n, n_extra, cohorts, seed0, device, knobs=((9, 4), (8, 3))):
    """``bench.py``'s ``build_fleet``: tenants cycling the crash-wave,
    join-wave and equal-churn families by ``i % 3``, (H, L) cycling
    ``knobs``, seeds ``seed0 + i``. Returns (clusters, targets)."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    clusters, targets = [], []
    for i in range(tenants):
        h, l = knobs[i % len(knobs)]
        vc = VirtualCluster.create(
            n, n_slots=n + n_extra, k=FLEET["k"], h=h, l=l, cohorts=cohorts, fd_threshold=3,
            seed=seed0 + i, delivery_spread=FLEET["spread"], device=device,
        )
        vc.assign_cohorts_roundrobin()
        rng = np.random.default_rng(seed0 + 10_000 + i)
        vc.stagger_fd_counts(rng, spread_rounds=3)
        family = i % 3
        if family != 1:  # crash wave, or the crash half of equal churn
            vc.crash(rng.choice(n, size=n_extra, replace=False))
        if family != 0:  # join wave, or the join half of equal churn
            vc.inject_join_wave(np.arange(n, n + n_extra))
        targets.append(n + n_extra * (int(family == 1) - int(family == 0)))
        clusters.append(vc)
    return clusters, targets


def phase_fleet_engine(dev):
    from rapid_tpu_torch.convert import state_to_numpy
    from rapid_tpu_torch.tenancy import TenantFleet
    from rapid_tpu_torch.tenancy.fleet import fleet_wave

    b, n, n_extra, cohorts = 6, 256, 6, 40
    knobs = ((9, 4), (8, 3), (7, 2))
    wave = dict(max_steps=FLEET["max_steps"], max_cuts=4, min_cuts=1)
    results, lanes = {}, {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        clusters, targets = fleet_clusters(b, n, n_extra, cohorts, 300, device, knobs)
        fleet = TenantFleet.from_clusters(clusters)
        results[where] = [r.tolist() for r in fleet.run_until_membership(targets, **wave)]
        lanes[where] = {**state_to_numpy(fleet.state), **state_to_numpy(fleet.faults)}
    check(results["card"] == results["cpu"], f"fleet results differ: {results}")
    rounds, cuts, resolved, sizes = results["card"]
    check(all(resolved), f"B={b} fleet did not resolve: {results['card']}")
    for field, want in lanes["cpu"].items():
        check(np.array_equal(lanes["card"][field], want), f"fleet lane {field} differs card vs cpu")

    singles, _ = fleet_clusters(b, n, n_extra, cohorts, 300, dev, knobs)
    for i, vc in enumerate(singles):
        r, c, res, sz = vc.run_until_membership(targets[i], **wave)
        check((r, c, res, list(sz)) == (rounds[i], cuts[i], resolved[i], sizes[i][:c]),
              f"tenant {i} differs from its single cluster: {(r, c, res, sz)}")
        for field, value in state_to_numpy(vc.state).items():
            check(np.array_equal(lanes["card"][field][i], value),
                  f"tenant {i} lane {field} differs from its single cluster")

    # The wave loop makes no synchronizing call: run it once more with
    # every sync turned into an error (inputs built before).
    clusters, _ = fleet_clusters(b, n, n_extra, cohorts, 300, dev, knobs)
    fleet = TenantFleet.from_clusters(clusters)
    target_t = torch.tensor(targets, dtype=torch.int32, device=dev)
    min_cuts = torch.ones_like(target_t)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fleet_wave(fleet.cfg, fleet.state, fleet.faults, fleet.knobs, target_t,
                         wave["max_steps"], wave["max_cuts"], min_cuts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check([x.tolist() for x in out[1:]] == results["card"], "sync-checked wave differs")
    emit({"phase": "fleet_engine", "tenants": b, "n": n, "n_slots": n + n_extra,
          "cohorts": cohorts, "knobs": [list(kn) for kn in knobs], "rounds": rounds,
          "cuts": cuts, "sizes": sizes, "lanes_bit_exact": len(lanes["cpu"]),
          "singles_bit_exact": b, "wave_sync_free": True})


def phase_fleet_path(dev):
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.tenancy import TenantFleet

    b, n, n_extra = FLEET["tenants"], FLEET["n"], FLEET["n_extra"]
    wave = dict(max_steps=FLEET["max_steps"], max_cuts=4, min_cuts=1)

    def fresh(seed0):
        clusters, targets = fleet_clusters(b, n, n_extra, FLEET["cohorts"], seed0, dev)
        fleet = TenantFleet.from_clusters(clusters)
        fleet.sync()
        return fleet, targets

    delivery_new_bits.launches = 0
    samples = []
    for rep in range(1 + FLEET_TIMED_SAMPLES):
        fleet, targets = fresh(50_000 if rep == 0 else 60_000 + 1_000 * (rep - 1))
        torch.cuda.reset_peak_memory_stats(dev)
        launches0, reads0 = delivery_new_bits.launches, _host.read.count
        start = time.perf_counter()
        rounds, cuts, resolved, sizes = fleet.run_until_membership(targets, **wave)
        fleet.sync()
        ms = (time.perf_counter() - start) * 1e3
        launches = delivery_new_bits.launches - launches0
        reads = _host.read.count - reads0
        check(resolved.all(), f"fleet tenants unresolved: {np.nonzero(~resolved)[0].tolist()}")
        check(launches == wave["max_steps"],
              f"{launches} kernel launches in a {wave['max_steps']}-round wave")
        check(reads == 1, f"the wave made {reads} host reads")
        check((fleet.membership_sizes() == np.asarray(targets)).all(), "a tenant missed its target")
        samples.append(dict(
            warmup=rep == 0, ms=ms, view_changes=int(cuts.sum()),
            view_changes_per_sec=int(cuts.sum()) / (ms / 1e3),
            max_tenant_rounds=int(rounds.max()), host_reads=reads, kernel_launches=launches,
            peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
        ))
    total_launches = delivery_new_bits.launches
    fleet, targets = fresh(70_000)
    (_, _, resolved, _), prof = profile_run(
        dev, lambda: fleet.run_until_membership(targets, **wave)
    )
    check(resolved.all(), "profiled fleet wave did not resolve")
    timed = [s["ms"] for s in samples if not s["warmup"]]
    emit({"phase": "fleet_path", "tenants": b, "n": n, "n_slots": n + n_extra,
          "cohorts": FLEET["cohorts"], "rounds_per_wave": wave["max_steps"], "telemetry": "off",
          "samples": samples, "median_ms": statistics.median(timed),
          "median_view_changes_per_sec": statistics.median(
              s["view_changes_per_sec"] for s in samples if not s["warmup"]),
          "profile": prof})
    return total_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from rapid_tpu_torch import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    start = time.perf_counter()
    _build.build_all()
    ptxas = [ln.strip() for log in _build.build_log.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - start, "sources": _build.sources(),
          "ptxas": ptxas, "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    modes = phase_kernel(dev)
    phase_engine(dev)
    launches = {"churn": phase_main_path(dev), "scale_point": phase_scale_point(dev)}
    fleet_modes = phase_kernel_fleet(dev, modes)
    phase_fleet_engine(dev)
    launches["fleet_wave"] = phase_fleet_path(dev)

    main_mode = next(m for m in modes if m["spread"] == HEADLINE["spread"] and m["permille"] >= 1000)
    fleet_mode = next(m for m in fleet_modes if m["spread"] == FLEET["spread"])
    emit({"kernels": [{
        "name": "delivery_new_bits",
        "route": "cuda",
        "source": "rapid_tpu_torch/csrc/delivery.cu",
        "replaces": "rapid_tpu/ops/pallas_kernels.py:180",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(m["max_abs_err"] for m in modes + fleet_modes),
        "ms": main_mode["ms"],
        "plain_ms": main_mode["plain_ms"],
        "bound_ms": main_mode["bound_ms"],
        "bound_by": main_mode["bound_by"],
        "library_ms": None,
        "fleet_shape": {key: fleet_mode[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
