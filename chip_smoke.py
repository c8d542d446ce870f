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
   coordinators), one warm-up and three timed samples on fresh state. The
   launch counts are zeroed just before it and read just after;
5. scale point: ``bench.py``'s crash-1% point at N=1,000,000 (8 cohorts,
   10,000 crashes, one ``run_to_decision``), a warm-up and one timed run.

Then the kernels line, the card's name and power limit from ``nvidia-smi``,
and as the last line ``{"ok": true, "device": {...}}``.
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


def check(cond, message):
    if not cond:
        raise RuntimeError(message)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=30, warmup=5):
    """Median milliseconds of ``fn`` on the card, one pair of CUDA events per
    call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def delivery_bound(c, k, n, spread, permille):
    """(bound_ms, bound_by) of one delivery call: each input read once, the
    output written once, against the operations its draws make."""
    w = (c + 31) // 32
    nbytes = 4 * (w * k * n + k * n + 1 + c * n)
    ops = c * n * k * delivery_ops_per_draw(spread, permille)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def delivery_inputs(c, k, n, seed, dev):
    from rapid_tpu_torch import _u32

    rng = np.random.default_rng(seed)
    w = (c + 31) // 32
    blocked = rng.integers(0, 2**32, size=(w * k, n), dtype=np.uint32)
    blocked &= rng.integers(0, 2**32, size=(w * k, n), dtype=np.uint32)  # ~1/4 bits set
    age = rng.integers(-3, 6, size=(k, n)).astype(np.int32)
    age[rng.random((k, n)) < 0.2] = -(1 << 30)  # edges that never fired
    return (
        _u32.from_numpy(blocked, dev),
        torch.from_numpy(age).to(dev),
        torch.tensor([seed % 7], dtype=torch.int32, device=dev),
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


def profile_churn(dev):
    """One more main-path sample under torch.profiler: device busy share of
    the profiled wall clock and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    vc, _ = churn_cluster(HEADLINE["n"], HEADLINE["n_join"], HEADLINE["n_crash"],
                          HEADLINE["cohorts"], 9, dev)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        rounds, _, resolved, _ = resolve(vc, HEADLINE["n"])
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - start) * 1e3
    check(resolved, "profiled churn did not resolve")
    # Kernel rows only: CPU-side op rows carry their kernels' device time too.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return {
        "wall_ms": wall_ms, "rounds": rounds, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "device_kernels": sum(e.count for e in kernels),
        "top": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top],
    }


def phase_scale_point(dev):
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
    from rapid_tpu_torch.ops.kernels import delivery_new_bits

    n, cohorts = 1_000_000, 8
    n_crash = n // 100
    runs = []
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
    emit({"phase": "scale_point", "n": n, "cohorts": cohorts, "crashes": n_crash, "runs": runs,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)})


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
    launches = phase_main_path(dev)
    phase_scale_point(dev)

    main_mode = next(m for m in modes if m["spread"] == HEADLINE["spread"] and m["permille"] >= 1000)
    emit({"kernels": [{
        "name": "delivery_new_bits",
        "route": "cuda",
        "source": "rapid_tpu_torch/csrc/delivery.cu",
        "replaces": "rapid_tpu/ops/pallas_kernels.py:180",
        "launches": launches,
        "max_abs_err": max(m["max_abs_err"] for m in modes),
        "ms": main_mode["ms"],
        "plain_ms": main_mode["plain_ms"],
        "bound_ms": main_mode["bound_ms"],
        "bound_by": main_mode["bound_by"],
        "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
