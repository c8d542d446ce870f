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
   all three delay modes and at ragged small shapes (the generic-K instance
   included), each mode timed warm (one input set) and cold (input sets
   taken in turn, more bytes than L2 holds), beside its bound;
3. engine: one seeded churn at N=4,096 with C=40 on the card and on the
   CPU; every lane of the final state and every returned count must match;
4. main path: the 5%-churn resolution at N=100,000 (``bench.py``'s recipe:
   2,500 crashes and 2,500 joins, 64 cohorts, spread 2, two racing
   coordinators), and the same churns with the telemetry plane and a
   64-round trace ring on (same rounds, cuts and host reads; the decoded
   activity and ring checked against each churn). The two take turns on
   fresh state from the same seeds, a warm-up and five timed samples each;
   then one profiled sample of each;
5. scale point: ``bench.py``'s crash-1% point at N=1,000,000 (8 cohorts,
   10,000 crashes, one ``run_to_decision``), a warm-up and one timed run;
6. kernel_fleet: phase 2 with a tenant axis, at the fleet shape (256
   tenants, 8 cohorts, K=10, n=1,044) with distinct per-tenant epochs, and
   at ragged fleet shapes (c=1,024 among them);
7. fleet_engine: a fleet of 6 tenants (N=256, 262 slots, 40 cohorts, the
   three ``bench.py`` families, a knob mix) through ``run_until_membership``
   on the card and on the CPU: every stacked lane and result must match,
   each tenant must match its own single cluster on the card, and the wave
   loop must make no synchronizing call (``torch.cuda.set_sync_debug_mode``);
8. fleet_path: ``bench.py``'s fleet point on the port as ``bench.py`` writes
   it, 256 tenants x 1,024 members with the telemetry plane on, resolved in
   one 96-round lockstep wave; in the same call the same waves with the
   plane off. Per side a warm-up and five timed samples on fresh fleets
   (built on the CPU and copied to the card; the sides take turns), then
   one profiled wave;
9. telemetry_engine: phase 3's churn with the plane and a 6-round ring
   (wrapped) on the card and on the CPU: every state, telemetry and ring
   lane, both digests and the decoded summaries must match, and a
   plane-off twin must end in the same state; then phase 7's fleet with the
   plane and a 16-round ring, card against CPU, each tenant against its own
   single cluster, and its wave loop under the sync check.

10. kernel_paths: the delivery inputs of every round of phase 4's warm-up
   churn and of phase 8's warm-up wave, captured by wrapping the engine's
   call (``rapid_tpu_torch.models.virtual_cluster.delivery_new_bits``):
   each round bit for bit against the plain version, and one pass over the
   rounds in path order timed beside the sum of their bounds;
11. kernel_ab, only with ``--parent DIR``: the delivery kernel of the
   checkout at DIR built beside this one and timed against it in turns
   (parent, change, change, parent) on phases 2, 6 and 10's inputs;
12. compact_paths: phase 4's churn (planes off) and phase 5's 1M point,
   each built wide and built compact (``compact=True``) from the same
   seeds, the sides in turns (churn: a warm-up and three timed each; 1M:
   one and one): equal rounds, cuts and config ids, the widened compact
   state equal to the wide one on every lane on the card, every lane at its
   policy dtype, the state's tensor bytes equal to ``state_bytes_total``;
   per side the peak device memory, the medians and one profiled churn's
   kernels per round;
13. compact_fleet: one of phase 8's CPU-built fleets (plane on) copied to
   the card wide and narrowed (``narrow_state``), a warm-up and three timed
   96-round waves per side in turns: equal cuts, rounds and sizes per
   tenant, the widened compact state equal to the wide one, every tenant
   healthy (``tenant_health``), int16 index lanes; then the first 8 rounds
   of a wave profiled per side (kernels per round);
14. endpoints_path: 102,500 endpoints with hostnames of mixed lengths hashed
   into ring keys on the host (timed), ``VirtualCluster.from_endpoints``
   (100,000 members, 2,500 keyed joiner slots, compact) on the card; the
   sorting ``ring_topology`` against ``ring_topology_from_perm``; 2,500
   crashes and the 2,500 joiners resolved; and a 2,048-endpoint twin on the
   card and on the CPU, equal on every lane.

A kernel's bound (``delivery_bound``) is the larger of its bytes (each
input once, the output once) over the HBM rate and the delay draws its
inputs need (unblocked edges with ``0 <= age < spread``) times the
operations of one draw over the int32 issue rate.

The delivery kernel's launch count is zeroed just before each of the
paths 4, 5, 8, 12 (churn and 1M), 13 and 14 and read just after. Then the kernels line, the card's
name and power limit from ``nvidia-smi``, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
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

# The three delay modes, (spread, permille): none, uniform (the paths'), gated.
DELAY_MODES = ((0, 1000), (2, 1000), (3, 300))
# Bytes of input sets a cold timing rotates through: over twice the 50 MB L2.
COLD_BYTES = 120e6

HEADLINE = dict(n=100_000, n_join=2_500, n_crash=2_500, k=10, cohorts=64, spread=2)
# bench.py's crash-1% scale point: N members, 8 cohorts, N // 100 crashes.
SCALE = dict(n=1_000_000, cohorts=8)
TIMED_SAMPLES = 5  # per side of the plane-on / plane-off comparison
# bench.py's fleet point: B tenants of N members, n_extra = N // 50 extra
# slots, 8 cohorts, K=10, fd_threshold 3, spread 2, one 96-round wave.
FLEET = dict(tenants=256, n=1_024, n_extra=20, k=10, cohorts=8, spread=2, max_steps=96)
FLEET_TIMED_SAMPLES = 5  # per side of the plane-on / plane-off comparison
COMPACT_TIMED_SAMPLES = 3  # per side of the wide / compact comparisons (churn, fleet)


def check(cond, message):
    if not cond:
        raise RuntimeError(message)


def smi(query):
    """One ``nvidia-smi --query-gpu`` reading of card 0, as its CSV line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=30, warmup=5, runs=3, graph=True):
    """Milliseconds of one call on the card: after ``warmup`` calls, the
    median over ``runs`` of one pair of CUDA events around ``reps`` calls
    back to back, divided by ``reps``. With ``graph`` the ``reps`` calls are
    captured once as a CUDA graph and the events time its replays, so the
    host's cost of a call (the wrapper's checks and the launch, tens of
    microseconds) does not hide a kernel that takes less; without it the
    calls are issued from the host each time. ``fn`` is one callable, or a
    list of callables taken in turn (input sets rotated, so that each call
    finds its inputs out of L2 when the sets hold more bytes than L2)."""
    calls = list(fn) if isinstance(fn, (list, tuple)) else [fn]

    def issue():
        for i in range(reps):
            calls[i % len(calls)]()

    for i in range(warmup):
        calls[i % len(calls)]()
    run = issue
    if graph:
        torch.cuda.synchronize()
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            issue()
        run = captured.replay
        run()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def delivery_ops_per_draw(spread, permille):
    """Integer operations of one needed delay draw, counted from
    csrc/delivery.cu: the ring salt (2), a mix32 (8) and a modulus (1); in
    the gated mode also the second stream's xor, mix32, modulus and compare
    (11) and the magnitude's add and select (2). None are drawn when every
    delay is 0."""
    if spread == 0:
        return 0
    return 11 if permille >= 1000 else 24


def delivery_needed_draws(blocked, age, k, c, spread):
    """Delay draws these inputs need, counted with torch ops on their
    device: unblocked (tenant, cohort, slot, ring) edges with ``0 <= age <
    spread``. Below 0 an edge is not delivered whatever the draw; at or
    above ``spread`` (the largest delay) it is delivered iff unblocked."""
    from rapid_tpu_torch import _u32
    from rapid_tpu_torch.ops.kernels import popcount32

    if spread == 0:
        return 0
    if age.dim() == 2:
        blocked, age = blocked[None], age[None]
    t, _, n = age.shape
    words = blocked.reshape(t, -1, k, n)
    pending = ((age >= 0) & (age < spread)).to(torch.int64)
    total = 0
    for wi in range(words.shape[1]):
        cohort_bits = (1 << min(32, c - 32 * wi)) - 1
        unblocked = popcount32((_u32.widen(words[:, wi]) ^ _u32.MASK) & cohort_bits)
        total += int((unblocked * pending).sum())
    return total


def delivery_bound(blocked, age, epoch, k, c, spread, permille):
    """(bound_ms, bound_by, needed draws) of one delivery call on these
    inputs (one cluster or a fleet). Bytes: each input read once and the
    ``[t, c, n]`` output written once. Operations: the draws these inputs
    need (:func:`delivery_needed_draws`) times the operations of one draw
    (:func:`delivery_ops_per_draw`); the per-edge test is not counted, since
    a word-wide kernel forms 32 outputs with a few operations. The larger of
    the two times, at the H100's HBM rate and int32 issue rate."""
    n = age.shape[-1]
    nbytes = 4 * (blocked.numel() + age.numel() + epoch.numel() + epoch.numel() * c * n)
    draws = delivery_needed_draws(blocked, age, k, c, spread)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = draws * delivery_ops_per_draw(spread, permille) / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), draws


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


def skip_edge_inputs(kind, c, k, n, spread, seed, dev, t=None):
    """:func:`delivery_inputs` moved to the edges of the kernel's skips.
    ``edges``: ages -2^30, -1, 0, spread - 1, spread, spread + 1 in turn
    along tenants, rings and slots; ``all_blocked`` / ``none_blocked``: the
    same ages with every or no cohort blocked; ``all_pending``: every age in
    ``[0, spread)`` (needs spread >= 1); ``misaligned``: the seeded inputs
    one element past a 16-byte boundary."""
    blocked, age, epoch = delivery_inputs(c, k, n, seed, dev, t=t)
    if kind == "misaligned":
        def shifted(x):
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
            buf[1:] = x.reshape(-1)
            return buf[1:].view(x.shape)
        return shifted(blocked), shifted(age), epoch
    if kind == "all_pending":
        rng = np.random.default_rng(seed)
        age = torch.from_numpy(rng.integers(0, spread, size=age.shape).astype(np.int32)).to(dev)
        return blocked, age, epoch
    edges = torch.tensor([-(1 << 30), -1, 0, spread - 1, spread, spread + 1], dtype=torch.int32)
    lead = age.shape[:-2]
    pos = torch.arange(k)[:, None] + torch.arange(n)[None, :]
    if lead:
        pos = pos + torch.arange(lead[0])[:, None, None]
    age = edges[pos % len(edges)].to(dev).contiguous()
    if kind == "all_blocked":
        blocked = torch.full_like(blocked, -1)
    elif kind == "none_blocked":
        blocked = torch.zeros_like(blocked)
    return blocked, age, epoch


def kernel_modes(dev, c, k, n, seed_base, t=None):
    """The delivery kernel against its plain version, bit for bit, at one
    shape in the three delay modes, each timed warm (one input set) and
    cold (``COLD_BYTES`` of input sets taken in turn), beside its bound.
    Returns (the modes' JSON, each mode's list of argument tuples)."""
    from rapid_tpu_torch import _u32
    from rapid_tpu_torch.ops.kernels import delivery_new_bits, delivery_new_bits_ref

    modes, inputs = [], []
    for spread, permille in DELAY_MODES:
        seed = spread * 10 + seed_base
        first = delivery_inputs(c, k, n, seed, dev, t=t)
        nbytes = 4 * (sum(x.numel() for x in first) + (t or 1) * c * n)
        sets = [first] + [delivery_inputs(c, k, n, seed + 1000 * i, dev, t=t)
                          for i in range(1, math.ceil(COLD_BYTES / nbytes))]
        args = [(*inp, k, c, spread, permille) for inp in sets]
        got, want = delivery_new_bits(*args[0]), delivery_new_bits_ref(*args[0])
        torch.cuda.synchronize()
        err = int((_u32.widen(got) - _u32.widen(want)).abs().max())
        check(torch.equal(got, want),
              f"delivery kernel differs (t={t}, c={c}, n={n}, spread={spread}, permille={permille})")
        bound_ms, bound_by, draws = delivery_bound(*args[0])
        cold_bound_ms = statistics.mean(delivery_bound(*a)[0] for a in args)
        clocks_before = smi("clocks.sm,clocks.max.sm")
        ms = cuda_ms(lambda: delivery_new_bits(*args[0]))
        cold_ms = cuda_ms([functools.partial(delivery_new_bits, *a) for a in args])
        modes.append(dict(
            spread=spread, permille=permille, max_abs_err=err, ms=ms, cold_ms=cold_ms,
            plain_ms=cuda_ms(lambda: delivery_new_bits_ref(*args[0]), reps=20, graph=False),
            bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
            cold_sets=len(args), cold_bound_ms=cold_bound_ms,
            cold_share_of_bound=cold_bound_ms / cold_ms,
            needed_draws=draws, needed_draw_share=draws / ((t or 1) * c * n * k),
            sm_clock_before_after=[clocks_before, smi("clocks.sm,clocks.max.sm")],
        ))
        inputs.append(args)
    return modes, inputs


def check_ragged(dev, cases):
    """The kernel equals its plain version at shapes off the paths' grid and
    at its skip edges: (t or None, c, k, n, spread, permille, kind of
    :func:`skip_edge_inputs`) each."""
    from rapid_tpu_torch.ops.kernels import delivery_new_bits, delivery_new_bits_ref

    for t, c, k, n, spread, permille, kind in cases:
        args = (*skip_edge_inputs(kind, c, k, n, spread, n + k, dev, t=t), k, c, spread, permille)
        check(torch.equal(delivery_new_bits(*args), delivery_new_bits_ref(*args)),
              f"delivery kernel differs at t={t} c={c} k={k} n={n} spread={spread}")
    return [list(case) for case in cases]


def phase_kernel(dev):
    k, n, c = HEADLINE["k"], HEADLINE["n"] + HEADLINE["n_join"], HEADLINE["cohorts"]
    modes, inputs = kernel_modes(dev, c, k, n, 1)
    ragged = check_ragged(dev, (
        (None, 33, 10, 1000, 1, 250, "edges"), (None, 5, 10, 37, 2, 1000, "all_pending"),
        (None, 64, 10, 129, 3, 300, "edges"), (None, 40, 17, 130, 2, 1000, "edges"),
        (None, 64, 3, 1002, 0, 1000, "none_blocked"), (None, 64, 10, 1000, 2, 1000, "misaligned"),
    ))
    emit({"phase": "kernel", "shape": {"c": c, "k": k, "n": n}, "modes": modes,
          "ragged_bit_exact": ragged})
    return modes, inputs


def churn_cluster(n, n_join, n_crash, cohorts, seed, device, **planes):
    """bench.py's 5%-churn build: round-robin cohorts, FD counters staggered
    over 3 rounds, ``n_crash`` crashes and ``n_join`` joins. ``planes``:
    ``telemetry`` / ``trace`` for ``VirtualCluster.create``."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    vc = VirtualCluster.create(
        n, n_slots=n + n_join, k=HEADLINE["k"], h=9, l=4, cohorts=cohorts, fd_threshold=3,
        seed=seed, delivery_spread=HEADLINE["spread"], concurrent_coordinators=2,
        device=device, **planes,
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


@contextlib.contextmanager
def capturing(captured):
    """A context in which every delivery call of the engine also appends a
    copy of its arguments to ``captured`` (nothing when it is None). The
    engine's own call still runs, and counts, as it does without it."""
    from rapid_tpu_torch.models import virtual_cluster

    real = virtual_cluster.delivery_new_bits
    if captured is None:
        yield
        return

    def capture(blocked, age, epoch, *params):
        captured.append((blocked.clone(), age.clone(), epoch.clone(), *params))
        return real(blocked, age, epoch, *params)

    virtual_cluster.delivery_new_bits = capture
    try:
        yield
    finally:
        virtual_cluster.delivery_new_bits = real


def phase_main_path(dev, captured=None):
    """Phase 4. ``captured``: a list that receives the delivery inputs of
    every round of the warm-up churn (planes off)."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.ops.kernels import delivery_new_bits

    n, n_join, trace = HEADLINE["n"], HEADLINE["n_join"], 64
    delivery_new_bits.launches = 0
    # bench.py's churn (planes off) and the same churn with the telemetry
    # plane and a 64-round ring on take turns on the same seeds, before any
    # profiling: a warm-up each, then TIMED_SAMPLES pairs.
    order = [(0, "off"), (0, "on")] + [
        (seed, side) for seed in range(1, 1 + TIMED_SAMPLES)
        for side in (("off", "on") if seed % 2 else ("on", "off"))
    ]
    samples = {"off": {}, "on": {}}
    for seed, side in order:
        planes = dict(telemetry=True, trace=trace) if side == "on" else {}
        vc, victims = churn_cluster(n, n_join, HEADLINE["n_crash"], HEADLINE["cohorts"], seed, dev,
                                    **planes)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        launches0, reads0 = delivery_new_bits.launches, _host.read.count
        capture = capturing(captured if (seed, side) == order[0] else None)
        start = time.perf_counter()
        with capture:
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
        sample = dict(warmup=seed == 0, seed=seed, ms=ms, rounds=rounds, cuts=cuts,
                      sizes=list(sizes), host_reads=reads, host_reads_per_round=reads / rounds,
                      kernel_launches=launches,
                      peak_memory_bytes=torch.cuda.max_memory_allocated(dev))
        if side == "on":
            vc.sync()
            activity, ring = vc.activity, vc.trace
            check(activity["rounds"] == rounds, f"activity counts {activity['rounds']} of {rounds} rounds")
            check(activity["decisions_fast"] + activity["decisions_classic"] == cuts,
                  f"activity counts the wrong decisions for {cuts} cuts: {activity}")
            check(ring["rounds_recorded"] == rounds and ring["decisions_held"] == cuts,
                  f"the ring holds {ring['rounds_recorded']} rounds, {ring['decisions_held']} decisions")
        samples[side][seed] = sample
    for seed, on in samples["on"].items():
        off = samples["off"][seed]
        got, want = (on["rounds"], on["cuts"], on["host_reads"]), (off["rounds"], off["cuts"], off["host_reads"])
        check(got == want, f"seed {seed}: planes on (rounds, cuts, reads) {got}, planes off {want}")
    profiles = {"off": profile_churn(dev), "on": profile_churn(dev, telemetry=True, trace=trace)}
    total_launches = delivery_new_bits.launches

    def side_summary(side):
        timed = [s for s in samples[side].values() if not s["warmup"]]
        return {"samples": list(samples[side].values()),
                "median_ms": statistics.median(s["ms"] for s in timed),
                "peak_memory_bytes": max(s["peak_memory_bytes"] for s in timed),
                "profile": profiles[side]}

    off, on = side_summary("off"), side_summary("on")
    emit({"phase": "main_path", "n": n, "n_slots": n + n_join, "churn": "2500 crashes + 2500 joins",
          "cohorts": HEADLINE["cohorts"], **off,
          "kernels_per_round": {side: profiles[side]["kernels_per_round"] for side in profiles},
          "telemetry_on": {"trace": trace, **on, "activity": {key: activity[key] for key in (
              "rounds", "alerts", "decisions_fast", "decisions_classic", "conflict_rate",
              "active_fraction", "peak_active_fraction", "fast_path_share", "rounds_undecided_hist",
          )}, "trace_rounds_recorded": ring["rounds_recorded"], "trace_last_path": ring["last_path"]},
          "churn_ms_on_over_off": on["median_ms"] / off["median_ms"]})
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
    host_ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    return result, {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "host_op_self_ms": sum(e.self_cpu_time_total for e in host_ops) / 1e3,
        "host_ops": sum(e.count for e in host_ops),
        "device_busy_share": device_ms / wall_ms,
        "delivery_device_ms": delivery_ms,
        "delivery_share": delivery_ms / device_ms if device_ms else None,
        "device_kernels": sum(e.count for e in kernels),
        "top": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top],
    }


def profile_churn(dev, **planes):
    """One more main-path sample under torch.profiler (``planes``:
    ``telemetry`` / ``trace``), always on the same seed."""
    vc, _ = churn_cluster(HEADLINE["n"], HEADLINE["n_join"], HEADLINE["n_crash"],
                          HEADLINE["cohorts"], 9, dev, **planes)
    (rounds, _, resolved, _), prof = profile_run(dev, lambda: resolve(vc, HEADLINE["n"]))
    check(resolved, "profiled churn did not resolve")
    return {"rounds": rounds, "kernels_per_round": prof["device_kernels"] / rounds, **prof}


def phase_scale_point(dev):
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
    from rapid_tpu_torch.ops.kernels import delivery_new_bits

    n, cohorts = SCALE["n"], SCALE["cohorts"]
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


def phase_kernel_fleet(dev):
    t, c, k, n = FLEET["tenants"], FLEET["cohorts"], FLEET["k"], FLEET["n"] + FLEET["n_extra"]
    modes, inputs = kernel_modes(dev, c, k, n, 2, t=t)
    ragged = check_ragged(dev, (
        (3, 40, 10, 77, 2, 1000, "edges"), (5, 8, 10, 1046, 2, 1000, "all_pending"),
        (2, 1024, 10, 36, 3, 300, "edges"), (4, 8, 10, 1044, 2, 1000, "misaligned"),
    ))
    emit({"phase": "kernel_fleet", "shape": {"t": t, "c": c, "k": k, "n": n}, "modes": modes,
          "ragged_bit_exact": ragged})
    return modes, inputs


def fleet_clusters(tenants, n, n_extra, cohorts, seed0, device, knobs=((9, 4), (8, 3)), **planes):
    """``bench.py``'s ``build_fleet``: tenants cycling the crash-wave,
    join-wave and equal-churn families by ``i % 3``, (H, L) cycling
    ``knobs``, seeds ``seed0 + i``; ``planes`` (``telemetry`` / ``trace``)
    go to ``VirtualCluster.create``. Returns (clusters, targets)."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    clusters, targets = [], []
    for i in range(tenants):
        h, l = knobs[i % len(knobs)]
        vc = VirtualCluster.create(
            n, n_slots=n + n_extra, k=FLEET["k"], h=h, l=l, cohorts=cohorts, fd_threshold=3,
            seed=seed0 + i, delivery_spread=FLEET["spread"], device=device, **planes,
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


def fleet_on(fleet, dev):
    """The same fleet with every lane, plane lanes included, copied to ``dev``."""
    from rapid_tpu_torch.models.state import map_lanes
    from rapid_tpu_torch.tenancy import TenantFleet

    def move(tree):
        return map_lanes(lambda x: x.to(dev), tree)

    moved = TenantFleet(fleet.cfg, move(fleet.state), move(fleet.faults), move(fleet.knobs))
    moved.telem, moved.trace_ring = move(fleet.telem), move(fleet.trace_ring)
    return moved


def sync_checked_wave(fleet, targets, max_steps, max_cuts, min_cuts):
    """``fleet_wave`` over the fleet's lanes (its planes included) with every
    synchronizing call turned into an error: the wave loop must make none.
    Returns what ``fleet_wave`` returns."""
    from rapid_tpu_torch.tenancy.fleet import fleet_wave

    target_t = torch.tensor(targets, dtype=torch.int32, device=fleet.device)
    min_t = torch.full_like(target_t, min_cuts)
    torch.cuda.synchronize(fleet.device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fleet_wave(fleet.cfg, fleet.state, fleet.faults, fleet.knobs, target_t,
                          max_steps, max_cuts, min_t, fleet.telem, fleet.trace_ring)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase_fleet_engine(dev):
    from rapid_tpu_torch.convert import state_to_numpy
    from rapid_tpu_torch.tenancy import TenantFleet

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
    out = sync_checked_wave(TenantFleet.from_clusters(clusters), targets, **wave)
    check([x.tolist() for x in out[1:5]] == results["card"], "sync-checked wave differs")
    emit({"phase": "fleet_engine", "tenants": b, "n": n, "n_slots": n + n_extra,
          "cohorts": cohorts, "knobs": [list(kn) for kn in knobs], "rounds": rounds,
          "cuts": cuts, "sizes": sizes, "lanes_bit_exact": len(lanes["cpu"]),
          "singles_bit_exact": b, "wave_sync_free": True})


def phase_fleet_path(dev, captured=None, built=None):
    """Phase 8. ``captured``: a list that receives the delivery inputs of
    every round of the warm-up wave (plane on, as bench.py runs it);
    ``built``: a list that receives one fleet as built on the CPU (plane
    on) and its targets, untouched, for phase 13."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.tenancy import TenantFleet

    b, n, n_extra = FLEET["tenants"], FLEET["n"], FLEET["n_extra"]
    wave = dict(max_steps=FLEET["max_steps"], max_cuts=4, min_cuts=1)

    def fresh(seed0, telemetry):
        # Built on the CPU and copied to the card: the same lanes, in ~1 s
        # instead of ~10 s of small launches per fleet.
        clusters, targets = fleet_clusters(
            b, n, n_extra, FLEET["cohorts"], seed0, torch.device("cpu"), telemetry=telemetry
        )
        cpu = TenantFleet.from_clusters(clusters)
        if built is not None and not built and telemetry:
            built.extend((cpu, targets))
        fleet = fleet_on(cpu, dev)
        fleet.sync()
        return fleet, targets

    # bench.py's form (plane on) and the plane-off form on the same seeds,
    # taking turns, so their difference is read within one call.
    order = [("on", None), ("off", None)] + [
        (side, rep) for rep in range(FLEET_TIMED_SAMPLES)
        for side in (("off", "on") if rep % 2 == 0 else ("on", "off"))
    ]
    delivery_new_bits.launches = 0
    samples = {"on": [], "off": []}
    activity = None
    for side, rep in order:
        fleet, targets = fresh(50_000 if rep is None else 60_000 + 1_000 * rep, side == "on")
        torch.cuda.reset_peak_memory_stats(dev)
        launches0, reads0 = delivery_new_bits.launches, _host.read.count
        capture = capturing(captured if (side, rep) == order[0] else None)
        start = time.perf_counter()
        with capture:
            rounds, cuts, resolved, sizes = fleet.run_until_membership(targets, **wave)
        ms = (time.perf_counter() - start) * 1e3
        launches = delivery_new_bits.launches - launches0
        reads = _host.read.count - reads0
        check(resolved.all(), f"fleet tenants unresolved: {np.nonzero(~resolved)[0].tolist()}")
        check(launches == wave["max_steps"],
              f"{launches} kernel launches in a {wave['max_steps']}-round wave")
        check(reads == 1, f"the wave made {reads} host reads")
        check((fleet.membership_sizes() == np.asarray(targets)).all(), "a tenant missed its target")
        samples[side].append(dict(
            warmup=rep is None, seed0=50_000 if rep is None else 60_000 + 1_000 * rep, ms=ms,
            view_changes=int(cuts.sum()), view_changes_per_sec=int(cuts.sum()) / (ms / 1e3),
            max_tenant_rounds=int(rounds.max()), host_reads=reads, kernel_launches=launches,
            peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
        ))
        if side == "on":
            fleet.sync()  # bench.py reads the lanes after its timed wave
            rollup, tenants = fleet.activity, fleet.tenant_activity
            check(rollup["rounds"] == int(rounds.sum()), "activity misses wave rounds")
            check(rollup["decisions_fast"] + rollup["decisions_classic"] == int(cuts.sum()),
                  "activity misses wave decisions")
            check([a["rounds"] for a in tenants] == rounds.tolist(), "a tenant's rounds differ")
            if rep is not None:
                rates = sorted(a["conflict_rate"] for a in tenants)
                activity = {
                    "seed0": samples[side][-1]["seed0"],
                    **{key: rollup[key] for key in (
                        "conflict_rate", "fast_path_share", "active_fraction",
                        "decisions_fast", "decisions_classic")},
                    "tenant_conflict_rate_min_median_max": [
                        rates[0], statistics.median(rates), rates[-1]],
                }
    total_launches = delivery_new_bits.launches
    sides = {}
    for side in ("on", "off"):
        fleet, targets = fresh(70_000, side == "on")
        (_, _, resolved, _), prof = profile_run(
            dev, lambda: fleet.run_until_membership(targets, **wave)
        )
        check(resolved.all(), "profiled fleet wave did not resolve")
        prof["kernels_per_round"] = prof["device_kernels"] / wave["max_steps"]
        timed = [s for s in samples[side] if not s["warmup"]]
        sides[side] = {
            "samples": samples[side],
            "median_ms": statistics.median(s["ms"] for s in timed),
            "median_view_changes_per_sec": statistics.median(
                s["view_changes_per_sec"] for s in timed),
            "view_changes_per_wave": [s["view_changes"] for s in timed],
            "peak_memory_bytes": max(s["peak_memory_bytes"] for s in timed),
            "profile": prof,
        }
    emit({"phase": "fleet_path", "tenants": b, "n": n, "n_slots": n + n_extra,
          "cohorts": FLEET["cohorts"], "rounds_per_wave": wave["max_steps"],
          "telemetry_on": {**sides["on"], "activity": activity}, "telemetry_off": sides["off"],
          "wave_ms_on_over_off": sides["on"]["median_ms"] / sides["off"]["median_ms"]})
    return total_launches


def pass_ms(fn, rounds, reps=5):
    """Milliseconds of one pass of ``fn`` over ``rounds`` in order (one
    launch each), captured as one CUDA graph after a warm-up pass: the
    median of ``reps`` replays, each between one pair of CUDA events."""
    return cuda_ms(lambda: [fn(*args) for args in rounds], reps=1, warmup=1, runs=reps)


def phase_kernel_paths(dev, paths):
    """Phase 10: the delivery kernel on the inputs captured from the paths
    (``paths``: name -> every round's arguments, in order). Each round
    bit for bit against the plain version; one pass over the rounds timed,
    beside the sum of the rounds' bounds and the share of draws needed."""
    from rapid_tpu_torch.ops.kernels import delivery_new_bits, delivery_new_bits_ref

    out = {}
    for name, rounds in paths.items():
        for i, args in enumerate(rounds):
            check(torch.equal(delivery_new_bits(*args), delivery_new_bits_ref(*args)),
                  f"delivery kernel differs on {name} round {i}")
        bounds = [delivery_bound(*args) for args in rounds]
        edges = sum(args[1].numel() * args[4] for args in rounds)  # k*n*t rings x c cohorts
        ms = pass_ms(delivery_new_bits, rounds)
        bound_ms = sum(b[0] for b in bounds)
        out[name] = dict(
            rounds=len(rounds), spread=rounds[0][5], permille=rounds[0][6],
            shape=list(rounds[0][1].shape), ms=ms, ms_per_launch=ms / len(rounds),
            bound_ms=bound_ms, bound_by=sorted({b[1] for b in bounds}),
            share_of_bound=bound_ms / ms, needed_draws=sum(b[2] for b in bounds),
            needed_draw_share=sum(b[2] for b in bounds) / edges,
        )
    emit({"phase": "kernel_paths", **out})
    return out


def parent_delivery(root):
    """The delivery kernel of another checkout at ``root`` (the first
    design's C entry point: 11 arguments, no fastmod constant), built with this tree's nvcc
    flags, as a callable with :func:`delivery_new_bits`'s arguments."""
    import ctypes
    from pathlib import Path

    from rapid_tpu_torch import _build

    src = Path(root) / "rapid_tpu_torch" / "csrc" / "delivery.cu"
    lib = Path(root) / "rapid_tpu_torch" / "build" / "libdelivery-parent.so"
    lib.parent.mkdir(exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).rapid_delivery_new_bits
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(blocked, age, epoch, k, c, spread, permille):
        t = age.shape[0] if age.dim() == 3 else 1
        out = torch.empty(age.shape[:-2] + (c, age.shape[-1]), dtype=torch.int32, device=age.device)
        stream = torch.cuda.current_stream(age.device).cuda_stream
        err = fn(blocked.data_ptr(), age.data_ptr(), epoch.data_ptr(), out.data_ptr(),
                 t, age.shape[-1], k, c, spread, permille, stream)
        check(err == 0, f"parent delivery kernel launch failed: cudaError {err}")
        return out

    return call


def phase_kernel_ab(dev, root, shapes, paths):
    """Phase 11 (with ``--parent``): the parent's kernel against this one on
    the same inputs, in turns (parent, change, change, parent): every mode
    warm and cold at both shapes (``shapes``: name -> the argument lists of
    :func:`kernel_modes`), and one pass over each path's captured rounds.
    The two must agree bit for bit."""
    from rapid_tpu_torch.ops.kernels import delivery_new_bits

    parent = parent_delivery(root)
    sides = {"parent": parent, "change": delivery_new_bits}

    def turns(time_side):
        got = {"parent": [], "change": []}
        for side in ("parent", "change", "change", "parent"):
            got[side].append(time_side(sides[side]))
        return {**got, "change_over_parent": statistics.mean(got["change"]) / statistics.mean(got["parent"])}

    cases = {}
    for shape, mode_args in shapes.items():
        for args in mode_args:
            check(torch.equal(parent(*args[0]), delivery_new_bits(*args[0])),
                  f"parent and change differ at {shape}")
            name = f"{shape}_spread{args[0][5]}_permille{args[0][6]}"
            cases[name + "_warm"] = turns(lambda f: cuda_ms(lambda: f(*args[0])))
            cases[name + "_cold"] = turns(lambda f: cuda_ms([functools.partial(f, *a) for a in args]))
    for name, rounds in paths.items():
        for args in rounds:
            check(torch.equal(parent(*args), delivery_new_bits(*args)),
                  f"parent and change differ on {name}")
        cases[name + "_captured"] = turns(lambda f: pass_ms(f, rounds))
    emit({"phase": "kernel_ab", "parent": str(root), "cases": cases})
    return cases


def launch_us(dev, count=2000):
    """Host microseconds per launch of a one-element kernel, ``count``
    launches back to back: the host's launch rate, which bounds both
    launch-bound paths (read after every phase, since it moves)."""
    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    start = time.perf_counter()
    for _ in range(count):
        x.add_(1)
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - start) / count * 1e6


def plane_lanes(tree):
    """Every lane of a state, fault, telemetry or ring tree as numpy."""
    from rapid_tpu_torch.convert import state_to_numpy

    return {} if tree is None else state_to_numpy(tree)


def check_same_lanes(got, want, what):
    check(set(got) == set(want), f"{what}: different lanes")
    for field, value in want.items():
        check(np.array_equal(got[field], value), f"{what}: lane {field} differs")


def phase_telemetry_engine(dev):
    from rapid_tpu_torch.models.state import map_lanes
    from rapid_tpu_torch.models.virtual_cluster import telemetry_digest, trace_digest
    from rapid_tpu_torch.tenancy import TenantFleet

    # Phase 3's churn with both planes, then quiet rounds so that the
    # 6-round ring has wrapped more than once.
    n, n_churn, ring, quiet = 4096, 102, 6, 6
    runs = {}
    for where, device, planes in (
        ("card", dev, True), ("cpu", torch.device("cpu"), True), ("card_off", dev, False),
    ):
        vc, _ = churn_cluster(n, n_churn, n_churn, 40, 7, device,
                              telemetry=planes, trace=ring if planes else 0)
        result = resolve(vc, n)
        for _ in range(quiet):
            vc.step()
        checksum = vc.sync()
        lanes = {**plane_lanes(vc.state), **plane_lanes(vc.faults),
                 **plane_lanes(vc.telem), **plane_lanes(vc.trace_ring)}
        digests = [] if not planes else [
            d(map_lanes(lambda x: x[None], tree)).cpu().numpy()
            for d, tree in ((telemetry_digest, vc.telem), (trace_digest, vc.trace_ring))
        ]
        runs[where] = (result, checksum, lanes, digests, vc.activity, vc.trace)
    card, cpu, off = runs["card"], runs["cpu"], runs["card_off"]
    check(card[0] == cpu[0] == off[0], f"planes: results differ {card[0]}, {cpu[0]}, {off[0]}")
    check(card[1] == cpu[1] == off[1], "planes: sync checksums differ")
    check_same_lanes(card[2], cpu[2], "planes card vs cpu")
    check_same_lanes({f: card[2][f] for f in off[2]}, off[2], "planes on vs off")
    check(all(np.array_equal(a, b) for a, b in zip(card[3], cpu[3])), "digests differ card vs cpu")
    check(card[4] == cpu[4] and card[5] == cpu[5], "decoded activity or ring differs")
    rounds = card[0][0] + quiet
    check(card[4]["rounds"] == rounds == card[5]["rounds_recorded"], "plane missed rounds")
    check(card[5]["wraps"] == rounds // ring >= 1 and card[5]["rounds_held"] == ring,
          f"the {ring}-round ring did not wrap as counted: {card[5]}")

    # Phase 7's fleet with both planes: card against CPU, each tenant against
    # its own single cluster, and the wave loop under the sync check.
    b, fn, n_extra, cohorts, fring = 6, 256, 6, 40, 16
    knobs = ((9, 4), (8, 3), (7, 2))
    wave = dict(max_steps=FLEET["max_steps"], max_cuts=4, min_cuts=1)
    planes = dict(telemetry=True, trace=fring)
    results, lanes = {}, {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        clusters, targets = fleet_clusters(b, fn, n_extra, cohorts, 300, device, knobs, **planes)
        fleet = TenantFleet.from_clusters(clusters)
        results[where] = [r.tolist() for r in fleet.run_until_membership(targets, **wave)]
        fleet.sync()
        lanes[where] = {**plane_lanes(fleet.state), **plane_lanes(fleet.telem),
                        **plane_lanes(fleet.trace_ring)}
        lanes[where + "_decoded"] = (fleet.tenant_activity, fleet.tenant_trace)
    check(results["card"] == results["cpu"], f"fleet with planes: results differ {results}")
    check(all(results["card"][2]), "fleet with planes did not resolve")
    check_same_lanes(lanes["card"], lanes["cpu"], "fleet planes card vs cpu")
    check(lanes["card_decoded"] == lanes["cpu_decoded"], "fleet decoded planes differ")
    singles, _ = fleet_clusters(b, fn, n_extra, cohorts, 300, dev, knobs, **planes)
    for i, vc in enumerate(singles):
        vc.run_until_membership(targets[i], **wave)
        for tree in (vc.telem, vc.trace_ring):
            for field, value in plane_lanes(tree).items():
                check(np.array_equal(lanes["card"][field][i], value),
                      f"tenant {i}: {field} differs from its single cluster")

    clusters, _ = fleet_clusters(b, fn, n_extra, cohorts, 300, dev, knobs, **planes)
    out = sync_checked_wave(TenantFleet.from_clusters(clusters), targets, **wave)
    check([x.tolist() for x in out[1:5]] == results["card"], "sync-checked wave with planes differs")
    check_same_lanes({**plane_lanes(out[5]), **plane_lanes(out[6])},
                     {f: lanes["card"][f] for f in (*out[5]._fields, *out[6]._fields)},
                     "sync-checked wave planes")
    emit({"phase": "telemetry_engine", "n": n, "cohorts": 40, "trace": ring,
          "rounds": rounds, "wraps": card[5]["wraps"], "lanes_bit_exact": len(cpu[2]),
          "activity": {k: card[4][k] for k in ("rounds", "alerts", "active_sum", "invalidations",
                                               "decisions_fast", "decisions_classic")},
          "fleet": {"tenants": b, "n": fn, "trace": fring, "rounds": results["card"][0],
                    "lanes_bit_exact": len(lanes["cpu"]), "singles_bit_exact": b,
                    "wave_sync_free": True}})


def check_compact_against_wide(wide_state, comp_cfg, comp_state, what):
    """The widened compact state equals the wide one on every lane, on the
    device, and every compact lane is stored at its policy dtype."""
    from rapid_tpu_torch.models.state import lane_storage, widen_state

    widened = widen_state(comp_cfg, comp_state)
    for field in wide_state._fields:
        check(torch.equal(getattr(widened, field), getattr(wide_state, field)),
              f"{what}: widened compact lane {field} differs from the wide one")
    storage = lane_storage(comp_cfg)
    for field, value in comp_state._asdict().items():
        check(value.dtype == storage[field], f"{what}: lane {field} is {value.dtype}, not {storage[field]}")


def pair_up(first, key, side, cfg, state, faults, result, what):
    """The wide-against-compact check of one key's two runs (phases 12 and
    13), with one side's state on the card at a time: the first run of a
    key leaves its final lanes on the host; the second brings them back
    and checks that both runs gave the same ``result`` and that the widened
    compact state (and faults) equals the wide one on the card."""
    from rapid_tpu_torch.convert import faults_from_numpy, state_from_numpy, state_to_numpy

    if key not in first:
        first[key] = (side, cfg, state_to_numpy(state), state_to_numpy(faults), result)
        return
    other, other_cfg, other_state, other_faults, other_result = first.pop(key)
    check(result == other_result, f"{what}: {side} {result}, {other} {other_result}")
    dev = state.alive.device
    tenants = state.alive.shape[0] if state.alive.dim() == 2 else None
    back = (state_from_numpy(other_cfg, other_state, dev, tenants),
            faults_from_numpy(other_cfg, other_faults, dev, tenants))
    wide, comp = ((state, faults), back) if side == "wide" else (back, (state, faults))
    comp_cfg = cfg if side == "compact" else other_cfg
    for wide_lanes, comp_lanes in zip(wide, comp):
        check_compact_against_wide(wide_lanes, comp_cfg, comp_lanes, what)


def state_bytes(vc):
    """(bytes of the state's and faults' tensors, the formula's bytes)."""
    from rapid_tpu_torch.models.state import pytree_nbytes, state_bytes_total

    return pytree_nbytes(vc.state) + pytree_nbytes(vc.faults), state_bytes_total(vc.cfg)


def phase_compact_paths(dev):
    """Phase 12: the churn and the 1M point, wide against compact. Returns
    the delivery launches of (the churns, the 1M runs)."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
    from rapid_tpu_torch.ops.kernels import delivery_new_bits

    n, n_join = HEADLINE["n"], HEADLINE["n_join"]
    sides = ("wide", "compact")
    order = [(0, "wide"), (0, "compact")] + [
        (seed, side) for seed in range(1, 1 + COMPACT_TIMED_SAMPLES)
        for side in (sides if seed % 2 else sides[::-1])
    ]
    samples = {side: [] for side in sides}
    first, bytes_per_member = {}, {}
    delivery_new_bits.launches = 0
    for seed, side in order:
        vc, victims = churn_cluster(n, n_join, HEADLINE["n_crash"], HEADLINE["cohorts"], seed, dev,
                                    compact=side == "compact")
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        launches0, reads0 = delivery_new_bits.launches, _host.read.count
        start = time.perf_counter()
        rounds, cuts, resolved, sizes = resolve(vc, n)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - start) * 1e3
        check(resolved and vc.membership_size == n, f"{side} churn unresolved: {cuts} cuts, {sizes}")
        alive = vc.alive_mask
        check(not alive[victims].any() and alive[n:].all(), f"{side} churn: wrong members")
        measured, formula = state_bytes(vc)
        check(measured == formula, f"{side} churn: {measured} state bytes, the formula {formula}")
        bytes_per_member[side] = measured / vc.cfg.n
        samples[side].append(dict(
            warmup=seed == 0, seed=seed, ms=ms, rounds=rounds, cuts=cuts, sizes=list(sizes),
            host_reads=_host.read.count - reads0,
            kernel_launches=delivery_new_bits.launches - launches0,
            allocated_before_bytes=before,
            peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
        ))
        pair_up(first, seed, side, vc.cfg, vc.state, vc.faults, (rounds, cuts, sizes, vc.config_id),
                f"churn seed {seed}")
        del vc
    churn_launches = delivery_new_bits.launches
    check(churn_launches > 0, "the compact churns never launched the delivery kernel")
    profiles = {side: profile_churn(dev, compact=side == "compact") for side in sides}

    # The 1M point, wide and compact from the same seeds, in turns.
    n1, cohorts = SCALE["n"], SCALE["cohorts"]
    runs = {side: [] for side in sides}
    delivery_new_bits.launches = 0
    for seed, side in ((7, "wide"), (7, "compact"), (8, "compact"), (8, "wide")):
        vc = VirtualCluster.create(
            n1, k=HEADLINE["k"], h=9, l=4, cohorts=cohorts, fd_threshold=3, seed=seed,
            delivery_spread=HEADLINE["spread"], compact=side == "compact", device=dev,
        )
        vc.assign_cohorts_roundrobin()
        vc.crash(np.random.default_rng(seed).choice(n1, size=n1 // 100, replace=False))
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        launches0 = delivery_new_bits.launches
        start = time.perf_counter()
        rounds, decided, _, members = vc.run_to_decision(max_steps=96)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - start) * 1e3
        check(decided and members == n1 - n1 // 100, f"{side} 1M point: {decided}, {members}")
        measured, formula = state_bytes(vc)
        check(measured == formula, f"{side} 1M: {measured} state bytes, the formula {formula}")
        runs[side].append(dict(warmup=seed == 7, ms=ms, rounds=rounds, state_bytes=measured,
                               kernel_launches=delivery_new_bits.launches - launches0,
                               allocated_before_bytes=before,
                               peak_memory_bytes=torch.cuda.max_memory_allocated(dev)))
        pair_up(first, seed, side, vc.cfg, vc.state, vc.faults, (rounds, vc.config_id), f"1M seed {seed}")
        del vc
    scale_launches = delivery_new_bits.launches
    check(scale_launches > 0, "the 1M runs never launched the delivery kernel")

    def churn_side(side):
        timed = [x for x in samples[side] if not x["warmup"]]
        return {"median_ms": statistics.median(x["ms"] for x in timed),
                "samples": samples[side],
                "peak_memory_bytes": max(x["peak_memory_bytes"] for x in timed),
                "state_bytes_per_member": bytes_per_member[side],
                "kernels_per_round": profiles[side]["kernels_per_round"],
                "profile": profiles[side]}

    emit({"phase": "compact_paths", "churn": {
        "n": n, "n_slots": n + n_join, "cohorts": HEADLINE["cohorts"],
        **{side: churn_side(side) for side in sides},
        "ms_compact_over_wide": churn_side("compact")["median_ms"] / churn_side("wide")["median_ms"],
        "launches": churn_launches, "widened_equal_to_wide": len(order) // 2,
    }, "scale_point": {
        "n": n1, "cohorts": cohorts,
        **{side: {"runs": runs[side], "state_bytes_per_member": runs[side][0]["state_bytes"] / n1,
                  "peak_memory_bytes": max(r["peak_memory_bytes"] for r in runs[side])}
           for side in sides},
        "launches": scale_launches,
    }})
    return churn_launches, scale_launches


def compact_fleet(fleet):
    """The fleet with its stacked state narrowed to the compact policy (the
    fault masks, knobs and plane lanes as they are)."""
    from rapid_tpu_torch.models.state import narrow_state
    from rapid_tpu_torch.tenancy import TenantFleet

    cfg = fleet.cfg._replace(compact=1)
    out = TenantFleet(cfg, narrow_state(cfg, fleet.state), fleet.faults, fleet.knobs)
    out.telem, out.trace_ring = fleet.telem, fleet.trace_ring
    return out


def phase_compact_fleet(dev, built):
    """Phase 13: ``built`` = (a fleet built on the CPU, its targets), run
    wide and compact on the card in turns. Returns the delivery launches."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.models.state import pytree_nbytes
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.tenancy.fleet import tenant_health

    cpu, targets = built
    wave = dict(max_steps=FLEET["max_steps"], max_cuts=4, min_cuts=1)
    sides = ("wide", "compact")
    order = [(None, "wide"), (None, "compact")] + [
        (rep, side) for rep in range(COMPACT_TIMED_SAMPLES) for side in (sides if rep % 2 else sides[::-1])
    ]
    samples = {side: [] for side in sides}
    first, nbytes = {}, {}
    delivery_new_bits.launches = 0
    for rep, side in order:
        fleet = fleet_on(cpu, dev)
        if side == "compact":
            fleet = compact_fleet(fleet)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        launches0, reads0 = delivery_new_bits.launches, _host.read.count
        start = time.perf_counter()
        result = fleet.run_until_membership(targets, **wave)
        ms = (time.perf_counter() - start) * 1e3
        launches, reads = delivery_new_bits.launches - launches0, _host.read.count - reads0
        check(result[2].all(), f"{side} fleet: tenants unresolved")
        check(launches == wave["max_steps"] and reads == 1, f"{side} wave: {launches} launches, {reads} reads")
        check(bool(tenant_health(fleet.cfg, fleet.state).all()), f"{side} fleet: a tenant is unhealthy")
        nbytes[side] = (pytree_nbytes(fleet.state) + pytree_nbytes(fleet.faults)) / (fleet.b * fleet.cfg.n)
        samples[side].append(dict(warmup=rep is None, ms=ms, view_changes=int(result[1].sum()),
                                  view_changes_per_sec=int(result[1].sum()) / (ms / 1e3),
                                  kernel_launches=launches, host_reads=reads,
                                  allocated_before_bytes=before,
                                  peak_memory_bytes=torch.cuda.max_memory_allocated(dev)))
        if side == "compact":
            check(fleet.state.ring_perm.dtype == fleet.state.obs_idx.dtype == torch.int16,
                  f"fleet index lanes are {fleet.state.obs_idx.dtype}, not int16")
        pair_up(first, rep, side, fleet.cfg, fleet.state, fleet.faults,
                [r.tolist() for r in result], f"fleet rep {rep}")
        del fleet
    total = delivery_new_bits.launches
    # Kernels per round from the first rounds of a wave: the lockstep wave
    # launches the same kernels every round, and the profiler's processing
    # of a whole wave's ~330,000 host ops would take tens of seconds.
    profiles, profiled_rounds = {}, 8
    for side in sides:
        fleet = fleet_on(cpu, dev)
        fleet = compact_fleet(fleet) if side == "compact" else fleet
        _, profiles[side] = profile_run(
            dev, lambda: fleet.run_until_membership(targets, **{**wave, "max_steps": profiled_rounds}))
        profiles[side]["kernels_per_round"] = profiles[side]["device_kernels"] / profiled_rounds
        del fleet

    def side_summary(side):
        timed = [x for x in samples[side] if not x["warmup"]]
        return {"median_ms": statistics.median(x["ms"] for x in timed),
                "median_view_changes_per_sec": statistics.median(x["view_changes_per_sec"] for x in timed),
                "peak_memory_bytes": max(x["peak_memory_bytes"] for x in timed),
                "state_bytes_per_member": nbytes[side], "samples": samples[side],
                "kernels_per_round": profiles[side]["kernels_per_round"], "profile": profiles[side]}

    emit({"phase": "compact_fleet", "tenants": cpu.b, "n_slots": cpu.cfg.n,
          "rounds_per_wave": wave["max_steps"], **{side: side_summary(side) for side in sides},
          "ms_compact_over_wide": side_summary("compact")["median_ms"] / side_summary("wide")["median_ms"],
          "launches": total, "widened_equal_to_wide": len(order) // 2, "tenants_healthy": True})
    return total


def endpoint_list(count):
    """``count`` endpoints with hostnames of mixed lengths and varied ports."""
    from rapid_tpu_torch.types import Endpoint

    return [Endpoint(f"node-{i}.r{i % 97}.dc{i % 3}.example", 7000 + (i * 7919) % 50_000)
            for i in range(count)]


def endpoint_churn(endpoints, n, n_join, n_crash, device):
    """A compact endpoint cluster of ``n`` members and ``n_join`` keyed
    joiner slots (the churn's geometry), its cohorts assigned, ``n_crash``
    seeded crashes and the joiners injected. Returns (cluster, victims)."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    vc = VirtualCluster.from_endpoints(
        endpoints, n_members=n, n_slots=n + n_join, k=HEADLINE["k"], h=9, l=4,
        cohorts=HEADLINE["cohorts"], fd_threshold=3, delivery_spread=HEADLINE["spread"],
        concurrent_coordinators=2, compact=True, device=device,
    )
    vc.assign_cohorts_roundrobin()
    victims = np.random.default_rng(n).choice(n, size=n_crash, replace=False)
    vc.crash(victims)
    vc.inject_join_wave(np.arange(n, n + n_join))
    return vc, victims


def phase_endpoints_path(dev):
    """Phase 14. Returns the delivery launches of the 100,000-member churn."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.convert import state_to_numpy
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.ops.rings import endpoint_ring_keys, ring_topology, ring_topology_from_perm

    n, n_join, n_crash = HEADLINE["n"], HEADLINE["n_join"], HEADLINE["n_crash"]
    endpoints = endpoint_list(n + n_join)
    start = time.perf_counter()
    key_hi, _ = endpoint_ring_keys(endpoints, HEADLINE["k"])
    ring_key_ms = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    vc, victims = endpoint_churn(endpoints, n, n_join, n_crash, dev)
    torch.cuda.synchronize(dev)
    build_ms = (time.perf_counter() - start) * 1e3
    check(np.array_equal(state_to_numpy(vc.state)["key_hi"], key_hi), "ring keys differ on the card")
    alive = vc.state.alive
    by_sort = ring_topology(vc.state.key_hi, vc.state.key_lo, alive)
    by_perm = ring_topology_from_perm(vc.state.ring_perm, alive)
    for field in by_sort._fields:
        check(torch.equal(getattr(by_sort, field), getattr(by_perm, field)),
              f"ring_topology and ring_topology_from_perm differ in {field}")
    delivery_new_bits.launches = 0
    reads0 = _host.read.count
    torch.cuda.synchronize(dev)
    start = time.perf_counter()
    rounds, cuts, resolved, sizes = resolve(vc, n)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - start) * 1e3
    launches, reads = delivery_new_bits.launches, _host.read.count - reads0
    check(resolved and vc.membership_size == n, f"endpoint churn unresolved: {cuts} cuts, {sizes}")
    members = vc.alive_mask
    check(not members[victims].any() and members[n:].all(), "endpoint churn: wrong members")
    check(launches > 0, "the endpoint churn never launched the delivery kernel")

    # The same path at 2,048 endpoints on the card and on the CPU.
    twin = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        small, _ = endpoint_churn(endpoint_list(2_048), 2_000, 48, 48, device)
        result = resolve(small, 2_000)
        twin[where] = (result, {**state_to_numpy(small.state), **state_to_numpy(small.faults)})
    check(twin["card"][0] == twin["cpu"][0] and twin["card"][0][2], f"endpoint twin: {twin['card'][0]}, {twin['cpu'][0]}")
    check_same_lanes(twin["card"][1], twin["cpu"][1], "endpoint twin card vs cpu")
    emit({"phase": "endpoints_path", "endpoints": n + n_join, "n": n, "compact": True,
          "ring_key_ms_host": ring_key_ms, "build_ms": build_ms, "ms": ms, "rounds": rounds,
          "cuts": cuts, "sizes": list(sizes), "host_reads": reads,
          "kernel_launches": launches, "topology_sort_equals_scan": True,
          "twin": {"endpoints": 2_048, "rounds": twin["card"][0][0],
                   "lanes_bit_exact": len(twin["cpu"][1])}})
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", metavar="DIR",
                        help="another checkout whose delivery kernel phase 11 times against this one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from rapid_tpu_torch import _build

    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    start = time.perf_counter()
    _build.build_all()
    ptxas = [ln.strip() for log in _build.build_log.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - start, "sources": _build.sources(),
          "ptxas": ptxas, "card": card, "torch": torch.__version__, "cuda": torch.version.cuda})

    seconds, launch = {}, {"start": launch_us(dev)}

    def timed(name, fn, *args):
        begin = time.perf_counter()
        out = fn(dev, *args)
        seconds[name] = time.perf_counter() - begin
        launch[name] = launch_us(dev)
        return out

    paths = {"churn": [], "fleet_wave": []}
    built = []
    modes, churn_inputs = timed("kernel", phase_kernel)
    timed("engine", phase_engine)
    launches = {"churn": timed("main_path", phase_main_path, paths["churn"]),
                "scale_point": timed("scale_point", phase_scale_point)}
    fleet_modes, fleet_inputs = timed("kernel_fleet", phase_kernel_fleet)
    timed("fleet_engine", phase_fleet_engine)
    launches["fleet_wave"] = timed("fleet_path", phase_fleet_path, paths["fleet_wave"], built)
    timed("telemetry_engine", phase_telemetry_engine)
    captured = timed("kernel_paths", phase_kernel_paths, paths)
    if args.parent:
        timed("kernel_ab", phase_kernel_ab, args.parent,
              {"churn": churn_inputs, "fleet": fleet_inputs}, paths)
    # The kernel phases' inputs and the captured rounds (~2.5 GB on the
    # card) go before the layouts' peak memory is read.
    del churn_inputs, fleet_inputs
    paths.clear()
    launches["compact_churn"], launches["compact_scale_point"] = timed(
        "compact_paths", phase_compact_paths)
    launches["compact_fleet_wave"] = timed("compact_fleet", phase_compact_fleet, built)
    launches["endpoints_churn"] = timed("endpoints_path", phase_endpoints_path)
    emit({"phase": "timing", "seconds": seconds, "total_seconds": time.perf_counter() - start,
          "launch_us_after": launch})

    def paths_mode(mode_list):
        return next(m for m in mode_list if (m["spread"], m["permille"]) == (HEADLINE["spread"], 1000))

    keys = ("ms", "cold_ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
            "cold_share_of_bound", "needed_draw_share")
    main_mode, fleet_mode = paths_mode(modes), paths_mode(fleet_modes)
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
        "cold_ms": main_mode["cold_ms"],
        "fleet_shape": {key: fleet_mode[key] for key in keys},
        "mode0": {shape: {key: m[key] for key in keys} for shape, m in (
            ("churn", modes[0]), ("fleet", fleet_modes[0]))},
        "captured": {name: {key: run[key] for key in (
            "rounds", "ms", "bound_ms", "share_of_bound", "needed_draw_share")}
            for name, run in captured.items()},
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
