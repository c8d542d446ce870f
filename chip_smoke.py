#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rapid_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``, and imports neither JAX nor the ``rapid_tpu`` package.
Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. build: compile every ``rapid_tpu_torch/csrc/*.cu`` (one ``nvcc`` each,
   started together) and report the build time and ptxas's register report,
   then the native host library (``g++``; phase 22 (a));
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
   card and on the CPU, equal on every lane;
15. serving: ``bench.py``'s stream stage as it writes it for an accelerator
   (``rapid_tpu_torch.serving.StreamDriver``, 64 waves of 8 rounds, 2 deep):
   a cluster of N=4,096 (4,224 slots, C=8, the plane and a 512-round ring,
   ``PoissonChurn(rate=2.0, seed=7,300)``) and a fleet of 4 such tenants
   (``FleetPoissonChurn(rate=0.5, seed=7,500)``), after ``bench.py``'s
   warm-up; then the same single-cluster stream at the headline churn's
   geometry (N=100,000, 102,500 slots, C=64, a 128-round ring, 16 waves,
   rate 64). Every wave's application and every streamed round run with each
   synchronizing call an error and must make no counted read; each stream
   equals the same schedule driven through the batch seams and ``step()``
   on the card (cut count, config ids, every lane of state, faults and
   planes); the first 8 waves of the cluster stream equal the CPU's on every
   lane; no wave's span was evicted from the ring. Printed: each
   ``StreamResult``, the combined rate, p99 and overlap, the ring's
   trajectory, and kernels per round of ``stream_step`` against ``step()``
   from one profiled 8-round sample each;
16. recovery: ``bench.py``'s drill (``Supervisor``: N=4,096, 4,128 slots,
   16 waves of 4 rounds, a checkpoint every 5 waves, a transient failure at
   wave 1, a kill after wave 8, ``recovery.resume`` on the card and the
   rest replayed; 2 waves without churn after it) against an uninterrupted
   twin, every lane equal; a checkpoint written on the card loaded on the
   CPU to equal lanes; a damaged newest checkpoint skipped for its
   predecessor, which replays to the twin; then the same drill at the
   headline geometry (rate 64), whose checkpoints hold the full wide
   state. Printed: MTTR, resume-to-serving, retries, replayed cuts and each
   checkpoint's bytes and write time;
17. chaos: ``bench.py``'s chaos stage as it writes it for an accelerator
   (``rapid_tpu_torch.tenancy.chaos.fuzz_fleet``: 256 mixed hostile
   scenarios over the ten fleet families, seeds 70,000 for the warm-up and
   71,000 timed, no violation allowed), its fields printed; the timed specs
   run again on the CPU to equal phase records, final slots, soak cuts and
   totals; one restack of the 256 clusters timed; the first phase group's
   wave again under the sync check and once profiled; the tampered
   two-tenant fleet (tenant 1 at H=5 under a schedule judged at H=9)
   shrunk and its repro written on the card, then replayed on the CPU to
   the same violations and an undivided round trace;
18. loss_variant: ``bench.py``'s loss variant: phase 4's churn at
   N=100,000 with ``churn_under_loss``'s 5% loss mapped onto the delivery
   knobs by ``loss_as_engine_delivery`` (spread 2, 50 permille: the
   kernel's gated mode), a warm-up on seed 100 and the minimum of seeds
   101 and 102, with ``bench.py``'s membership assertion; a twin at
   N=4,096 on the card and on the CPU, equal on every lane. Then the
   delivery rounds captured from the timed chaos fleet and the loss
   warm-up go through phase 10's checks and timings;
19. observability: the scrape tier. Phase 4's churn at N=100,000 with the
   plane and a 64-round ring, then ``telemetry_snapshot()`` and its
   Prometheus text, each timed, the text's bytes and the snapshot's counted
   reads; the allocator gauges set, ``device_bytes_in_use`` equal to
   ``torch.cuda.memory_allocated`` at the scrape, the peak at least the
   state's bytes; the build capture's arithmetic (lookups are hits plus
   misses, builds are misses and the build histogram's count). Phase 9's
   churn at N=4,096 on the card and on the CPU: equal snapshots (but the
   build and memory sections and wall-clock values), metric names and ring
   recordings. Phase 8's fleet after one wave (every ``tenant=`` label
   present, names equal to a 6-tenant CPU fleet's) and phase 15's stream
   cluster under a ``Supervisor``, scraped between waves (its ``stream``
   and ``recovery`` names equal to the CPU's). One more N=100,000 churn
   under ``profiling.trace`` inside ``annotate("churn")``: the exported
   trace holds the delivery kernel and the span, and the churn's results
   equal the unprofiled one's. Last, ptxas's facts of every delivery
   kernel instance (``compiled_memory_analysis("delivery")``);
20. host_path: the host membership path (``rapid_tpu_torch.protocol``)
   with its two device adapters on the card, at the paper's K/H/L =
   10/9/3. (a) A ``MembershipView`` of 2,000 endpoints and a
   ``DeviceCutDetector`` (4,096 slots) fed per-observer
   ``BatchedAlertMessage``s in a seeded shuffled order: a 1% crash, a
   20-joiner wave and a crash under flux that clears only through the
   implicit invalidation; every proposal equal to the CPU adapter's and
   the host ``MultiNodeCutDetector``'s, one counted read a pass; ms, reads
   and uploaded bytes per batch, and one wave profiled. (b) 2,000 seeded
   fast-round votes over three proposals (1,600 / 300 / 100, one with a
   high hash lane of 2**31 or above) through ``FastPaxos`` with a
   ``DeviceVoteTally`` and with the host tally: the same decision at the
   same vote, the votes before quorum under the sync check, one read a
   tally; µs a vote, ms a tally, the tallies profiled. (c) 50 nodes
   through ``Cluster.start`` / ``Cluster.join`` on one in-process network,
   every node on both adapters on the card, 5 crashed, and the same with
   the host's detector and tally; then ``examples/host_scale_ceiling.py``'s
   service-level crash at N=200 with device and with host adapters, to
   equal final configurations. No delivery kernel is launched;
21. host_sim: the host chaos harness and the hierarchy. (a) The pinned
   chaos grid (every family of ``rapid_tpu_torch.sim.fuzz.FAMILIES`` x seeds
   1-5, the four hierarchical families included) through ``run_schedule``
   and ``check_all`` with the differential replay on the card: no
   violation, cuts wherever the schedule asks for a membership change, every
   replay equal to the same replay on the CPU; the delivery inputs of every
   replay round captured; scenarios per second, the host run's and the
   replay's shares, and kernels per replay round from one profiled replay.
   (b) ``examples/host_scale_ceiling.py``'s service-level crash at N=256
   with ``hier_target_cohort_size=64`` (4 cohorts) under a ``ManualClock``:
   ``HierMembershipService`` with a ``DeviceCutDetector`` on the card and
   with the host detector (to equal configuration ids), and the flat
   service beside them. (c) 64 nodes through ``Cluster.start`` /
   ``Cluster.join`` over ``UdpHybridServer`` / ``UdpHybridClient`` on
   loopback, cohorts of 16, every cut detector on the card, 3 members of
   one cohort crashed; then ``examples/udp_loss_curve.py``'s measurement on
   the port (8 nodes; 0, 1, 5, 10 and 20% datagram loss). Then the captured
   replay rounds go through phase 10's checks and timings.

22. config_resume: a cluster resumed from a saved ``Configuration`` at
   the churn's geometry (102,500 endpoints of phase 14's
   ``endpoint_list``). (a) The native host library (``g++`` of
   ``csrc/rapid_native.cpp``, built at the start of the run, before phase
   14, so that phase 14's ring keys take it): its compiler, wall ms and
   path; the run fails there when it does not build or load. (b) A native
   ``Configuration`` of the first 100,000 endpoints with seeded
   ``NodeId``s, saved and loaded (bytes, write and read ms, equal
   contents), and a 2,048-member java one round-tripped as version 2.
   (c) Its configuration id through the native library and the Python
   fold, equal, ms each. (d) The ring keys of all 102,500 endpoints at
   K=10 natively and through numpy, equal, ms each. (e) The host view
   rebuilt from the loaded configuration (ms), each ring equal to the
   engine's ``ring_perm`` restricted to member slots. (f) That engine,
   ``VirtualCluster.from_endpoints`` of the loaded members and 2,500
   joiners on the card, through phase 14's churn (2,500 crashes, 2,500
   joins) to the right member set; every round's delivery inputs
   captured, then through phase 10's checks and timings.
23. sharded: the sharded engine (``rapid_tpu_torch.parallel``) on a
   one-rank NCCL group (a file rendezvous in a temporary directory, on the
   loopback interface), every collective really issued. (a) The delivery
   kernel at the churn shape on column slices at slot offsets 0, 33,333
   and 51,250 and on the upper cohort word at cohort offset 32, in the
   two draw modes: each bit for bit against its plain version, side by
   side against the whole launch. (b) Phase 4's churn through
   ``make_sharded_wave`` on the ``(cohort=1, nodes=1)`` mesh, (c) phase
   5's 1M point through ``make_sharded_step`` to decision on
   ``(nodes=1)``, (d) phase 8's 256x1,024 fleet in one 96-round wave
   through ``make_fleet_wave`` on ``(tenant=1, cohort=1, nodes=1)``, (e)
   six churn rounds with the plane and a 64-round ring through
   ``make_sharded_step_trace``: each held against its unsharded twin, in
   turns (b, c, e: two each; d: a warm-up and one each), on the same seeds (rounds, cuts, sizes, checksum and every lane,
   digests for (e)), with equal host reads and one delivery launch a
   round, every round under ``set_sync_debug_mode("error")`` outside the
   counted reads; the collectives per round by site, kind and payload
   class with their bytes, and one profiled churn a side; beside them the
   host microseconds of one collective on the one-rank group. The rounds
   of (b)'s and (d)'s warm-ups and of (c)'s first sharded run are
   captured for phase 10's checks.

A kernel's bound (``delivery_bound``) is the larger of its bytes (each
input once, the output once) over the HBM rate and the delay draws its
inputs need (unblocked edges with ``0 <= age < spread``) times the
operations of one draw over the int32 issue rate.

The delivery kernel's launch count is zeroed just before each of the
paths 4, 5, 8, 12 (churn and 1M), 13, 14, 15 (each stream), 16 (each drill
with its twin), 17 (the timed fleet), 18 (the three churns) and 19 (each
scraped path and the profiled churn) and 21 (a: the grid's ``check_all``
replays) and 22 (f) and 23 (each of b-e, each side) and read just after;
phase 20 and phase 21's (b) and (c) zero it and must leave it at 0. Then the kernels
line (with ptxas's facts), the card's
name and power limit from ``nvidia-smi``, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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


def delivery_bound(blocked, age, epoch, k, c, spread, permille, *offsets):
    """(bound_ms, bound_by, needed draws) of one delivery call on these
    inputs (one cluster or a fleet). Bytes: each input read once and the
    ``[t, c, n]`` output written once. Operations: the draws these inputs
    need (:func:`delivery_needed_draws`) times the operations of one draw
    (:func:`delivery_ops_per_draw`); the per-edge test is not counted, since
    a word-wide kernel forms 32 outputs with a few operations. The larger of
    the two times, at the H100's HBM rate and int32 issue rate. A shard's
    ``offsets`` (global slot and cohort of its first column and row) move
    no bytes and change no count."""
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


def churn_cluster(n, n_join, n_crash, cohorts, seed, device, delivery_spread=HEADLINE["spread"],
                  delivery_prob_permille=1000, **planes):
    """bench.py's 5%-churn build: round-robin cohorts, FD counters staggered
    over 3 rounds, ``n_crash`` crashes and ``n_join`` joins, with the
    delivery knobs given (bench.py's clean churn by default, its loss
    variant with ``loss_as_engine_delivery``'s). ``planes``: ``telemetry`` /
    ``trace`` for ``VirtualCluster.create``."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    vc = VirtualCluster.create(
        n, n_slots=n + n_join, k=HEADLINE["k"], h=9, l=4, cohorts=cohorts, fd_threshold=3,
        seed=seed, delivery_spread=delivery_spread, concurrent_coordinators=2,
        delivery_prob_permille=delivery_prob_permille, device=device, **planes,
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
    ``min_cuts``: one value, or one per tenant. Returns what ``fleet_wave``
    returns."""
    from rapid_tpu_torch.tenancy.fleet import fleet_wave

    target_t = torch.tensor(targets, dtype=torch.int32, device=fleet.device)
    min_t = torch.tensor(np.broadcast_to(min_cuts, target_t.shape), dtype=torch.int32,
                         device=fleet.device)
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


def captured_report(name, rounds):
    """The delivery kernel on the inputs captured from one path (every
    round's arguments, in order): each round bit for bit against the plain
    version, then one pass over the rounds timed for the kernel and for the
    plain version, beside the sum of the rounds' bounds and the share of
    draws needed."""
    from rapid_tpu_torch.ops.kernels import delivery_new_bits, delivery_new_bits_ref

    check(rounds, f"no delivery round was captured on {name}")
    for i, args in enumerate(rounds):
        check(torch.equal(delivery_new_bits(*args), delivery_new_bits_ref(*args)),
              f"delivery kernel differs on {name} round {i}")
    bounds = [delivery_bound(*args) for args in rounds]
    edges = sum(args[1].numel() * args[4] for args in rounds)  # k*n*t rings x c cohorts
    ms = pass_ms(delivery_new_bits, rounds)
    bound_ms = sum(b[0] for b in bounds)
    return dict(
        rounds=len(rounds), spread=rounds[0][5], permille=rounds[0][6],
        shape=list(rounds[0][1].shape), ms=ms, ms_per_launch=ms / len(rounds),
        plain_ms=cuda_ms(lambda: [delivery_new_bits_ref(*args) for args in rounds], reps=1,
                         warmup=1, runs=3, graph=False),
        bound_ms=bound_ms, bound_by=sorted({b[1] for b in bounds}),
        share_of_bound=bound_ms / ms, needed_draws=sum(b[2] for b in bounds),
        needed_draw_share=sum(b[2] for b in bounds) / edges,
    )


def phase_kernel_paths(dev, paths):
    """Phase 10: the delivery kernel on the inputs captured from the paths
    (``paths``: name -> every round's arguments, in order), each path
    through :func:`captured_report`."""
    out = {name: captured_report(name, rounds) for name, rounds in paths.items()}
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


# -- phases 15-16: the serving tier ----------------------------------------

# bench.py's stream stage as it writes it for an accelerator: N=4,096 members
# (2 x 64 spare slots for the joins), K=10, H=9, L=4, 8 cohorts, fd_threshold
# 3, spread 2, the plane and a ring of the whole stage's 512 rounds on, 64
# waves of 8 rounds 2 deep; a fleet of 4 such tenants.
STREAM = dict(n=4_096, cohorts=8, waves=64, rounds=8, depth=2, tenants=4, rate=2.0,
              fleet_rate=0.5, cpu_waves=8)
# The same single-cluster stream at the headline churn's geometry.
STREAM_HEADLINE = dict(n=HEADLINE["n"], n_slots=HEADLINE["n"] + HEADLINE["n_join"],
                       cohorts=HEADLINE["cohorts"], trace=128, waves=16, rate=64.0)
# bench.py's recovery drill: 16 waves of 4 rounds, a checkpoint every 16 // 3
# waves, one transient failure at wave 1, a kill after wave 8; then 2 waves
# without churn on the twin and the resumed drill, so that a cut still
# pending (at N=100,000 a 4-round wave ends before its cut) commits on both.
RECOVERY = dict(waves=16, rounds=4, every=5, kill_after=8, settle_waves=2)


def stream_cluster(n, n_slots, cohorts, trace, seed, device, telemetry=True):
    """bench.py's stream cluster (its recovery cluster with the planes off)."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    vc = VirtualCluster.create(
        n, n_slots=n_slots, k=HEADLINE["k"], h=9, l=4, cohorts=cohorts, fd_threshold=3, seed=seed,
        delivery_spread=HEADLINE["spread"], telemetry=telemetry, trace=trace if telemetry else 0,
        device=device,
    )
    vc.assign_cohorts_roundrobin()
    return vc


def stream_fleet(seed0, device):
    """bench.py's stream fleet: STREAM["tenants"] clusters of N members."""
    from rapid_tpu_torch.tenancy import TenantFleet

    n, trace = STREAM["n"], STREAM["waves"] * STREAM["rounds"]
    return TenantFleet.from_clusters([
        stream_cluster(n, n, STREAM["cohorts"], trace, seed0 + i, device)
        for i in range(STREAM["tenants"])
    ])


def sync_checked_stream(target, **shape):
    """A StreamDriver over ``target`` whose every wave application and every
    streamed round run with each synchronizing call an error, and whose
    submits make no counted read: only the ticket waits may block."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.serving import StreamDriver

    def checked(fn, *args):
        reads = _host.read.count
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(_host.read.count == reads, f"{fn.__name__} read the host on the stream path")
        return out

    class Checked(StreamDriver):
        def submit(self, wave):
            reads = _host.read.count
            super().submit(wave)
            check(_host.read.count == reads, "a submit read the host")

        def _apply(self, wave):
            checked(super()._apply, wave)

    step = target.stream_step
    target.stream_step = lambda: checked(step)
    return Checked(target, **shape)


def batch_drive(target, waves, rounds):
    """The batch spelling of a stream schedule: the injection seams (the
    join's admissibility read included) and ``step()`` rounds."""
    from rapid_tpu_torch.serving import FleetWave

    for wave in waves:
        if isinstance(wave, FleetWave):
            if wave.crash:
                target.stream_crash(wave.crash)
        else:
            if wave.crash:
                target.crash(list(wave.crash))
            if wave.join:
                target.inject_join_wave(list(wave.join))
        for _ in range(rounds):
            target.step()


def all_lanes(target):
    return {**plane_lanes(target.state), **plane_lanes(target.faults),
            **{f"telem.{k}": v for k, v in plane_lanes(target.telem).items()},
            **{f"trace.{k}": v for k, v in plane_lanes(target.trace_ring).items()}}


def run_stream(dev, target, waves, checked=True):
    """``waves`` through a (sync-checked) driver 8 rounds, 2 deep; returns
    (driver, StreamResult as a dict, delivery launches)."""
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.serving import StreamDriver

    shape = dict(rounds_per_wave=STREAM["rounds"], depth=STREAM["depth"])
    driver = sync_checked_stream(target, **shape) if checked else StreamDriver(target, **shape)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    delivery_new_bits.launches = 0
    for wave in waves:
        driver.submit(wave)
    result = driver.drain()
    launches = delivery_new_bits.launches
    check(result.waves == len(waves) and result.cuts > 0, f"stream result {result}")
    return driver, result._asdict(), launches


def stream_vs_batch(dev, build, waves, what):
    """Stream ``waves`` through a sync-checked driver on a fresh target from
    ``build(dev)``, drive the same schedule through the batch seams on
    another, and hold them equal: config ids, the cut count and every lane
    of state, faults and planes. Returns (driver, result, launches)."""
    streamed = build(dev)
    driver, result, launches = run_stream(dev, streamed, waves)
    batch = build(dev)
    batch_drive(batch, waves, STREAM["rounds"])
    if hasattr(batch, "config_ids"):
        check(streamed.config_ids() == batch.config_ids(), f"{what}: config ids differ")
        check(int(batch.config_epochs().sum()) == result["cuts"], f"{what}: cut counts differ")
    else:
        check(streamed.config_id == batch.config_id, f"{what}: config ids differ")
        check(batch.config_epoch == result["cuts"], f"{what}: cut counts differ")
    check_same_lanes(all_lanes(streamed), all_lanes(batch), f"{what}: stream vs batch")
    return driver, result, launches


def kernels_per_round(dev, build, wave, rounds=8):
    """Device kernels per round of ``stream_step`` and of ``step()``: one
    profiled sample of ``rounds`` rounds each, on fresh targets from
    ``build`` after ``wave`` is applied."""
    out = {}
    for name in ("stream_step", "step"):
        vc = build(dev)
        if wave.crash:
            vc.crash(list(wave.crash))
        if wave.join:
            vc.inject_join_wave(list(wave.join), check_admissible=False)
        run = getattr(vc, name)
        _, prof = profile_run(dev, lambda: [run() for _ in range(rounds)])
        out[name] = {"kernels_per_round": prof["device_kernels"] / rounds,
                     "wall_ms_per_round": prof["wall_ms"] / rounds,
                     "device_ms_per_round": prof["device_ms"] / rounds,
                     "device_busy_share": prof["device_busy_share"]}
    return out


def phase_serving(dev):
    """Phase 15. Returns the delivery launches of each streamed path."""
    from rapid_tpu_torch.serving import FleetPoissonChurn, PoissonChurn
    from rapid_tpu_torch.utils.histogram import LogHistogram

    n, waves_n = STREAM["n"], STREAM["waves"]
    n_slots, trace = n + 2 * waves_n, waves_n * STREAM["rounds"]

    def cluster(device, seed=7_200):
        return stream_cluster(n, n_slots, STREAM["cohorts"], trace, seed, device)

    # Warm-up, as bench.py's: the crash, join and round paths once each.
    warm = cluster(dev, 7_000)
    warm.crash([0])
    warm.inject_join_wave([n])
    warm.step()
    warm.sync()
    warm_fleet = stream_fleet(7_100, dev)
    warm_fleet.stream_crash([(0, 1)])
    warm_fleet.step()
    warm_fleet.sync()
    del warm, warm_fleet

    launches = {}
    waves = PoissonChurn(n, n_slots, rate=STREAM["rate"], seed=7_300).waves(waves_n)
    driver, cluster_result, launches["stream_cluster"] = stream_vs_batch(
        dev, cluster, waves, "stream cluster")
    trajectory = driver.last_trajectory
    check(trajectory["waves_evicted"] == 0, f"the ring evicted waves: {trajectory}")
    cluster_hist = driver.target.metrics.timings["engine_stream_alert_to_commit"]

    fleet_waves = FleetPoissonChurn(STREAM["tenants"], n, rate=STREAM["fleet_rate"],
                                    seed=7_500).waves(waves_n)
    fleet_driver, fleet_result, launches["stream_fleet"] = stream_vs_batch(
        dev, lambda d: stream_fleet(7_400, d), fleet_waves, "stream fleet")
    fleet_hist = fleet_driver.target.metrics.timings["engine_stream_alert_to_commit"]

    # The first waves of the cluster stream on the card and on the CPU.
    cpu_waves = waves[:STREAM["cpu_waves"]]
    sides = []
    for device in (dev, torch.device("cpu")):
        target = cluster(device)
        run_stream(device, target, cpu_waves, checked=device.type == "cuda")
        sides.append(all_lanes(target))
    check_same_lanes(sides[0], sides[1], "stream cluster card vs cpu")

    # The single-cluster stream at the headline churn's geometry.
    hl = STREAM_HEADLINE

    def headline(device):
        return stream_cluster(hl["n"], hl["n_slots"], hl["cohorts"], hl["trace"], 7_200, device)

    hl_waves = PoissonChurn(hl["n"], hl["n_slots"], rate=hl["rate"], seed=7_300).waves(hl["waves"])
    hl_driver, hl_result, launches["stream_headline"] = stream_vs_batch(
        dev, headline, hl_waves, "headline stream")
    check(hl_driver.last_trajectory["waves_evicted"] == 0, "the headline ring evicted waves")
    per_round = kernels_per_round(dev, headline, hl_waves[0])

    wall = cluster_result["wall_ms"] + fleet_result["wall_ms"]
    merged = LogHistogram.merged([cluster_hist, fleet_hist])
    emit({"phase": "serving", "n": n, "n_slots": n_slots, "waves": waves_n,
          "rounds_per_wave": STREAM["rounds"], "depth": STREAM["depth"],
          "tenants": STREAM["tenants"], "cluster": cluster_result, "fleet": fleet_result,
          "combined": {
              "view_changes_per_sec": (cluster_result["cuts"] + fleet_result["cuts"]) / (wall / 1e3),
              "p99_alert_to_commit_ms": merged.quantile(0.99),
              "overlap_efficiency": 1.0 - (cluster_result["fetch_blocked_ms"]
                                           + fleet_result["fetch_blocked_ms"]) / wall,
              "h2d_bytes": cluster_result["h2d_bytes"] + fleet_result["h2d_bytes"]},
          "trajectory": trajectory,
          "cpu_twin_waves": len(cpu_waves), "lanes_bit_exact": len(sides[1]),
          "headline": {"n": hl["n"], "n_slots": hl["n_slots"], "cohorts": hl["cohorts"],
                       "trace": hl["trace"], "waves": hl["waves"], "rate": hl["rate"],
                       **hl_result, "trajectory": hl_driver.last_trajectory,
                       "per_round": per_round},
          "delivery_launches": launches})
    return launches


@contextlib.contextmanager
def timed_checkpoints(records):
    """A context in which every serving checkpoint write appends its
    (cursor, bytes, write ms) to ``records``."""
    from rapid_tpu_torch.serving import recovery

    real = recovery.write_checkpoint

    def write(directory, target, wave_index, **kw):
        start = time.perf_counter()
        path = real(directory, target, wave_index, **kw)
        records.append({"wave": wave_index, "bytes": path.stat().st_size,
                        "write_ms": (time.perf_counter() - start) * 1e3})
        return path

    recovery.write_checkpoint = write
    try:
        yield
    finally:
        recovery.write_checkpoint = real


def recovery_drill(dev, n, n_slots, cohorts, rate, ckpt_dir):
    """bench.py's recovery drill on the card: an uninterrupted twin, then
    the supervised drill (a transient failure at wave 1, checkpoints every
    RECOVERY["every"] waves, a kill after wave RECOVERY["kill_after"]),
    resumed from its checkpoint directory and replayed to the end, then
    RECOVERY["settle_waves"] waves without churn on both. The resumed target
    must equal the twin on every lane. Returns (report, resumed supervisor,
    twin, schedule factory)."""
    from rapid_tpu_torch.models.state import state_bytes_total
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.serving import (
        PoissonChurn, SimulatedProcessKill, StreamWave, Supervisor, SupervisorFaultPlan, recovery,
    )

    waves, rounds, every = RECOVERY["waves"], RECOVERY["rounds"], RECOVERY["every"]

    def build():
        return stream_cluster(n, n_slots, cohorts, 0, 8_000, dev, telemetry=False)

    def churn():
        return PoissonChurn(n, n_slots, rate=rate, seed=8_100)

    delivery_new_bits.launches = 0
    twin = build()
    twin_sup = Supervisor(twin, rounds_per_wave=rounds)
    for wave in churn().waves(waves):
        twin_sup.submit(wave)
    twin_sup.drain()
    written = []
    drill = build()
    with timed_checkpoints(written):
        drill_sup = Supervisor(
            drill, rounds_per_wave=rounds, checkpoint_dir=ckpt_dir, checkpoint_every=every,
            fault_plan=SupervisorFaultPlan(transient_submit=((1, 1),),
                                           kill_after_wave=RECOVERY["kill_after"]),
        )
        schedule, killed = churn(), None
        try:
            for _ in range(waves):
                drill_sup.submit(schedule.wave())
        except SimulatedProcessKill as exc:
            killed = exc.wave_index
        check(killed == RECOVERY["kill_after"], f"the drill's kill fired after wave {killed}")
        start = time.monotonic()
        resumed_sup, next_wave = recovery.resume(ckpt_dir, checkpoint_every=every, device=dev)
        schedule = recovery.fast_forward(churn(), next_wave)
        for _ in range(next_wave, waves):
            resumed_sup.submit(schedule.wave())
        replayed = resumed_sup.drain()
        torch.cuda.synchronize(dev)
        resume_to_serving_ms = (time.monotonic() - start) * 1e3
    for sup in (twin_sup, resumed_sup):
        for _ in range(RECOVERY["settle_waves"]):
            sup.submit(StreamWave())
        sup.drain()
    launches = delivery_new_bits.launches
    resumed = resumed_sup.target
    check(twin.config_epoch > 0, "the drill committed no cut")
    check(resumed.config_id == twin.config_id, "the resumed drill's config id differs from the twin's")
    check_same_lanes(all_lanes(resumed), all_lanes(twin), "resumed drill vs twin")
    report = {"n": n, "n_slots": n_slots, "cohorts": cohorts, "rate": rate, "waves": waves,
              "rounds_per_wave": rounds, "checkpoint_every": every, "killed_after_wave": killed,
              "resumed_wave": next_wave, "mttr_ms": resumed_sup.last_resume_ms,
              "resume_to_serving_ms": resume_to_serving_ms,
              "retries": drill.metrics.counters["engine_recovery_retries"],
              "replayed_cuts": replayed.cuts, "cuts_after_settling": twin.config_epoch,
              "checkpoints": written,
              "state_bytes_at_rest": state_bytes_total(drill.cfg),
              "delivery_launches": launches, "lanes_bit_exact": len(all_lanes(twin))}
    return report, resumed_sup, twin, churn


def phase_recovery(dev):
    """Phase 16. Returns the delivery launches of both drills."""
    import shutil
    import tempfile

    from pathlib import Path

    from rapid_tpu_torch.serving import StreamWave, recovery
    from rapid_tpu_torch.serving.supervisor import _damage_file
    from rapid_tpu_torch.utils.checkpoint import load_serving_state
    from rapid_tpu_torch.utils.xxhash import xxh64

    root = tempfile.mkdtemp(prefix="rapid-recovery-")
    try:
        n = STREAM["n"]
        drill, resumed_sup, twin, churn = recovery_drill(
            dev, n, n + 2 * RECOVERY["waves"], STREAM["cohorts"], 2.0, f"{root}/drill")
        # A checkpoint written on the card loads on the CPU to equal lanes.
        target = resumed_sup.target
        path = resumed_sup.checkpoint()
        cfg, state, faults, _, meta = load_serving_state(path, device="cpu")
        check(cfg == target.cfg and meta["wave_index"] == RECOVERY["waves"] + RECOVERY["settle_waves"],
              f"checkpoint meta {meta}")
        check_same_lanes({**plane_lanes(state), **plane_lanes(faults)},
                         {**plane_lanes(target.state), **plane_lanes(target.faults)},
                         "card checkpoint loaded on the cpu")
        # A damaged newest checkpoint falls back to its predecessor, which
        # replays to the twin.
        _damage_file(path, truncate=False)
        found, _, corrupt = recovery.latest_valid_checkpoint(f"{root}/drill", device=dev)
        check(corrupt == [path] and found != path, f"no fallback past the damaged {path}: {found}")
        fallback_sup, next_wave = recovery.resume(f"{root}/drill", device=dev)
        schedule = recovery.fast_forward(churn(), next_wave)
        for _ in range(next_wave, RECOVERY["waves"]):
            fallback_sup.submit(schedule.wave())
        for _ in range(max(next_wave, RECOVERY["waves"]), RECOVERY["waves"] + RECOVERY["settle_waves"]):
            fallback_sup.submit(StreamWave())
        fallback_sup.drain()
        check_same_lanes(all_lanes(fallback_sup.target), all_lanes(twin), "fallback resume vs twin")
        drill["fallback"] = {"damaged": path.name, "resumed_from": found.name,
                             "resumed_wave": next_wave}

        hl = STREAM_HEADLINE
        headline, *_ = recovery_drill(dev, hl["n"], hl["n_slots"], hl["cohorts"], hl["rate"],
                                      f"{root}/headline")
        # The integrity trailer's share of a write and of the MTTR: one
        # xxh64 over the newest headline checkpoint's bytes, on this host.
        newest = sorted(Path(f"{root}/headline").glob("ckpt_w*.npz"))[-1]
        data = newest.read_bytes()
        start = time.perf_counter()
        xxh64(data[:-12])
        headline["xxh64_ms"] = (time.perf_counter() - start) * 1e3
        headline["xxh64_bytes"] = len(data) - 12
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "recovery", "drill": drill, "headline": headline})
    return {"recovery": drill["delivery_launches"], "recovery_headline": headline["delivery_launches"]}


# -- phases 17-18: the chaos stage and the loss variant --------------------

# bench.py's chaos stage as it writes it for an accelerator: 256 mixed
# hostile scenarios per fleet (tenancy.chaos.fleet_specs), a warm-up fleet
# and a timed one. Then the tampered two-tenant fleet of the JAX package's
# shrinker test (tenant 1 runs H=5 under a schedule judged at H=9).
CHAOS = dict(tenants=256, warmup_seed=70_000, timed_seed=71_000, max_steps=64)
CHAOS_TAMPERED = dict(specs=[("partition_heal", 1), ("false_alert_stability", 3)],
                      knobs=[(9, 4, 1), (5, 2, 1)])
# bench.py's loss variant: the headline churn under churn_under_loss's loss,
# a warm-up on seed 100 and the minimum of seeds 101 and 102; a twin at
# N=4,096 on the card and on the CPU.
LOSS = dict(warmup_seed=100, timed_seeds=(101, 102), twin_n=4_096, twin_churn=102,
            twin_cohorts=40)


@contextlib.contextmanager
def keeping_runs(runs):
    """A context in which every ``tenancy.chaos.run_fleet`` call also
    appends its ``FleetRunResult`` to ``runs`` (``fuzz_fleet`` returns only
    a summary)."""
    from rapid_tpu_torch.tenancy import chaos

    real = chaos.run_fleet

    def keep(*args, **kwargs):
        runs.append(real(*args, **kwargs))
        return runs[-1]

    chaos.run_fleet = keep
    try:
        yield
    finally:
        chaos.run_fleet = real


def fleet_records(result):
    """Every tenant's phase records, final slots and soak cuts, and the
    run's totals, as plain values."""
    return dict(
        phases=[[(r.resolved, r.cuts, r.config_id, r.config_epoch, r.members) for r in records]
                for records in result.phases],
        final_slots=[sorted(slots) for slots in result.final_slots],
        soak_cuts=None if result.soak_cuts is None else result.soak_cuts.tolist(),
        total_rounds=result.total_rounds, total_cuts=result.total_cuts,
        dispatches=result.dispatches,
    )


def first_group_fleet(specs, dev):
    """The fleet of ``specs`` as ``run_fleet`` stacks it for its first
    phase-group wave: compiled on the CPU (the same lanes, without ~10
    launches per tenant), group 0 injected into every tenant that has one,
    stacked and copied to ``dev``. Returns (fleet, targets, min_cuts)."""
    from rapid_tpu_torch.tenancy import TenantFleet, chaos

    scenarios = chaos.compile_fleet(specs, device=torch.device("cpu"))
    targets, min_cuts = [], []
    for scenario in scenarios:
        delta = chaos._inject_group(scenario.vc, scenario.groups[0]) if scenario.groups else 0
        targets.append(scenario.schedule.n0 + delta)
        min_cuts.append(1 if scenario.groups else 0)
    return fleet_on(TenantFleet.from_clusters([s.vc for s in scenarios]), dev), targets, min_cuts


def phase_chaos(dev, captured):
    """Phase 17. ``captured``: a list that receives the delivery inputs of
    every round of the timed fleet. Returns the timed fleet's delivery
    launches."""
    import shutil
    import tempfile

    from rapid_tpu_torch import _host
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.tenancy import TenantFleet, chaos

    b, max_steps = CHAOS["tenants"], CHAOS["max_steps"]
    seconds, mark = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        seconds[name], mark[0] = now - mark[0], now

    warm = chaos.fuzz_fleet(b, base_seed=CHAOS["warmup_seed"], shrink_failures=False, device=dev)
    lap("warmup")
    check(not warm["violations"], "chaos warm-up violations:\n" + "\n".join(warm["violations"]))

    runs = []
    torch.cuda.synchronize(dev)
    delivery_new_bits.launches = 0
    reads0 = _host.read.count
    start = time.perf_counter()
    with keeping_runs(runs), capturing(captured):
        summary = chaos.fuzz_fleet(b, base_seed=CHAOS["timed_seed"], shrink_failures=False,
                                   device=dev)
    total_ms = (time.perf_counter() - start) * 1e3
    launches, reads = delivery_new_bits.launches, _host.read.count - reads0
    lap("timed")
    check(not summary["violations"], "chaos fleet violations:\n" + "\n".join(summary["violations"]))
    check(launches > 0, "the chaos fleet never launched the delivery kernel")
    check(len(runs) == 1, f"fuzz_fleet made {len(runs)} fleet runs")
    timed = runs[0]
    n_groups = max(len(s.groups) for s in timed.scenarios)
    check(launches == n_groups * max_steps + timed.soak_rounds,
          f"{launches} delivery launches for {n_groups} waves and {timed.soak_rounds} soak rounds")

    # The same specs through the port on the CPU: equal records.
    specs = chaos.fleet_specs(b, CHAOS["timed_seed"])
    cpu = chaos.run_fleet(chaos.compile_fleet(specs, device=torch.device("cpu")))
    check(fleet_records(cpu) == fleet_records(timed), "chaos fleet records differ card vs cpu")
    check([str(v) for v in chaos.check_fleet(cpu)] == summary["violations"], "cpu battery differs")
    lap("cpu_twin")

    # Host costs of the batched run: one restack of the 256 compiled
    # clusters (run_fleet stacks once per phase group and once for the soak).
    clusters = [s.vc for s in timed.scenarios]
    restack = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        begin = time.perf_counter()
        TenantFleet.from_clusters(clusters)
        torch.cuda.synchronize(dev)
        restack.append((time.perf_counter() - begin) * 1e3)
    lap("restacks")

    # The first phase group's wave again, with every synchronizing call an
    # error; then one profiled.
    fleet, targets, min_cuts = first_group_fleet(specs, dev)
    out = sync_checked_wave(fleet, targets, max_steps, 8, min_cuts)
    got = [(bool(r), int(c), int(m)) for r, c, m in zip(out[3].tolist(), out[2].tolist(),
                                                        out[0].n_members.tolist())]
    want = [(records[0].resolved, records[0].cuts, records[0].members) for records in timed.phases]
    check(got == want, "sync-checked first wave differs from the timed run's first group")
    lap("sync_checked_wave")
    fleet, targets, min_cuts = first_group_fleet(specs, dev)
    (_, cuts, resolved, _), prof = profile_run(
        dev, lambda: fleet.run_until_membership(targets, max_steps=max_steps, max_cuts=8,
                                                min_cuts=min_cuts))
    check(resolved.all(), "profiled chaos wave did not resolve")
    prof["kernels_per_round"] = prof["device_kernels"] / max_steps
    lap("profiled_wave")

    # The tampered fleet: shrunk and written on the card, replayed on the CPU.
    tampered = chaos.compile_fleet(CHAOS_TAMPERED["specs"], knobs=CHAOS_TAMPERED["knobs"],
                                   device=dev)
    violations = chaos.check_fleet(chaos.run_fleet(tampered))
    check(set(chaos.violating_tenants(violations)) == {1}, f"tampered fleet: {violations}")
    start = time.perf_counter()
    t, minimal, min_violations, shrink_runs = chaos.shrink_tenant(
        chaos.compile_fleet(CHAOS_TAMPERED["specs"], knobs=CHAOS_TAMPERED["knobs"], device=dev),
        violations, device=dev)
    shrink_ms = (time.perf_counter() - start) * 1e3
    root = tempfile.mkdtemp(prefix="chaos-repro-")
    try:
        repro = chaos.write_fleet_repro(
            f"{root}/repro", minimal, CHAOS_TAMPERED["knobs"][t], CHAOS_TAMPERED["specs"][t][0],
            CHAOS_TAMPERED["specs"][t][1], tenant_index=t, fleet_size=2, device=dev)
        recorded = sorted(line for line in (repro / "violations.txt").read_text().splitlines()
                          if line and line != "(none)")
        _, replayed = chaos.replay_fleet_repro(repro, device=torch.device("cpu"))
        diff = chaos.replay_trace_divergence(repro, device=torch.device("cpu"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(recorded and sorted(map(str, replayed)) == recorded,
          f"repro replayed on the cpu to {replayed}, recorded {recorded}")
    check(diff["first_divergent_round"] is None, f"repro trace diverged: {diff}")
    lap("tampered")

    emit({"phase": "chaos", "tenants": b, "families": len(summary["families"]),
          "scenarios_per_sec": summary["scenarios_per_sec"], "dispatches": summary["dispatches"],
          "total_cuts": summary["total_cuts"], "wall_ms": summary["wall_ms"],
          "fuzz_fleet_ms": total_ms, "outside_run_window_ms": total_ms - summary["wall_ms"],
          "warmup": {"scenarios_per_sec": warm["scenarios_per_sec"], "wall_ms": warm["wall_ms"]},
          "seconds": seconds,
          "waves": n_groups, "soak_rounds": timed.soak_rounds, "total_rounds": timed.total_rounds,
          "host_reads": reads, "kernel_launches": launches,
          "restack_ms": statistics.median(restack), "restacks_per_run": n_groups + 1,
          "records_equal_cpu": b, "first_wave_sync_free": True,
          "profile_first_wave": prof,
          "tampered": {"violations": [str(v) for v in violations], "shrunk_tenant": t,
                       "shrunk_events": len(minimal.events), "shrink_runs": shrink_runs,
                       "shrink_ms": shrink_ms, "min_violations": [str(v) for v in min_violations],
                       "replayed_on_cpu_equal": True, "trace": diff}})
    return launches


def phase_loss_variant(dev, captured):
    """Phase 18. ``captured``: a list that receives the delivery inputs of
    every round of the warm-up churn. Returns the delivery launches of the
    warm-up and the timed churns."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.convert import state_to_numpy
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.sim.faults import loss_as_engine_delivery
    from rapid_tpu_torch.sim.fuzz import churn_under_loss

    n, n_join, n_crash = HEADLINE["n"], HEADLINE["n_join"], HEADLINE["n_crash"]
    permille = max(int(e.args["permille"]) for e in churn_under_loss(0).events if e.kind == "loss")
    knobs = loss_as_engine_delivery(permille)
    check((knobs["delivery_spread"], knobs["delivery_prob_permille"]) == (2, 50),
          f"loss knobs {knobs}")
    delivery_new_bits.launches = 0
    samples = []
    for seed in (LOSS["warmup_seed"], *LOSS["timed_seeds"]):
        vc, victims = churn_cluster(n, n_join, n_crash, HEADLINE["cohorts"], seed, dev, **knobs)
        torch.cuda.synchronize(dev)
        launches0, reads0 = delivery_new_bits.launches, _host.read.count
        start = time.perf_counter()
        with capturing(captured if seed == LOSS["warmup_seed"] else None):
            rounds, cuts, resolved, sizes = resolve(vc, n)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - start) * 1e3
        check(resolved, f"loss churn unresolved: {cuts} cuts in {rounds} rounds, sizes {sizes}")
        # bench.py's assertion: the membership is N and no victim is alive.
        check(vc.membership_size == n and not vc.alive_mask[victims].any(),
              "loss churn: wrong membership")
        samples.append(dict(warmup=seed == LOSS["warmup_seed"], seed=seed, ms=ms, rounds=rounds,
                            cuts=cuts, sizes=list(sizes), host_reads=_host.read.count - reads0,
                            kernel_launches=delivery_new_bits.launches - launches0))
    launches = delivery_new_bits.launches
    check(launches > 0, "the loss variant never launched the delivery kernel")

    # The twin at N=4,096 with the same knobs, on the card and on the CPU.
    twin = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        vc, _ = churn_cluster(LOSS["twin_n"], LOSS["twin_churn"], LOSS["twin_churn"],
                              LOSS["twin_cohorts"], 7, device, **knobs)
        twin[where] = (resolve(vc, LOSS["twin_n"]),
                       {**state_to_numpy(vc.state), **state_to_numpy(vc.faults)})
    check(twin["card"][0] == twin["cpu"][0] and twin["card"][0][2],
          f"loss twin: {twin['card'][0]}, {twin['cpu'][0]}")
    check_same_lanes(twin["card"][1], twin["cpu"][1], "loss twin card vs cpu")
    timed = [s for s in samples if not s["warmup"]]
    emit({"phase": "loss_variant", "n": n, "n_slots": n + n_join, "cohorts": HEADLINE["cohorts"],
          "loss_permille": permille, **knobs, "samples": samples,
          "min_ms": min(s["ms"] for s in timed), "median_ms": statistics.median(s["ms"] for s in timed),
          "twin": {"n": LOSS["twin_n"], "result": list(twin["card"][0][:2]),
                   "lanes_bit_exact": len(twin["cpu"][1])}})
    return launches


# -- phase 19: engine observability ------------------------------------------

OBSERVE = dict(trace=64, twin_n=4_096, twin_churn=102, stream_waves=8, cpu_fleet=6)


def comparable_snapshot(snap):
    """``snap`` as plain JSON without what may rightly differ between two
    runs of the same drive (a card and the CPU, or the port and the JAX
    package): the ``compile`` and ``memory`` sections, each ``*_ms``
    histogram but its count, and the stream's drained rates and the
    recovery MTTR (wall clock) but whether they are set."""
    snap = json.loads(json.dumps(snap))
    engine = snap["engine"]
    engine.pop("compile")
    engine.pop("memory")
    for name, value in snap["metrics"].items():
        if isinstance(value, dict):
            snap["metrics"][name] = (
                value["count"] if "count" in value
                else {phase: hist["count"] for phase, hist in value.items()}
            )
    for section, keys in (("stream", ("view_changes_per_sec", "overlap_efficiency",
                                      "p99_alert_to_commit_ms")),
                          ("recovery", ("mttr_ms",))):
        for key in keys:
            if section in engine:
                engine[section][key] = engine[section][key] is None
    return snap


def scrape(target):
    """One scrape of a driver: the snapshot and its Prometheus text, each
    timed on the host's clock, with the text's bytes and the counted reads
    of the snapshot. Returns (snapshot, text, report)."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.utils import exposition

    reads0 = _host.read.count
    start = time.perf_counter()
    snap = target.telemetry_snapshot()
    scrape_ms = (time.perf_counter() - start) * 1e3
    reads = _host.read.count - reads0
    start = time.perf_counter()
    text = exposition.prometheus_text(snap)
    render_ms = (time.perf_counter() - start) * 1e3
    return snap, text, {"scrape_ms": scrape_ms, "render_ms": render_ms,
                        "text_bytes": len(text.encode()), "reads_per_scrape": reads,
                        "series": sum(1 for ln in text.splitlines() if not ln.startswith("#"))}


def check_build_capture(snap, what):
    """The build capture's own arithmetic (utils/engine_telemetry)."""
    build = snap["engine"]["compile"]
    check(build["cache_requests"] == build["persistent_cache_hits"] + build["persistent_cache_misses"],
          f"{what}: build lookups {build}")
    check(build["compiles"] == build["persistent_cache_misses"] == build["compile_ms"]["count"],
          f"{what}: builds {build}")
    return {k: build[k] for k in ("compiles", "persistent_cache_hits", "persistent_cache_misses",
                                  "cache_requests")} | {"compile_ms_sum": build["compile_ms"]["sum"]}


def phase_observability(dev):
    """Phase 19. Returns the delivery launches of each scraped path."""
    import shutil
    import tempfile
    from pathlib import Path

    from rapid_tpu_torch.models.state import state_bytes_total
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.serving import PoissonChurn, Supervisor
    from rapid_tpu_torch.tenancy import TenantFleet
    from rapid_tpu_torch.utils import engine_telemetry, exposition, profiling

    launches, report = {}, {}
    n, n_join = HEADLINE["n"], HEADLINE["n_join"]
    planes = dict(telemetry=True, trace=OBSERVE["trace"])

    # The single cluster at the churn's full width, scraped after one churn.
    vc, _ = churn_cluster(n, n_join, HEADLINE["n_crash"], HEADLINE["cohorts"], 11, dev, **planes)
    torch.cuda.synchronize(dev)
    delivery_new_bits.launches = 0
    churned = resolve(vc, n)
    launches["observability_churn"] = delivery_new_bits.launches
    check(churned[2], f"the scraped churn did not resolve: {churned}")
    vc.sync()
    snap, text, cluster = scrape(vc)
    allocated = torch.cuda.memory_allocated(dev)
    memory = snap["engine"]["memory"]
    check(None not in memory.values(), f"memory gauges unset on the card: {memory}")
    check(memory["device_bytes_in_use"] == allocated,
          f"device_bytes_in_use {memory['device_bytes_in_use']} != memory_allocated {allocated}")
    check(memory["device_peak_bytes"] >= state_bytes_total(vc.cfg),
          f"peak {memory['device_peak_bytes']} below the state's {state_bytes_total(vc.cfg)} bytes")
    check(cluster["reads_per_scrape"] == 4, f"a scrape made {cluster['reads_per_scrape']} reads")
    check(exposition.metric_names(vc.prometheus_text()) == exposition.metric_names(text),
          "prometheus_text() names differ from the rendered snapshot's")
    report["cluster"] = {"n": n, "n_slots": n + n_join, "cohorts": HEADLINE["cohorts"],
                         "rounds": churned[0], "cuts": churned[1], **cluster, "memory": memory,
                         "build": check_build_capture(snap, "cluster"),
                         "state_bytes": state_bytes_total(vc.cfg)}
    del vc

    # The same seeded churn at N=4,096 on the card and on the CPU.
    tn, tc = OBSERVE["twin_n"], OBSERVE["twin_churn"]
    twins = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        twin, _ = churn_cluster(tn, tc, tc, 40, 7, device, telemetry=True, trace=16)
        delivery_new_bits.launches = 0
        resolve(twin, tn)
        if side == "card":
            launches["observability_twin_churn"] = delivery_new_bits.launches
        twin.sync()
        twins[side] = (twin.telemetry_snapshot(), twin.prometheus_text())
    (card_snap, card_text), (cpu_snap, cpu_text) = twins["card"], twins["cpu"]
    check(comparable_snapshot(card_snap) == comparable_snapshot(cpu_snap),
          "the N=4,096 snapshots differ card vs cpu")
    check(exposition.metric_names(card_text) == exposition.metric_names(cpu_text),
          "the N=4,096 metric names differ card vs cpu")
    check(engine_telemetry.trace_recorder_snapshot(card_snap["engine"]["trace"])
          == engine_telemetry.trace_recorder_snapshot(cpu_snap["engine"]["trace"]),
          "the ring's flight recordings differ card vs cpu")
    report["twin"] = {"n": tn, "keys_equal": len(comparable_snapshot(cpu_snap)["metrics"]),
                      "names": len(exposition.metric_names(cpu_text)),
                      "ring_events": len(engine_telemetry.trace_recorder_snapshot(
                          cpu_snap["engine"]["trace"])["events"])}

    # bench.py's fleet with the plane on, scraped after one wave.
    b, fn, extra = FLEET["tenants"], FLEET["n"], FLEET["n_extra"]
    wave = dict(max_steps=FLEET["max_steps"], max_cuts=4, min_cuts=1)
    clusters, targets = fleet_clusters(b, fn, extra, FLEET["cohorts"], 80_000,
                                       torch.device("cpu"), telemetry=True)
    fleet = fleet_on(TenantFleet.from_clusters(clusters), dev)
    fleet.sync()
    delivery_new_bits.launches = 0
    _, _, resolved, _ = fleet.run_until_membership(targets, **wave)
    launches["observability_fleet_wave"] = delivery_new_bits.launches
    check(resolved.all(), "the scraped fleet wave did not resolve")
    fleet.sync()
    fsnap, ftext, fleet_report = scrape(fleet)
    missing = [t for t in range(b) if f'tenant="{t}"' not in ftext]
    check(not missing, f"tenant labels missing from the fleet's text: {missing[:8]}")
    small, small_targets = fleet_clusters(OBSERVE["cpu_fleet"], 256, 6, 40, 300,
                                          torch.device("cpu"), ((9, 4), (8, 3), (7, 2)),
                                          telemetry=True)
    small = TenantFleet.from_clusters(small)
    small.run_until_membership(small_targets, **wave)
    small.sync()
    check(exposition.metric_names(ftext) == exposition.metric_names(small.prometheus_text()),
          "the fleet's metric names differ from a 6-tenant CPU fleet's")
    report["fleet"] = {"tenants": b, "n": fn, "n_slots": fn + extra, **fleet_report,
                       "memory": fsnap["engine"]["memory"]}
    del fleet, clusters

    # Phase 15's stream cluster under a Supervisor, scraped between waves.
    sn, waves_n = STREAM["n"], OBSERVE["stream_waves"]
    s_slots = sn + 2 * STREAM["waves"]
    stream_sides = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        target = stream_cluster(sn, s_slots, STREAM["cohorts"], STREAM["waves"] * STREAM["rounds"],
                                7_200, device)
        sup = Supervisor(target, rounds_per_wave=STREAM["rounds"], depth=STREAM["depth"])
        delivery_new_bits.launches = 0
        scrapes = []
        for wave in PoissonChurn(sn, s_slots, rate=STREAM["rate"], seed=7_300).waves(waves_n):
            sup.submit(wave)
            scrapes.append(scrape(target))
        sup.drain()
        if side == "card":
            launches["observability_stream"] = delivery_new_bits.launches
        ssnap, stext, _ = scrapes[-1]
        check({"stream", "recovery"} <= ssnap["engine"].keys(),
              f"stream scrape sections: {sorted(ssnap['engine'])}")
        stream_sides[side] = (exposition.metric_names(stext), [r for _, _, r in scrapes])
    check(stream_sides["card"][0] == stream_sides["cpu"][0],
          "the supervised stream's metric names differ card vs cpu")
    per_wave = stream_sides["card"][1]
    report["stream"] = {"n": sn, "n_slots": s_slots, "waves": waves_n,
                        "scrape_ms": [r["scrape_ms"] for r in per_wave],
                        "render_ms": [r["render_ms"] for r in per_wave],
                        "median_scrape_ms": statistics.median(r["scrape_ms"] for r in per_wave),
                        "median_render_ms": statistics.median(r["render_ms"] for r in per_wave),
                        "text_bytes": per_wave[-1]["text_bytes"],
                        "reads_per_scrape": per_wave[-1]["reads_per_scrape"]}

    # The profiler around one full-width churn, inside an annotated span.
    root = tempfile.mkdtemp(prefix="rapid-profile-")
    try:
        vc, _ = churn_cluster(n, n_join, HEADLINE["n_crash"], HEADLINE["cohorts"], 11, dev,
                              **planes)
        torch.cuda.synchronize(dev)
        delivery_new_bits.launches = 0
        start = time.perf_counter()
        with profiling.trace(root):
            with profiling.annotate("churn"):
                profiled = resolve(vc, n)
        profiled_ms = (time.perf_counter() - start) * 1e3
        launches["observability_profiled_churn"] = delivery_new_bits.launches
        check(profiled == churned, f"profiled churn {profiled} != unprofiled {churned}")
        path = Path(profiling.trace_file(root))
        start = time.perf_counter()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        report["profiler"] = {
            "export_bytes": path.stat().st_size, "events": len(events),
            "profiled_churn_ms": profiled_ms, "load_ms": (time.perf_counter() - start) * 1e3,
            "delivery_kernel_events": sum(
                1 for e in events
                if e.get("cat") == "kernel" and "delivery_new_bits_kernel" in e.get("name", "")),
            "churn_spans": sum(1 for e in events if e.get("name") == "churn"),
        }
        check(report["profiler"]["delivery_kernel_events"] > 0,
              "the profiler's trace holds no delivery_new_bits_kernel event")
        check(report["profiler"]["churn_spans"] > 0, "the profiler's trace holds no churn span")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    facts = engine_telemetry.compiled_memory_analysis("delivery")
    check(facts is not None, "no ptxas report for the delivery kernel")
    report["ptxas"] = facts
    for path_name, count in launches.items():
        check(count > 0, f"{path_name} launched no delivery kernel")
    emit({"phase": "observability", **report, "delivery_launches": launches})
    return launches, facts


# -- phase 20: the host membership path --------------------------------------

# The paper's {K, H, L} (SURVEY.md:373-381) at N = 2,000 for the two device
# adapters, with a 1% crash, a 20-joiner wave and one crash under flux;
# 2,000 fast-round votes over three proposals; whole clusters at
# ClusterTest.java's 50 nodes (5 crashed); the service-level crash at N=200
# (EVALUATION.md §4b: the asyncio path's host cost per view change climbs
# steeply past it).
HOST = dict(n=2_000, k=10, h=9, l=3, crash=20, join=20, votes=(1_600, 300, 100),
            cluster=50, cluster_crash=5, services=200)


def host_view(n, k, seed):
    """A ``MembershipView`` of n seeded endpoints with injected identifiers,
    and the endpoints in creation order."""
    from rapid_tpu_torch.protocol.view import MembershipView
    from rapid_tpu_torch.types import Endpoint, NodeId

    rng = np.random.default_rng(seed)
    ports = rng.choice(np.arange(1024, 65536), size=n, replace=False)
    endpoints = [Endpoint(f"10.{40 + i // 65536}.{(i // 256) % 256}.{i % 256}", int(p))
                 for i, p in enumerate(ports)]
    view = MembershipView(k, node_ids=[NodeId(7, i) for i in range(n)], endpoints=endpoints)
    return view, endpoints


def host_alert_waves(view, endpoints, h, seed):
    """Phase 20 (a)'s alert waves, each a list of per-observer
    ``BatchedAlertMessage``s in a seeded shuffled order: a crash of
    ``HOST["crash"]`` members (DOWN from all K observers each), a wave of
    ``HOST["join"]`` joiners (UP from each joiner's expected observers), and
    a crash under flux: H-1 observers report the subject, and the other
    K-H+1 have crashed themselves and are reported by all of theirs, so the
    subject clears H only through the implicit invalidation."""
    import random

    from rapid_tpu_torch.types import (
        AlertMessage, BatchedAlertMessage, EdgeStatus, Endpoint, NodeId,
    )

    rng = random.Random(seed)
    cid = view.configuration_id
    down, up = EdgeStatus.DOWN, EdgeStatus.UP

    def batched(alerts):
        by_src = {}
        for alert in alerts:
            by_src.setdefault(alert.edge_src, []).append(alert)
        batches = [BatchedAlertMessage(src, tuple(msgs)) for src, msgs in by_src.items()]
        rng.shuffle(batches)
        return batches

    crashed = rng.sample(endpoints, HOST["crash"])
    crash = [AlertMessage(o, s, down, cid, (r,))
             for s in crashed for r, o in enumerate(view.observers_of(s))]
    joiners = [Endpoint(f"10.99.{i // 256}.{i % 256}", 7000 + i) for i in range(HOST["join"])]
    join = [AlertMessage(o, j, up, cid, (r,), NodeId(9, i))
            for i, j in enumerate(joiners) for r, o in enumerate(view.expected_observers_of(j))]
    subject = rng.choice([e for e in endpoints if e not in crashed])
    observers = view.observers_of(subject)
    flux = [AlertMessage(observers[r], subject, down, cid, (r,)) for r in range(h - 1)]
    for o in observers[h - 1:]:
        flux += [AlertMessage(oo, o, down, cid, (r,)) for r, oo in enumerate(view.observers_of(o))]
    return {"crash": batched(crash), "join": batched(join), "flux": batched(flux)}, (
        set(crashed), set(joiners), {subject, *observers[h - 1:]})


def host_cut_detectors(dev):
    """Phase 20 (a): the three waves through a ``DeviceCutDetector`` on the
    card (default 4,096 slots), the same on the CPU and the host's
    ``MultiNodeCutDetector``, batch by batch; ``clear()`` between waves, as
    the service clears at a view change."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.protocol import DeviceCutDetector, MultiNodeCutDetector

    k, h, l = HOST["k"], HOST["h"], HOST["l"]
    view, endpoints = host_view(HOST["n"], k, 20)
    waves, expected = host_alert_waves(view, endpoints, h, 21)
    # A warm-up detector takes the card's first launches of every op.
    warm = DeviceCutDetector(k, h, l, device=dev)
    for batch in waves["crash"]:
        warm.aggregate_batch(batch.messages, view)
    detectors = {"card": DeviceCutDetector(k, h, l, device=dev),
                 "cpu": DeviceCutDetector(k, h, l, device="cpu"),
                 "host": MultiNodeCutDetector(k, h, l)}
    check(detectors["card"].max_slots == 4096, "the card detector is not at the default slots")
    report = {}
    for wave, want in zip(("crash", "join", "flux"), expected):
        proposals = {name: [] for name in detectors}
        ms = {name: [] for name in detectors}
        card = detectors["card"]
        passes0, bytes0, card_reads = card.batches, card.bytes_uploaded, 0
        for batch in waves[wave]:
            for name, det in detectors.items():
                reads0 = _host.read.count
                start = time.perf_counter()
                out = det.aggregate_batch(batch.messages, view)
                ms[name].append((time.perf_counter() - start) * 1e3)
                card_reads += _host.read.count - reads0 if name == "card" else 0
                proposals[name].append(sorted(str(e) for e in out))
        released = {e for p in proposals["card"] for e in p}
        check(proposals["card"] == proposals["cpu"] == proposals["host"],
              f"{wave}: the card detector's proposals differ from the CPU's or the host's")
        check(released == {str(e) for e in want}, f"{wave}: released {len(released)} of {len(want)}")
        batches = len(waves[wave])
        check(card_reads == card.batches - passes0, f"{wave}: not one read a pass on the card")
        report[wave] = {
            "batches": batches, "proposals": sum(1 for p in proposals["card"] if p),
            "released": len(released),
            "card_ms_per_batch": statistics.median(ms["card"]),
            "cpu_device_ms_per_batch": statistics.median(ms["cpu"]),
            "host_ms_per_batch": statistics.median(ms["host"]),
            "card_passes": card.batches - passes0,
            "card_reads_per_batch": card_reads / batches,
            "card_bytes_uploaded_per_batch": (card.bytes_uploaded - bytes0) / batches,
        }
        for det in detectors.values():
            det.clear()
    if dev.type == "cuda":
        det = DeviceCutDetector(k, h, l, device=dev)
        _, prof = profile_run(dev, lambda: [det.aggregate_batch(b.messages, view)
                                            for b in waves["crash"]])
        report["crash_profiled"] = per_call(prof, det.batches)
    return report


def per_call(prof, calls):
    """A profiled run's kernels, host ops and times divided by its calls."""
    return {"calls": calls, "kernels_per_call": prof["device_kernels"] / calls,
            "host_ops_per_call": prof["host_ops"] / calls,
            "device_ms_per_call": prof["device_ms"] / calls,
            "wall_ms_per_call": prof["wall_ms"] / calls,
            "device_busy_share": prof["device_busy_share"]}


def host_vote_tallies(dev):
    """Phase 20 (b): 2,000 seeded votes over three proposals (1,600 / 300 /
    100, the first with a high hash lane of 2**31 or above) through Fast
    Paxos with a ``DeviceVoteTally`` on the card and with the host's tally:
    the same decision at the same vote; every vote before quorum under the
    sync check."""
    import random

    from rapid_tpu_torch import _host
    from rapid_tpu_torch.ops.consensus import fast_paxos_quorum
    from rapid_tpu_torch.protocol import DeviceVoteTally, FastPaxos
    from rapid_tpu_torch.protocol.device_vote_tally import _proposal_hash_lanes
    from rapid_tpu_torch.types import FastRoundPhase2bMessage
    from rapid_tpu_torch.utils.clock import ManualClock

    n = HOST["n"]
    _, endpoints = host_view(n, HOST["k"], 22)
    first = next(j for j in range(n) if _proposal_hash_lanes(
        tuple(sorted(endpoints[j:j + 20])))[0] >= 1 << 31)
    proposals = [tuple(sorted(endpoints[first:first + w])) for w in (20, 19, 21)]
    rng = random.Random(23)
    plan = [p for p, count in enumerate(HOST["votes"]) for _ in range(count)]
    rng.shuffle(plan)
    quorum = fast_paxos_quorum(n)

    def run(tally):
        decided = []
        fp = FastPaxos(my_addr=endpoints[0], configuration_id=5, membership_size=n,
                       broadcast_fn=lambda m: None, send_fn=lambda d, m: None,
                       on_decide=decided.append, clock=ManualClock(), rng=random.Random(0),
                       vote_tally=tally)
        us, at = [], None
        for i, (sender, p) in enumerate(zip(endpoints, plan)):
            msg = FastRoundPhase2bMessage(sender=sender, configuration_id=5,
                                          endpoints=proposals[p])
            guard = (sync_checked() if tally is not None and dev.type == "cuda"
                     and i < quorum - 1 else contextlib.nullcontext())
            start = time.perf_counter()
            with guard:
                fp.handle_message(msg)
            us.append((time.perf_counter() - start) * 1e6)
            if decided and at is None:
                at = i
                break
        return decided, at, us

    run(DeviceVoteTally(n, device=dev))  # warm-up: the card's first launches
    host = run(None)
    tally = DeviceVoteTally(n, device=dev)
    reads0 = _host.read.count
    card = run(tally)
    check(card[0] == host[0] == [proposals[0]], "the card tally decided another proposal")
    check(card[1] == host[1], f"the card tally decided at vote {card[1]}, the host's at {host[1]}")
    check(tally.tallies == card[1] - quorum + 2, "a tally ran before quorum")
    reads = _host.read.count - reads0
    check(reads == tally.tallies, f"{reads} reads for {tally.tallies} tallies on the card")
    profiled = {}
    if dev.type == "cuda":
        again = DeviceVoteTally(n, device=dev)
        _, prof = profile_run(dev, lambda: run(again))
        profiled = {"tally_profiled": per_call(prof, again.tallies)}
    return {**profiled, 
        "votes": len(plan), "quorum": quorum, "decided_at_vote": card[1] + 1,
        "winner_hi_lane": _proposal_hash_lanes(proposals[0])[0],
        "tallies": tally.tallies, "reads_per_tally": reads / tally.tallies,
        "bytes_uploaded_per_tally": tally.bytes_uploaded / tally.tallies,
        "card_us_per_vote_before_quorum": statistics.mean(card[2][:quorum - 1]),
        "host_us_per_vote_before_quorum": statistics.mean(host[2][:quorum - 1]),
        "card_ms_per_tally": statistics.median(card[2][quorum - 1:]) / 1e3,
        "host_ms_per_vote_after_quorum": statistics.median(host[2][quorum - 1:]) / 1e3,
        "sync_checked_votes": quorum - 1,
    }


@contextlib.contextmanager
def sync_checked():
    """Every synchronizing CUDA call inside is an error."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def host_settings():
    from rapid_tpu_torch.settings import Settings

    s = Settings()
    s.batching_window_ms = 20
    s.failure_detector_interval_ms = 50
    s.rpc_timeout_ms = 500
    s.rpc_join_timeout_ms = 2000
    s.rpc_probe_timeout_ms = 200
    s.consensus_fallback_base_delay_ms = 2000
    return s


def decided_paths(services):
    return sorted({e.fields.get("path") for s in services for e in s.recorder.events()
                   if e.name.name == "CONSENSUS_DECIDED"})


async def host_cluster_run(dev, adapters):
    """Phase 20 (c), whole clusters: ``HOST["cluster"]`` nodes through
    ``Cluster.start`` / ``Cluster.join`` on one in-process network with a
    static failure detector, then ``HOST["cluster_crash"]`` crashed; with
    ``adapters`` every node runs both device adapters on ``dev``."""
    import asyncio
    import random

    from rapid_tpu_torch.messaging.inprocess import InProcessNetwork
    from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
    from rapid_tpu_torch.protocol import Cluster, DeviceCutDetector, DeviceVoteTally
    from rapid_tpu_torch.types import Endpoint

    n, crash = HOST["cluster"], HOST["cluster_crash"]
    network, fd, settings = InProcessNetwork(), StaticFailureDetectorFactory(), host_settings()
    kw = dict(settings=settings, network=network, fd_factory=fd)
    if adapters:
        kw.update(cut_detector_factory=functools.partial(DeviceCutDetector, device=dev),
                  vote_tally_factory=functools.partial(DeviceVoteTally, device=dev))
    eps = [Endpoint("127.0.0.1", 21000 + i) for i in range(n)]

    async def converged(clusters, size, limit_s=60):
        deadline = time.perf_counter() + limit_s
        while time.perf_counter() < deadline:
            if all(c.membership_size == size for c in clusters) and len(
                    {(c.service.view.configuration_id, tuple(c.membership)) for c in clusters}) == 1:
                return True
            await asyncio.sleep(0.005)
        return False

    start = time.perf_counter()
    seed = await Cluster.start(eps[0], rng=random.Random(0), **kw)
    joiners = await asyncio.gather(*(
        Cluster.join(eps[0], eps[i], rng=random.Random(i), **kw) for i in range(1, n)))
    clusters = [seed, *joiners]
    try:
        check(await converged(clusters, n), "the cluster did not form")
        boot_ms = (time.perf_counter() - start) * 1e3
        msgs0 = sum(c.service.client.stats.msgs_tx for c in clusters)
        victims = clusters[3::10][:crash]
        network.blackholed.update(v.listen_address for v in victims)
        fd.add_failed_nodes([v.listen_address for v in victims])
        survivors = [c for c in clusters if c not in victims]
        start = time.perf_counter()
        check(await converged(survivors, n - crash), "the survivors did not converge")
        crash_ms = (time.perf_counter() - start) * 1e3
        kinds = {(type(c.service.cut_detector).__name__,
                  type(c.service._fast_paxos._vote_tally).__name__) for c in survivors}
        want = ({("DeviceCutDetector", "DeviceVoteTally")} if adapters
                else {("MultiNodeCutDetector", "NoneType")})
        check(kinds == want, f"the nodes ran {kinds}")
        return {
            "bootstrap_wall_ms": boot_ms, "crash_to_convergence_wall_ms": crash_ms,
            "bootstrap_msgs": msgs0,
            "crash_msgs": sum(c.service.client.stats.msgs_tx for c in clusters) - msgs0,
            "decision_paths": decided_paths([c.service for c in survivors]),
            "final_size": survivors[0].membership_size,
        }
    finally:
        await asyncio.gather(*(c.shutdown() for c in clusters), return_exceptions=True)


async def host_service_crash(dev, adapters, n, cohort=0):
    """Phase 20 (c) and phase 21 (b), the service-level crash as
    ``examples/host_scale_ceiling.py`` builds it: n services on one
    ``InProcessNetwork`` under a ``ManualClock``, one crash. ``cohort`` > 0
    sets ``hier_target_cohort_size``, so ``Cluster._service_class`` gives
    ``HierMembershipService`` (which passes no vote tally on)."""
    import asyncio
    import random

    from rapid_tpu_torch.messaging.inprocess import (
        InProcessClient, InProcessNetwork, InProcessServer,
    )
    from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
    from rapid_tpu_torch.protocol import (
        Cluster, DeviceCutDetector, DeviceVoteTally, MembershipView, MultiNodeCutDetector,
    )
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.types import Endpoint, NodeId
    from rapid_tpu_torch.utils.clock import ManualClock

    settings = Settings()
    settings.hier_target_cohort_size = cohort
    service_class = Cluster._service_class(settings)
    endpoints = [Endpoint(f"10.20.{i // 250}.{i % 250}", 6000 + i) for i in range(n)]
    node_ids = [NodeId(0, i) for i in range(n)]
    network, clock, fd = InProcessNetwork(), ManualClock(), StaticFailureDetectorFactory()
    services, servers, tallies = [], [], []

    def tally_factory(size):
        tallies.append(DeviceVoteTally(size, device=dev))
        return tallies[-1]

    for i in range(n):
        view = MembershipView(settings.k, node_ids=node_ids, endpoints=endpoints)
        client = InProcessClient(network, endpoints[i], settings)
        detector = (DeviceCutDetector(settings.k, settings.h, settings.l, device=dev) if adapters
                    else MultiNodeCutDetector(settings.k, settings.h, settings.l))
        service = service_class(
            my_addr=endpoints[i], cut_detector=detector, view=view, settings=settings,
            client=client, fd_factory=fd, clock=clock, rng=random.Random(i), node_id=node_ids[i],
            vote_tally_factory=tally_factory if adapters else None)
        server = InProcessServer(network, endpoints[i])
        server.set_membership_service(service)
        await server.start()
        await service.start()
        services.append(service)
        servers.append(server)
    victim = endpoints[n // 2]
    fd.add_failed_nodes([victim])
    network.blackholed.add(victim)
    live = [s for s in services if s.my_addr != victim]
    msgs0 = sum(s.client.stats.msgs_tx for s in services)
    start, sim_ms = time.perf_counter(), 0
    while not all(s.membership_size == n - 1 for s in live):
        clock.advance_ms(50)
        sim_ms += 50
        for _ in range(40):
            await asyncio.sleep(0)
        check(sim_ms <= 120_000, f"n={n}: no convergence in 120 s of simulated time")
    wall_ms = (time.perf_counter() - start) * 1e3
    final = {(s.view.configuration_id, tuple(str(e) for e in s.membership)) for s in live}
    check(len(final) == 1, f"n={n}: the survivors hold different configurations")
    counters = {}
    for s in live:
        for key, value in s.metrics.counters.items():
            if key.startswith("cohort_"):
                counters[key] = counters.get(key, 0) + value
    out = {"crash_wall_ms": wall_ms, "sim_ms": sim_ms,
           "msgs": sum(s.client.stats.msgs_tx for s in services) - msgs0,
           "decision_paths": decided_paths(live), "final": final.pop(),
           "cohort_counters": counters}
    if cohort:
        out["cohorts"] = live[0]._cohort_map.n_cohorts
    if adapters:
        kinds = {type(s.cut_detector).__name__ for s in live}
        check(kinds == {"DeviceCutDetector"}, f"the services ran {kinds}")
        out["cut_passes"] = sum(s.cut_detector.batches for s in live)
        out["tallies"] = sum(t.tallies for t in tallies)
    for server in servers:
        await server.shutdown()
    for service in services:
        await service.shutdown()
    return out


def phase_host_path(dev, card):
    """Phase 20. The host membership path launches no delivery kernel: the
    count is zeroed before it and must read 0 after."""
    import asyncio

    from rapid_tpu_torch.ops.kernels import delivery_new_bits

    delivery_new_bits.launches = 0
    report = {"cut_detector": host_cut_detectors(dev), "vote_tally": host_vote_tallies(dev)}
    clusters = {}
    for adapters in (True, False):
        clusters["device" if adapters else "host"] = asyncio.run(asyncio.wait_for(
            host_cluster_run(dev, adapters), 120))
    report["clusters"] = clusters
    services = {}
    for adapters in (True, False):
        services["device" if adapters else "host"] = asyncio.run(asyncio.wait_for(
            host_service_crash(dev, adapters, HOST["services"]), 300))
    check(services["device"]["final"] == services["host"]["final"],
          "the N=200 crash ended in another configuration with the device adapters")
    for side in services.values():
        cid, members = side.pop("final")
        side["config_id"], side["final_size"] = cid, len(members)
    report["services"] = services
    report["delivery_launches"] = delivery_new_bits.launches
    check(delivery_new_bits.launches == 0, "the host path launched the delivery kernel")
    emit({"phase": "host_path", "card": card, **report})


HOST_SIM = dict(seeds=(1, 2, 3, 4, 5), services=256, cohort=64, cluster=64, cluster_cohort=16,
                cluster_crash=3, loss_rates=(0, 1, 5, 10, 20), loss_nodes=8, loss_seed=42)


def host_sim_grid(dev, captured):
    """Phase 21 (a): the pinned chaos grid (every family x ``HOST_SIM["seeds"]``)
    through the port's ``run_schedule`` and ``check_all`` with the
    differential replay on ``dev``; ``captured`` receives every delivery
    call's inputs. Then each replay again on ``dev`` and on the CPU, to
    equal cuts and final memberships. Returns (report, launches)."""
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.sim.fuzz import FAMILIES, run_schedule, scenario_family
    from rapid_tpu_torch.sim.oracles import check_all, replay_through_engine

    schedules = [scenario_family(family, seed)
                 for family in sorted(FAMILIES) for seed in HOST_SIM["seeds"]]
    results, run_s, check_s, failures = [], 0.0, 0.0, []
    delivery_new_bits.launches = 0
    with capturing(captured):
        for schedule in schedules:
            begin = time.perf_counter()
            result = run_schedule(schedule)
            middle = time.perf_counter()
            violations = check_all(result, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            run_s += middle - begin
            check_s += time.perf_counter() - middle
            results.append(result)
            failures += [f"{schedule.name}: {v}" for v in violations]
            # Zero cuts is the asserted outcome only where no membership
            # change is asked for (the stable-band adversarial family).
            if not result.cuts and schedule.membership_phases():
                failures.append(f"{schedule.name}: produced no cuts (vacuous run)")
    launches = delivery_new_bits.launches
    check(not failures, "the pinned chaos grid failed: " + "; ".join(failures[:5]))
    check(launches > 0, "the host chaos replays launched no delivery kernel")
    replayed = 0
    for result in results:
        if (not result.final_converged or result.aborted_at_event is not None
                or not result.schedule.engine_compatible):
            continue
        card = replay_through_engine(result.schedule, result.endpoints, device=dev)
        cpu = replay_through_engine(result.schedule, result.endpoints, device="cpu")
        check(card == cpu, f"{result.schedule.name}: the card's replay differs from the CPU's")
        replayed += 1
    report = {
        "scenarios": len(schedules), "violations": 0, "replays_held_to_cpu": replayed,
        "cuts": sum(len(r.cuts) for r in results), "delivery_launches": launches,
        "scenarios_per_s": len(schedules) / (run_s + check_s),
        "host_run_s": run_s, "check_all_s": check_s,
        "host_run_share": run_s / (run_s + check_s), "replay_share": check_s / (run_s + check_s),
        "replay_rounds_per_scenario": launches / len(schedules),
    }
    if dev.type == "cuda":
        result = next(r for r in results if r.schedule.name.startswith("churn_under_loss"))
        before = delivery_new_bits.launches
        _, prof = profile_run(dev, lambda: replay_through_engine(
            result.schedule, result.endpoints, device=dev))
        rounds = delivery_new_bits.launches - before
        report["profiled_replay"] = {"scenario": result.schedule.name, "rounds": rounds,
                                     "kernels_per_round": prof["device_kernels"] / rounds,
                                     "host_ops_per_round": prof["host_ops"] / rounds,
                                     "device_busy_share": prof["device_busy_share"],
                                     "wall_ms": prof["wall_ms"]}
    return report, launches


def free_ports(count):
    """Kernel-assigned loopback ports, reserved together then released."""
    import socket

    socks = []
    for _ in range(count):
        sk = socket.socket()
        sk.bind(("127.0.0.1", 0))
        socks.append(sk)
    ports = [sk.getsockname()[1] for sk in socks]
    for sk in socks:
        sk.close()
    return ports


async def hier_udp_cluster(dev):
    """Phase 21 (c): ``HOST_SIM["cluster"]`` nodes through ``Cluster.start``
    / ``Cluster.join`` over ``UdpHybridServer`` / ``UdpHybridClient`` on
    loopback, ``hier_target_cohort_size`` = ``HOST_SIM["cluster_cohort"]``,
    every node's cut detector a ``DeviceCutDetector`` on ``dev``; then
    ``HOST_SIM["cluster_crash"]`` members of one cohort crash."""
    import asyncio
    import random

    from rapid_tpu_torch.messaging.udp import UdpHybridClient, UdpHybridServer
    from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
    from rapid_tpu_torch.protocol import Cluster, DeviceCutDetector
    from rapid_tpu_torch.types import Endpoint

    n, crash = HOST_SIM["cluster"], HOST_SIM["cluster_crash"]
    settings = host_settings()
    settings.hier_target_cohort_size = HOST_SIM["cluster_cohort"]
    fd = StaticFailureDetectorFactory()
    eps = [Endpoint("127.0.0.1", p) for p in free_ports(n)]

    def kw(i):
        return dict(settings=settings, client=UdpHybridClient(eps[i], settings),
                    server=UdpHybridServer(eps[i]),
                    fd_factory=fd, rng=random.Random(i),
                    cut_detector_factory=functools.partial(DeviceCutDetector, device=dev))

    async def converged(clusters, size, limit_s=90):
        deadline = time.perf_counter() + limit_s
        while time.perf_counter() < deadline:
            if all(c.membership_size == size for c in clusters) and len(
                    {(c.service.view.configuration_id, tuple(c.membership)) for c in clusters}) == 1:
                return True
            await asyncio.sleep(0.005)
        return False

    start = time.perf_counter()
    clusters = [await Cluster.start(eps[0], **kw(0))]
    try:
        clusters += await asyncio.gather(*(Cluster.join(eps[0], eps[i], **kw(i))
                                           for i in range(1, n)))
        check(await converged(clusters, n), "the hierarchical UDP cluster did not form")
        boot_ms = (time.perf_counter() - start) * 1e3
        kinds = {(type(c.service).__name__, type(c.service.cut_detector).__name__)
                 for c in clusters}
        check(kinds == {("HierMembershipService", "DeviceCutDetector")}, f"the nodes ran {kinds}")
        cmap = clusters[0].service._cohort_map
        cohort = next(c for c in range(cmap.n_cohorts) if eps[0] not in cmap.members_of(c))
        victims = [c for c in clusters if c.listen_address in cmap.members_of(cohort)][:crash]
        msgs0 = sum(c.service.client.stats.msgs_tx for c in clusters)
        start = time.perf_counter()
        for victim in victims:
            await victim.shutdown()
        fd.add_failed_nodes([v.listen_address for v in victims])
        survivors = [c for c in clusters if c not in victims]
        check(await converged(survivors, n - crash), "the hierarchical UDP cluster did not converge")
        crash_ms = (time.perf_counter() - start) * 1e3
        counters = {}
        for c in survivors:
            for key, value in c.service.metrics.counters.items():
                if key.startswith("cohort_"):
                    counters[key] = counters.get(key, 0) + value
        check(counters.get("cohort_global_decisions", 0) > 0, "the global tier decided nothing")
        return {
            "cohorts": cmap.n_cohorts, "bootstrap_wall_ms": boot_ms,
            "crash_to_convergence_wall_ms": crash_ms,
            "crash_msgs": sum(c.service.client.stats.msgs_tx for c in clusters) - msgs0,
            "decision_paths": decided_paths([c.service for c in survivors]),
            "cut_passes": sum(c.service.cut_detector.batches for c in survivors),
            "cohort_counters": counters, "final_size": survivors[0].membership_size,
        }
    finally:
        await asyncio.gather(*(c.shutdown() for c in clusters), return_exceptions=True)


async def udp_loss_point(loss_rate, n_nodes, seed):
    """``examples/udp_loss_curve.py``'s measurement on the port: a cluster
    over the hybrid transport with seeded datagram loss at the sender
    (``LossyDatagramClient``), a join wave of 3, then a crash."""
    import asyncio
    import random

    from rapid_tpu_torch.messaging.udp import LossyDatagramClient, UdpHybridServer
    from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
    from rapid_tpu_torch.protocol import Cluster
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.types import Endpoint

    settings = Settings()
    settings.batching_window_ms = 20
    settings.failure_detector_interval_ms = 50
    settings.rpc_timeout_ms = 500
    settings.rpc_join_timeout_ms = 4000
    settings.rpc_probe_timeout_ms = 200
    settings.consensus_fallback_base_delay_ms = 1000
    settings.join_attempts = 10
    fd = StaticFailureDetectorFactory()
    rng = random.Random(seed)
    eps = [Endpoint("127.0.0.1", p) for p in free_ports(n_nodes)]
    clients = {}

    def kw(i):
        clients[i] = LossyDatagramClient(eps[i], settings, loss_rate=loss_rate,
                                         rng=random.Random(rng.randrange(1 << 30)))
        return dict(settings=settings, client=clients[i], server=UdpHybridServer(eps[i]),
                    fd_factory=fd, rng=random.Random(seed + i))

    async def converged(size, members):
        start = time.perf_counter()
        while not all(c.membership_size == size for c in members):
            await asyncio.sleep(0.02)
            check(time.perf_counter() - start <= 120, f"no convergence to {size}")
        return (time.perf_counter() - start) * 1e3

    n_seed = n_nodes - 3
    clusters = [await Cluster.start(eps[0], **kw(0))]
    try:
        for i in range(1, n_seed):
            clusters.append(await Cluster.join(eps[0], eps[i], **kw(i)))
        await converged(n_seed, clusters)
        start = time.perf_counter()
        clusters += await asyncio.gather(*(Cluster.join(eps[0], eps[i], **kw(i))
                                           for i in range(n_seed, n_nodes)))
        await converged(n_nodes, clusters)
        join_wave_ms = (time.perf_counter() - start) * 1e3
        victim = clusters[2]
        await victim.shutdown()
        fd.add_failed_nodes([victim.listen_address])
        survivors = [c for c in clusters if c is not victim]
        crash_ms = await converged(n_nodes - 1, survivors)
        return {
            "loss_pct": loss_rate * 100, "n_nodes": n_nodes, "join_wave_ms": join_wave_ms,
            "crash_ms": crash_ms,
            "forced_rejoins": sum(c.service.metrics.counters["decision_missing_joiner_uuid"]
                                  for c in survivors),
            "kicked": sum(c.service.metrics.counters["kicked"] for c in survivors),
            "datagrams_dropped": sum(c.datagrams_dropped for c in clients.values()),
            "datagrams_delivered": sum(c.datagrams_delivered for c in clients.values()),
        }
    finally:
        await asyncio.gather(*(c.shutdown() for c in clusters), return_exceptions=True)


def phase_host_sim(dev, card, captured):
    """Phase 21. (a) counts the delivery launches of its ``check_all``
    replays (zeroed just before, read just after) and fills ``captured``
    with their inputs; (b) and (c) launch none."""
    import asyncio

    from rapid_tpu_torch.ops.kernels import delivery_new_bits

    seconds = {}
    begin = time.perf_counter()
    grid, launches = host_sim_grid(dev, captured)
    seconds["grid"] = time.perf_counter() - begin
    begin = time.perf_counter()
    delivery_new_bits.launches = 0
    services = {}
    for mode, adapters, cohort in (("hier_device", True, HOST_SIM["cohort"]),
                                   ("hier_host", False, HOST_SIM["cohort"]),
                                   ("flat_host", False, 0)):
        services[mode] = asyncio.run(asyncio.wait_for(
            host_service_crash(dev, adapters, HOST_SIM["services"], cohort), 300))
    check(services["hier_device"]["final"] == services["hier_host"]["final"],
          f"the N={HOST_SIM['services']} hierarchical crash ended in another configuration "
          "with the device cut detector")
    for side in services.values():
        cid, members = side.pop("final")
        side["config_id"], side["final_size"] = cid, len(members)
    seconds["services"] = time.perf_counter() - begin
    begin = time.perf_counter()
    cluster = asyncio.run(asyncio.wait_for(hier_udp_cluster(dev), 240))
    seconds["udp_cluster"] = time.perf_counter() - begin
    begin = time.perf_counter()
    loss = [asyncio.run(asyncio.wait_for(udp_loss_point(
        pct / 100, HOST_SIM["loss_nodes"], HOST_SIM["loss_seed"]), 300))
        for pct in HOST_SIM["loss_rates"]]
    seconds["udp_loss_curve"] = time.perf_counter() - begin
    check(delivery_new_bits.launches == 0, "the host services launched the delivery kernel")
    emit({"phase": "host_sim", "card": card, "grid": grid, "services": services,
          "udp_cluster": cluster, "udp_loss_curve": loss, "seconds": seconds})
    return launches


# -- phase 22: a cluster resumed from a Configuration -------------------------

RESUME = dict(members=HEADLINE["n"], java=2_048, node_id_seed=22)


def native_build():
    """The native host library, built before the phases that hash
    endpoints (``utils/_native.ensure_built``): g++'s version, the wall ms
    and the library's path. Fails when it does not build or load."""
    from rapid_tpu_torch import _build
    from rapid_tpu_torch.utils import _native

    start = time.perf_counter()
    built = _native.ensure_built()
    ms = (time.perf_counter() - start) * 1e3
    check(built, f"the native host library did not build: {_build.build_log.get('rapid_native')}")
    _native._attempted = False  # load the fresh build
    check(_native.get_lib() is not None, f"the native host library does not load: {_native._LIB_PATH}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True)
    return {"gxx": gxx.stdout.splitlines()[0], "build_ms": ms, "path": str(_native._LIB_PATH)}


@contextlib.contextmanager
def without_native():
    """The host path's Python and numpy fallbacks, as with no native
    library (``get_lib()`` returns None inside)."""
    from rapid_tpu_torch.utils import _native

    saved = _native._lib, _native._attempted
    _native._lib, _native._attempted = None, True
    try:
        yield
    finally:
        _native._lib, _native._attempted = saved


def seeded_node_ids(count, seed):
    from rapid_tpu_torch.types import NodeId

    words = np.random.default_rng(seed).integers(0, 2**64, size=(count, 2), dtype=np.uint64)
    return [NodeId(int(hi), int(lo)) for hi, lo in words.tolist()]


def same_configuration(a, b):
    return (a.node_ids == b.node_ids and a.endpoints == b.endpoints and a.topology == b.topology)


def phase_config_resume(dev, native, captured):
    """Phase 22. ``native``: :func:`native_build`'s record; ``captured``: a
    list that receives the delivery inputs of every round of the resumed
    churn. Returns its delivery launches."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.ops.rings import endpoint_ring_keys
    from rapid_tpu_torch.protocol.view import (
        TOPOLOGY_JAVA, TOPOLOGY_NATIVE, Configuration, MembershipView, configuration_id_of,
        node_id_sort_key,
    )
    from rapid_tpu_torch.utils import _native
    from rapid_tpu_torch.utils.checkpoint import (
        configuration_to_bytes, load_configuration, save_configuration, view_from_configuration,
    )

    k, n, n_join, n_crash = HEADLINE["k"], RESUME["members"], HEADLINE["n_join"], HEADLINE["n_crash"]
    check(_native.get_lib() is not None, "the native host library is not loaded")
    report = {"native": native}
    endpoints = endpoint_list(n + n_join)
    node_ids = seeded_node_ids(n, RESUME["node_id_seed"])

    # (b) The Configuration file: the identifiers in the native order and
    # the members in ring 0's (key) order, as a view would write it; (e)
    # checks both through the resumed view's configuration id.
    start = time.perf_counter()
    ring0 = _native.native_ring_keys_batch(
        [ep.hostname.encode("utf-8") for ep in endpoints[:n]], [ep.port for ep in endpoints[:n]], 1)[0]
    check(len(np.unique(ring0)) == n, "two members share a ring-0 key")
    config = Configuration(sorted(node_ids, key=lambda nid: node_id_sort_key(nid, TOPOLOGY_NATIVE)),
                           [endpoints[i] for i in np.argsort(ring0, kind="stable")])
    config_ms = (time.perf_counter() - start) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config.rtcf")
        start = time.perf_counter()
        save_configuration(path, config)
        write_ms = (time.perf_counter() - start) * 1e3
        start = time.perf_counter()
        loaded = load_configuration(path)
        read_ms = (time.perf_counter() - start) * 1e3
        file_bytes = os.path.getsize(path)
        check(same_configuration(loaded, config), "the loaded configuration differs from the saved one")
        java = MembershipView(k, node_ids=node_ids[:RESUME["java"]],
                              endpoints=endpoints[:RESUME["java"]], topology=TOPOLOGY_JAVA).configuration
        java_path = os.path.join(tmp, "java.rtcf")
        save_configuration(java_path, java)
        check(configuration_to_bytes(java)[4] == 2, "a java configuration is not written as version 2")
        check(configuration_to_bytes(config)[4] == 1, "a native configuration is not written as version 1")
        java_loaded = load_configuration(java_path)
        check(same_configuration(java_loaded, java) and java_loaded.topology == TOPOLOGY_JAVA,
              "the java configuration did not round-trip")
    report["file"] = {"members": n, "bytes": file_bytes, "config_ms": config_ms,
                      "write_ms": write_ms, "read_ms": read_ms,
                      "java": {"members": RESUME["java"], "version": 2}}

    # (c) The configuration id.
    args = (loaded.node_ids, loaded.endpoints)
    start = time.perf_counter()
    native_id = configuration_id_of(*args)
    native_id_ms = (time.perf_counter() - start) * 1e3
    with without_native():
        start = time.perf_counter()
        python_id = configuration_id_of(*args)
        python_id_ms = (time.perf_counter() - start) * 1e3
    check(native_id == python_id == config.configuration_id,
          f"configuration ids differ: native {native_id}, Python {python_id}")
    report["configuration_id"] = {"equal": True, "native_ms": native_id_ms, "python_ms": python_id_ms}

    # (d) The ring keys.
    resumed = list(loaded.endpoints) + endpoints[n:]
    start = time.perf_counter()
    native_keys = endpoint_ring_keys(resumed, k)
    native_keys_ms = (time.perf_counter() - start) * 1e3
    with without_native():
        start = time.perf_counter()
        numpy_keys = endpoint_ring_keys(resumed, k)
        numpy_keys_ms = (time.perf_counter() - start) * 1e3
    check(all(np.array_equal(a, b) for a, b in zip(native_keys, numpy_keys)),
          "native and numpy ring keys differ")
    report["ring_keys"] = {"endpoints": len(resumed), "k": k, "equal": True,
                           "native_ms": native_keys_ms, "numpy_ms": numpy_keys_ms}

    # (e) The host view, against the engine's rings; (f) the engine's churn.
    start = time.perf_counter()
    view = view_from_configuration(loaded, k)
    resume_view_ms = (time.perf_counter() - start) * 1e3
    check(view.configuration_id == config.configuration_id, "the resumed view has another configuration id")
    start = time.perf_counter()
    vc, victims = endpoint_churn(resumed, n, n_join, n_crash, dev)
    torch.cuda.synchronize(dev)
    engine_build_ms = (time.perf_counter() - start) * 1e3
    perm = np.asarray(_host.read(vc.state.ring_perm))
    for r in range(k):
        slots = perm[r][perm[r] < n]
        check([resumed[i] for i in slots] == view.ring(r), f"the view's ring {r} is not the engine's")
    report["view"] = {"ms": resume_view_ms, "rings_equal_ring_perm": k}
    delivery_new_bits.launches = 0
    torch.cuda.synchronize(dev)
    start = time.perf_counter()
    with capturing(captured):
        rounds, cuts, resolved, sizes = resolve(vc, n)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - start) * 1e3
    launches = delivery_new_bits.launches
    check(resolved and vc.membership_size == n, f"resumed churn unresolved: {cuts} cuts, {sizes}")
    alive = vc.alive_mask
    got = {resumed[i] for i in np.nonzero(alive)[0]}
    want = (set(loaded.endpoints) - {resumed[i] for i in victims}) | set(endpoints[n:])
    check(got == want, "the resumed churn ended with the wrong members")
    check(launches > 0, "the resumed churn never launched the delivery kernel")
    report["churn"] = {"build_ms": engine_build_ms, "ms": ms, "rounds": rounds, "cuts": cuts,
                       "sizes": list(sizes), "members_right": True, "kernel_launches": launches,
                       "captured_rounds": len(captured)}
    emit({"phase": "config_resume", **report})
    return launches


SHARDED = dict(offsets=(0, 33_333, 51_250), churn_timed=2, trace_rounds=6, trace=64)


@contextlib.contextmanager
def syncs_only_in_reads(dev):
    """A context in which every synchronizing call raises
    (``torch.cuda.set_sync_debug_mode("error")``) except inside the
    engine's counted reads (``_host.read``), which are its branch points."""
    from rapid_tpu_torch import _host

    real = _host.read

    def read(t):  # _host.read with the check lifted, counted on the real one
        real.count += 1
        torch.cuda.set_sync_debug_mode("default")
        try:
            return t.tolist()
        finally:
            torch.cuda.set_sync_debug_mode("error")

    torch.cuda.synchronize(dev)
    _host.read = read
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
        _host.read = real


def nccl_group():
    """A one-rank NCCL process group over a file in a fresh temporary
    directory, on the loopback interface (the card machine has no other
    network). Returns the directory, which the caller removes after
    ``destroy_process_group``."""
    from rapid_tpu_torch.parallel.multihost import initialize_multihost

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_IB_DISABLE", "1")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    initialize_multihost(f"file://{tmp}/store", 1, 0, device_type="cuda")
    return tmp


def offset_kernel_slices(dev):
    """Phase 23 (a): the delivery kernel on column slices of the churn
    shape at global slot offsets (and on the upper cohort word at cohort
    offset 32), each bit for bit against its plain version, the slices side
    by side against the whole launch, in the two draw modes."""
    from rapid_tpu_torch.ops.kernels import delivery_new_bits, delivery_new_bits_ref

    k, n, c = HEADLINE["k"], HEADLINE["n"] + HEADLINE["n_join"], HEADLINE["cohorts"]
    cuts = list(SHARDED["offsets"]) + [n]
    out = []
    for spread, permille in DELAY_MODES[1:]:
        blocked, age, epoch = delivery_inputs(c, k, n, 70 + spread, dev)
        whole = delivery_new_bits(blocked, age, epoch, k, c, spread, permille)
        check(torch.equal(whole, delivery_new_bits_ref(blocked, age, epoch, k, c, spread, permille)),
              f"whole launch differs from its plain version (spread {spread})")
        parts, slices = [], []
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            args = (blocked[:, lo:hi].contiguous(), age[:, lo:hi].contiguous(), epoch, k, c,
                    spread, permille, lo, 0)
            part = delivery_new_bits(*args)
            check(torch.equal(part, delivery_new_bits_ref(*args)),
                  f"offset launch differs from its plain version at slot offset {lo}")
            parts.append(part)
            slices.append(args)
        check(torch.equal(torch.cat(parts, -1), whole), "the slices side by side differ from the whole")
        upper = (blocked[k:].contiguous(), age, epoch, k, 32, spread, permille, 0, 32)
        got = delivery_new_bits(*upper)
        check(torch.equal(got, whole[32:]) and torch.equal(got, delivery_new_bits_ref(*upper)),
              "the upper cohort word at cohort offset 32 differs from the whole launch")
        out.append(dict(spread=spread, permille=permille, slot_offsets=list(SHARDED["offsets"]),
                        cohort_offset=32, max_abs_err=0,
                        slices_ms=cuda_ms(lambda: [delivery_new_bits(*a) for a in slices]),
                        whole_ms=cuda_ms(lambda: delivery_new_bits(blocked, age, epoch, k, c,
                                                                   spread, permille))))
    return out


def collective_summary(ctx, rounds, n, c, tenants=1):
    """Collectives per round of one sharded run, by site, kind and payload
    class, with their bytes (from the context's log). A fleet's classes
    are per tenant: its payloads are priced against ``tenants`` clusters'
    n and c."""
    n = n * tenants
    from rapid_tpu_torch.parallel.collective_facts import (
        audit_collectives, collective_violations, payload_class,
    )

    rows = audit_collectives(ctx.log, n, c)
    by = {}
    for r in rows:
        key = f"{r['location']}/{r['kind']}/{payload_class(r['bytes'], n, c)}"
        count, nbytes = by.get(key, (0, 0))
        by[key] = (count + 1, nbytes + r["wire_bytes"])
    violations = collective_violations(rows)
    return {
        "collectives": len(rows), "collectives_per_round": len(rows) / rounds,
        "bytes_per_round": sum(r["wire_bytes"] for r in rows) / rounds,
        "per_round_by_site_kind_class": {
            key: {"count": count / rounds, "bytes": nbytes / rounds}
            for key, (count, nbytes) in sorted(by.items())},
        "labels": sorted({r["label"] for r in rows}),
        "violations": {key: len(v) for key, v in violations.items()},
    }


def collective_us(dev, calls=500):
    """Host microseconds per collective on the one-rank group, ``calls``
    back to back after a warm-up, the card synchronized at the end: an
    all-reduce of one int32 and an all-gather of a 102,500-byte lane (the
    churn's ``[1, n]`` membership), through the round body's context."""
    from rapid_tpu_torch.parallel.collectives import CollectiveContext
    from rapid_tpu_torch.parallel.mesh import make_mesh

    ctx = CollectiveContext(make_mesh(), HEADLINE["n"] + HEADLINE["n_join"], HEADLINE["cohorts"])
    scalar = torch.zeros((1,), dtype=torch.int32, device=dev)
    lane = torch.zeros((1, ctx.n), dtype=torch.bool, device=dev)
    out = {}
    for name, call in (("all_reduce_int32", lambda: ctx.sum(scalar, ("nodes",), "probe")),
                       ("all_gather_n_bool", lambda: ctx.gather(lane, "nodes", "probe")),
                       ("torch_add_int32", lambda: scalar + 1)):
        for _ in range(50):
            call()
        torch.cuda.synchronize(dev)
        start = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize(dev)
        out[name] = (time.perf_counter() - start) / calls * 1e6
    return out


def turns(sides, order):
    """Run ``sides[name]()`` in ``order``; each returns a dict with ``ms``.
    Returns name -> the list of its results in order."""
    out = {name: [] for name in sides}
    for name in order:
        out[name].append(sides[name]())
    return out


def sharded_churn(dev, mesh, captured):
    """Phase 23 (b): the N=100,000 5% churn through ``make_sharded_wave`` on
    the one-rank ``('cohort', 'nodes')`` mesh against ``run_until_membership``
    unsharded, in turns on fresh clusters from one seed."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.models.virtual_cluster import run_until_membership, sync_checksum
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.parallel.mesh import local_tree, make_sharded_wave, shard_faults, shard_state

    n = HEADLINE["n"]
    want = {}

    def run(side, capture=None):
        vc, _ = churn_cluster(n, HEADLINE["n_join"], HEADLINE["n_crash"], HEADLINE["cohorts"], 4, dev)
        cfg, faults = vc.cfg, vc.faults
        if side == "sharded":
            wave = make_sharded_wave(cfg, mesh, max_cuts=4)
            state, faults_in = shard_state(vc.state, mesh), shard_faults(faults, mesh)
        torch.cuda.synchronize(dev)
        delivery_new_bits.launches, reads0 = 0, _host.read.count
        start = time.perf_counter()
        with capturing(capture), syncs_only_in_reads(dev):
            if side == "sharded":
                state, steps, cuts, resolved, sizes = wave(state, faults_in, n, 96 * 4, 1)
                state = local_tree(state)
            else:
                state, steps, cuts, resolved, sizes, _, _ = run_until_membership(
                    cfg, vc.state, faults, n, 96 * 4, 4, 1)
                sizes = tuple(sizes) + (-1,) * (4 - len(sizes))
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - start) * 1e3
        launches, reads = delivery_new_bits.launches, _host.read.count - reads0
        check(resolved, f"{side} churn unresolved: {cuts} cuts in {steps} rounds")
        check(launches == steps, f"{side} churn: {launches} launches in {steps} rounds")
        result = (steps, cuts, resolved, tuple(sizes), _host.read(sync_checksum(state, faults)))
        lanes = plane_lanes(state)
        if side in want:
            check(want[side][0] == result, f"{side} churn differs between its samples")
        want.setdefault(side, (result, lanes))
        out = dict(ms=ms, rounds=steps, cuts=cuts, host_reads=reads,
                   host_reads_per_round=reads / steps, kernel_launches=launches)
        if side == "sharded":
            out["collectives"] = collective_summary(wave.context, steps, cfg.n, cfg.c)
        return out

    warm = {"unsharded": run("unsharded"), "sharded": run("sharded", captured)}
    timed = turns({"unsharded": lambda: run("unsharded"), "sharded": lambda: run("sharded")},
                  ["sharded", "unsharded", "unsharded", "sharded"][: 2 * SHARDED["churn_timed"]])
    profiles = {}
    for side in ("unsharded", "sharded"):
        vc, _ = churn_cluster(n, HEADLINE["n_join"], HEADLINE["n_crash"], HEADLINE["cohorts"], 4, dev)
        if side == "sharded":
            wave = make_sharded_wave(vc.cfg, mesh, max_cuts=4)
            args = (shard_state(vc.state, mesh), shard_faults(vc.faults, mesh), n, 96 * 4, 1)
            drive = functools.partial(wave, *args)
        else:
            drive = functools.partial(run_until_membership, vc.cfg, vc.state, vc.faults, n, 96 * 4,
                                      4, 1)
        (_, steps, *_), prof = profile_run(dev, drive)
        profiles[side] = {"kernels_per_round": prof["device_kernels"] / steps,
                          "host_ops_per_round": prof["host_ops"] / steps,
                          **{key: prof[key] for key in ("wall_ms", "device_ms", "host_op_self_ms",
                                                         "device_busy_share", "top")}}
    check(want["sharded"][0] == want["unsharded"][0],
          f"sharded churn {want['sharded'][0]} differs from unsharded {want['unsharded'][0]}")
    check_same_lanes(want["sharded"][1], want["unsharded"][1], "sharded churn")
    sh, un = timed["sharded"], timed["unsharded"]
    check(all(a["host_reads"] == b["host_reads"] for a, b in zip(sh, un)),
          "the sharded churn made other host reads than the unsharded")
    steps, cuts, _, sizes, checksum = want["sharded"][0]
    return {"n": n, "mesh": "(cohort=1, nodes=1)", "rounds": steps, "cuts": cuts,
            "sizes": list(sizes), "checksum": checksum, "lanes_bit_exact": len(want["sharded"][1]),
            "warmup": warm, "timed": timed,
            "median_ms": {side: statistics.median(r["ms"] for r in rs) for side, rs in timed.items()},
            "profile": profiles, "launches": sh[-1]["kernel_launches"]}


def sharded_scale_point(dev, mesh, captured):
    """Phase 23 (c): the N=1,000,000 crash-1% point through
    ``make_sharded_step`` to decision on the one-rank ``('nodes',)`` mesh
    against ``engine_step`` rounds unsharded, two seeds, in turns; the
    first sharded run's delivery rounds go to ``captured``."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster, engine_step, sync_checksum
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.parallel.mesh import local_tree, make_sharded_step, shard_faults, shard_state

    n, cohorts = SCALE["n"], SCALE["cohorts"]
    want = {}

    def run(side, seed, capture=None):
        vc = VirtualCluster.create(n, k=HEADLINE["k"], h=9, l=4, cohorts=cohorts, fd_threshold=3,
                                   seed=seed, delivery_spread=HEADLINE["spread"], device=dev)
        vc.assign_cohorts_roundrobin()
        vc.crash(np.random.default_rng(seed).choice(n, size=n // 100, replace=False))
        cfg, faults = vc.cfg, vc.faults
        if side == "sharded":
            step = make_sharded_step(cfg, mesh)
            state, faults_in = shard_state(vc.state, mesh), shard_faults(faults, mesh)
        else:
            state = vc.state
        torch.cuda.synchronize(dev)
        delivery_new_bits.launches, reads0 = 0, _host.read.count
        start = time.perf_counter()
        rounds, decided = 0, False
        with capturing(capture), syncs_only_in_reads(dev):
            while not decided and rounds < 96:
                if side == "sharded":
                    state, _ = step(state, faults_in)
                    decided = step.decided
                else:
                    state, _, decided, _, _ = engine_step(cfg, state, faults)
                rounds += 1
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - start) * 1e3
        launches, reads = delivery_new_bits.launches, _host.read.count - reads0
        state = local_tree(state)
        members = _host.read(state.n_members)
        check(decided and members == n - n // 100, f"{side} N={n}: {decided}, {members}")
        check(launches == rounds, f"{side} N={n}: {launches} launches in {rounds} rounds")
        result = (rounds, members, _host.read(sync_checksum(state, faults)),
                  _host.read(_u32_pair(state)))
        want.setdefault((side, seed), result)
        out = dict(seed=seed, ms=ms, rounds=rounds, host_reads=reads,
                   host_reads_per_round=reads / rounds, kernel_launches=launches)
        if side == "sharded":
            out["collectives"] = collective_summary(step.context, rounds, n, cohorts)
        return out

    runs = [run("unsharded", 7), run("sharded", 7, captured), run("sharded", 8),
            run("unsharded", 8)]
    for seed in (7, 8):
        check(want[("sharded", seed)] == want[("unsharded", seed)],
              f"N={n} seed {seed}: sharded {want[('sharded', seed)]}, "
              f"unsharded {want[('unsharded', seed)]}")
    return {"n": n, "cohorts": cohorts, "mesh": "(nodes=1)", "runs": runs,
            "result": list(want[("sharded", 8)]), "launches": runs[2]["kernel_launches"]}


def _u32_pair(state):
    from rapid_tpu_torch import _u32

    return _u32.widen(torch.stack([state.config_hi.reshape(()), state.config_lo.reshape(())]))


def sharded_fleet(dev, captured):
    """Phase 23 (d): the 256x1,024 fleet's 96-round wave through
    ``make_fleet_wave`` on the one-rank ``('tenant', 'cohort', 'nodes')``
    mesh against ``fleet_wave`` unsharded, on copies of one CPU-built
    fleet, in turns, each wave free of synchronizing calls."""
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.parallel.mesh import (
        full_pytree, make_mesh, shard_fleet_faults, shard_fleet_state,
    )
    from rapid_tpu_torch.tenancy import TenantFleet
    from rapid_tpu_torch.tenancy.fleet import fleet_wave, make_fleet_wave

    mesh = make_mesh(shape=(1, 1, 1))
    b, n, n_extra, steps = FLEET["tenants"], FLEET["n"], FLEET["n_extra"], FLEET["max_steps"]
    clusters, targets = fleet_clusters(b, n, n_extra, FLEET["cohorts"], 80_000, torch.device("cpu"))
    cpu = TenantFleet.from_clusters(clusters)
    want = {}

    def run(side, capture=None):
        fleet = fleet_on(cpu, dev)
        target = torch.tensor(targets, dtype=torch.int32, device=dev)
        min_cuts = torch.ones_like(target)
        if side == "sharded":
            wave = make_fleet_wave(fleet.cfg, mesh, max_cuts=4)
            state = shard_fleet_state(fleet.state, mesh)
            faults = shard_fleet_faults(fleet.faults, mesh)
        torch.cuda.synchronize(dev)
        delivery_new_bits.launches = 0
        start = time.perf_counter()
        with capturing(capture), syncs_only_in_reads(dev):
            if side == "sharded":
                state, *res = wave(state, faults, fleet.knobs, target, steps, min_cuts)
            else:
                state, *res, _, _ = fleet_wave(fleet.cfg, fleet.state, fleet.faults, fleet.knobs,
                                               target, steps, 4, min_cuts)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - start) * 1e3
        launches = delivery_new_bits.launches
        if side == "sharded":
            state = full_pytree(state)
            res = [r.to_local() for r in res]
        rounds, cuts, resolved, sizes = (r.cpu().numpy() for r in res)
        check(resolved.all(), f"{side} fleet wave left tenants unresolved")
        check(launches == steps, f"{side} fleet wave: {launches} launches in {steps} rounds")
        result = (rounds.tolist(), cuts.tolist(), sizes.tolist())
        lanes = plane_lanes(state)
        want.setdefault(side, (result, lanes))
        out = dict(ms=ms, view_changes=int(cuts.sum()), kernel_launches=launches)
        if side == "sharded":
            out["collectives"] = collective_summary(wave.context, steps, fleet.cfg.n, fleet.cfg.c,
                                                    tenants=b)
        return out

    warm = {"unsharded": run("unsharded"), "sharded": run("sharded", captured)}
    timed = turns({"unsharded": lambda: run("unsharded"), "sharded": lambda: run("sharded")},
                  ["sharded", "unsharded"])
    check(want["sharded"][0] == want["unsharded"][0], "the sharded fleet wave's results differ")
    check_same_lanes(want["sharded"][1], want["unsharded"][1], "sharded fleet wave")
    return {"tenants": b, "n": n, "n_slots": n + n_extra, "mesh": "(tenant=1, cohort=1, nodes=1)",
            "rounds_per_wave": steps, "view_changes": warm["sharded"]["view_changes"],
            "lanes_bit_exact": len(want["sharded"][1]), "warmup": warm, "timed": timed,
            "launches": timed["sharded"][-1]["kernel_launches"]}


def sharded_trace(dev, mesh):
    """Phase 23 (e): ``make_sharded_step_trace`` for a few rounds of the
    N=100,000 churn with the plane and a 64-round ring, against
    ``engine_step`` with both unsharded: every state, telemetry and ring
    lane and both digests."""
    from rapid_tpu_torch.models.virtual_cluster import engine_step, telemetry_digest, trace_digest
    from rapid_tpu_torch.ops.kernels import delivery_new_bits
    from rapid_tpu_torch.parallel.mesh import (
        local_tree, make_sharded_step_trace, shard_faults, shard_pytree, shard_state,
        telemetry_shardings, trace_shardings,
    )

    rounds, trace = SHARDED["trace_rounds"], SHARDED["trace"]
    got = {}

    def run(side):
        vc, _ = churn_cluster(HEADLINE["n"], HEADLINE["n_join"], HEADLINE["n_crash"],
                              HEADLINE["cohorts"], 5, dev, telemetry=True, trace=trace)
        cfg, state, faults, telem, ring = vc.cfg, vc.state, vc.faults, vc.telem, vc.trace_ring
        if side == "sharded":
            step = make_sharded_step_trace(cfg, mesh)
            state, faults_in = shard_state(state, mesh), shard_faults(faults, mesh)
            telem = shard_pytree(telem, telemetry_shardings(mesh), mesh)
            ring = shard_pytree(ring, trace_shardings(mesh), mesh)
        torch.cuda.synchronize(dev)
        delivery_new_bits.launches = 0
        start = time.perf_counter()
        with syncs_only_in_reads(dev):
            for _ in range(rounds):
                if side == "sharded":
                    state, telem, ring, _ = step(state, telem, ring, faults_in)
                else:
                    state, _, _, telem, ring = engine_step(cfg, state, faults, telem, ring)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - start) * 1e3
        launches = delivery_new_bits.launches
        check(launches == rounds, f"{side} trace rounds: {launches} launches in {rounds} rounds")
        state, telem, ring = local_tree(state), local_tree(telem), local_tree(ring)
        got.setdefault(side, dict(launches=launches, lanes={
            **plane_lanes(state), **{f"telem.{k}": v for k, v in plane_lanes(telem).items()},
            **{f"ring.{k}": v for k, v in plane_lanes(ring).items()}},
            digests=(telemetry_digest(_one(telem)).cpu().numpy(),
                     trace_digest(_one(ring)).cpu().numpy())))
        return {"ms": ms}

    timed = turns({"unsharded": lambda: run("unsharded"), "sharded": lambda: run("sharded")},
                  ["unsharded", "sharded", "sharded", "unsharded"])
    check_same_lanes(got["sharded"]["lanes"], got["unsharded"]["lanes"], "sharded trace rounds")
    for a, b in zip(got["sharded"]["digests"], got["unsharded"]["digests"]):
        check(np.array_equal(a, b), "sharded trace rounds: a digest differs")
    return {"n": HEADLINE["n"], "rounds": rounds, "trace": trace, "mesh": "(cohort=1, nodes=1)",
            "lanes_bit_exact": len(got["sharded"]["lanes"]),
            "telemetry_digest": got["sharded"]["digests"][0].tolist()[0][:10],
            "ms": {side: [r["ms"] for r in rs] for side, rs in timed.items()},
            "launches": got["sharded"]["launches"]}


def _one(tree):
    from rapid_tpu_torch.models.state import map_lanes

    return map_lanes(lambda x: x.unsqueeze(0), tree)


def phase_sharded(dev, captured):
    """Phase 23. ``captured``: name -> a list that receives the delivery
    inputs of every round of the sharded churn's warm-up, the first
    sharded 1M run and the sharded fleet wave's warm-up. Returns the
    sharded paths' delivery launches."""
    import shutil

    import torch.distributed as dist

    from rapid_tpu_torch.parallel.mesh import make_mesh

    card = smi("name,power.limit")
    tmp = nccl_group()
    try:
        report = {"card": card, "offset_kernel": offset_kernel_slices(dev),
                  "collective_us": collective_us(dev)}
        report["churn"] = sharded_churn(dev, make_mesh(shape=(1, 1)), captured["sharded_churn"])
        report["scale_point"] = sharded_scale_point(dev, make_mesh(),
                                                    captured["sharded_scale_point"])
        report["fleet_wave"] = sharded_fleet(dev, captured["sharded_fleet_wave"])
        report["trace_rounds"] = sharded_trace(dev, make_mesh(shape=(1, 1)))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "sharded", **report})
    return {f"sharded_{key}": report[key]["launches"]
            for key in ("churn", "scale_point", "fleet_wave", "trace_rounds")}


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
    native = native_build()
    emit({"phase": "build", "seconds": time.perf_counter() - start, "sources": _build.sources(),
          "ptxas": ptxas, "native": native, "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

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
    launches.update(timed("serving", phase_serving))
    launches.update(timed("recovery", phase_recovery))
    late_paths = {"chaos": [], "loss_variant": []}
    launches["chaos"] = timed("chaos", phase_chaos, late_paths["chaos"])
    launches["loss_variant"] = timed("loss_variant", phase_loss_variant,
                                     late_paths["loss_variant"])
    captured.update(timed("late_kernel_paths", phase_kernel_paths, late_paths))
    late_paths.clear()
    observed, ptxas = timed("observability", phase_observability)
    launches.update(observed)
    timed("host_path", phase_host_path, card)
    host_sim_rounds = []
    launches["host_sim"] = timed("host_sim", phase_host_sim, card, host_sim_rounds)
    captured.update(timed("host_sim_kernel_paths", phase_kernel_paths,
                          {"host_sim": host_sim_rounds}))
    del host_sim_rounds
    resume_rounds = []
    launches["config_resume"] = timed("config_resume", phase_config_resume, native, resume_rounds)
    captured.update(timed("config_resume_kernel_paths", phase_kernel_paths,
                          {"config_resume": resume_rounds}))
    del resume_rounds
    sharded_rounds = {"sharded_churn": [], "sharded_scale_point": [], "sharded_fleet_wave": []}
    launches.update(timed("sharded", phase_sharded, sharded_rounds))
    captured.update(timed("sharded_kernel_paths", phase_kernel_paths, sharded_rounds))
    del sharded_rounds
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
        "ptxas": ptxas,
        "cold_ms": main_mode["cold_ms"],
        "fleet_shape": {key: fleet_mode[key] for key in keys},
        "mode0": {shape: {key: m[key] for key in keys} for shape, m in (
            ("churn", modes[0]), ("fleet", fleet_modes[0]))},
        "captured": {name: {key: run[key] for key in (
            "rounds", "ms", "plain_ms", "bound_ms", "share_of_bound", "needed_draw_share")}
            for name, run in captured.items()},
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
