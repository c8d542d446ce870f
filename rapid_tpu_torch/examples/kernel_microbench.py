"""Microbenchmark: the CUDA delivery kernel against its plain PyTorch
version, the watermark pass, and a profile of one engine convergence.

The port's counterpart of the JAX package's ``examples/pallas_microbench.py``
(which times the Pallas delivery kernel, ``pallas_ms``, against the engine's
jnp path, ``jnp_ms``). Here, on engine-realistic inputs (a crashed cluster
after its detectors fired, round-robin cohorts, spread 2):

- the delivery kernel (``ops/kernels.delivery_new_bits``, ``kernel_ms``)
  against its plain version (``delivery_new_bits_ref``, ``plain_ms``) at
  ``[64, min(n, 100,000)]`` and ``[cohorts, n]`` (default ``[8, 1,000,000]``),
  bit for bit, with the speedup;
- ``watermark_merge_classify``, a torch elementwise op (the Mosaic
  watermark kernel was deleted upstream of the port), for the op-level
  record;
- with ``--profile DIR``, one N=100,000 churn convergence under
  ``rapid_tpu_torch.utils.profiling.trace``.

On a card every time is the median over 3 runs of CUDA events around 30
calls, as ``chip_smoke.py``'s ``cuda_ms`` times them: the kernel's and the
watermark op's captured as one CUDA graph and replayed (the host's launch
cost does not hide a kernel that takes less), the plain version's many
small ops issued from the host. On the CPU (``--device cpu``) there is no kernel: the plain
times are host wall clock and ``kernel_ms`` is null, as JAX's script
reports a null ``pallas_ms`` off the TPU. JAX's ``--platform`` is replaced
by ``--device`` (CUDA unless another device is named; CUDA without a card
raises).

    python -m rapid_tpu_torch.examples.kernel_microbench [--n 1000000] [--profile /tmp/tr]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from rapid_tpu_torch import _cli


def device_ms(fn, device, reps: int = 30, warmup: int = 5, runs: int = 3,
              graph: bool = True) -> float:
    """Milliseconds of one ``fn()`` on ``device``. On a card: after
    ``warmup`` calls, the median over ``runs`` of one pair of CUDA events
    around ``reps`` calls, divided by ``reps``; with ``graph`` the calls are
    captured once as a CUDA graph and replayed, without it they are issued
    from the host each time (the plain version's many small ops). On the
    CPU: the median wall clock of ``runs`` calls after one warm-up."""
    if device.type != "cuda":
        fn()
        times = []
        for _ in range(runs):
            start = time.perf_counter()
            fn()
            times.append((time.perf_counter() - start) * 1e3)
        return statistics.median(times)
    for _ in range(warmup):
        fn()

    def issue():
        for _ in range(reps):
            fn()

    run = issue
    if graph:
        torch.cuda.synchronize(device)
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            issue()
        run = captured.replay
        run()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def speedup_of(plain_ms: float, kernel_ms: Optional[float]):
    """plain / kernel from the unrounded times, or None without a kernel
    time (or one too small to divide)."""
    if kernel_ms is None or plain_ms <= 0.0 or kernel_ms <= 1e-6:
        return None
    return round(plain_ms / kernel_ms, 2)


def delivery_inputs(n: int, c: int, rng: np.random.Generator, device):
    """The delivery call's arguments one engine round makes on a cluster of
    ``n`` with ``c`` cohorts, 1% of it crashed, after the round that fired
    its detectors."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster, _edge_masks, _one

    vc = VirtualCluster.create(n, cohorts=c, fd_threshold=1, seed=1, delivery_spread=2,
                               device=device)
    vc.assign_cohorts_roundrobin()
    vc.crash(np.asarray(rng.choice(n, size=max(1, n // 100), replace=False)))
    vc.step()  # fire the detectors
    cfg, state = vc.cfg, _one(vc.state)
    _, blocked = _edge_masks(cfg, state, _one(vc.faults))
    age = (state.round_idx[:, None, None] - state.fire_round.transpose(1, 2).to(torch.int32))
    return (blocked[0].contiguous(), age[0].contiguous(), state.config_epoch.reshape(1),
            cfg.k, cfg.c, cfg.delivery_spread, cfg.delivery_prob_permille)


def delivery_row(n: int, c: int, rng: np.random.Generator, device) -> dict:
    from rapid_tpu_torch.ops.kernels import delivery_new_bits, delivery_new_bits_ref

    args = delivery_inputs(n, c, rng, device)
    plain = delivery_new_bits_ref(*args)
    row = {"platform": device.type, "delivery_shape": [c, n],
           "plain_ms": round(device_ms(lambda: delivery_new_bits_ref(*args), device,
                                           graph=False), 4)}
    if device.type == "cuda":
        exact = torch.equal(delivery_new_bits(*args), plain)
        if not exact:
            raise RuntimeError(f"the delivery kernel differs from its plain version at {[c, n]}")
        kernel_ms = device_ms(lambda: delivery_new_bits(*args), device)
        row.update(kernel_ms=round(kernel_ms, 4), bit_exact=exact,
                   speedup=speedup_of(row["plain_ms"], kernel_ms))
    else:
        row.update(kernel_ms=None, bit_exact=None, speedup=None,
                   note="the CUDA delivery kernel runs only on a card; re-run with --device cuda")
    return row


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=1_000_000)
    parser.add_argument("--cohorts", type=int, default=8)
    parser.add_argument("--profile", default=None,
                        help="also trace one 100K-member churn convergence into DIR")
    _cli.add_device_argument(parser)
    args = parser.parse_args(argv)
    device = _cli.device_of(args)

    from rapid_tpu_torch.ops.kernels import watermark_merge_classify

    h, l, k = 9, 4, 10
    rng = np.random.default_rng(0)
    shape = (args.cohorts, args.n)

    def lane(x):  # uint32 values as the int32 bit pattern the port stores
        return torch.from_numpy(x.astype(np.int64).astype(np.int32)).to(device)

    old = lane(rng.integers(0, 1 << k, size=shape, dtype=np.uint32))
    new = lane(rng.integers(0, 1 << k, size=shape, dtype=np.uint32))
    mask = torch.from_numpy(rng.random(shape) < 0.95).to(device)
    wm_ms = device_ms(lambda: watermark_merge_classify(old, new, mask, h, l), device)
    print(json.dumps({"watermark_shape": list(shape), "torch_op_ms": round(wm_ms, 4),
                      "platform": device.type}), flush=True)

    for n, c in ((min(args.n, 100_000), 64), (args.n, args.cohorts)):
        print(json.dumps(delivery_row(n, c, rng, device)), flush=True)

    if args.profile:
        from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
        from rapid_tpu_torch.utils.profiling import trace

        n = 100_000

        def build_churn(seed: int):
            vc = VirtualCluster.create(
                n, n_slots=n + 2500, cohorts=64, fd_threshold=3, seed=seed,
                delivery_spread=2, device=device,
            )
            vc.assign_cohorts_roundrobin()
            vc.crash(np.random.default_rng(seed + 1).choice(n, size=2500, replace=False))
            vc.inject_join_wave(np.arange(n, n + 2500))
            vc.sync()
            return vc

        build_churn(0).run_to_decision(max_steps=96)  # warm outside the trace
        vc2 = build_churn(1)
        with trace(args.profile):
            vc2.run_to_decision(max_steps=96)
        print(f"profile written to {args.profile}")
    return 0


if __name__ == "__main__":
    sys.exit(_cli.run_main(main))
