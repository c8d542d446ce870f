"""Demo: drive the virtual-cluster engine through the BASELINE scenarios.

The port's counterpart of the JAX package's
``examples/virtual_cluster_demo.py``, with the same scenarios and printed
lines (but the first, which names the torch device):

  1. 1K virtual nodes, 1% crash-fault injection
  2. 10K virtual nodes, batched 512-node join wave
  3. 50K virtual nodes, asymmetric one-way partition
  4. 100K virtual nodes, 5% concurrent churn

``--small`` divides every size by 10. JAX's ``--platform`` is replaced by
``--device`` (CUDA unless another device is named; CUDA without a card
raises).

Usage: python -m rapid_tpu_torch.examples.virtual_cluster_demo [--small] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from rapid_tpu_torch import _cli


def timed(label, fn):
    start = time.perf_counter()
    result = fn()
    elapsed = (time.perf_counter() - start) * 1000
    print(f"  {label}: {elapsed:.1f} ms -> {result}")
    return result


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--small", action="store_true", help="scale down for quick runs")
    _cli.add_device_argument(parser)
    args = parser.parse_args(argv)
    device = _cli.device_of(args)
    scale = 10 if args.small else 1

    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")

    # 1. crash faults
    n = 1000 // scale * scale
    print(f"[1] N={n}, 1% crash")
    vc = VirtualCluster.create(n, fd_threshold=3, seed=0, device=device)
    victims = np.random.default_rng(0).choice(n, size=max(1, n // 100), replace=False)
    vc.crash(victims)
    vc.run_until_converged()
    print(f"  converged: members {vc.membership_size}, epoch {vc.config_epoch}")

    # 2. join wave
    n = 10_000 // scale
    wave = 512 // scale
    print(f"[2] N={n}, {wave}-node join wave")
    vc = VirtualCluster.create(n, n_slots=n + wave, fd_threshold=3, seed=1, device=device)
    vc.inject_join_wave(list(range(n, n + wave)))
    rounds, _ = timed("join wave", lambda: vc.timed_convergence())
    print(f"  members {vc.membership_size}")

    # 3. asymmetric one-way partition
    n = 50_000 // scale
    print(f"[3] N={n}, one-way partition on 10 nodes")
    vc = VirtualCluster.create(n, fd_threshold=3, seed=2, device=device)
    faulty = list(range(100, 110))
    probe_fail = np.zeros((vc.cfg.n, vc.cfg.k), dtype=bool)
    probe_fail[faulty, :] = True  # all observers see these nodes as dead
    vc.set_flaky_edges(probe_fail)
    vc.run_until_converged()
    removed = ~vc.alive_mask[faulty]
    print(f"  removed exactly the faulty set: {removed.all()} "
          f"(members {vc.membership_size})")

    # 4. churn
    n = 100_000 // scale
    print(f"[4] N={n}, 5% churn")
    vc = VirtualCluster.create(n, n_slots=int(n * 1.05), fd_threshold=3, seed=3, device=device)
    rng = np.random.default_rng(3)
    crash = rng.choice(n, size=n // 20, replace=False)
    vc.crash(crash)
    vc.inject_join_wave(list(range(n, int(n * 1.05))))
    epochs = 0
    start = time.perf_counter()
    while epochs < 2:
        rounds, events = vc.run_until_converged(max_steps=32)
        if events is None:
            break
        epochs = vc.config_epoch
    _cli.synchronize(device)
    elapsed = (time.perf_counter() - start) * 1000
    print(f"  churn settled in {elapsed:.1f} ms: members {vc.membership_size}, "
          f"epochs {vc.config_epoch}")
    return 0


if __name__ == "__main__":
    sys.exit(_cli.run_main(main))
