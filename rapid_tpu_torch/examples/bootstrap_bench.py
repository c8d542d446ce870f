"""Bootstrap benchmark: the paper's Fig. 5 / Table 1 scenario on the engine.

The port's counterpart of the JAX package's ``examples/bootstrap_bench.py``.
The paper's headline comparison is cluster BOOTSTRAP: N processes join
through a seed as fast as the protocol admits them, and (Table 1) do so
through a handful of large cuts, 4-10 unique intermediate cluster sizes,
where ZooKeeper and Memberlist pass through ~N one-at-a-time sizes. The
cleanliness comes from alert batching + multi-node cut detection agreeing
on whole join waves.

This script replays that scenario on the virtual-cluster engine: a small
seed cluster is up; the remaining members all request admission
concurrently, arriving in ``--waves`` batches; each batch is admitted
through full consensus with jittered per-cohort delivery. Reported per run,
with JAX's keys:

  - wall_ms            end-to-end bootstrap time on this device
  - view_changes       consensus decisions taken (Table 1: O(waves), not O(N))
  - unique_sizes       every intermediate membership size observed
  - rounds             protocol rounds executed across all decisions

JAX's ``use_pallas`` / ``--platform`` are replaced by ``device`` /
``--device`` (CUDA unless another device is named; CUDA without a card
raises): on a card every round's delivery runs the CUDA kernel.

Usage:
    python -m rapid_tpu_torch.examples.bootstrap_bench                  # N=2000, paper scale
    python -m rapid_tpu_torch.examples.bootstrap_bench --n 100000
    python -m rapid_tpu_torch.examples.bootstrap_bench --waves 8 --seed-size 64
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np

from rapid_tpu_torch import _cli


def run_bootstrap(
    n_total: int,
    seed_size: int,
    waves: int,
    cohorts: int,
    delivery_spread: int,
    seed: int = 0,
    device=None,
    max_steps: int = 64,
) -> dict:
    """Bootstrap seed_size -> n_total through `waves` batched join cuts on
    ``device`` (CUDA unless another device is named)."""
    from rapid_tpu_torch.models.state import resolve_device
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    device = resolve_device(device)
    vc = VirtualCluster.create(
        seed_size,
        n_slots=n_total,
        cohorts=cohorts,
        fd_threshold=3,
        seed=seed,
        delivery_spread=delivery_spread,
        device=device,
    )
    vc.assign_cohorts_roundrobin()

    joiners = np.arange(seed_size, n_total)
    batches = np.array_split(joiners, waves)

    sizes = [vc.membership_size]
    total_rounds = 0
    view_changes = 0
    vc.sync()
    t0 = time.perf_counter()
    for batch in batches:
        if batch.size == 0:
            continue
        vc.inject_join_wave(batch)
        # One wave may land as one cut or (under delivery jitter) a couple;
        # keep deciding until every joiner in the batch is admitted, in one
        # run_until_membership per wave (the per-cut sizes come back with
        # its one packed read).
        target = sizes[-1] + batch.size
        rounds, cuts, resolved, cut_sizes = vc.run_until_membership(
            target, max_steps=max_steps * 8, max_cuts=8
        )
        total_rounds += rounds
        if not resolved:
            raise RuntimeError(
                f"wave unresolved after {cuts} cuts / {rounds} rounds "
                f"(sizes {cut_sizes}, target {target})"
            )
        for size in cut_sizes:
            if size <= sizes[-1]:
                # Every decision in a pure join wave must admit someone; a
                # non-growing cut would corrupt the Table 1 instrument.
                raise RuntimeError(
                    f"decision did not grow membership ({sizes[-1]} -> {size})"
                )
            sizes.append(size)
        view_changes += cuts
    _cli.synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1000.0

    if sizes[-1] != n_total:
        raise RuntimeError(f"bootstrap ended at {sizes[-1]} != {n_total}")
    return {
        "scenario": "bootstrap",
        "n_total": n_total,
        "seed_size": seed_size,
        "waves": waves,
        "wall_ms": round(wall_ms, 3),
        "view_changes": view_changes,
        "rounds": total_rounds,
        "unique_sizes": sizes,
        "cohorts": cohorts,
        "delivery_spread": delivery_spread,
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=2000,
                        help="total cluster size (paper Fig. 5 uses 2000)")
    parser.add_argument("--seed-size", type=int, default=64,
                        help="members already up before the herd arrives")
    parser.add_argument("--waves", type=int, default=8,
                        help="batching windows the joiner herd arrives in "
                             "(Table 1 reports 4-10 intermediate sizes)")
    parser.add_argument("--cohorts", type=int, default=16)
    parser.add_argument("--delivery-spread", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    _cli.add_device_argument(parser)
    args = parser.parse_args(argv)
    device = _cli.device_of(args)

    # Warm the kernel build and the allocator on a throwaway bootstrap, then
    # measure.
    run_bootstrap(args.n, args.seed_size, args.waves, args.cohorts,
                  args.delivery_spread, seed=args.seed + 1, device=device)
    result = run_bootstrap(args.n, args.seed_size, args.waves, args.cohorts,
                           args.delivery_spread, seed=args.seed, device=device)
    result["platform"] = device.type
    # Table 1's metric: intermediate sizes the cluster passed through.
    result["cleanliness"] = len(result["unique_sizes"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(_cli.run_main(main))
