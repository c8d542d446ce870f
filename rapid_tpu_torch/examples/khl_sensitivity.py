"""K/H/L sensitivity of almost-everywhere agreement (paper Fig. 11 analog).

The port's counterpart of the JAX package's ``examples/khl_sensitivity.py``,
with its arguments, its table and, run for run, its
``(conflicted, announced, rounds)`` results.

The paper's experiment: 1000 processes, F random failures; "We generate
alert messages from the F processes' observers and deliver these alerts to
each process in a uniform random order. We count the number of processes
that announce a membership proposal that did not include all F processes
(a conflict)." The receivers differ only in alert arrival order, and the
conflict rate is the fraction of processes that announced early (a
proposal missing at least one victim).

The engine reproduces that model by derivation, not tuning:

  * every (cohort, edge) delivery delay is an independent uniform draw in
    [0, spread] (the counter hash of ``_deliver_alerts``); as spread grows,
    the induced per-cohort arrival order converges to the paper's
    independent uniform permutation;
  * all alerts fire simultaneously (stagger=0);
  * the metric is the paper's: the fraction of receiver cohorts whose FIRST
    announced proposal misses at least one victim.

The only approximation is time discretization: simultaneous arrivals within
one round are tallied atomically, which can only hide an early
announcement, so measured rates approach the paper's from below as
``--delivery-spread`` grows. Default 128 puts the per-pair tie probability
under 1%. No parameter is fitted to the paper's reported rates.

JAX's ``--platform`` is replaced by ``--device`` (CUDA unless another device
is named; CUDA without a card raises). On a card every round's delivery is
one launch of the CUDA kernel, at spread 128 and 1000 permille by default.

Usage: python -m rapid_tpu_torch.examples.khl_sensitivity [--n 1000] [--reps 20] [--cohorts 64]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch

from rapid_tpu_torch import _cli

#: Rounds run on the device between two reads of the end condition.
CHECK_EVERY = 8


def detector_experiment(cfg, state, blocked_rows, budget: int):
    """The detector-only experiment of one run, on the state's device.

    The paper's Fig. 11 study has no consensus: it is a pure cut-detector
    experiment run until every receiver announces. Driving the full engine
    would let the cluster decide (and apply the view change) long before
    slow receivers announce, truncating the sample; so this loop drives
    exactly the engine's delivery and cut-detection steps
    (``_deliver_alerts`` and ``_cohort_cut_detection``, the code the round
    body runs) and latches each cohort's FIRST announced proposal mask.

    ``state`` holds one cluster's lanes with a leading axis of 1. The loop
    stays on the device: it reads the end condition back once every
    :data:`CHECK_EVERY` rounds, never every round. Rounds run past the end
    (fewer than :data:`CHECK_EVERY`) change nothing that is returned: no cohort
    is left to latch, and ``t`` counts only the rounds that started with a
    cohort silent, as JAX's ``while_loop`` counts them. Returns
    ``(first_mask [c, n], got [c], t)`` as host values."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.models.virtual_cluster import _cohort_cut_detection, _deliver_alerts

    dev = state.alive.device
    first_mask = torch.zeros((1, cfg.c, cfg.n), dtype=torch.bool, device=dev)
    got = torch.zeros((1, cfg.c), dtype=torch.bool, device=dev)
    t = torch.zeros((), dtype=torch.int32, device=dev)
    ran = 0
    while ran < budget:
        for _ in range(min(CHECK_EVERY, budget - ran)):
            running = ~got.all()
            new_bits = _deliver_alerts(cfg, state, state.fire_round, blocked_rows)
            heard_down = ((new_bits != 0) & state.alive[:, None, :]).any(-1)
            (report_bits, released, announced, seen_down, proposed_now,
             prop_masks) = _cohort_cut_detection(cfg, state, new_bits, heard_down, select=True)
            state = state._replace(
                report_bits=report_bits, released=released, announced=announced,
                seen_down=seen_down, round_idx=state.round_idx + 1,
            )
            newly = proposed_now & ~got
            first_mask = torch.where(newly[..., None], prop_masks, first_mask)
            got = got | proposed_now
            t = t + running.to(torch.int32)
            ran += 1
        if _host.read(got.all(), "khl_sweep"):
            break
    return first_mask[0].cpu().numpy(), got[0].cpu().numpy(), _host.read(t, "khl_sweep")


def run_once(n, k, h, l, f, cohorts, seed, delivery_spread=128, stagger=0,
             loss=0.0, delay_permille=1000, device=None) -> tuple:
    """One paper-experiment run on ``device`` (CUDA unless another device is
    named).

    Returns (conflicted_cohorts, announced_cohorts, rounds_to_all_announced).
    A cohort is conflicted iff its first announced proposal differs from the
    full victim set (the paper's per-process conflict metric)."""
    from rapid_tpu_torch.models.state import resolve_device
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster, _edge_masks, _one

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    vc = VirtualCluster.create(
        n, k=k, h=h, l=l, cohorts=cohorts, fd_threshold=1, seed=seed,
        delivery_spread=delivery_spread, delivery_prob_permille=delay_permille,
        device=device,
    )
    cohort_of = rng.integers(0, cohorts, size=n).astype(np.int32)
    vc.assign_cohorts(cohort_of)
    if loss > 0:
        rx_block = np.zeros((cohorts, vc.cfg.n), dtype=bool)
        for c in range(1, cohorts):
            rx_block[c] = rng.random(vc.cfg.n) < loss
        vc.set_rx_block(rx_block)

    victims = rng.choice(n, size=f, replace=False)
    vc.crash(victims)
    # "We generate alert messages from the F processes' observers": fire all
    # victim edges as one event (stamped at the current round; optional
    # per-edge stagger delays firing like real detection jitter would).
    idx = vc._slot_index(victims)
    vc._stamp_fired_edges(idx, torch.ones((f, k), dtype=torch.bool, device=device))
    if stagger:
        # Spread fire rounds over [0, stagger] (delivery uses
        # round - fire_round), drawn as JAX's script draws them.
        offs = rng.integers(0, stagger + 1, size=(f, k)).astype(np.int32)
        fire = vc.state.fire_round
        rows = torch.from_numpy(offs).to(device=device, dtype=fire.dtype)
        vc.state = vc.state._replace(fire_round=fire.index_copy(0, idx, rows))

    state, faults = _one(vc.state), _one(vc.faults)
    _, blocked_rows = _edge_masks(vc.cfg, state, faults)
    budget = delivery_spread + stagger + 64
    first_mask, got, t = detector_experiment(vc.cfg, state, blocked_rows, budget)

    victims_mask = np.zeros(n, dtype=bool)
    victims_mask[victims] = True
    conflicted = int(
        (got & (first_mask[:, :n] != victims_mask[None, :]).any(axis=1)).sum()
    )
    return conflicted, int(got.sum()), int(t)


#: The table's (H, L, F) cells, in the order they print.
CELLS = tuple((h, l, f) for h in (9, 8, 7, 6) for l in (1, 2, 3, 4) if l < h
              for f in (2, 4, 8, 16))
K = 10


def header(args) -> list:
    """The table's two header lines."""
    return [f"N={args.n}, K={K}, cohorts={args.cohorts}, reps={args.reps}, "
            f"spread={args.delivery_spread} (paper-permutation mode)",
            f"{'H':>3} {'L':>3} {'F':>4} {'conflict%':>10} {'silent%':>8} "
            f"{'avg rounds':>11}"]


def cell(args, h: int, l: int, f: int, device) -> str:
    """One (H, L, F) cell over ``args.reps`` runs: its table line."""
    conflicted_total, announced_total, rounds_sum = 0, 0, 0
    total = args.cohorts * args.reps
    for rep in range(args.reps):
        conflicted, announced, rounds = run_once(
            args.n, K, h, l, f, args.cohorts,
            seed=hash((h, l, f, rep)) % 2**31,
            delivery_spread=args.delivery_spread,
            stagger=args.stagger,
            loss=args.loss,
            delay_permille=args.delay_permille,
            device=device,
        )
        conflicted_total += conflicted
        announced_total += announced
        rounds_sum += rounds
    # Conflict rate over ANNOUNCED receivers; cohorts that never announced
    # (possible only under --loss) are surfaced as silent%, never silently
    # counted as conflict-free.
    return (
        f"{h:>3} {l:>3} {f:>4} "
        f"{100.0 * conflicted_total / max(announced_total, 1):>9.2f}% "
        f"{100.0 * (total - announced_total) / total:>7.1f}% "
        f"{rounds_sum / args.reps:>11.1f}"
    )


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--reps", type=int, default=20,
                   help="paper: 20 repetitions per combination")
    p.add_argument("--cohorts", type=int, default=64,
                   help="independent receiver states sampled per run")
    p.add_argument("--delivery-spread", type=int, default=128,
                   help="uniform delay support per (cohort, edge); large "
                   "spread => per-cohort arrival order converges to the "
                   "paper's independent uniform permutation")
    p.add_argument("--stagger", type=int, default=0,
                   help="max rounds of per-edge detection jitter (paper "
                   "model: 0 — alerts all generated at once)")
    p.add_argument("--delay-permille", type=int, default=1000,
                   help="probability (permille, per cohort-edge) of a "
                   "nonzero delay; 1000 = the full uniform draw the paper "
                   "model derives to")
    p.add_argument("--loss", type=float, default=0.0,
                   help="one-way loss fraction per non-primary cohort (paper sim: 0)")
    _cli.add_device_argument(p)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    device = _cli.device_of(args)
    for line in header(args):
        print(line)
    for h, l, f in CELLS:
        print(cell(args, h, l, f, device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_cli.run_main(main))
