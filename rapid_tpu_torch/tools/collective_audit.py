"""Sharded-collective audit: run the engine's sharded round on a process
group and classify every cross-device collective it issues.

The port's counterpart of the JAX package's ``tools/collective_audit.py``,
with its arguments (``--n``, ``--devices``, ``--cohorts``,
``--cohort-devices``, ``--out``), its markdown table and its JSON keys where
they carry over. JAX's tool compiles the engine under a device mesh and
reads the collectives off the HLO. The port compiles no HLO: its round body
issues its collectives itself through a ``CollectiveContext``, which records
each one, and this tool reads that record
(``rapid_tpu_torch/parallel/collective_facts.py``) after driving the round.
The invariants are JAX's: the hot loop's unconditional collectives are
all-reduces only, the per-edge gathers sit in the prologue, and anything
[c,n]-sized moves only inside a gated branch.

Because the record holds only what ran, the scenario must take every gated
branch: where JAX compiles the loop at ``n - devices`` members with no
churn, the port drives ``bench.py``'s 5% churn at ``--n`` slots (K/H/L
10/9/4, fd 3 staggered over 3 rounds, spread 2, two racing coordinators,
round-robin cohorts): ``n // 41`` members crash and as many slots join
(2,500 of 100,000 members at n=102,500).
The two programs are JAX's: ``convergence_loop`` (the churn through
``make_sharded_wave`` until the membership is whole again) and
``engine_step`` (a fresh copy through ``make_sharded_step`` to its first
decision).

The ranks: ``--devices`` of them, on an NCCL group over the cards present
(``--device cuda``, the default; CUDA without a card raises) or on a gloo
group on the CPU (``--device cpu``), started as the port's tests start
their mesh jobs (a file rendezvous in a temporary directory, one spawned
process a rank; one rank runs in this process).

JSON keys kept from JAX's report: ``n_slots``, ``cohorts``, ``devices``,
``mesh``, ``programs`` (rows: kind, shape, bytes, location, source,
cn_scale, n_scale, groups, unknown_dtypes, plus the round, axis, label and
wire bytes), ``facts`` (``collectives`` by location/kind with count, bytes,
max_bytes and class; ``transfers``: the host reads and uploads, where JAX
counts the HLO's transfer ops), ``violations``, ``ok``. Those that cannot
carry over are named under ``not_carried_over``: ``donation`` (the port
reports ``aliases``, the lanes a call hands back in their input's
storage), ``memory``, ``parameter_dtype_bytes`` and ``cost`` (XLA's
analyses of a compiled program).

    python -m rapid_tpu_torch.tools.collective_audit [--n 10240] [--devices 8] \\
        [--cohort-devices 2] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

from rapid_tpu_torch import _cli

#: JAX report keys the port has no counterpart for, and why.
NOT_CARRIED_OVER = {
    "donation": "XLA's buffer donation table; the port reports `aliases`, the state "
                "lanes a call returns in their input's storage",
    "memory": "XLA's memory analysis of a compiled program",
    "parameter_dtype_bytes": "the HLO entry signature's bytes per dtype",
    "cost": "XLA's cost analysis of a compiled program",
}


def churn_cluster(n: int, members: int, crashes: int, cohorts: int, seed: int, device):
    """``bench.py``'s churn at ``n`` slots: ``members`` up, ``crashes`` of
    them crashed, the other ``n - members`` slots joining."""
    import numpy as np

    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    vc = VirtualCluster.create(
        members, n_slots=n, k=10, h=9, l=4, cohorts=cohorts, fd_threshold=3, seed=seed,
        delivery_spread=2, concurrent_coordinators=2, device=device,
    )
    vc.assign_cohorts_roundrobin()
    rng = np.random.default_rng(seed + 1000)
    vc.stagger_fd_counts(rng, spread_rounds=3)
    vc.crash(rng.choice(members, size=crashes, replace=False))
    vc.inject_join_wave(np.arange(members, n))
    return vc


def program_facts(rows: List[Dict], n: int, c: int) -> Dict[str, Dict]:
    """JAX's ``collectives`` fact: rows grouped by location/kind with their
    count, bytes, largest payload and that payload's class."""
    from rapid_tpu_torch.parallel.collective_facts import payload_class

    out: Dict[str, Dict] = {}
    for row in rows:
        entry = out.setdefault(f"{row['location']}/{row['kind']}",
                               {"count": 0, "bytes": 0, "max_bytes": 0})
        entry["count"] += 1
        entry["bytes"] += row["bytes"]
        entry["max_bytes"] = max(entry["max_bytes"], row["bytes"])
    for entry in out.values():
        entry["class"] = payload_class(entry["max_bytes"], n, c)
    return out


def audit(args: argparse.Namespace, device) -> dict:
    """Both programs on this rank's shard of the mesh, on ``device``; the
    report (every rank computes the same one)."""
    import torch.distributed as dist

    from rapid_tpu_torch.parallel import mesh as pm
    from rapid_tpu_torch.parallel.collective_facts import (
        audit_collectives, collective_violations, count_transfer_ops, input_output_aliases,
    )

    device_type = device.type
    if args.cohort_devices:
        mesh = pm.make_mesh(shape=(args.cohort_devices, args.devices // args.cohort_devices),
                            device_type=device_type)
    else:
        mesh = pm.make_mesh(device_type=device_type)
    churn = args.n // 41
    members = args.n - churn

    def build():
        return churn_cluster(args.n, members, churn, args.cohorts, args.seed, device)

    report = {"n_slots": args.n, "cohorts": args.cohorts, "devices": args.devices,
              "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
              "members": members, "crashes": churn, "joins": churn,
              "seed": args.seed, "backend": dist.get_backend(), "programs": {}, "facts": {},
              "not_carried_over": NOT_CARRIED_OVER}

    # Program 1: the convergence loop (the product path of
    # run_until_membership), edge gathers in its prologue.
    vc = build()
    cfg = vc.cfg
    wave = pm.make_sharded_wave(cfg, mesh, max_cuts=4)
    state = pm.shard_state(vc.state, mesh)
    faults = pm.shard_faults(vc.faults, mesh)
    (out_state, steps, cuts, resolved, _sizes), transfers = count_transfer_ops(
        lambda: wave(state, faults, members, 96 * 4, 1))
    rows = audit_collectives(wave.context.log, cfg.n, cfg.c)
    report["programs"]["convergence_loop"] = rows
    report["facts"]["convergence_loop"] = {
        "collectives": program_facts(rows, cfg.n, cfg.c), "transfers": transfers,
        "aliases": len(input_output_aliases(state, out_state)), "lanes": len(state),
        "rounds": steps, "cuts": cuts, "resolved": bool(resolved)}

    # Program 2: one engine step at a time, to the first decision.
    vc = build()
    step = pm.make_sharded_step(cfg, mesh)
    state = pm.shard_state(vc.state, mesh)
    faults = pm.shard_faults(vc.faults, mesh)
    first = state
    rounds, transfers = 0, {}
    while rounds < 96:
        (state, _events), counts = count_transfer_ops(lambda: step(state, faults))
        for kind, v in counts.items():
            transfers[kind] = transfers.get(kind, 0) + v
        rounds += 1
        if step.decided:
            break
    rows = audit_collectives(step.context.log, cfg.n, cfg.c)
    report["programs"]["engine_step"] = rows
    report["facts"]["engine_step"] = {
        "collectives": program_facts(rows, cfg.n, cfg.c), "transfers": transfers,
        "aliases": len(input_output_aliases(first, state)), "lanes": len(state),
        "rounds": rounds, "decided": bool(step.decided)}

    violations = collective_violations(report["programs"]["convergence_loop"])
    report["violations"] = violations
    report["ok"] = bool(resolved) and not any(violations.values())
    return report


def _rank(rank: int, world: int, store: str, out: str, args: argparse.Namespace,
          device_type: str) -> None:
    """One rank: join the group, audit, rank 0 writes the report."""
    import torch
    import torch.distributed as dist

    from rapid_tpu_torch.parallel.multihost import initialize_multihost

    device = torch.device("cpu")
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    initialize_multihost(f"file://{store}", world, rank, device_type=device_type)
    try:
        report = audit(args, device)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()


def run_ranks(args: argparse.Namespace, device_type: str) -> dict:
    """The audit on ``args.devices`` ranks; returns rank 0's report."""
    with tempfile.TemporaryDirectory(prefix="collective_audit_") as tmp:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "report.json")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if args.devices == 1:
            _rank(0, 1, store, out, args, device_type)
        else:
            import torch.multiprocessing as mp

            mp.spawn(_rank, args=(args.devices, store, out, args, device_type),
                     nprocs=args.devices, join=True)
        return json.loads(Path(out).read_text())


def markdown(report: dict) -> List[str]:
    """JAX's table and summary lines."""
    def summarize(rows):
        agg = {}
        for r in rows:
            key = (r["location"], r["kind"], r["source"])
            agg.setdefault(key, {"count": 0, "bytes": 0})
            agg[key]["count"] += 1
            agg[key]["bytes"] += r["bytes"]
        return agg

    lines = ["", "| program | location | kind | source | count | payload bytes |",
             "|---|---|---|---|---|---|"]
    for prog, rows in report["programs"].items():
        for (loc, kind, src), v in sorted(summarize(rows).items()):
            lines.append(f"| {prog} | {loc} | {kind} | {src} | {v['count']} | {v['bytes']} |")
    for prog, facts in report["facts"].items():
        t = facts["transfers"]
        lines.append(
            f"\n{prog}: {facts['rounds']} round(s), aliases {facts['aliases']}/{facts['lanes']}"
            f" lanes, host reads {t.get('read', 0)}, uploads {t.get('upload', 0)}"
        )
    lines.append(f"\nnot carried over from the JAX report: {', '.join(NOT_CARRIED_OVER)}")
    lines.append(f"\nok={report['ok']} violations=" + json.dumps(
        {k: len(v) for k, v in report["violations"].items()}))
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=10240)
    parser.add_argument("--devices", type=int, default=8,
                        help="ranks of the group (cards with --device cuda)")
    parser.add_argument("--cohorts", type=int, default=64)
    parser.add_argument(
        "--cohort-devices", type=int, default=0, metavar="D",
        help="audit the 2-D ('cohort','nodes') mesh with D cohort rows "
             "(must divide --devices and --cohorts); 0 = the 1-D mesh",
    )
    parser.add_argument("--seed", type=int, default=0,
                        help="the churn's seed (its victims and detector stagger)")
    parser.add_argument("--out", default=None,
                        help="the JSON report (default collective_audit.json)")
    _cli.add_device_argument(parser)
    args = parser.parse_args(argv)
    if args.cohort_devices and (
        args.devices % args.cohort_devices or args.cohorts % args.cohort_devices
    ):
        parser.error("--cohort-devices must divide --devices and --cohorts")
    device = _cli.device_of(args)
    if device.type == "cuda":
        import torch

        if args.devices > torch.cuda.device_count():
            parser.error(f"--devices {args.devices} needs that many cards, "
                         f"{torch.cuda.device_count()} present")
    report = run_ranks(args, device.type)
    print("\n".join(markdown(report)))
    out = args.out or "collective_audit.json"
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(_cli.run_main(main))
