"""Run, fuzz, and replay deterministic chaos scenarios (rapid_tpu_torch.sim).

The port's counterpart of the JAX package's ``tools/chaosrun.py``: the same
subcommands, arguments, printed lines, artifact directories and exit codes
(1 when violations are found or a repro diverges, 2 on a ``ScheduleError``,
a missing file or bad JSON). A repro directory written by either package's
command line replays in the other. Where the work runs:

- the host run of a scenario (``run_schedule``) stays on the host, as in
  JAX's;
- the differential oracle's engine replay (``check_all``), the fleet round
  (``fuzz --fleet``) and every fleet or quarantine replay run on
  ``--device`` (CUDA unless another device is named; CUDA without a card
  raises). JAX's script forces its CPU platform instead.

Three subcommands:

``run``     one named scenario family at one seed (or a schedule JSON file),
            through the full oracle battery, writing the repro artifact
            directory (schedule + per-node flight recordings + outcome) and,
            with ``--chrome``, a Chrome trace-event file of the merged
            timeline with fault-injection annotations (via the port's
            ``traceview``).

``fuzz``    N seeded random schedules; every oracle violation is shrunk to a
            minimal repro and written under the output directory. With
            ``--fleet B`` the round instead compiles B mixed scenarios onto
            one batched engine fleet (``rapid_tpu_torch/tenancy/chaos.py``),
            resolves them in wave dispatches plus the stability soak, and
            prints wall clock, scenarios/sec and per-family violation
            tallies; a violating tenant is shrunk and written as a
            single-tenant fleet repro.

``replay``  re-run a written repro directory; exits nonzero iff the recorded
            violations reproduce. Fleet repros (``fleet.json``) replay
            through the engine fleet path with the recorded knobs, and with
            a ``trace.json`` get the round-granular trace diff; quarantine
            exports reload the captured state slice and re-run the health
            scan; sim repros replay through the host runner.

Usage:

    python -m rapid_tpu_torch.tools.chaosrun run partition_heal --seed 3 --artifacts /tmp/r
    python -m rapid_tpu_torch.tools.chaosrun run --schedule repro/schedule.json
    python -m rapid_tpu_torch.tools.chaosrun fuzz --seeds 20 --out /tmp/fuzz
    python -m rapid_tpu_torch.tools.chaosrun fuzz --fleet 256 --out /tmp/fleet
    python -m rapid_tpu_torch.tools.chaosrun replay /tmp/fuzz/seed7 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path
from typing import List, Optional

from rapid_tpu_torch import _cli
from rapid_tpu_torch.sim import fuzz as simfuzz
from rapid_tpu_torch.sim.faults import FaultSchedule, ScheduleError
from rapid_tpu_torch.sim.oracles import check_all


def _write_chrome(artifacts: Path, out: str) -> None:
    from rapid_tpu_torch.tools import traceview

    events = traceview.merge_events(traceview.scenario_snapshots(artifacts))
    traceview.write_chrome(events, out)
    print(f"wrote {out} ({len(events)} events)")


def _recorded_violations(repro: str) -> List[str]:
    path = Path(repro) / "violations.txt"
    if not path.exists():
        return []
    return [line for line in path.read_text().splitlines() if line and line != "(none)"]


def cmd_run(args: argparse.Namespace) -> int:
    if args.schedule:
        schedule = FaultSchedule.from_json(Path(args.schedule).read_text())
    else:
        if not args.family:
            print("chaosrun run: need a family name or --schedule", file=sys.stderr)
            return 2
        schedule = simfuzz.scenario_family(args.family, args.seed)
    result = simfuzz.run_schedule(schedule)
    violations = check_all(result, device=args.dev)
    artifacts = Path(
        args.artifacts
        or tempfile.mkdtemp(prefix=f"chaosrun-{schedule.name.replace('/', '-')}-")
    )
    simfuzz.write_repro(result, violations, artifacts)
    print(f"scenario {schedule.name or '(file)'}: {len(result.cuts)} cut(s), "
          f"converged={result.final_converged}, artifacts in {artifacts}")
    if args.chrome:
        _write_chrome(artifacts, args.chrome)
    for v in violations:
        print(f"VIOLATION {v}")
    return 1 if violations else 0


def cmd_fuzz(args: argparse.Namespace) -> int:
    out = Path(args.out) if args.out else Path(tempfile.mkdtemp(prefix="chaosfuzz-"))
    if args.fleet:
        return _fuzz_fleet(args, out)
    seeds = range(args.base_seed, args.base_seed + args.seeds)
    summaries = simfuzz.fuzz(seeds, out_dir=out, device=args.dev)
    failing = [s for s in summaries if s["violations"]]
    for s in summaries:
        status = "FAIL" if s["violations"] else "ok"
        extra = (
            f" -> shrunk {s['events']}->{s['shrunk_events']} events, "
            f"repro {s.get('repro', '(not written)')}"
            if s["violations"]
            else ""
        )
        print(f"seed {s['seed']}: {status}{extra}")
        for v in s["violations"]:
            print(f"  {v}")
    print(f"{len(summaries) - len(failing)}/{len(summaries)} seeds clean; "
          f"repros under {out}" if failing else
          f"{len(summaries)}/{len(summaries)} seeds clean")
    return 1 if failing else 0


def _fuzz_fleet(args: argparse.Namespace, out: Path) -> int:
    """The batched adversarial round: B scenarios per dispatch through the
    tenancy fleet on ``--device``, scenarios/sec as the headline,
    per-family tallies."""
    from rapid_tpu_torch.tenancy import chaos as tchaos

    summary = tchaos.fuzz_fleet(args.fleet, base_seed=args.base_seed, out_dir=out,
                                device=args.dev)
    for family in sorted(summary["families"]):
        total = summary["families"][family]
        bad = summary["family_violations"].get(family, 0)
        print(f"family {family}: {total - bad}/{total} clean"
              + (f" ({bad} violating)" if bad else ""))
    for v in summary["violations"]:
        print(f"VIOLATION {v}")
    if "shrunk_tenant" in summary:
        print(f"shrunk tenant {summary['shrunk_tenant']} to "
              f"{summary['shrunk_events']} event(s) in "
              f"{summary['shrink_runs']} probe run(s); repro "
              f"{summary.get('repro', '(not written)')}")
    print(f"{summary['tenants']} scenarios in {summary['dispatches']} "
          f"dispatch(es), {summary['total_cuts']} view changes, "
          f"{summary['wall_ms']:.0f} ms wall — "
          f"{summary['scenarios_per_sec']:.1f} scenarios/sec")
    return 1 if summary["violations"] else 0


def cmd_replay(args: argparse.Namespace) -> int:
    if (Path(args.repro) / "fleet.json").exists():
        return _replay_fleet(args)
    recorded = _recorded_violations(args.repro)
    result, violations = simfuzz.replay(args.repro, device=args.dev)
    for v in violations:
        print(f"VIOLATION {v}")
    if recorded and sorted(map(str, violations)) != sorted(recorded):
        print("chaosrun replay: violations DIVERGED from the recorded repro:",
              file=sys.stderr)
        for line in recorded:
            print(f"  recorded: {line}", file=sys.stderr)
        return 1
    if args.chrome:
        with tempfile.TemporaryDirectory() as fresh:
            simfuzz.write_repro(result, violations, fresh)
            _write_chrome(Path(fresh), args.chrome)
    return 1 if violations else 0


def _replay_fleet(args: argparse.Namespace) -> int:
    """Replay a single-tenant FLEET repro through the engine fleet path on
    ``--device``: shrinker artifacts re-run the recorded schedule with the
    recorded knobs; quarantine exports reload the captured poisoned state
    slice and re-run the deterministic health scan."""
    from rapid_tpu_torch.tenancy import chaos as tchaos

    recorded = _recorded_violations(args.repro)
    recipe = json.loads((Path(args.repro) / "fleet.json").read_text())
    if recipe.get("kind") == "quarantine":
        from rapid_tpu_torch.serving import recovery

        violations = recovery.replay_quarantine_repro(args.repro, device=args.dev)
    else:
        _result, violations = tchaos.replay_fleet_repro(args.repro, device=args.dev)
    for v in violations:
        print(f"VIOLATION {v}")
    diverged = recorded and sorted(map(str, violations)) != sorted(recorded)
    if recipe.get("kind") != "quarantine":
        # Round-granular divergence instrument: diff the replayed engine's
        # decoded trace ring against the write-time trace.json (pre-trace
        # repro dirs skip it).
        trace_diff = tchaos.replay_trace_divergence(args.repro, device=args.dev)
        if trace_diff is not None:
            fork = trace_diff["first_divergent_round"]
            if fork is None:
                print(
                    f"trace: rings agree record-for-record "
                    f"({trace_diff['replayed_rounds']} round(s) recorded)"
                )
            else:
                print(
                    f"trace: round histories FORK at round {fork} "
                    f"(written {trace_diff['written_rounds']} round(s), "
                    f"replayed {trace_diff['replayed_rounds']})",
                    file=sys.stderr,
                )
                diverged = True
    if diverged:
        print("chaosrun replay: violations DIVERGED from the recorded repro:",
              file=sys.stderr)
        for line in recorded:
            print(f"  recorded: {line}", file=sys.stderr)
        return 1
    return 1 if violations else 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="chaosrun",
        description="deterministic chaos scenarios: run, fuzz, replay",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    run_p = sub.add_parser("run", help="run one named scenario or schedule file")
    run_p.add_argument("family", nargs="?", default=None,
                       choices=sorted(simfuzz.FAMILIES),
                       help="scenario family (hier-profile families boot the "
                            "two-level hierarchical protocol, rapid_tpu_torch/hier)")
    run_p.add_argument("--seed", type=int, default=0)
    run_p.add_argument("--schedule", default=None, metavar="JSON",
                       help="run this schedule file instead of a named family")
    run_p.add_argument("--artifacts", default=None, metavar="DIR",
                       help="repro artifact directory (default: a fresh tmpdir)")
    run_p.add_argument("--chrome", default=None, metavar="OUT.json",
                       help="also write a Chrome trace of the merged timeline")
    run_p.set_defaults(fn=cmd_run)

    fuzz_p = sub.add_parser("fuzz", help="fuzz N random schedules, shrink failures")
    fuzz_p.add_argument("--seeds", type=int, default=10)
    fuzz_p.add_argument("--base-seed", type=int, default=0)
    fuzz_p.add_argument("--out", default=None, metavar="DIR")
    fuzz_p.add_argument("--fleet", type=int, default=0, metavar="B",
                        help="instead of host-runner seeds, compile B mixed "
                             "scenarios onto one batched engine fleet and "
                             "report scenarios/sec + per-family violation "
                             "tallies; violating tenants shrink to "
                             "single-tenant fleet repros")
    fuzz_p.set_defaults(fn=cmd_fuzz)

    replay_p = sub.add_parser("replay", help="re-run a written repro directory")
    replay_p.add_argument("repro")
    replay_p.add_argument("--chrome", default=None, metavar="OUT.json")
    replay_p.set_defaults(fn=cmd_replay)

    for p in (run_p, fuzz_p, replay_p):
        _cli.add_device_argument(p)
    args = parser.parse_args(argv)
    args.dev = _cli.device_of(args)
    try:
        return args.fn(args)
    except (ScheduleError, FileNotFoundError, json.JSONDecodeError) as exc:
        print(f"chaosrun: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(_cli.run_main(main))
