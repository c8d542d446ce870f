"""Merge per-node flight recordings into one causally-ordered timeline.

The port's counterpart of the JAX package's ``tools/traceview.py``: the same
arguments, the same merge order, text and Chrome trace, byte for byte, over
the ``EventName`` vocabulary of ``rapid_tpu_torch/utils/flight_recorder.py``
and the engine lane of ``rapid_tpu_torch/utils/engine_telemetry.py``. It
touches no tensor, so it takes no ``--device``.

Each node's flight recorder (rapid_tpu/utils/flight_recorder.py) holds that
node's view of a membership change; the cluster-wide story only exists once
the recordings are merged. This tool takes one telemetry-snapshot JSON per
node (what ``MembershipService.telemetry_snapshot`` returns and the
standalone agent's ``--metrics-dump`` writes — a bare
``FlightRecorder.snapshot()`` dict works too) and merges them into a single
timeline ordered by (timestamp, causal phase rank, node, per-node sequence).
The phase rank breaks timestamp ties the way the protocol actually flows —
alert before proposal before decision before delivery — which matters under
simulated clocks that tick coarsely, and under real clocks when one batch of
events lands within scheduler jitter.

Events that share a ``trace_id`` are one membership change seen from every
node: ``--trace`` filters to a single change, and the Chrome trace output
(``--chrome out.json``, the trace-event format Perfetto and chrome://tracing
read) lanes events by node so the cross-node cascade is visible at a glance.

A chaos-scenario artifact directory (what ``chaosrun`` and
``RunResult.write_repro`` emit: ``nodes/*.json`` snapshots plus a
``faultlog.json``) can be passed directly: the per-node recordings are
merged as usual and the fault-injection events (partition start/heal,
crash, restart, clock faults) are woven into the timeline as a synthetic
``(chaos)`` lane, so a repro reads end-to-end — injection, detection,
agreement, delivery. A directory carrying a ``trace.json`` (the decoded
device round-trace ring that ``tenancy/chaos.write_fleet_repro`` freezes)
additionally gets a synthetic ``(engine)`` lane: every recorded engine
round, its conflicts and its decisions, merged into the same timeline —
the compiled engine's own flight recording next to the host's.

Usage:

    python -m rapid_tpu_torch.tools.traceview node1.json node2.json node3.json
    python -m rapid_tpu_torch.tools.traceview dumps/*.json --trace 0x1b3 --chrome view.json
    python -m rapid_tpu_torch.tools.traceview repro-dir/ --chrome view.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

from rapid_tpu_torch.utils.flight_recorder import EventName

#: Rank for event names outside the registered vocabulary (a newer recording
#: read by an older traceview): sorts after every known phase at the same
#: timestamp instead of crashing the merge.
_UNKNOWN_RANK = max(n.phase_rank for n in EventName) + 1


def _phase_rank(name: str) -> int:
    try:
        return EventName(name).phase_rank
    except ValueError:
        return _UNKNOWN_RANK


class SnapshotLoadError(RuntimeError):
    """A snapshot file could not be read or is not telemetry-snapshot JSON.
    Carries the offending path in its message; the CLI turns it into a clean
    nonzero exit instead of a traceback."""


def load_snapshots(paths: Iterable[str]) -> List[Dict[str, Any]]:
    """Read telemetry-snapshot (or bare recorder-snapshot) JSON files. A file
    holding a list is a convenience for single-file dumps of many nodes.
    Raises :class:`SnapshotLoadError` on unreadable files, invalid JSON, or
    JSON that is not a snapshot object."""
    snapshots: List[Dict[str, Any]] = []
    for path in paths:
        try:
            with open(path) as f:
                data = json.load(f)
        except OSError as exc:
            raise SnapshotLoadError(f"{path}: cannot read snapshot: {exc}") from exc
        except json.JSONDecodeError as exc:
            raise SnapshotLoadError(f"{path}: invalid JSON: {exc}") from exc
        entries = data if isinstance(data, list) else [data]
        for entry in entries:
            if not isinstance(entry, dict):
                raise SnapshotLoadError(
                    f"{path}: not a telemetry snapshot (expected a JSON "
                    f"object, got {type(entry).__name__})"
                )
        snapshots.extend(entries)
    return snapshots


def _recorder_of(snapshot: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if "events" in snapshot:  # bare FlightRecorder.snapshot()
        return snapshot
    return snapshot.get("recorder")


#: Synthetic node name for fault-injection annotations: sorts apart from
#: real endpoints and renders as its own lane in the Chrome trace.
FAULT_LANE = "(chaos)"


def fault_snapshot(faultlog_path) -> Optional[Dict[str, Any]]:
    """The fault-injection events of a scenario ``faultlog.json`` (the
    ``ScenarioRunner`` capture: one ``{t_ms, kind, slots, args...}`` entry
    per applied schedule event) as a bare recorder-style snapshot for the
    synthetic :data:`FAULT_LANE` node, so :func:`merge_events` weaves the
    injections into the cluster timeline like any other recording. A
    missing file returns None — plain telemetry dumps have no fault log."""
    path = Path(faultlog_path)
    if not path.exists():
        return None
    try:
        entries = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        raise SnapshotLoadError(f"{path}: cannot read fault log: {exc}") from exc
    if not isinstance(entries, list):
        raise SnapshotLoadError(f"{path}: fault log is not a JSON list")
    events = []
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict):
            raise SnapshotLoadError(
                f"{path}: fault-log entry {i} is not a JSON object "
                f"(got {type(entry).__name__})"
            )
        fields: Dict[str, Any] = {}
        if entry.get("slots"):
            fields["slots"] = entry["slots"]
        fields.update(entry.get("args") or {})
        events.append({
            "seq": i,
            "t_ms": entry.get("t_ms", 0.0),
            "node": FAULT_LANE,
            "name": f"fault:{entry.get('kind', '?')}",
            "config_id": None,
            "trace_id": None,
            "fields": fields,
        })
    return {"node": FAULT_LANE, "events": events}


#: Synthetic node name for the device round-trace ring: the compiled
#: engine's lane in the merged timeline, next to hosts and ``(chaos)``.
ENGINE_LANE = "(engine)"


def engine_trace_snapshot(trace_path) -> Optional[Dict[str, Any]]:
    """The decoded device round-trace ring of a repro directory
    (``trace.json``, frozen by ``tenancy/chaos.write_fleet_repro``) as a
    recorder-style snapshot for the synthetic :data:`ENGINE_LANE` node —
    ``engine_telemetry.trace_recorder_snapshot`` turns each held round into
    registered ``engine_round`` / ``engine_conflict`` / ``engine_decision``
    events, so :func:`merge_events` weaves device rounds into the timeline
    like any other recording. A missing file returns None — pre-trace
    repro directories merge exactly as before."""
    path = Path(trace_path)
    if not path.exists():
        return None
    try:
        summary = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        raise SnapshotLoadError(
            f"{path}: cannot read trace ring: {exc}"
        ) from exc
    if not isinstance(summary, dict) or "records" not in summary:
        raise SnapshotLoadError(
            f"{path}: not a decoded trace ring (no records section)"
        )
    from rapid_tpu_torch.utils.engine_telemetry import trace_recorder_snapshot

    return trace_recorder_snapshot(summary, node=ENGINE_LANE)


def expand_scenario_dir(path: str) -> Tuple[List[str], Optional[Path]]:
    """A scenario artifact directory expands to its per-node snapshots plus
    its fault log: ``nodes/*.json`` when the ``write_repro`` layout is
    present, else any ``*.json`` directly inside (minus the scenario
    metadata files, which are not snapshots)."""
    root = Path(path)
    nodes_dir = root / "nodes"
    if nodes_dir.is_dir():
        snapshots = sorted(str(p) for p in nodes_dir.glob("*.json"))
    else:
        skip = {"schedule.json", "result.json", "faultlog.json",
                "fleet.json", "trace.json"}
        snapshots = sorted(
            str(p) for p in root.glob("*.json") if p.name not in skip
        )
    faultlog = root / "faultlog.json"
    return snapshots, faultlog if faultlog.exists() else None


def scenario_snapshots(path) -> List[Dict[str, Any]]:
    """Everything mergeable inside one scenario artifact directory: the
    per-node snapshots plus the fault-injection lane. THE loader for repro
    directories — traceview's own CLI and chaosrun both go through
    it, so the two can never render the same repro differently."""
    paths, faultlog = expand_scenario_dir(str(path))
    snapshots = load_snapshots(paths)
    if faultlog is not None:
        lane = fault_snapshot(faultlog)
        if lane is not None:
            snapshots.append(lane)
    engine_lane = engine_trace_snapshot(Path(path) / "trace.json")
    if engine_lane is not None:
        snapshots.append(engine_lane)
    return snapshots


def write_chrome(events: List[Dict[str, Any]], out: str) -> None:
    """Dump a merged timeline as Chrome trace-event JSON (shared by the two
    CLIs for the same never-diverge reason as :func:`scenario_snapshots`)."""
    with open(out, "w") as f:
        json.dump(chrome_trace(events), f, indent=1)
        f.write("\n")


def merge_events(
    snapshots: Iterable[Dict[str, Any]], trace_id: Optional[int] = None
) -> List[Dict[str, Any]]:
    """One causally-ordered timeline from many per-node recordings.

    Sort key: (t_ms, phase rank, node, per-node seq). Timestamps order
    events whose clocks are comparable (one simulated clock, or one host's
    loop clock); the phase rank arbitrates ties so the merged order reads
    as the protocol executes even when a whole view change lands on one
    simulated-clock tick. ``trace_id`` filters to one membership change.
    """
    merged: List[Dict[str, Any]] = []
    for snapshot in snapshots:
        recorder = _recorder_of(snapshot)
        if not recorder:
            continue
        # Hierarchical-membership snapshots carry the node's cohort index
        # (HierMembershipService.telemetry_snapshot): stamp it onto the
        # events so the rendered timeline lanes by cohort.
        cohort = snapshot.get("cohort")
        for event in recorder.get("events", ()):
            if trace_id is not None and event.get("trace_id") != trace_id:
                continue
            if cohort is not None and "cohort_lane" not in event:
                event = dict(event)
                event["cohort_lane"] = cohort
            merged.append(event)
    merged.sort(
        key=lambda e: (
            e.get("t_ms", 0.0),
            _phase_rank(e.get("name", "")),
            str(e.get("node", "")),
            e.get("seq", 0),
        )
    )
    return merged


def render_text(events: List[Dict[str, Any]]) -> str:
    """The human-facing timeline: one line per event, time-left-aligned to
    the first event so a convergence run reads as elapsed milliseconds."""
    if not events:
        return "(no events)\n"
    t0 = events[0].get("t_ms", 0.0)
    width = max(len(_node_label(e)) for e in events)
    lines = []
    for e in events:
        fields = " ".join(f"{k}={v}" for k, v in (e.get("fields") or {}).items())
        trace = e.get("trace_id")
        lines.append(
            f"{e.get('t_ms', 0.0) - t0:>10.3f}ms  {_node_label(e):<{width}}  "
            f"{e.get('name', '?'):<22}"
            f" cfg={e.get('config_id')}"
            + (f" trace={trace:#x}" if trace is not None else "")
            + (f"  {fields}" if fields else "")
        )
    return "\n".join(lines) + "\n"


def _node_label(event: Dict[str, Any]) -> str:
    """The lane label for one event: ``c<cohort>:<node>`` for hierarchical
    recordings (so a merged timeline reads cohort-by-cohort), the bare node
    otherwise."""
    node = str(event.get("node", ""))
    cohort = event.get("cohort_lane")
    return node if cohort is None else f"c{cohort}:{node}"


def chrome_trace(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace-event JSON (the format chrome://tracing and Perfetto
    load): every flight event becomes a thread-scoped instant event, laned
    by node (pid) with the trace id as the thread so concurrent membership
    changes render as separate rows under each node."""
    pids: Dict[str, int] = {}
    tids: Dict[Any, int] = {}
    named_lanes: set = set()  # (pid, tid) pairs with thread_name emitted
    trace_events: List[Dict[str, Any]] = []
    for e in events:
        node = _node_label(e) or "?"
        if node not in pids:
            pids[node] = len(pids) + 1
            trace_events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pids[node],
                    "tid": 0,
                    "args": {"name": node},
                }
            )
        lane = e.get("trace_id")
        if lane not in tids:
            tids[lane] = len(tids) + 1
        if (pids[node], tids[lane]) not in named_lanes:
            # thread_name metadata is scoped per (pid, tid): a trace shared
            # across nodes needs its lane named under EVERY node's pid.
            named_lanes.add((pids[node], tids[lane]))
            trace_events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pids[node],
                    "tid": tids[lane],
                    "args": {
                        "name": "untraced" if lane is None else f"trace {lane:#x}"
                    },
                }
            )
        args = dict(e.get("fields") or {})
        args["config_id"] = e.get("config_id")
        if lane is not None:
            args["trace_id"] = f"{lane:#x}"
        trace_events.append(
            {
                "name": e.get("name", "?"),
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "ts": e.get("t_ms", 0.0) * 1000.0,  # trace-event ts is µs
                "pid": pids[node],
                "tid": tids[lane],
                "args": args,
            }
        )
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def _parse_trace_id(value: str) -> int:
    return int(value, 0)  # accepts decimal and the 0x-prefixed form we print


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="merge per-node flight recordings into one timeline"
    )
    parser.add_argument(
        "snapshots", nargs="+",
        help="telemetry-snapshot JSON files, one per node (--metrics-dump "
             "output), and/or chaos-scenario artifact directories "
             "(chaosrun output: nodes/*.json + faultlog.json)",
    )
    parser.add_argument(
        "--trace", type=_parse_trace_id, default=None, metavar="ID",
        help="only events of this trace id (one membership change)",
    )
    parser.add_argument(
        "--chrome", metavar="OUT.json", default=None,
        help="also write Chrome trace-event JSON (open in Perfetto)",
    )
    args = parser.parse_args(argv)

    try:
        snapshots: List[Dict[str, Any]] = []
        for arg in args.snapshots:
            if Path(arg).is_dir():
                snapshots.extend(scenario_snapshots(arg))
            else:
                snapshots.extend(load_snapshots([arg]))
    except SnapshotLoadError as exc:
        print(f"traceview: {exc}", file=sys.stderr)
        return 2
    recorded = sum(
        len((_recorder_of(s) or {}).get("events", ())) for s in snapshots
    )
    if recorded == 0:
        # Distinct from an empty --trace filter result: the inputs carry no
        # recording at all (e.g. dumps taken with recorder_tail=0), so there
        # is no timeline to merge — say so, nonzero.
        print(
            f"traceview: no recorder events in {len(args.snapshots)} "
            "snapshot file(s) — dump with the full recorder tail "
            "(--metrics-dump writes it by default)",
            file=sys.stderr,
        )
        return 2
    events = merge_events(snapshots, trace_id=args.trace)
    sys.stdout.write(render_text(events))
    if args.chrome:
        write_chrome(events, args.chrome)
        sys.stdout.write(f"wrote {args.chrome} ({len(events)} events)\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
