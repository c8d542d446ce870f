"""Live top-like terminal dashboard over per-node telemetry snapshots.

The port's counterpart of the JAX package's ``tools/clustertop.py``: the same
arguments and frames, byte for byte, over the port's ``utils/health.py``,
``utils/histogram.py`` and ``utils/engine_telemetry.py``. It touches no
tensor, so it takes no ``--device``.

``traceview`` answers "show me this one view change, end to end";
this tool answers the operator's other question — "how is the cluster doing
RIGHT NOW". It reads the same inputs (one telemetry-snapshot JSON per node,
what ``--metrics-dump`` writes continuously) and renders a refreshing
cluster view: per-node health states (utils/health.py), configuration
agreement, message rates, and the phase-decomposed convergence quantiles
(detection / agreement / delivery, utils/histogram.py) — both per node and
merged cluster-wide, which is exactly what the histogram's associative
``merge()`` exists for.

Usage:

    python -m rapid_tpu_torch.tools.clustertop dumps/*.json              # refresh every 2 s
    python -m rapid_tpu_torch.tools.clustertop dumps/*.json --interval 1
    python -m rapid_tpu_torch.tools.clustertop dumps/*.json --once       # one frame, exit

Unreadable or torn files (a node mid-rewrite, a crashed agent) degrade to a
footnote, never a crash: a live dashboard that dies on one bad file is
useless during the incident it exists for.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from rapid_tpu_torch.utils.health import aggregate_health, parse_health
from rapid_tpu_torch.utils.histogram import LogHistogram

#: Display order of the convergence phases (the protocol's causal order).
PHASE_ORDER = ("detection", "agreement", "delivery")

_CLEAR = "\x1b[2J\x1b[H"  # ANSI: clear screen + home cursor


def load_snapshots_tolerant(
    paths: List[str],
) -> Tuple[List[Dict[str, Any]], List[str]]:
    """(snapshots, error strings). A file holding a list contributes every
    entry (single-file dumps of many nodes); malformed files become error
    lines instead of exceptions."""
    snapshots: List[Dict[str, Any]] = []
    errors: List[str] = []
    for path in paths:
        try:
            with open(path) as f:
                data = json.load(f)
        except OSError as exc:
            errors.append(f"{path}: unreadable ({exc})")
            continue
        except json.JSONDecodeError as exc:
            errors.append(f"{path}: invalid JSON ({exc})")
            continue
        entries = data if isinstance(data, list) else [data]
        for entry in entries:
            if isinstance(entry, dict) and "node" in entry:
                snapshots.append(entry)
            else:
                errors.append(f"{path}: not a telemetry snapshot entry")
    return snapshots, errors


def _phase_histograms(snapshot: Dict[str, Any]) -> Dict[str, LogHistogram]:
    """Per-phase histograms of one node, agreement paths folded into their
    phase (``agreement/fast`` + ``agreement/classic`` -> ``agreement``) —
    merge is associative, so folding here and folding across nodes commute."""
    family = (snapshot.get("metrics") or {}).get("view_change_phase_ms") or {}
    out: Dict[str, LogHistogram] = {}
    for key, summary in family.items():
        if not isinstance(summary, dict) or "count" not in summary:
            continue
        phase = key.split("/", 1)[0]
        hist = out.setdefault(phase, LogHistogram())
        hist.merge(LogHistogram.from_summary(summary))
    return out


def _convergence_histogram(snapshot: Dict[str, Any]) -> Optional[LogHistogram]:
    summary = (snapshot.get("metrics") or {}).get("view_change_convergence_ms")
    if isinstance(summary, dict) and summary.get("count"):
        return LogHistogram.from_summary(summary)
    return None


def _fmt_ms(value: Optional[float]) -> str:
    if value is None:
        return "-"
    if value >= 1000.0:
        return f"{value / 1000.0:.2f}s"
    return f"{value:.1f}"


def _fmt_rate(stats: Optional[Dict[str, Any]], key: str) -> str:
    if not stats or key not in stats:
        return "-"
    return f"{float(stats[key]):.1f}"


def _quantile_cell(hist: Optional[LogHistogram], q: float) -> str:
    if hist is None or hist.count == 0:
        return "-"
    return _fmt_ms(hist.quantile(q))


def _render_table(header: Tuple[str, ...],
                  rows: List[Tuple[str, ...]]) -> List[str]:
    """Fixed-width text table — shared by the node table and engine pane."""
    widths = [
        max(len(header[i]), *(len(r[i]) for r in rows)) if rows else len(header[i])
        for i in range(len(header))
    ]
    return [
        "  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row))
        for row in (header, *rows)
    ]


def _fmt_bytes(value: Any) -> str:
    if not isinstance(value, (int, float)):
        return "-"
    if value >= 1 << 30:
        return f"{value / (1 << 30):.2f}G"
    if value >= 1 << 20:
        return f"{value / (1 << 20):.1f}M"
    if value >= 1 << 10:
        return f"{value / (1 << 10):.1f}K"
    return str(int(value))


def _dispatch_histogram(snapshot: Dict[str, Any]) -> Optional[LogHistogram]:
    """All engine dispatch latencies of one snapshot, entrypoint phases
    merged (merge is associative — same folding rule as the phase SLOs)."""
    family = (snapshot.get("metrics") or {}).get("engine_dispatch_ms") or {}
    merged = LogHistogram()
    for summary in family.values():
        if isinstance(summary, dict) and "count" in summary:
            merged.merge(LogHistogram.from_summary(summary))
    return merged if merged.count else None


def render_engine_pane(snapshots: List[Dict[str, Any]]) -> List[str]:
    """The device-engine rows: one line per snapshot carrying an ``engine``
    section (VirtualCluster scrapes) — compile count, persistent-cache hit
    rate, dispatch p99, transfer bytes, device memory, and the device
    telemetry plane's activity columns (active-subject fraction, mean
    winning tally, fast-path share, conflict rate). Snapshots from
    pre-ledger code (no ``engine`` key, or partial sections) and
    pre-telemetry scrapes (no ``activity`` block, or ``telemetry=0``)
    contribute nothing / dashes, never a crash."""
    engines = [s for s in snapshots if isinstance(s.get("engine"), dict)]
    if not engines:
        return []
    header = (
        "ENGINE", "TENANTS", "COMPILES", "CACHEHIT", "DISP99", "DISPATCHES",
        "H2D", "D2H", "LIVEBUF", "DEVMEM",
        "ACTIVE", "TALLY", "FAST%", "CONFLICT",
    )
    rows: List[Tuple[str, ...]] = []
    for snapshot in sorted(engines, key=lambda s: str(s.get("node", ""))):
        engine = snapshot["engine"]
        compile_stats = engine.get("compile") or {}
        memory = engine.get("memory") or {}
        metrics = snapshot.get("metrics") or {}
        tenancy = engine.get("tenancy")
        activity = engine.get("activity")
        activity = activity if isinstance(activity, dict) else {}
        hits = compile_stats.get("persistent_cache_hits")
        misses = compile_stats.get("persistent_cache_misses")
        if isinstance(hits, int) and isinstance(misses, int) and hits + misses:
            cache = f"{100.0 * hits / (hits + misses):.0f}%"
        else:
            cache = "-"
        rows.append((
            str(snapshot.get("node", "?")),
            # Tenant-fleet snapshots carry their batch width; single-cluster
            # (and pre-fleet) snapshots dash.
            str(tenancy.get("tenants", "-")) if isinstance(tenancy, dict)
            else "-",
            str(compile_stats.get("compiles", "-")),
            cache,
            _quantile_cell(_dispatch_histogram(snapshot), 0.99),
            str(metrics.get("engine_dispatches", "-")),
            _fmt_bytes(metrics.get("engine_h2d_bytes")),
            _fmt_bytes(metrics.get("engine_d2h_bytes")),
            _fmt_bytes(memory.get("live_buffer_bytes")),
            _fmt_bytes(memory.get("device_bytes_in_use")),
            _fmt_ratio(activity.get("active_fraction")),
            _fmt_opt(activity.get("winning_tally_mean"), ".1f"),
            _fmt_ratio(activity.get("fast_path_share")),
            _fmt_ratio(activity.get("conflict_rate")),
        ))
    return ["", *_render_table(header, rows)]


def _fmt_ratio(value: Any) -> str:
    if not isinstance(value, (int, float)):
        return "-"
    return f"{100.0 * float(value):.1f}%"


def _fmt_opt(value: Any, spec: str = ".2f") -> str:
    if not isinstance(value, (int, float)):
        return "-"
    return format(float(value), spec)


def render_stream_pane(snapshots: List[Dict[str, Any]]) -> List[str]:
    """The streaming-serving rows: one line per snapshot whose ``engine``
    section carries a ``stream`` block (a rapid_tpu.serving.StreamDriver is
    attached) — waves in flight, pipeline progress, sustained rate, overlap
    efficiency, p99 alert->commit. Pre-stream snapshots (no ``stream`` key,
    or pre-drain None rates) contribute nothing / dashes, never a crash."""
    streams = [
        s for s in snapshots
        if isinstance(s.get("engine"), dict)
        and isinstance(s["engine"].get("stream"), dict)
    ]
    if not streams:
        return []
    header = (
        "STREAM", "INFLIGHT", "SUBMITTED", "COMPLETED", "RATE/S",
        "OVERLAP", "P99MS",
    )
    rows: List[Tuple[str, ...]] = []
    for snapshot in sorted(streams, key=lambda s: str(s.get("node", ""))):
        stream = snapshot["engine"]["stream"]
        rows.append((
            str(snapshot.get("node", "?")),
            _fmt_opt(stream.get("waves_in_flight"), ".0f"),
            _fmt_opt(stream.get("waves_submitted"), ".0f"),
            _fmt_opt(stream.get("waves_completed"), ".0f"),
            _fmt_opt(stream.get("view_changes_per_sec")),
            _fmt_ratio(stream.get("overlap_efficiency")),
            _fmt_opt(stream.get("p99_alert_to_commit_ms"), ".1f"),
        ))
    return ["", *_render_table(header, rows)]


def render_recovery_pane(snapshots: List[Dict[str, Any]]) -> List[str]:
    """The self-healing tier rows: one line per snapshot whose ``engine``
    section carries a ``recovery`` block (a rapid_tpu.serving.supervisor.
    Supervisor is attached) — checkpoint cadence/progress, retry/wedge/
    resume tallies, the quarantine census, and the last resume's MTTR.
    Pre-supervision snapshots (no ``recovery`` key, or None gauges)
    contribute nothing / dashes, never a crash."""
    supervised = [
        s for s in snapshots
        if isinstance(s.get("engine"), dict)
        and isinstance(s["engine"].get("recovery"), dict)
    ]
    if not supervised:
        return []
    header = (
        "RECOVERY", "WAVES", "CKPTS", "LASTCKPT", "RETRIES", "WEDGES",
        "RESUMES", "QUARANTINED", "MTTRMS",
    )
    rows: List[Tuple[str, ...]] = []
    for snapshot in sorted(supervised, key=lambda s: str(s.get("node", ""))):
        recovery = snapshot["engine"]["recovery"]
        rows.append((
            str(snapshot.get("node", "?")),
            _fmt_opt(recovery.get("waves_submitted"), ".0f"),
            _fmt_opt(recovery.get("checkpoints_written"), ".0f"),
            _fmt_opt(recovery.get("last_checkpoint_wave"), ".0f"),
            _fmt_opt(recovery.get("retries"), ".0f"),
            _fmt_opt(recovery.get("wedges"), ".0f"),
            _fmt_opt(recovery.get("resumes"), ".0f"),
            _fmt_opt(recovery.get("quarantined"), ".0f"),
            _fmt_opt(recovery.get("mttr_ms"), ".1f"),
        ))
    return ["", *_render_table(header, rows)]


#: Height-coded glyphs for the ROUNDS sparkline, lowest to highest.
_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def _sparkline(values: List[Any], width: int = 16) -> str:
    """The last ``width`` numeric values as a unicode sparkline, scaled to
    the window's max (floor 1 so an all-zero window renders flat, not
    blank). Non-numeric entries (torn snapshots) are dropped; an empty
    window dashes."""
    vals = [float(v) for v in values if isinstance(v, (int, float))]
    if not vals:
        return "-"
    vals = vals[-width:]
    top = max(max(vals), 1.0)
    hi = len(_SPARK_CHARS) - 1
    return "".join(
        _SPARK_CHARS[min(int(v * hi / top + 0.5), hi)] for v in vals
    )


def _trace_rows(snapshot: Dict[str, Any]) -> List[Tuple[str, Dict[str, Any]]]:
    """(row label, decoded trace summary) pairs of one snapshot: the
    single-cluster ``engine.trace`` section under the node's own label,
    fleet ``engine.tenant_trace`` entries as ``node/t<i>`` lanes. Sections
    of the wrong shape (torn mid-rewrite) contribute nothing."""
    engine = snapshot.get("engine")
    if not isinstance(engine, dict):
        return []
    node = str(snapshot.get("node", "?"))
    out: List[Tuple[str, Dict[str, Any]]] = []
    trace = engine.get("trace")
    if isinstance(trace, dict):
        out.append((node, trace))
    tenant_trace = engine.get("tenant_trace")
    if isinstance(tenant_trace, list):
        out.extend(
            (f"{node}/t{i}", t)
            for i, t in enumerate(tenant_trace)
            if isinstance(t, dict)
        )
    return out


def render_rounds_pane(snapshots: List[Dict[str, Any]]) -> List[str]:
    """The device round-trace rows: one line per decoded ring (a
    ``VirtualCluster`` with ``trace=R``, or one per tenant of a traced
    fleet) — recorded/held round counts, wrap and decision tallies, the
    last recorded round's stamp and decision path, and a sparkline of the
    ``rounds_undecided`` trajectory across the held window (the climb to
    each decision, as the compiled engine recorded it). Pre-trace
    snapshots (no ``trace`` / ``tenant_trace`` section) and torn records
    contribute nothing / dashes, never a crash."""
    from rapid_tpu_torch.utils.engine_telemetry import TRACE_PATH_NAMES

    pairs = [pair for s in snapshots for pair in _trace_rows(s)]
    if not pairs:
        return []
    header = (
        "ROUNDS", "RECORDED", "HELD", "WRAPS", "DECIDED", "CONFLICT",
        "LASTROUND", "LASTPATH", "UNDECIDED",
    )
    rows: List[Tuple[str, ...]] = []
    for label, trace in sorted(pairs, key=lambda p: p[0]):
        records = trace.get("records")
        records = records if isinstance(records, list) else []
        undecided = [
            r.get("undecided") for r in records if isinstance(r, dict)
        ]
        path = trace.get("last_path")
        rows.append((
            label,
            _fmt_opt(trace.get("rounds_recorded"), ".0f"),
            _fmt_opt(trace.get("rounds_held"), ".0f"),
            _fmt_opt(trace.get("wraps"), ".0f"),
            _fmt_opt(trace.get("decisions_held"), ".0f"),
            _fmt_opt(trace.get("conflicts_held"), ".0f"),
            _fmt_opt(trace.get("last_round"), ".0f"),
            TRACE_PATH_NAMES.get(path, "-") if isinstance(path, int) else "-",
            _sparkline(undecided),
        ))
    return ["", *_render_table(header, rows)]


def render_frame(
    snapshots: List[Dict[str, Any]], errors: Optional[List[str]] = None
) -> str:
    """One complete dashboard frame as a string (the testable core; the
    refresh loop just clears the screen and prints it)."""
    lines: List[str] = []
    agg = aggregate_health(s.get("health") for s in snapshots)
    configs = {s.get("configuration_id") for s in snapshots}
    counts = ", ".join(f"{n} {state}" for state, n in agg["counts"].items() if n)
    lines.append(
        f"rapid clustertop — {len(snapshots)} node(s)"
        f" | health: {str(agg['overall']).upper()}"
        + (f" ({counts})" if counts else "")
        + f" | configs: {len(configs) if snapshots else 0}"
        + (" (agreement)" if len(configs) == 1 and snapshots else "")
    )

    # Cluster-wide phase SLOs: per-node bounded histograms merge exactly.
    merged: Dict[str, LogHistogram] = {}
    merged_conv = LogHistogram()
    for snapshot in snapshots:
        for phase, hist in _phase_histograms(snapshot).items():
            merged.setdefault(phase, LogHistogram()).merge(hist)
        conv = _convergence_histogram(snapshot)
        if conv is not None:
            merged_conv.merge(conv)
    slo_cells = []
    for phase in PHASE_ORDER:
        hist = merged.get(phase)
        slo_cells.append(
            f"{phase} p50={_quantile_cell(hist, 0.5)} p99={_quantile_cell(hist, 0.99)}"
        )
    slo_cells.append(
        f"convergence p50={_quantile_cell(merged_conv, 0.5)}"
        f" p99={_quantile_cell(merged_conv, 0.99)}"
    )
    lines.append("cluster SLO (ms): " + " | ".join(slo_cells))
    lines.append("")

    header = (
        "NODE", "HEALTH", "CONFIG", "SIZE", "VIEWS",
        "TXKBPS", "RXKBPS", "DET99", "AGR99", "DLV99", "CONV99",
    )
    rows: List[Tuple[str, ...]] = []
    for snapshot in sorted(snapshots, key=lambda s: str(s.get("node", ""))):
        metrics = snapshot.get("metrics") or {}
        phases = _phase_histograms(snapshot)
        transport = snapshot.get("transport") or {}
        client = transport.get("client")
        rows.append((
            str(snapshot.get("node", "?")),
            parse_health(snapshot.get("health")).value,
            str(snapshot.get("configuration_id", "-")),
            str(snapshot.get("membership_size", "-")),
            str(metrics.get("view_changes", 0)),
            _fmt_rate(client, "kbps_tx"),
            _fmt_rate(client, "kbps_rx"),
            _quantile_cell(phases.get("detection"), 0.99),
            _quantile_cell(phases.get("agreement"), 0.99),
            _quantile_cell(phases.get("delivery"), 0.99),
            _quantile_cell(_convergence_histogram(snapshot), 0.99),
        ))
    lines.extend(_render_table(header, rows))
    lines.extend(render_engine_pane(snapshots))
    lines.extend(render_rounds_pane(snapshots))
    lines.extend(render_stream_pane(snapshots))
    lines.extend(render_recovery_pane(snapshots))
    for error in errors or ():
        lines.append(f"! {error}")
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="live cluster health/SLO dashboard over telemetry snapshots"
    )
    parser.add_argument(
        "snapshots", nargs="+",
        help="telemetry-snapshot JSON files, one per node (--metrics-dump output)",
    )
    parser.add_argument(
        "--interval", type=float, default=2.0, metavar="SECONDS",
        help="refresh interval (re-reads the files each frame)",
    )
    parser.add_argument(
        "--once", action="store_true",
        help="render a single frame and exit (scripting/testing)",
    )
    args = parser.parse_args(argv)

    while True:
        snapshots, errors = load_snapshots_tolerant(args.snapshots)
        frame = render_frame(snapshots, errors)
        if args.once:
            sys.stdout.write(frame)
            # Nothing renderable at all is an error exit like traceview's.
            return 0 if snapshots else 2
        sys.stdout.write(_CLEAR + frame)
        sys.stdout.flush()
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
