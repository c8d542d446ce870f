"""Render bench run ledgers and the BENCH_r* perf trajectory.

The port's counterpart of the JAX package's ``tools/perfview.py``: the same
arguments, tables and Chrome trace, byte for byte, over the port's
``utils/ledger.py`` (which reads and writes the JAX package's ledger
lines). It touches no tensor, so it takes no ``--device``.

``traceview`` answers "show me this one view change";
``clustertop`` answers "how is the cluster doing right now"; this
tool answers the third operator question — "what happened to my benchmark
runs, and can I trust the numbers". Two input kinds, freely mixed:

- **Run ledgers** (``*.jsonl``, what ``bench.py --ledger`` appends — see
  rapid_tpu/utils/ledger.py): rendered as a stage timeline — every stage's
  begin/duration/status, compile + device-memory stats, heartbeat gaps,
  watchdog kills, snapshot replays, and the run outcome with the last
  completed stage. A wedged run reads as "died in <stage>", not a mystery.

- **Bench metric JSON** (``*.json``, the one-line artifact each bench round
  emits — BENCH_r01.json ...): rendered as a perf trajectory table, one row
  per round, flagging every point that is NOT a live measurement of the
  code it claims to measure: ``snapshot`` (replayed evidence), ``stale``
  (snapshot measured different code than HEAD), ``wedged`` (live attempt
  died), ``hole`` (explicit accelerator-unavailable marker),
  ``suspect-rate`` (a derived rate outside plausibility bounds — the
  alert_deliveries_per_sec ≈ 5e10 class of bug), ``headline-missing``
  (an audited round that carries neither the ``n1M_crash1pct_ms``
  headline nor its explicit ``n1M_status`` marker — the 1M scale number
  must never be silently absent), ``fleet-missing`` (same discipline
  for the multi-tenant point: an audited round omitting BOTH
  ``tenant_view_changes_per_sec`` and ``tenant_fleet_status``), and
  ``stream-missing`` (same discipline for the streaming-serving point:
  an audited round omitting BOTH ``stream_view_changes_per_sec`` and
  ``stream_status``), ``chaos-missing`` (same discipline for the
  adversarial-chaos point: an audited round omitting BOTH
  ``chaos_scenarios_per_sec`` and ``chaos_status``), ``mem-missing``
  (same discipline for the state-compaction memory point: an audited
  round omitting BOTH ``bytes_per_member`` and ``mem_status``), and
  ``recovery-missing`` (same discipline for the self-healing drill: an
  audited round omitting BOTH ``recovery_mttr_ms`` and
  ``recovery_status``), and ``activity-missing`` (same discipline for the
  device telemetry plane: an audited round omitting BOTH
  ``stream_active_fraction`` and ``activity_status`` — a zero-churn soak
  must publish ``activity=0`` explicitly, never silence), and
  ``cost-missing`` (same discipline for the scaling-law cost model: an
  audited round omitting the ``cost_fit`` table AND its status marker).
  The N1M, FLEET, STREAM, CHAOS, MEM, RECOVERY, ACTIVITY, and COSTFIT
  columns render the headline / fleet / sustained-stream /
  chaos-throughput / bytes-per-member / resume-MTTR / active-fraction /
  worst-fitted-scaling-class values (or their status markers) per round.

``--chrome out.json`` additionally writes Chrome trace-event JSON (the same
envelope traceview emits — Perfetto/chrome://tracing load it):
ledger stages as duration events, point events as instants, one process
lane per ledger.

Usage:

    python -m rapid_tpu_torch.tools.perfview bench_ledger.jsonl
    python -m rapid_tpu_torch.tools.perfview BENCH_r0*.json
    python -m rapid_tpu_torch.tools.perfview bench_ledger.jsonl BENCH_r0*.json --chrome t.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from rapid_tpu_torch.utils.ledger import (
    LedgerEvent,
    last_completed_stage,
    open_stage,
    read_ledger,
)

#: A derived per-second rate above this is treated as implausible for this
#: workload class and flagged ``suspect-rate`` (no network or chip moves
#: 1e9+ distinct alert deliveries a second at these Ns — the historical
#: 4.96e10 figure came from multiplying by all N members instead of the
#: engine's C-cohort delivery grain).
SUSPECT_RATE_PER_SEC = 1e9

_POINT_EVENTS = (
    LedgerEvent.ATTEMPT_BEGIN.value,
    LedgerEvent.ATTEMPT_END.value,
    LedgerEvent.HEARTBEAT_GAP.value,
    LedgerEvent.WATCHDOG_KILL.value,
    LedgerEvent.SNAPSHOT_REPLAY.value,
    LedgerEvent.COMPILE_STATS.value,
    LedgerEvent.DEVICE_MEMORY.value,
    # Self-healing serving runtime: the recovery timeline —
    # retries, wedges, checkpoints (and corrupt-checkpoint fallbacks),
    # resumes, quarantines — renders as point events on the stage line.
    LedgerEvent.RECOVERY_RETRY.value,
    LedgerEvent.RECOVERY_WEDGED.value,
    LedgerEvent.RECOVERY_CHECKPOINT.value,
    LedgerEvent.RECOVERY_CHECKPOINT_CORRUPT.value,
    LedgerEvent.RECOVERY_RESUME.value,
    LedgerEvent.RECOVERY_QUARANTINE.value,
)


class PerfviewError(RuntimeError):
    """An input could not be read/parsed; the CLI exits 2 with the message."""


def split_runs(events: List[Dict[str, Any]]) -> List[Tuple[str, List[Dict[str, Any]]]]:
    """Group a ledger file's events by ``run_id``, in order of first
    appearance — the default bench_ledger.jsonl is append-only across
    invocations, and mixing two runs into one timeline would pin the wrong
    provenance (and the wrong outcome) on both."""
    order: List[str] = []
    groups: Dict[str, List[Dict[str, Any]]] = {}
    for record in events:
        run_id = str(record.get("run_id", "?"))
        if run_id not in groups:
            order.append(run_id)
            groups[run_id] = []
        groups[run_id].append(record)
    return [(run_id, groups[run_id]) for run_id in order]


# ---------------------------------------------------------------------------
# Ledger rendering
# ---------------------------------------------------------------------------


def render_table(header: Tuple[str, ...],
                 rows: List[Tuple[str, ...]]) -> List[str]:
    """Fixed-width text table (header + rows, columns padded to the widest
    cell) — the one table renderer both report kinds share."""
    widths = [
        max(len(header[i]), *(len(r[i]) for r in rows)) if rows else len(header[i])
        for i in range(len(header))
    ]
    return [
        "  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row))
        for row in (header, *rows)
    ]


def stage_rows(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Pair stage begin/end(or fail) events into timeline rows, in begin
    order. An unpaired begin renders as OPEN — exactly what a wedged run
    looks like."""
    rows: List[Dict[str, Any]] = []
    open_rows: List[Dict[str, Any]] = []
    for record in events:
        kind = record.get("event")
        if kind == LedgerEvent.STAGE_BEGIN.value:
            row = {
                "stage": record.get("stage", "?"),
                "n": record.get("n"),
                "begin_s": record.get("t_s", 0.0),
                "pid": record.get("pid"),
                "timeout_s": record.get("timeout_s"),
                "duration_ms": None,
                "status": "OPEN",
                "error": None,
            }
            rows.append(row)
            open_rows.append(row)
        elif kind in (LedgerEvent.STAGE_END.value, LedgerEvent.STAGE_FAIL.value):
            match = next(
                (r for r in reversed(open_rows)
                 if r["stage"] == record.get("stage")
                 and r["pid"] == record.get("pid")),
                None,
            )
            if match is None:
                continue  # end without begin (pre-ledger writer): skip
            open_rows.remove(match)
            match["duration_ms"] = record.get("duration_ms")
            match["status"] = (
                "ok" if kind == LedgerEvent.STAGE_END.value else "FAIL"
            )
            match["error"] = record.get("error")
    return rows


def _fmt_duration(ms: Optional[float]) -> str:
    if ms is None:
        return "-"
    if ms >= 60_000:
        return f"{ms / 60_000.0:.1f}m"
    if ms >= 1000:
        return f"{ms / 1000.0:.2f}s"
    return f"{ms:.0f}ms"


def render_ledger(path: str, events: List[Dict[str, Any]], skipped: int) -> str:
    lines: List[str] = []
    begin = next(
        (e for e in events if e.get("event") == LedgerEvent.RUN_BEGIN.value), None
    )
    lines.append(f"== run ledger {path} ==")
    if begin:
        lines.append(
            f"run {begin.get('run_id', '?')} mode={begin.get('mode', '?')}"
            f" git_rev={begin.get('git_rev')} code_hash={begin.get('code_hash')}"
        )
    header = ("T+", "STAGE", "N", "DURATION", "BUDGET", "STATUS")
    rows: List[Tuple[str, ...]] = []
    for row in stage_rows(events):
        rows.append((
            f"{row['begin_s']:.1f}s",
            str(row["stage"]),
            "-" if row["n"] is None else str(row["n"]),
            _fmt_duration(row["duration_ms"]),
            "-" if row["timeout_s"] is None else f"{row['timeout_s']:.0f}s",
            row["status"] + (f" ({row['error']})" if row["error"] else ""),
        ))
    lines.extend(render_table(header, rows))
    if not rows:
        lines.append("(no stage events)")

    for record in events:
        kind = record.get("event")
        if kind not in _POINT_EVENTS:
            continue
        fields = {
            k: v for k, v in record.items()
            if k not in ("event", "seq", "pid", "t_s", "wall", "run_id")
        }
        detail = " ".join(f"{k}={v}" for k, v in fields.items())
        lines.append(f"! {record.get('t_s', 0.0):.1f}s {kind}: {detail}")

    terminal = [
        e for e in events
        if e.get("event") in (LedgerEvent.RUN_FAIL.value, LedgerEvent.RUN_END.value)
    ]
    fails = [e for e in terminal if e.get("event") == LedgerEvent.RUN_FAIL.value]
    stuck = open_stage(events)
    # The LATEST terminal event wins: a --cpu-fallback/--allow-snapshot run
    # records the wedge (run_fail) and THEN closes successfully (run_end) —
    # event order, not event kind, decides the outcome.
    if terminal and terminal[-1]["event"] == LedgerEvent.RUN_FAIL.value:
        last = terminal[-1].get("last_completed_stage") or last_completed_stage(events)
        where = f"; wedged in {stuck['stage']!r}" if stuck else ""
        lines.append(
            f"outcome: FAILED ({terminal[-1].get('outcome') or terminal[-1].get('error')})"
            f" — last completed stage: {last or 'none'}{where}"
        )
    elif terminal:
        note = (
            f" (after run_fail: {fails[-1].get('outcome') or fails[-1].get('error')})"
            if fails else ""
        )
        lines.append(f"outcome: {terminal[-1].get('outcome', 'completed')}{note}")
    else:
        where = f" (in {stuck['stage']!r})" if stuck else ""
        lines.append(f"outcome: still running or killed mid-run{where}")
    if skipped:
        lines.append(f"({skipped} unparseable line(s) skipped)")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Trajectory rendering
# ---------------------------------------------------------------------------


def hlo_audit_table(data: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The point's per-entrypoint compiled-program audit (bench.py's
    ``hlo_audit`` key), or None when the round predates the audit or it
    errored — absence never flags, only a measured difference does."""
    table = data.get("hlo_audit")
    if not isinstance(table, dict) or "error" in table:
        return None
    return table


def hlo_drift(prev: Optional[Dict[str, Any]],
              cur: Optional[Dict[str, Any]]) -> bool:
    """True when two audited rounds disagree on any shared entrypoint's
    collective counts — the compiled communication budget moved between
    rounds (intentionally or not: the trajectory must show it either way)."""
    if not prev or not cur:
        return False
    for name in set(prev) & set(cur):
        for key in ("collectives", "hot_loop_collectives"):
            if prev[name].get(key) != cur[name].get(key):
                return True
    return False


def point_flags(
    data: Dict[str, Any], prev: Optional[Dict[str, Any]] = None
) -> List[str]:
    """The trust flags of one bench-round JSON artifact. ``prev`` is the
    nearest EARLIER round that carried an hlo_audit table (trajectory
    rendering threads it); a collective-count difference against it flags
    ``hlo-drift``."""
    flags: List[str] = []
    if "error" in data:
        flags.append("hole")
        return flags
    if data.get("live_attempt") == "wedged":
        flags.append("wedged")
    if data.get("capture") == "session_snapshot":
        flags.append("snapshot")
    if data.get("stale_code"):
        flags.append("stale")
    for key, value in data.items():
        if key.endswith("_per_sec") and isinstance(value, (int, float)):
            if value > SUSPECT_RATE_PER_SEC:
                flags.append("suspect-rate")
                break
    # Headline discipline: an AUDITED round (it carries the
    # hlo_audit table, i.e. post-promotion bench code produced it) must
    # carry the 1M headline value or its explicit n1M_status marker.
    # Pre-audit historical rounds are exempt — absence there is history,
    # not a silent drop.
    if (
        hlo_audit_table(data) is not None
        and not isinstance(data.get("n1M_crash1pct_ms"), (int, float))
        and not data.get("n1M_status")
    ):
        flags.append("headline-missing")
    # Fleet discipline: the same rule for the multi-tenant
    # point — an audited round must carry tenant_view_changes_per_sec or
    # its explicit tenant_fleet_status marker; the fleet metric must never
    # be silently absent. Pre-audit historical rounds are exempt.
    if (
        hlo_audit_table(data) is not None
        and not isinstance(
            data.get("tenant_view_changes_per_sec"), (int, float)
        )
        and not data.get("tenant_fleet_status")
    ):
        flags.append("fleet-missing")
    # Streaming discipline: same rule for the sustained-serving
    # point — an audited round must carry stream_view_changes_per_sec or
    # its explicit stream_status marker; the streaming metric must never be
    # silently absent. Pre-audit historical rounds are exempt.
    if (
        hlo_audit_table(data) is not None
        and not isinstance(
            data.get("stream_view_changes_per_sec"), (int, float)
        )
        and not data.get("stream_status")
    ):
        flags.append("stream-missing")
    # Chaos discipline: same rule for the adversarial-chaos
    # point — an audited round must carry chaos_scenarios_per_sec or its
    # explicit chaos_status marker; the chaos throughput metric must never
    # be silently absent. Pre-audit historical rounds are exempt.
    if (
        hlo_audit_table(data) is not None
        and not isinstance(data.get("chaos_scenarios_per_sec"), (int, float))
        and not data.get("chaos_status")
    ):
        flags.append("chaos-missing")
    # Memory discipline: same rule for the state-compaction
    # point — an audited round must carry bytes_per_member or its explicit
    # mem_status marker; the memory-footprint metric must never be
    # silently absent. Pre-audit historical rounds are exempt.
    if (
        hlo_audit_table(data) is not None
        and not isinstance(data.get("bytes_per_member"), (int, float))
        and not data.get("mem_status")
    ):
        flags.append("mem-missing")
    # Recovery discipline: same rule for the self-healing drill
    # — an audited round must carry recovery_mttr_ms or its explicit
    # recovery_status marker; the resume-MTTR metric must never be
    # silently absent. Pre-audit historical rounds are exempt.
    if (
        hlo_audit_table(data) is not None
        and not isinstance(data.get("recovery_mttr_ms"), (int, float))
        and not data.get("recovery_status")
    ):
        flags.append("recovery-missing")
    # Activity discipline: same rule for the device telemetry
    # plane — an audited round must carry stream_active_fraction or its
    # explicit activity_status marker. A quiet cluster reads activity=0,
    # so absence is always instrumentation loss, never "nothing happened".
    # Pre-audit historical rounds are exempt.
    if (
        hlo_audit_table(data) is not None
        and not isinstance(data.get("stream_active_fraction"), (int, float))
        and not data.get("activity_status")
    ):
        flags.append("activity-missing")
    # Trace discipline: same rule for the round-trace ring — an
    # audited round must carry the round_trajectory digest's
    # rounds-to-decision p99 or its explicit trace_status marker. The ring
    # is zero-minted at attach, so absence is instrumentation loss, never
    # "nothing decided". Pre-audit historical rounds are exempt.
    trajectory = data.get("round_trajectory") or {}
    if (
        hlo_audit_table(data) is not None
        and not isinstance(
            trajectory.get("rounds_to_decision_p99"), (int, float)
        )
        and not data.get("trace_status")
    ):
        flags.append("trace-missing")
    # Cost-model discipline: same rule for the scaling-law
    # axis — an audited round must carry the cost_fit table (fitted
    # per-entrypoint scaling classes) or its explicit status marker
    # (suppressed ladder / unavailable backend). Pre-audit historical
    # rounds are exempt.
    if hlo_audit_table(data) is not None and not data.get("cost_fit"):
        flags.append("cost-missing")
    # Dataflow-provenance discipline: same rule for the jaxpr
    # proof axis — an audited round must carry the dataflow block (proof
    # verdicts + opportunity coverage, or its explicit suppressed/
    # unavailable status inside it). Pre-provenance historical rounds are
    # exempt.
    if hlo_audit_table(data) is not None and not data.get("dataflow"):
        flags.append("dataflow-missing")
    if hlo_drift(prev, hlo_audit_table(data)):
        flags.append("hlo-drift")
    if not flags:
        flags.append("live")
    return flags


def load_trajectory_point(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            data = json.load(f)
    except OSError as exc:
        raise PerfviewError(f"{path}: cannot read: {exc}") from exc
    except json.JSONDecodeError as exc:
        raise PerfviewError(f"{path}: invalid JSON: {exc}") from exc
    if isinstance(data, dict) and isinstance(data.get("parsed"), dict):
        # Driver round artifact (BENCH_rNN.json): the bench's emitted JSON
        # line lives under "parsed", beside the harness's cmd/rc/tail.
        data = data["parsed"]
    if not isinstance(data, dict) or ("metric" not in data):
        raise PerfviewError(
            f"{path}: not a bench metric artifact (expected a JSON object "
            "with a 'metric' key, or a driver round file with 'parsed')"
        )
    return data


def headline_cell(data: Dict[str, Any]) -> str:
    """The N1M column: the measured 1M headline, else its explicit status
    marker, else '-' (pre-promotion rounds)."""
    value = data.get("n1M_crash1pct_ms")
    if isinstance(value, (int, float)):
        return f"{float(value):.1f}ms"
    status = data.get("n1M_status")
    return str(status) if status else "-"


def fleet_cell(data: Dict[str, Any]) -> str:
    """The FLEET column: tenant_view_changes_per_sec (with the fleet shape
    when present), else its explicit tenant_fleet_status marker, else '-'
    (pre-fleet rounds)."""
    value = data.get("tenant_view_changes_per_sec")
    if isinstance(value, (int, float)):
        return f"{float(value):.1f}/s"
    status = data.get("tenant_fleet_status")
    return str(status) if status else "-"


def stream_cell(data: Dict[str, Any]) -> str:
    """The STREAM column: sustained stream_view_changes_per_sec with the
    p99 alert->commit beside it when present, else the explicit
    stream_status marker, else '-' (pre-stream rounds)."""
    value = data.get("stream_view_changes_per_sec")
    if isinstance(value, (int, float)):
        p99 = data.get("stream_p99_alert_to_commit_ms")
        suffix = (
            f" p99={float(p99):.1f}ms" if isinstance(p99, (int, float)) else ""
        )
        return f"{float(value):.1f}/s{suffix}"
    status = data.get("stream_status")
    return str(status) if status else "-"


def mem_cell(data: Dict[str, Any]) -> str:
    """The MEM column: compact bytes/member (with the wide figure beside
    it when present), else the explicit mem_status marker, else '-'
    (pre-compaction rounds)."""
    value = data.get("bytes_per_member")
    if isinstance(value, (int, float)):
        wide = data.get("bytes_per_member_wide")
        suffix = (
            f" (wide {float(wide):.0f})" if isinstance(wide, (int, float)) else ""
        )
        return f"{float(value):.0f}B/m{suffix}"
    status = data.get("mem_status")
    return str(status) if status else "-"


def recovery_cell(data: Dict[str, Any]) -> str:
    """The RECOVERY column: the drill's resume MTTR (with the bit-identity
    verdict beside it — a resume that diverged is worse than no resume),
    else the explicit recovery_status marker, else '-' (pre-supervision
    rounds)."""
    value = data.get("recovery_mttr_ms")
    if isinstance(value, (int, float)):
        identical = data.get("recovery_bit_identical")
        suffix = "" if identical in (True, None) else " DIVERGED"
        return f"{float(value):.1f}ms mttr{suffix}"
    status = data.get("recovery_status")
    return str(status) if status else "-"


def chaos_cell(data: Dict[str, Any]) -> str:
    """The CHAOS column: adversarial scenarios resolved (and oracle-checked
    clean) per second of batched fleet dispatch, with the tenant count when
    present, else the explicit chaos_status marker, else '-' (pre-chaos
    rounds)."""
    value = data.get("chaos_scenarios_per_sec")
    if isinstance(value, (int, float)):
        tenants = data.get("chaos_tenants")
        suffix = f" B={int(tenants)}" if isinstance(tenants, int) else ""
        return f"{float(value):.1f}/s{suffix}"
    status = data.get("chaos_status")
    return str(status) if status else "-"


def activity_cell(data: Dict[str, Any]) -> str:
    """The ACTIVITY column: the stream soak's mean active-subject fraction
    (with the fast-path share beside it when present), else the explicit
    activity_status marker, else '-' (pre-telemetry rounds). A zero-churn
    soak renders '0.0%', not a dash — zero is a measurement."""
    value = data.get("stream_active_fraction")
    if isinstance(value, (int, float)):
        share = data.get("stream_fast_path_share")
        suffix = (
            f" fast={100.0 * float(share):.0f}%"
            if isinstance(share, (int, float)) else ""
        )
        return f"{100.0 * float(value):.1f}%{suffix}"
    status = data.get("activity_status")
    return str(status) if status else "-"


def trace_cell(data: Dict[str, Any]) -> str:
    """The TRACE column: the round-trajectory digest's rounds-to-decision
    p99 (with the worst wave beside it when present), else the explicit
    trace_status marker, else '-' (pre-trace rounds)."""
    trajectory = data.get("round_trajectory") or {}
    value = trajectory.get("rounds_to_decision_p99")
    if isinstance(value, (int, float)):
        worst = trajectory.get("rounds_to_decision_max")
        suffix = (
            f" max={int(worst)}" if isinstance(worst, (int, float)) else ""
        )
        return f"p99={float(value):.1f}r{suffix}"
    status = data.get("trace_status")
    return str(status) if status else "-"


#: Scaling-class vocabulary, weakest to strongest — mirrors
#: tools/analysis/cost_model.CLASSES (perfview stays import-light; the
#: spelling is part of the bench artifact contract). Classes this tool
#: does not know sort WORST — a future stronger class must never render
#: as better than the ones it replaced.
_COST_CLASS_ORDER = ("O(1)", "O(log N)", "O(N)", "O(N*K)", "O(N^2)")


def cost_cell(data: Dict[str, Any]) -> str:
    """The COSTFIT column: the WORST fitted scaling class across the
    round's audited entrypoints (with the quiescent round's collective
    payload beside it when measured), else the explicit cost_fit status
    marker, else '-' (pre-cost rounds)."""
    fit = data.get("cost_fit")
    if isinstance(fit, dict) and "status" in fit:
        return str(fit["status"])
    if isinstance(fit, dict) and fit:
        classes = [
            cls for per in fit.values() if isinstance(per, dict)
            for cls in per.values()
        ]
        if classes:
            worst = max(
                classes,
                key=lambda cls: (
                    _COST_CLASS_ORDER.index(cls)
                    if cls in _COST_CLASS_ORDER else len(_COST_CLASS_ORDER)
                ),
            )
            quiescent = data.get("quiescent_round_cost") or {}
            payload = quiescent.get("collective_payload_bytes")
            suffix = (
                f" q={int(payload)}B" if isinstance(payload, (int, float))
                else ""
            )
            return f"worst={worst}{suffix}"
    return "-"


def oppty_cell(data: Dict[str, Any]) -> str:
    """The OPPTY column: the sparse-opportunity map's coverage of the
    quiescent payload bytes with the proof verdicts beside it (ok = both
    observer-silence and tenant-isolation proven), else the explicit
    dataflow status marker, else '-' (pre-provenance rounds)."""
    df = data.get("dataflow")
    if not isinstance(df, dict):
        return "-"
    coverage = df.get("opportunity_coverage_pct")
    if isinstance(coverage, (int, float)):
        proofs = (
            "ok" if df.get("observer_silent")
            and df.get("tenant_isolated") is not False
            else "LEAK"
        )
        return f"{float(coverage):.0f}%/{proofs}"
    status = df.get("opportunity_status") or df.get("status")
    return str(status) if status else "-"


def render_trajectory(points: List[Tuple[str, Dict[str, Any]]]) -> str:
    lines = ["== perf trajectory =="]
    header = ("ROUND", "METRIC", "VALUE", "N1M", "FLEET", "STREAM", "CHAOS",
              "MEM", "RECOVERY", "ACTIVITY", "TRACE", "COSTFIT", "OPPTY",
              "PLATFORM", "VSBASE", "FLAGS")
    rows: List[Tuple[str, ...]] = []
    flag_rows: List[Tuple[str, List[str]]] = []
    prev_audit: Optional[Dict[str, Any]] = None
    for path, data in sorted(points, key=lambda p: p[0]):
        value = data.get("value")
        vs = data.get("vs_baseline", data.get("vs_baseline_at_capture"))
        flags = point_flags(data, prev=prev_audit)
        # The drift baseline is the nearest earlier AUDITED round: a hole
        # or pre-audit round in between must not reset the comparison.
        prev_audit = hlo_audit_table(data) or prev_audit
        rows.append((
            Path(path).stem,
            str(data.get("metric", "?")),
            "-" if value is None else f"{float(value):.1f}ms",
            headline_cell(data),
            fleet_cell(data),
            stream_cell(data),
            chaos_cell(data),
            mem_cell(data),
            recovery_cell(data),
            activity_cell(data),
            trace_cell(data),
            cost_cell(data),
            oppty_cell(data),
            str(data.get("platform", "-")),
            "-" if vs is None else f"{float(vs):.2f}x"
            + ("@capture" if "vs_baseline_at_capture" in data else ""),
            ",".join(flags),
        ))
        flag_rows.append((Path(path).stem, flags))
    lines.extend(render_table(header, rows))
    flagged = [
        (name, kept) for name, flags in flag_rows
        if (kept := [f for f in flags if f != "live"])
    ]
    if flagged:
        lines.append(
            "untrusted points: "
            + "; ".join(f"{name} ({','.join(flags)})" for name, flags in flagged)
        )
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Chrome trace output (same envelope as traceview)
# ---------------------------------------------------------------------------


def chrome_trace(ledgers: List[Tuple[str, List[Dict[str, Any]]]]) -> Dict[str, Any]:
    """Ledger stages as complete ('X') duration events and point events as
    thread-scoped instants, one process lane per ledger — the trace-event
    envelope Perfetto and chrome://tracing load (identical to
    traceview.chrome_trace's)."""
    trace_events: List[Dict[str, Any]] = []
    for pid, (path, events) in enumerate(ledgers, start=1):
        trace_events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": str(path)},
        })
        for row in stage_rows(events):
            duration_ms = row["duration_ms"] or 0.0
            trace_events.append({
                "name": row["stage"],
                "ph": "X",
                "ts": row["begin_s"] * 1e6,  # trace-event ts is µs
                "dur": duration_ms * 1000.0,
                "pid": pid,
                "tid": 1,
                "args": {
                    "n": row["n"], "status": row["status"],
                    "timeout_s": row["timeout_s"],
                },
            })
        for record in events:
            if record.get("event") not in _POINT_EVENTS:
                continue
            trace_events.append({
                "name": record["event"],
                "ph": "i",
                "s": "t",
                "ts": record.get("t_s", 0.0) * 1e6,
                "pid": pid,
                "tid": 1,
                "args": {
                    k: v for k, v in record.items()
                    if k not in ("event", "seq", "pid", "t_s", "wall", "run_id")
                },
            })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="render bench run ledgers (stage timelines) and the "
                    "BENCH_r* perf trajectory with trust flags"
    )
    parser.add_argument(
        "inputs", nargs="+",
        help="run-ledger .jsonl files (bench.py --ledger) and/or bench "
             "metric .json artifacts (BENCH_rNN.json)",
    )
    parser.add_argument(
        "--chrome", metavar="OUT.json", default=None,
        help="also write Chrome trace-event JSON of the ledger stages "
             "(open in Perfetto)",
    )
    args = parser.parse_args(argv)

    ledgers: List[Tuple[str, List[Dict[str, Any]], int]] = []
    points: List[Tuple[str, Dict[str, Any]]] = []
    try:
        for arg in args.inputs:
            if arg.endswith(".jsonl"):
                events, skipped = read_ledger(arg)
                if not events:
                    raise PerfviewError(
                        f"{arg}: no ledger events (missing file or not a "
                        "bench run ledger)"
                    )
                ledgers.append((arg, events, skipped))
            else:
                points.append((arg, load_trajectory_point(arg)))
    except PerfviewError as exc:
        print(f"perfview: {exc}", file=sys.stderr)
        return 2

    lanes: List[Tuple[str, List[Dict[str, Any]]]] = []
    for path, events, skipped in ledgers:
        runs = split_runs(events)
        for run_id, run_events in runs:
            label = path if len(runs) == 1 else f"{path} [{run_id}]"
            sys.stdout.write(render_ledger(label, run_events, skipped))
            sys.stdout.write("\n")
            skipped = 0  # unparseable-line count reported once per file
            lanes.append((label, run_events))
    if points:
        sys.stdout.write(render_trajectory(points))
    if args.chrome:
        trace = chrome_trace(lanes)
        with open(args.chrome, "w") as f:
            json.dump(trace, f, indent=1)
            f.write("\n")
        sys.stdout.write(
            f"wrote {args.chrome} ({len(trace['traceEvents'])} events)\n"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
