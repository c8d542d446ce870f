"""Metrics exposition: one unified telemetry snapshot per node, rendered as
Prometheus text or JSON (a copy of ``rapid_tpu/utils/exposition.py``: the
same vocabularies, names and text, byte for byte on the same snapshot).

The reference has no runtime telemetry surface at all (SURVEY §5.1/5.5); the
paper's Table 2 network numbers came from external OS tooling. This module
unifies the in-tree instruments — the ``Metrics`` registry
(utils/metrics.py), per-transport ``TransportStats`` (messaging/stats.py),
the flight recorder (utils/flight_recorder.py), and the node health model
(utils/health.py) — into a single snapshot dict with a stable shape, and
renders it in the Prometheus text exposition format under stable metric
names (pinned by tests/test_observability.py).

Snapshot shape (``MembershipService.telemetry_snapshot`` /
``Cluster.telemetry_snapshot`` produce it; ``tools/traceview.py``,
``tools/clustertop.py`` and the standalone agent's ``--metrics-dump``
consume it)::

    {
      "node": "host:port",
      "configuration_id": int,
      "membership_size": int,
      "health": "stable" | "detecting" | "proposing" | "catching_up" | "wedged",
      "metrics": {<counter>: int, ...,
                  "<timer>_ms": {count,last,p50,p90,p99,max,sum,buckets},
                  "<family>_ms": {<phase>: {count,...,buckets}, ...}},
      "transport": {"client": TransportStats.snapshot()|None, "server": ...},
      "recorder": FlightRecorder.snapshot(),
    }

Timers render as real Prometheus histograms (``_bucket``/``_sum``/``_count``
on the fixed schedule of utils/histogram.py); phase families additionally
carry ``phase=`` (and, for "phase/path" keys, ``path=``) labels — the
convergence SLO surface: ``rapid_view_change_phase_ms_bucket{phase="detection",...}``.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional

from rapid_tpu_torch.utils.health import NodeHealth
from rapid_tpu_torch.utils.histogram import LogHistogram, cumulative_from_summary

#: The zero-count summary shape, for series that must exist from the first
#: scrape even though their instrument is minted lazily on first record.
_EMPTY_HISTOGRAM_SUMMARY = LogHistogram().summary()

_PREFIX = "rapid"

#: Counters every membership-service scrape exposes even before the first
#: increment. Prometheus series that appear only once an event has happened
#: break rate()/absent() alerting; zero-filling the known vocabulary keeps
#: the series set stable from the first scrape. (``Metrics`` counters are a
#: defaultdict — there is no registry to enumerate, so the vocabulary lives
#: here and the golden test pins it.)
KNOWN_COUNTERS = (
    "alerts_enqueued",
    "alerts_received",
    "alert_batches_sent",
    "alert_batches_redelivered",
    "proposals_announced",
    "classic_rounds_started",
    "view_changes",
    "kicked",
    "config_beacons_sent",
    "config_catch_ups",
    "config_sync_unchanged",
    "config_pull_unchanged_served",
    "catch_up_wedged",
    "decision_missing_joiner_uuid",
)

_TRANSPORT_COUNTERS = ("msgs_tx", "bytes_tx", "msgs_rx", "bytes_rx")
_TRANSPORT_GAUGES = ("kbps_tx", "kbps_rx")

#: Device-engine counters zero-filled on every snapshot that carries an
#: ``engine`` section (``VirtualCluster.telemetry_snapshot``) — the engine
#: tier's series set must be stable from the first scrape, same rule as
#: KNOWN_COUNTERS for host nodes.
ENGINE_KNOWN_COUNTERS = (
    "engine_dispatches",
    "engine_steps",
    "engine_convergence_steps",
    "engine_cuts_committed",
    "engine_h2d_bytes",
    "engine_d2h_bytes",
)

#: Tenant-fleet counters zero-filled on snapshots whose ``engine`` section
#: carries a ``tenancy`` block (``TenantFleet.telemetry_snapshot``) — the
#: fleet tier's series set is stable from the first scrape, and a
#: single-cluster scrape never grows them.
TENANCY_KNOWN_COUNTERS = (
    "engine_tenant_rounds",
    "engine_tenant_cuts",
    "engine_tenant_quarantines",
)

#: Streaming-tier counters zero-filled on snapshots whose ``engine`` section
#: carries a ``stream`` block (a ``rapid_tpu_torch.serving.StreamDriver`` is
#: attached to the driver) — same stable-series rule; batch-only scrapes
#: never grow them.
STREAM_KNOWN_COUNTERS = (
    "engine_stream_waves",
    "engine_stream_cuts",
)

#: Supervision-tier counters zero-filled on snapshots whose ``engine``
#: section carries a ``recovery`` block (a ``rapid_tpu_torch.serving.supervisor.
#: Supervisor`` is attached) — same stable-series rule; unsupervised
#: scrapes never grow them.
RECOVERY_KNOWN_COUNTERS = (
    "engine_recovery_retries",
    "engine_recovery_wedges",
    "engine_recovery_checkpoints",
    "engine_recovery_resumes",
    "engine_recovery_quarantines",
    "engine_recovery_quarantine_dropped_events",
)

#: ``engine.stream`` gauge keys (``StreamDriver.snapshot()``); rate/ratio
#: gauges are None before the first drain and render NaN so the series set
#: is stable from the first scrape.
_ENGINE_STREAM_GAUGES = (
    "waves_submitted",
    "waves_completed",
    "waves_in_flight",
    "rounds_per_wave",
    "depth",
    "view_changes_per_sec",
    "overlap_efficiency",
    "p99_alert_to_commit_ms",
)

#: ``engine.recovery`` gauge keys (``Supervisor.snapshot()``); None values
#: (no checkpoint yet, no resume yet) render NaN so the series set is
#: stable from attach.
_ENGINE_RECOVERY_GAUGES = (
    "waves_submitted",
    "checkpoint_every",
    "checkpoints_written",
    "last_checkpoint_wave",
    "retries",
    "wedges",
    "resumes",
    "quarantined",
    "mttr_ms",
)

#: ``engine.compile`` counter keys -> metric suffix (all render as
#: ``rapid_engine_<suffix>_total``); the compile_ms histogram is rendered
#: separately.
_ENGINE_COMPILE_COUNTERS = (
    ("compiles", "compiles"),
    ("persistent_cache_hits", "persistent_cache_hits"),
    ("persistent_cache_misses", "persistent_cache_misses"),
    ("cache_requests", "compile_cache_requests"),
)

#: ``engine.memory`` gauge keys (``None`` probes render as NaN so the
#: series set is identical on platforms without allocator stats).
_ENGINE_MEMORY_GAUGES = (
    "live_buffers",
    "live_buffer_bytes",
    "device_bytes_in_use",
    "device_peak_bytes",
)

#: Device-telemetry-plane activity counters (``engine.activity`` — present
#: exactly when the driver was built with ``telemetry=1``; the section is
#: zero-minted at attach, so every series below exists from the first
#: scrape and is never minted mid-run). Rendered as
#: ``rapid_engine_activity_<name>_total``.
_ENGINE_ACTIVITY_COUNTERS = (
    "rounds",
    "alerts",
    "active_sum",
    "invalidations",
    "proposals",
    "tally_sum",
    "conflict_rounds",
)

#: ``engine.activity`` derived gauges (``rapid_engine_activity_<name>``):
#: the rates/peaks clustertop and perfview columns read.
_ENGINE_ACTIVITY_GAUGES = (
    "active_peak",
    "active_fraction",
    "peak_active_fraction",
    "fast_path_share",
    "conflict_rate",
    "winning_tally_mean",
)

#: Round-trace ring counters (``engine.trace`` / per-tenant
#: ``engine.tenant_trace`` — present exactly when the driver was built with
#: ``trace=R``; zero-minted at attach, so every series exists from the
#: first scrape). Rendered as ``rapid_engine_trace_<name>_total``.
_ENGINE_TRACE_COUNTERS = (
    "rounds_recorded",
    "wraps",
)

#: Round-trace ring gauges (``rapid_engine_trace_<name>``): ring geometry,
#: held-window census, and the newest record's stamps — the clustertop
#: ROUNDS pane's inputs.
_ENGINE_TRACE_GAUGES = (
    "capacity",
    "rounds_held",
    "decisions_held",
    "conflicts_held",
    "last_round",
    "last_epoch",
    "last_active",
    "last_path",
    "last_undecided",
)

#: ``engine.stream`` gauge keys that exist only on trace>0 targets
#: (StreamDriver.snapshot adds them exactly then): rendered when present,
#: so a trace=0 stream's scrape vocabulary is unchanged.
_ENGINE_STREAM_TRACE_GAUGES = (
    "rounds_to_decision_p99",
    "queue_wait_rounds_p99",
    "waves_evicted",
)


def _esc(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(**labels: str) -> str:
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items() if v is not None)
    return "{" + inner + "}" if inner else ""


def _num(value: Any) -> str:
    # Prometheus floats; integers render without a trailing .0 for
    # readability (both parse identically). Non-finite floats use the
    # exposition-format tokens — Python's repr ('nan', 'inf') is not
    # parseable by Prometheus scrapers.
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    value = float(value)
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    return repr(value)


def _le(bound: Any) -> str:
    """A histogram bucket's ``le`` label value: short float form for finite
    bounds, the literal ``+Inf`` token for the overflow bucket."""
    return bound if isinstance(bound, str) else format(bound, ".6g")


class _Renderer:
    def __init__(self) -> None:
        self._lines: List[str] = []
        self._typed: set = set()

    def declare(self, name: str, kind: str) -> None:
        if name not in self._typed:
            self._typed.add(name)
            self._lines.append(f"# TYPE {name} {kind}")

    def sample(
        self, name: str, kind: str, value: Any, **labels: str
    ) -> None:
        self.declare(name, kind)
        self._lines.append(f"{name}{_labels(**labels)} {_num(value)}")

    def histogram(self, name: str, summary: Dict[str, Any], **labels: str) -> None:
        """One Prometheus histogram series set (``_bucket``/``_sum``/
        ``_count``) from a LogHistogram summary dict. ``labels`` precede the
        ``le`` label on every bucket line; the TYPE is declared once per
        family name across label sets."""
        buckets = cumulative_from_summary(summary)
        if buckets is None:
            # Legacy timer dict without bucket data (an old snapshot file):
            # fall back to the stat-labeled summary rendering.
            for stat, value in sorted(summary.items()):
                self.sample(name, "summary", value, **labels, stat=stat)
            return
        self.declare(name, "histogram")
        for bound, cumulative in buckets:
            self._lines.append(
                f"{name}_bucket{_labels(**labels, le=_le(bound))} {cumulative}"
            )
        self._lines.append(f"{name}_sum{_labels(**labels)} {_num(summary.get('sum', 0.0))}")
        self._lines.append(f"{name}_count{_labels(**labels)} {summary.get('count', 0)}")

    def text(self) -> str:
        return "\n".join(self._lines) + "\n"


def _render_activity(
    out: "_Renderer", activity: Dict[str, Any], node: Optional[str],
    tenant: Optional[str] = None,
) -> None:
    """One ``engine.activity`` section as Prometheus series: the raw
    counters, the fast/classic decision split
    (``rapid_engine_decision_path_total{path=...}``), the derived rate
    gauges, and the rounds-undecided log2 histogram
    (``{bucket="<log2 floor>"}``). ``tenant`` adds the fleet variants'
    per-tenant label."""
    for key in _ENGINE_ACTIVITY_COUNTERS:
        out.sample(f"{_PREFIX}_engine_activity_{key}_total", "counter",
                   activity.get(key, 0), node=node, tenant=tenant)
    for path in ("fast", "classic"):
        out.sample(f"{_PREFIX}_engine_decision_path_total", "counter",
                   activity.get(f"decisions_{path}", 0),
                   node=node, tenant=tenant, path=path)
    for key in _ENGINE_ACTIVITY_GAUGES:
        out.sample(f"{_PREFIX}_engine_activity_{key}", "gauge",
                   activity.get(key, 0), node=node, tenant=tenant)
    for bucket, count in enumerate(activity.get("rounds_undecided_hist", ())):
        out.sample(f"{_PREFIX}_engine_activity_rounds_undecided_total",
                   "counter", count, node=node, tenant=tenant,
                   bucket=str(bucket))


def _render_trace(
    out: "_Renderer", trace: Dict[str, Any], node: Optional[str],
    tenant: Optional[str] = None,
) -> None:
    """One decoded ring digest (``engine.trace`` / a ``tenant_trace``
    entry) as Prometheus series: the monotone cursor/wrap counters plus the
    held-window and last-record gauges. The per-record lanes themselves are
    a timeline, not a gauge surface — traceview renders those."""
    for key in _ENGINE_TRACE_COUNTERS:
        out.sample(f"{_PREFIX}_engine_trace_{key}_total", "counter",
                   trace.get(key, 0), node=node, tenant=tenant)
    for key in _ENGINE_TRACE_GAUGES:
        out.sample(f"{_PREFIX}_engine_trace_{key}", "gauge",
                   trace.get(key, 0), node=node, tenant=tenant)


def _phase_labels(phase_key: str) -> Dict[str, str]:
    """'detection' -> {phase: detection}; 'agreement/fast' ->
    {phase: agreement, path: fast} (the consensus-path split of the
    agreement phase — arXiv:1308.1358's fast/classic boundary)."""
    if "/" in phase_key:
        phase, path = phase_key.split("/", 1)
        return {"phase": phase, "path": path}
    return {"phase": phase_key}


def prometheus_text(snapshot: Dict[str, Any]) -> str:
    """Render one unified telemetry snapshot as Prometheus text exposition.

    Metric names are a stable API (tests/test_observability.py pins them):
    - ``rapid_membership_size`` / ``rapid_configuration_id`` gauges;
    - ``rapid_node_health{state=...}`` one-hot over the health vocabulary;
    - every ``Metrics`` counter as ``rapid_<name>_total`` (the
      KNOWN_COUNTERS vocabulary is zero-filled);
    - every ``Metrics`` timer as a ``rapid_<name>`` histogram
      (``_bucket``/``_sum``/``_count``), phase families labeled
      ``{phase=...}`` (and ``path=`` for the agreement split);
    - transport counters as ``rapid_transport_<dir>_total{side=...}``;
    - flight-recorder depth/capacity/total/dropped gauges.
    """
    node = snapshot.get("node")
    out = _Renderer()
    if "membership_size" in snapshot:
        out.sample(f"{_PREFIX}_membership_size", "gauge",
                   snapshot["membership_size"], node=node)
    if "configuration_id" in snapshot:
        out.sample(f"{_PREFIX}_configuration_id", "gauge",
                   snapshot["configuration_id"], node=node)
    if "health" in snapshot:
        # One-hot over the full vocabulary: the series set is stable from
        # the first scrape, so absent() alerting works per state.
        current = str(snapshot["health"]).lower()
        for state in NodeHealth:
            out.sample(f"{_PREFIX}_node_health", "gauge",
                       1 if state.value == current else 0,
                       node=node, state=state.value)

    metrics: Dict[str, Any] = dict(snapshot.get("metrics", {}))
    counters = {name: 0 for name in KNOWN_COUNTERS}
    engine_section = snapshot.get("engine")
    if "engine" in snapshot:
        counters.update({name: 0 for name in ENGINE_KNOWN_COUNTERS})
    if isinstance(engine_section, dict) and "tenancy" in engine_section:
        counters.update({name: 0 for name in TENANCY_KNOWN_COUNTERS})
    if isinstance(engine_section, dict) and "recovery" in engine_section:
        counters.update({name: 0 for name in RECOVERY_KNOWN_COUNTERS})
    if isinstance(engine_section, dict) and "stream" in engine_section:
        counters.update({name: 0 for name in STREAM_KNOWN_COUNTERS})
        # The alert->commit timer is lazily minted on the first wave
        # COMPLETION, so a scrape between attach and first completion
        # would otherwise lack the histogram triplet — zero-fill it (the
        # stable-series rule the counters above follow).
        metrics.setdefault(
            "engine_stream_alert_to_commit_ms", _EMPTY_HISTOGRAM_SUMMARY
        )
    timers: Dict[str, Dict[str, Any]] = {}
    for name, value in metrics.items():
        if isinstance(value, dict):
            timers[name] = value
        else:
            counters[name] = value
    for name in sorted(counters):
        out.sample(f"{_PREFIX}_{name}_total", "counter", counters[name], node=node)
    for name in sorted(timers):
        value = timers[name]
        if "count" in value:
            out.histogram(f"{_PREFIX}_{name}", value, node=node)
        else:
            # Phase family: {phase_key: histogram summary}.
            for phase_key in sorted(value):
                out.histogram(
                    f"{_PREFIX}_{name}", value[phase_key],
                    **_phase_labels(phase_key), node=node,
                )

    transport = snapshot.get("transport") or {}
    for side in sorted(transport):
        stats = transport[side]
        if not stats:
            continue
        for key in _TRANSPORT_COUNTERS:
            if key in stats:
                out.sample(f"{_PREFIX}_transport_{key}_total", "counter",
                           stats[key], node=node, side=side)
        for key in _TRANSPORT_GAUGES:
            if key in stats:
                out.sample(f"{_PREFIX}_transport_{key}", "gauge",
                           stats[key], node=node, side=side)

    engine = snapshot.get("engine")
    if engine:
        # Device-engine tier: process-wide compile/cache counters, the
        # compile-duration histogram, and the device-memory gauges (NaN for
        # probes the platform does not expose — the series stays).
        compile_stats = engine.get("compile") or {}
        for key, suffix in _ENGINE_COMPILE_COUNTERS:
            out.sample(f"{_PREFIX}_engine_{suffix}_total", "counter",
                       compile_stats.get(key, 0), node=node)
        compile_ms = compile_stats.get("compile_ms")
        if isinstance(compile_ms, dict):
            out.histogram(f"{_PREFIX}_engine_compile_ms", compile_ms, node=node)
        memory = engine.get("memory") or {}
        for key in _ENGINE_MEMORY_GAUGES:
            value = memory.get(key)
            out.sample(f"{_PREFIX}_engine_{key}", "gauge",
                       float("nan") if value is None else value, node=node)
        stream = engine.get("stream")
        if isinstance(stream, dict):
            # The streaming tier (rapid_tpu_torch/serving): pipeline state and
            # the drained sustained rates as gauges (NaN pre-drain — the
            # series set is stable from the first scrape); the cumulative
            # wave/cut counters ride the ordinary metrics section,
            # zero-filled above, and the alert->commit histogram renders
            # from the timer family like every other timer.
            for key in _ENGINE_STREAM_GAUGES:
                value = stream.get(key)
                out.sample(f"{_PREFIX}_engine_stream_{key}", "gauge",
                           float("nan") if value is None else value,
                           node=node)
            # Ring-derived decomposition gauges: present in the snapshot
            # exactly when the stream's target runs trace>0 (NaN pre-drain).
            for key in _ENGINE_STREAM_TRACE_GAUGES:
                if key in stream:
                    value = stream.get(key)
                    out.sample(f"{_PREFIX}_engine_stream_{key}", "gauge",
                               float("nan") if value is None else value,
                               node=node)
        tenancy = engine.get("tenancy")
        if isinstance(tenancy, dict):
            # The fleet tier: tenant count, per-dispatch tenant throughput,
            # and the quarantine census as gauges (the cumulative counters
            # ride the ordinary metrics section, zero-filled above).
            out.sample(f"{_PREFIX}_engine_tenants", "gauge",
                       tenancy.get("tenants", 0), node=node)
            out.sample(f"{_PREFIX}_engine_tenant_rounds_per_dispatch",
                       "gauge",
                       tenancy.get("tenant_rounds_per_dispatch", 0.0),
                       node=node)
            out.sample(f"{_PREFIX}_engine_tenants_quarantined", "gauge",
                       tenancy.get("quarantined", 0), node=node)
        activity = engine.get("activity")
        if isinstance(activity, dict):
            # The device telemetry plane (models/state.TelemetryLanes):
            # present exactly when the driver runs with telemetry=1. The
            # aggregate renders unlabelled; a fleet's per-tenant list adds
            # tenant=<idx> variants of the same names.
            _render_activity(out, activity, node)
            tenant_activity = engine.get("tenant_activity")
            if isinstance(tenant_activity, (list, tuple)):
                for idx, per_tenant in enumerate(tenant_activity):
                    _render_activity(out, per_tenant, node, tenant=str(idx))
        trace = engine.get("trace")
        if isinstance(trace, dict):
            # The round-trace ring (models/state.TraceRing): present
            # exactly when the driver runs with trace=R (zero-minted at
            # attach — the series set is stable from the first scrape).
            _render_trace(out, trace, node)
        tenant_trace = engine.get("tenant_trace")
        if isinstance(tenant_trace, (list, tuple)):
            for idx, per_tenant in enumerate(tenant_trace):
                _render_trace(out, per_tenant, node, tenant=str(idx))
        recovery = engine.get("recovery")
        if isinstance(recovery, dict):
            # The supervision tier (rapid_tpu_torch/serving/supervisor.py):
            # checkpoint cadence/progress, retry/wedge/resume tallies, the
            # quarantine census, and the last resume's MTTR (NaN until a
            # resume happens — the series set is stable from attach).
            for key in _ENGINE_RECOVERY_GAUGES:
                value = recovery.get(key)
                out.sample(f"{_PREFIX}_engine_recovery_{key}", "gauge",
                           float("nan") if value is None else value,
                           node=node)

    recorder = snapshot.get("recorder")
    if recorder:
        # Derived from the ring counters, not len(events): a snapshot taken
        # with a truncated tail still reports the true ring depth.
        depth = recorder.get("recorded_total", 0) - recorder.get("dropped", 0)
        out.sample(f"{_PREFIX}_flight_recorder_depth", "gauge", depth, node=node)
        out.sample(f"{_PREFIX}_flight_recorder_capacity", "gauge",
                   recorder.get("capacity", 0), node=node)
        out.sample(f"{_PREFIX}_flight_recorder_recorded_total", "counter",
                   recorder.get("recorded_total", 0), node=node)
        out.sample(f"{_PREFIX}_flight_recorder_dropped_total", "counter",
                   recorder.get("dropped", 0), node=node)
    return out.text()


def metric_names(text: str) -> List[str]:
    """The sorted set of metric names in a Prometheus text exposition —
    what the golden-name test pins."""
    names = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        if name:
            names.add(name)
    return sorted(names)


def snapshot_json(snapshot: Dict[str, Any], indent: Optional[int] = None) -> str:
    """The JSON twin of the Prometheus rendering — the artifact
    ``--metrics-dump`` writes and ``tools/traceview.py`` merges."""
    return json.dumps(snapshot, indent=indent, sort_keys=False)
