"""Process-wide engine telemetry of the port: the build capture, the device
memory gauges, the host decoders of the telemetry plane and the round-trace
ring, and the ring rendered as a flight recording (the counterpart of
``rapid_tpu/utils/engine_telemetry.py``, with the same return shapes).

**What a "compile" is here.** The JAX package counts XLA compiles through
``jax.monitoring``. The port compiles nothing just in time: the code it
compiles is the ``nvcc`` build of each ``csrc/<name>.cu``
(``rapid_tpu_torch/_build.py``), which feeds the collector below. So in
:func:`compile_snapshot`:

- ``compiles`` and the ``compile_ms`` histogram: ``nvcc`` builds run in
  this process, and their wall time;
- ``persistent_cache_misses``: builds run because no ``.so`` matched the
  source hash;
- ``persistent_cache_hits``: first lookups that found the ``.so`` already
  built;
- ``cache_requests``: first lookups of a kernel in this process (by
  ``_build.load`` or ``_build.build_all``; ``load`` runs on every launch,
  and only its calls that miss the loaded table look). Each is a hit or a
  miss, so ``cache_requests == persistent_cache_hits +
  persistent_cache_misses``.

Build events are process-global (one build directory per checkout), so the
collector is a module singleton: :func:`compile_snapshot` reads the
monotonic totals and :class:`CompileDelta` diffs two snapshots around a
phase. :func:`device_memory_snapshot` reads the caching allocator of the
device a driver runs on; the decoders are pure host arithmetic and never
touch the device.
"""

from __future__ import annotations

import logging
import re
import threading
from typing import Any, Dict, Optional

import torch

from rapid_tpu_torch.models.state import TELEMETRY_BUCKETS
from rapid_tpu_torch.utils.histogram import LogHistogram

logger = logging.getLogger(__name__)


class _CompileCollector:
    """Monotonic process-wide build totals (thread-safe: builds run under
    ``_build``'s lock, snapshots from any thread)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "persistent_cache_hits": 0,
            "persistent_cache_misses": 0,
            "cache_requests": 0,
        }
        self.compiles = 0
        self.compile_ms_hist = LogHistogram()

    def on_lookup(self, built: bool) -> None:
        """The first lookup of one kernel in this process: its ``.so`` was
        already ``built`` (a hit) or must be built now (a miss)."""
        with self._lock:
            self.counters["cache_requests"] += 1
            self.counters["persistent_cache_hits" if built else "persistent_cache_misses"] += 1

    def on_build(self, ms: float) -> None:
        """One ``nvcc`` build run in this process, taking ``ms``."""
        with self._lock:
            self.compiles += 1
            self.compile_ms_hist.observe(ms)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self.counters)
            out["compiles"] = self.compiles
            out["compile_ms"] = self.compile_ms_hist.summary()
        return out


_COLLECTOR = _CompileCollector()


def install() -> bool:
    """True: build capture is on. ``_build`` reports every lookup and build
    to the collector whether or not a driver exists, so there is no
    listener to register; both drivers' constructors call this, as the JAX
    package's do, and it stays idempotent."""
    return True


def compile_snapshot() -> Dict[str, Any]:
    """Monotonic process-wide build totals:
    ``{persistent_cache_hits, persistent_cache_misses, cache_requests,
    compiles, compile_ms: <histogram summary>}`` (the JAX package's keys;
    their meaning in the port is in the module docstring)."""
    return _COLLECTOR.snapshot()


class CompileDelta:
    """Attribute process-global build activity to one phase: snapshot on
    enter, diff on exit (``delta`` holds the integer differences and
    ``compile_ms``, the difference of the summed build time). Only correct
    when nothing else builds concurrently."""

    def __init__(self) -> None:
        self.delta: Dict[str, Any] = {}
        self._before: Dict[str, Any] = {}

    def __enter__(self) -> "CompileDelta":
        self._before = compile_snapshot()
        return self

    def __exit__(self, *_exc: Any) -> None:
        after = compile_snapshot()
        self.delta = {
            key: after[key] - self._before[key]
            for key in after
            if isinstance(after[key], int)
        }
        self.delta["compile_ms"] = round(
            float(after["compile_ms"]["sum"]) - float(self._before["compile_ms"]["sum"]), 3
        )


def device_memory_snapshot(device) -> Dict[str, Any]:
    """The device memory gauges of ``device`` (the driver's), the JAX
    package's keys. On CUDA they come from the caching allocator
    (``torch.cuda.memory_stats(device)``):

    - ``live_buffers``: ``active.all.current``, the allocator's active
      blocks (a block is not a tensor: views share one, and one tensor may
      span a split block);
    - ``live_buffer_bytes``: ``active_bytes.all.current``;
    - ``device_bytes_in_use``: ``allocated_bytes.all.current`` (what
      ``torch.cuda.memory_allocated`` returns);
    - ``device_peak_bytes``: ``allocated_bytes.all.peak``, since the last
      ``torch.cuda.reset_peak_memory_stats`` (a snapshot never resets it).

    On any other device every value is None; the key set is the same."""
    out: Dict[str, Any] = {
        "live_buffers": None,
        "live_buffer_bytes": None,
        "device_bytes_in_use": None,
        "device_peak_bytes": None,
    }
    device = torch.device(device)
    if device.type != "cuda":
        return out
    stats = torch.cuda.memory_stats(device)
    for key, stat in (
        ("live_buffers", "active.all.current"),
        ("live_buffer_bytes", "active_bytes.all.current"),
        ("device_bytes_in_use", "allocated_bytes.all.current"),
        ("device_peak_bytes", "allocated_bytes.all.peak"),
    ):
        out[key] = int(stats.get(stat, 0))
    return out


#: Scalar layout of the telemetry digest vector, in order; the
#: TELEMETRY_BUCKETS rounds-undecided histogram buckets follow.
TELEMETRY_DIGEST_FIELDS = (
    "rounds",
    "alerts",
    "active_sum",
    "active_peak",
    "invalidations",
    "proposals",
    "tally_sum",
    "decisions_fast",
    "decisions_classic",
    "conflict_rounds",
)


def activity_summary(digest: Any, n: int, c: int) -> Dict[str, Any]:
    """The activity section from one fetched digest vector: the raw
    counters plus the derived rates: mean and peak active fraction of the
    ``[c, n]`` detector slots per round, the fast-path share of decisions,
    the conflict rate (rounds some cohort sat announced and undecided, per
    round) and the mean winning tally."""
    vec = [int(v) for v in digest]
    expected = len(TELEMETRY_DIGEST_FIELDS) + TELEMETRY_BUCKETS
    if len(vec) != expected:
        raise ValueError(f"telemetry digest carries {len(vec)} values, expected {expected}")
    out: Dict[str, Any] = dict(zip(TELEMETRY_DIGEST_FIELDS, vec))
    out["rounds_undecided_hist"] = vec[len(TELEMETRY_DIGEST_FIELDS):]
    rounds = out["rounds"]
    slots = n * c
    decisions = out["decisions_fast"] + out["decisions_classic"]
    out["active_fraction"] = out["active_sum"] / (rounds * slots) if rounds else 0.0
    out["peak_active_fraction"] = out["active_peak"] / rounds if rounds else 0.0
    out["fast_path_share"] = out["decisions_fast"] / decisions if decisions else 0.0
    out["conflict_rate"] = out["conflict_rounds"] / rounds if rounds else 0.0
    out["winning_tally_mean"] = out["tally_sum"] / decisions if decisions else 0.0
    return out


def zero_activity_summary(n: int, c: int) -> Dict[str, Any]:
    """The all-zero activity section a driver holds before its first sync,
    with every key the plane will ever report."""
    return activity_summary([0] * (len(TELEMETRY_DIGEST_FIELDS) + TELEMETRY_BUCKETS), n, c)


def aggregate_activity(summaries: Any, n: int, c: int) -> Dict[str, Any]:
    """Fleet rollup of per-tenant activity summaries: counters and the
    histogram summed across tenants, the peaks the tenant maximum (a peak
    summed across independent clusters is not a peak), the rates
    recomputed over the pooled totals."""
    summaries = list(summaries)
    if not summaries:
        return zero_activity_summary(n, c)
    hist = [
        sum(s["rounds_undecided_hist"][b] for s in summaries)
        for b in range(len(summaries[0]["rounds_undecided_hist"]))
    ]
    vec = [sum(s[f] for s in summaries) for f in TELEMETRY_DIGEST_FIELDS]
    out = activity_summary(vec + hist, n, c)
    out["active_peak"] = max(s["active_peak"] for s in summaries)
    out["peak_active_fraction"] = max(s["peak_active_fraction"] for s in summaries)
    return out


#: Per-round record fields, in the lane order ``trace_digest`` packs after
#: its two leading ``[cursor, wraps]`` scalars.
TRACE_RECORD_FIELDS = (
    "round",
    "epoch",
    "active",
    "alerts",
    "proposals",
    "tally",
    "path",
    "conflict",
    "undecided",
)

#: Decision-path codes of the ``path`` record field.
TRACE_PATH_NAMES = {0: "none", 1: "fast", 2: "classic"}


def trace_summary(digest: Any, capacity: int) -> Dict[str, Any]:
    """The decoded ring from one fetched trace digest: ``records`` oldest
    to newest, each a dict of :data:`TRACE_RECORD_FIELDS` plus ``seq``, the
    global ordinal of its round, and the derived scalars. The ring holds
    the last ``min(capacity, cursor)`` rounds; once wrapped, the oldest sits
    at slot ``cursor % capacity``."""
    vec = [int(v) for v in digest]
    expected = 2 + len(TRACE_RECORD_FIELDS) * capacity
    if len(vec) != expected:
        raise ValueError(f"trace digest carries {len(vec)} values, expected {expected}")
    cursor, wraps = vec[0], vec[1]
    lanes = {
        field: vec[2 + i * capacity : 2 + (i + 1) * capacity]
        for i, field in enumerate(TRACE_RECORD_FIELDS)
    }
    held = min(cursor, capacity)
    start = cursor % capacity if cursor >= capacity else 0
    records = []
    for i in range(held):
        slot = (start + i) % capacity
        rec = {field: lanes[field][slot] for field in TRACE_RECORD_FIELDS}
        rec["seq"] = cursor - held + i
        records.append(rec)
    last = records[-1] if records else dict.fromkeys(TRACE_RECORD_FIELDS, 0)
    return {
        "capacity": capacity,
        "rounds_recorded": cursor,
        "wraps": wraps,
        "rounds_held": held,
        "decisions_held": sum(1 for r in records if r["path"]),
        "conflicts_held": sum(r["conflict"] for r in records),
        "last_round": last["round"],
        "last_epoch": last["epoch"],
        "last_active": last["active"],
        "last_path": last["path"],
        "last_undecided": last["undecided"],
        "records": records,
    }


def zero_trace_summary(capacity: int) -> Dict[str, Any]:
    """The empty ring's summary a driver holds before its first sync."""
    return trace_summary([0] * (2 + len(TRACE_RECORD_FIELDS) * capacity), capacity)


def first_divergent_round(a: Dict[str, Any], b: Dict[str, Any]) -> Optional[int]:
    """The global round ordinal (``seq``) of the first record where two
    decoded rings disagree over the overlap of their held windows, then the
    cursor frontier; None when they agree."""
    by_seq_a = {r["seq"]: r for r in a["records"]}
    by_seq_b = {r["seq"]: r for r in b["records"]}
    for seq in sorted(set(by_seq_a) & set(by_seq_b)):
        ra, rb = by_seq_a[seq], by_seq_b[seq]
        if any(ra[f] != rb[f] for f in TRACE_RECORD_FIELDS):
            return seq
    if a["rounds_recorded"] != b["rounds_recorded"]:
        # The first round the shorter run never executed is where the
        # histories fork.
        return min(a["rounds_recorded"], b["rounds_recorded"])
    return None


def trace_recorder_snapshot(
    summary: Dict[str, Any],
    node: str = "(engine)",
    t0_ms: float = 0.0,
    ms_per_round: float = 1.0,
    config_id: Optional[int] = None,
) -> Dict[str, Any]:
    """A decoded ring rendered as a flight-recorder snapshot dict, the
    per-node artifact ``tools/traceview.py`` merges, so device rounds join
    the host and ``(chaos)`` lanes of one timeline (the JAX package's
    function, event for event).

    Device rounds carry no wall clock: record ``seq`` lands at ``t0_ms +
    seq * ms_per_round`` on a :class:`~rapid_tpu_torch.utils.clock.ManualClock`.
    Every round emits one ``ENGINE_ROUND`` event; conflict rounds add
    ``ENGINE_CONFLICT`` and deciding rounds ``ENGINE_DECISION``."""
    from rapid_tpu_torch.utils.clock import ManualClock
    from rapid_tpu_torch.utils.flight_recorder import EventName, FlightRecorder

    clock = ManualClock()
    recorder = FlightRecorder(node, clock, capacity=max(1, summary["capacity"] * 3))
    for rec in summary["records"]:
        clock.advance_ms(t0_ms + rec["seq"] * ms_per_round - clock.now_ms())
        recorder.record(
            EventName.ENGINE_ROUND,
            config_id=config_id,
            seq=rec["seq"],
            round=rec["round"],
            epoch=rec["epoch"],
            active=rec["active"],
            alerts=rec["alerts"],
            proposals=rec["proposals"],
            undecided=rec["undecided"],
        )
        if rec["conflict"]:
            recorder.record(
                EventName.ENGINE_CONFLICT,
                config_id=config_id,
                seq=rec["seq"],
                epoch=rec["epoch"],
                undecided=rec["undecided"],
            )
        if rec["path"]:
            recorder.record(
                EventName.ENGINE_DECISION,
                config_id=config_id,
                seq=rec["seq"],
                epoch=rec["epoch"],
                path=TRACE_PATH_NAMES.get(rec["path"], str(rec["path"])),
                tally=rec["tally"],
            )
    snap = recorder.snapshot()
    # The ring dropped rounds before its window: report the true totals, so
    # "dropped" reads as rounds lost to wraparound.
    snap["recorded_total"] = summary["rounds_recorded"]
    snap["dropped"] = summary["rounds_recorded"] - summary["rounds_held"]
    return snap


# One function's block of ptxas's ``-v`` report.
_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_PROPERTIES = re.compile(r"Function properties for (\S+)")
_PTXAS_FRAME = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
)
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_PTXAS_CMEM = re.compile(r"(\d+) bytes cmem\[\d+\]")


def _kernel_label(mangled: str) -> str:
    """``delivery_new_bits_kernel<10, 1>`` from an Itanium-mangled kernel
    name with integer template arguments (the innermost name of a nested
    one, so an anonymous namespace drops out); the mangled name itself when
    it does not read so."""
    i = 2 if mangled.startswith("_Z") else 0
    if mangled[i : i + 1] == "N":
        i += 1
    ident = None
    while True:
        m = re.match(r"\d+", mangled[i:])
        if m is None:
            break
        start = i + m.end()
        ident, i = mangled[start : start + int(m.group())], start + int(m.group())
    if not ident:
        return mangled
    args = re.match(r"I((?:Li-?\d+E)+)E", mangled[i:])
    if args is None:
        return ident
    return f"{ident}<{', '.join(re.findall(r'Li(-?\d+)E', args.group(1)))}>"


def parse_ptxas_report(text: str) -> Dict[str, Dict[str, int]]:
    """Per entry function of a ptxas ``-v`` report: ``registers``,
    ``shared_bytes`` (static smem), ``spill_store_bytes``,
    ``spill_load_bytes``, ``stack_bytes`` and ``constant_bytes`` (the sum of
    the cmem banks listed; 0 where ptxas lists none), keyed by
    :func:`_kernel_label`."""
    entries: Dict[str, Dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        m = _PTXAS_ENTRY.search(line) or _PTXAS_PROPERTIES.search(line)
        if m is not None:
            current = m.group(1)
            if _PTXAS_ENTRY.search(line):
                entries.setdefault(current, {
                    "registers": 0, "shared_bytes": 0, "spill_store_bytes": 0,
                    "spill_load_bytes": 0, "stack_bytes": 0, "constant_bytes": 0,
                })
            continue
        facts = entries.get(current)
        if facts is None:
            continue
        frame = _PTXAS_FRAME.search(line)
        if frame is not None:
            facts["stack_bytes"], facts["spill_store_bytes"], facts["spill_load_bytes"] = (
                int(x) for x in frame.groups()
            )
        used = _PTXAS_USED.search(line)
        if used is not None:
            facts["registers"] = int(used.group(1))
            smem = _PTXAS_SMEM.search(line)
            facts["shared_bytes"] = int(smem.group(1)) if smem else 0
            facts["constant_bytes"] = sum(int(x) for x in _PTXAS_CMEM.findall(line))
    return {_kernel_label(name): facts for name, facts in entries.items()}


def compiled_memory_analysis(name: str) -> Optional[Dict[str, Dict[str, int]]]:
    """What ptxas reported for the built kernel ``csrc/<name>.cu``, per
    template instance (:func:`parse_ptxas_report`), read from the report
    ``_build`` keeps beside the ``.so`` (so a cached build still has it).
    The counterpart of the JAX package's per-executable memory analysis for
    what the port compiles. None for a name that is not a kernel source,
    for a kernel not built in this checkout, and for a report with no
    entry function."""
    from rapid_tpu_torch import _build

    if name not in _build.sources():
        return None
    path = _build.report_path(name)
    if not path.is_file():
        return None
    return parse_ptxas_report(path.read_text()) or None
