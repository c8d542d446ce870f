"""Host decoders of the device telemetry plane and the round-trace ring
(a copy of the digest vocabulary of ``rapid_tpu/utils/engine_telemetry.py``).

The digests (``models/virtual_cluster.py``: ``telemetry_digest``,
``trace_digest``) pack the device lanes into one int32 vector each; these
functions turn one fetched vector into the summary dicts the drivers cache.
They are pure host arithmetic and never touch the device. The JAX module's
compile and memory capture and its flight-recorder rendering are not
copied (ROADMAP.md Queue 1 items 15 and 16).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from rapid_tpu_torch.models.state import TELEMETRY_BUCKETS

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
