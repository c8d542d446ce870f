"""Append-only JSONL run ledger (a copy of ``rapid_tpu/utils/ledger.py``).

One JSON object per line, appended and flushed as it happens, so a killed
or wedged run leaves a complete prefix pointing at its last completed
stage. Event names come from :class:`LedgerEvent` and stage names from
:data:`STAGE_NAMES`, with the JAX package's values, and every line has the
JAX writer's shape::

    {"event": "stage_begin", "seq": 3, "pid": 123, "t_s": 12.345,
     "wall": "2026-08-03T12:00:00Z", "run_id": "...", "stage": "state_build",
     ...fields}

so a ledger written by either package reads the same in the other
(:func:`read_ledger`, :func:`last_completed_stage`, :func:`open_stage`).
The serving supervisor emits into any object with ``.emit(event,
stage=..., **fields)``, :class:`RunLedger` among them.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import time
from contextlib import contextmanager
from enum import Enum
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple


class LedgerEvent(Enum):
    """The registered run-ledger event vocabulary (renderers key off it)."""

    RUN_BEGIN = "run_begin"
    RUN_END = "run_end"
    RUN_FAIL = "run_fail"
    ATTEMPT_BEGIN = "attempt_begin"
    ATTEMPT_END = "attempt_end"
    STAGE_BEGIN = "stage_begin"
    STAGE_END = "stage_end"
    STAGE_FAIL = "stage_fail"
    HEARTBEAT_GAP = "heartbeat_gap"
    COMPILE_STATS = "compile_stats"
    DEVICE_MEMORY = "device_memory"
    WATCHDOG_KILL = "watchdog_kill"
    SNAPSHOT_REPLAY = "snapshot_replay"
    METRIC = "metric"
    # The serving runtime (serving/supervisor.py and recovery.py): retries,
    # deadline wedges, checkpoint writes and corruption fallbacks, resumes
    # and quarantines.
    RECOVERY_RETRY = "recovery_retry"
    RECOVERY_WEDGED = "recovery_wedged"
    RECOVERY_CHECKPOINT = "recovery_checkpoint"
    RECOVERY_CHECKPOINT_CORRUPT = "recovery_checkpoint_corrupt"
    RECOVERY_RESUME = "recovery_resume"
    RECOVERY_QUARANTINE = "recovery_quarantine"


#: Registered stage names (parameterize via fields — e.g. ``n=`` — never by
#: minting a new name): the vocabulary perfview's timeline and the parent
#: watchdog's per-stage budgets are defined over.
STAGE_NAMES = frozenset({
    "devices_init",
    "native_build",
    "ramp",
    "state_build",
    "warmup_compile",
    "timed_samples",
    "rtt_probe",
    "xl_point",
    "stretch_point",
    "loss_variant",
    "tenant_fleet",
    "stream",
    "chaos",
    "recovery",
    "hlo_audit",
    "profile",
})


def utc_stamp() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def git_head_rev(root: str) -> Optional[str]:
    """Short HEAD rev of the repo at ``root``, or None when unavailable."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=root, capture_output=True, text=True, timeout=10,
        ).stdout.strip()
        return out or None
    except (OSError, subprocess.TimeoutExpired):
        return None


def code_hash(root: str, paths: Sequence[str]) -> str:
    """Deterministic sha256 over the measurement-relevant source trees (the
    "hash roots"): every file's relative path + content, sorted, caches and
    compiled artifacts excluded. Unlike a bare git rev this survives
    evidence-only commits AND detects uncommitted edits — two ledgers with
    equal code hashes measured byte-identical code."""
    digest = hashlib.sha256()
    skip_dirs = {"__pycache__", ".git", "target", "build"}
    skip_suffixes = (".pyc", ".so", ".o")
    files: List[Path] = []
    for entry in paths:
        path = Path(root) / entry
        if path.is_file():
            files.append(path)
        elif path.is_dir():
            for sub in path.rglob("*"):
                if not sub.is_file():
                    continue
                if any(part in skip_dirs for part in sub.parts):
                    continue
                if sub.name.endswith(skip_suffixes):
                    continue
                files.append(sub)
    for path in sorted(files):
        rel = os.path.relpath(str(path), root)
        digest.update(rel.encode())
        digest.update(b"\0")
        try:
            digest.update(path.read_bytes())
        except OSError:
            digest.update(b"<unreadable>")
        digest.update(b"\0")
    return digest.hexdigest()[:16]


def provenance(root: str, hash_roots: Sequence[str]) -> Dict[str, Any]:
    """The attribution block every ``run_begin`` carries: git rev + code
    hash over the hash roots, so any number in the ledger can be traced to
    the exact source that produced it."""
    return {
        "git_rev": git_head_rev(root),
        "code_hash": code_hash(root, hash_roots),
        "hash_roots": list(hash_roots),
    }


class RunLedger:
    """Append-only JSONL event writer. Every ``emit`` validates its event
    (and stage) against the registered vocabularies and flushes the line —
    a wedged process's ledger is complete up to the wedge."""

    def __init__(self, path: str, run_id: Optional[str] = None,
                 t0: Optional[float] = None) -> None:
        self.path = str(path)
        self.run_id = run_id or f"run-{os.getpid()}-{int(time.time())}"
        #: ``t_s`` epoch on the monotonic clock. A run spanning several
        #: processes (watchdog parent + attempt children + a fallback
        #: continuation) passes the FIRST writer's epoch along with the
        #: run id, so every process's t_s lands on one shared timeline
        #: (CLOCK_MONOTONIC is system-wide per boot on the platforms this
        #: runs on).
        self.t0 = t0 if t0 is not None else time.monotonic()
        self._seq = 0
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        # Line-buffered append: one write syscall per line (atomic at these
        # sizes), so parent and child can share the file.
        self._file = open(self.path, "a", buffering=1)

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()

    def emit(self, event: LedgerEvent, stage: Optional[str] = None,
             **fields: Any) -> None:
        if not isinstance(event, LedgerEvent):
            raise TypeError(
                f"ledger events must be LedgerEvent members, got {event!r}"
            )
        if stage is not None and stage not in STAGE_NAMES:
            raise ValueError(
                f"unregistered ledger stage {stage!r}; add it to "
                f"rapid_tpu_torch.utils.ledger.STAGE_NAMES"
            )
        record: Dict[str, Any] = {
            "event": event.value,
            "seq": self._seq,
            "pid": os.getpid(),
            "t_s": round(time.monotonic() - self.t0, 3),
            "wall": utc_stamp(),
            "run_id": self.run_id,
        }
        if stage is not None:
            record["stage"] = stage
        record.update(fields)
        self._seq += 1
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    @contextmanager
    def stage(self, name: str, timeout_s: Optional[float] = None,
              **fields: Any):
        """One ledger-bracketed stage: ``stage_begin`` (carrying the
        caller's per-stage timeout so the watchdog parent can enforce it
        from the ledger alone), then ``stage_end`` with the measured
        duration — or ``stage_fail`` with the error, re-raised."""
        begin_fields = dict(fields)
        if timeout_s is not None:
            begin_fields["timeout_s"] = timeout_s
        self.emit(LedgerEvent.STAGE_BEGIN, stage=name, **begin_fields)
        start = time.monotonic()
        try:
            yield
        except BaseException as exc:
            self.emit(
                LedgerEvent.STAGE_FAIL, stage=name,
                duration_ms=round((time.monotonic() - start) * 1000.0, 3),
                error=repr(exc),
            )
            raise
        self.emit(
            LedgerEvent.STAGE_END, stage=name,
            duration_ms=round((time.monotonic() - start) * 1000.0, 3),
        )


def read_ledger(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """(events, skipped_lines). Tolerant by design: a torn final line (the
    process died mid-write) or foreign garbage is counted and skipped, never
    an exception — the ledger's whole point is being readable after a
    crash."""
    events: List[Dict[str, Any]] = []
    skipped = 0
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return [], 0
    for line in lines:
        if not line.strip():
            continue
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            skipped += 1
            continue
        if isinstance(record, dict) and "event" in record:
            events.append(record)
        else:
            skipped += 1
    return events, skipped


def last_completed_stage(events: Sequence[Dict[str, Any]]) -> Optional[str]:
    """The most recent ``stage_end``'s stage name — what a loud failure
    points at ("got through warmup_compile, died in timed_samples")."""
    for record in reversed(list(events)):
        if record.get("event") == LedgerEvent.STAGE_END.value:
            return record.get("stage")
    return None


def open_stage(events: Sequence[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The latest ``stage_begin`` without a matching ``stage_end``/
    ``stage_fail`` — the stage a wedged run is stuck in (the watchdog
    parent's per-stage-timeout input)."""
    open_begin: Optional[Dict[str, Any]] = None
    for record in events:
        event = record.get("event")
        if event == LedgerEvent.STAGE_BEGIN.value:
            open_begin = record
        elif event in (LedgerEvent.STAGE_END.value, LedgerEvent.STAGE_FAIL.value):
            if open_begin is not None and open_begin.get("stage") == record.get("stage"):
                open_begin = None
    return open_begin
