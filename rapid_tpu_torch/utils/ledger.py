"""The run-ledger event vocabulary (a copy of ``LedgerEvent`` from
``rapid_tpu/utils/ledger.py``, with the same member values).

The port has no ledger writer of its own: the serving supervisor emits into
any object with ``.emit(event, stage=..., **fields)``, the JAX package's
``RunLedger`` among them, so a recovery timeline reads the same whichever
package wrote it.
"""

from __future__ import annotations

from enum import Enum


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
