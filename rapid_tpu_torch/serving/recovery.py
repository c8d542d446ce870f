"""Crash-consistent checkpoint/resume and quarantine export for the
supervised serving pipeline (port of ``rapid_tpu/serving/recovery.py``).

The whole serving target is one set of lanes and the churn source is a pure
function of its seed, so resume is deterministic REPLAY: load the newest
valid checkpoint (corrupt files skipped and logged, never trusted), rebuild
the supervisor, fast-forward the seeded churn schedule to the checkpointed
wave cursor and replay the rest. Final state, cuts and config ids come out
equal to a run that was never killed, for the ``VirtualCluster`` and the
``TenantFleet`` alike.

Checkpoint files are ``ckpt_w<cursor>.npz`` under one directory, written by
:func:`write_checkpoint` (xxh64-sealed, atomic tmp+rename, the JAX
package's format: ``utils/checkpoint.py``) and pruned to the newest few;
the meta block carries the wave cursor and pipeline shape, so
:func:`resume` rebuilds the supervisor from the directory alone. A
directory written by either package resumes in the other.

Quarantine export: :func:`write_quarantine_repro` writes a poisoned tenant
as a single-tenant repro directory (its state slice plus the health-report
violations) that :func:`replay_quarantine_repro` re-runs: the scan must
reproduce the recorded violations.
"""

from __future__ import annotations

import json
import logging
import re
import time
from pathlib import Path
from typing import List, Optional, Tuple

from rapid_tpu_torch.models.state import map_lanes
from rapid_tpu_torch.utils.checkpoint import (
    CheckpointCorruptError,
    load_serving_state,
    save_serving_state,
)
from rapid_tpu_torch.utils.ledger import LedgerEvent

LOG = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"ckpt_w(\d+)\.npz$")


def _checkpoint_path(directory, wave_index: int) -> Path:
    return Path(directory) / f"ckpt_w{wave_index:08d}.npz"


def _checkpoints(directory: Path, newest_first: bool = False) -> List[Path]:
    return sorted(
        (p for p in directory.iterdir() if _CKPT_RE.search(p.name)),
        key=lambda p: int(_CKPT_RE.search(p.name).group(1)),
        reverse=newest_first,
    )


def write_checkpoint(
    directory,
    target,
    wave_index: int,
    *,
    rounds_per_wave: int,
    depth: int,
    keep: int = 2,
) -> Path:
    """Publish one serving checkpoint at the given ABSOLUTE wave cursor and
    prune older files down to ``keep`` (the survivors are the fallback
    chain: a damaged newest checkpoint must leave a valid predecessor)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    knobs = getattr(target, "knobs", None)
    meta = {
        "wave_index": int(wave_index),
        "rounds_per_wave": int(rounds_per_wave),
        "depth": int(depth),
        "kind": "fleet" if knobs is not None else "cluster",
    }
    path = _checkpoint_path(directory, wave_index)
    save_serving_state(
        path, target.cfg, target.state, target.faults, knobs=knobs, meta=meta
    )
    for stale in _checkpoints(directory)[:-keep]:
        stale.unlink()
    return path


def latest_valid_checkpoint(
    directory, device=None
) -> Tuple[Optional[Path], Optional[tuple], List[Path]]:
    """``(path, loaded, corrupt)``: the newest checkpoint that passes its
    integrity checks, with its ``load_serving_state`` tuple already loaded
    onto ``device`` (so :func:`resume` never loads twice), plus the corrupt
    files skipped on the way down (newest first). Corruption is a logged
    fallback, never a crash."""
    directory = Path(directory)
    if not directory.is_dir():
        return None, None, []
    corrupt: List[Path] = []
    for path in _checkpoints(directory, newest_first=True):
        try:
            loaded = load_serving_state(path, device)
        except CheckpointCorruptError as exc:
            LOG.error("checkpoint %s is corrupt, falling back: %s", path, exc)
            corrupt.append(path)
            continue
        return path, loaded, corrupt
    return None, None, corrupt


def resume(
    checkpoint_dir,
    *,
    budgets=None,
    backoff=None,
    poll_ms: float = 2.0,
    checkpoint_every: Optional[int] = None,
    checkpoint_keep: int = 2,
    fault_plan=None,
    ledger=None,
    ledger_stage: Optional[str] = None,
    clock=None,
    sleep=None,
    device=None,
):
    """Resume a killed supervised run from its checkpoint directory: rebuild
    the serving target (cluster or fleet; the checkpoint says which) on
    ``device`` (CUDA unless named), attach a
    :class:`~rapid_tpu_torch.serving.supervisor.Supervisor` with the
    checkpointed pipeline shape and the ABSOLUTE wave offset, and return
    ``(supervisor, wave_index)``. The caller fast-forwards its seeded churn
    source by ``wave_index`` waves (:func:`fast_forward`) and replays the
    rest.

    The resume's duration, checkpoint load through supervisor attach on the
    injected clock, lands on ``supervisor.last_resume_ms`` (the MTTR) and
    in the ``RECOVERY_RESUME`` ledger event. Corrupt newest checkpoints are
    skipped with ``RECOVERY_CHECKPOINT_CORRUPT`` events; no valid
    checkpoint at all raises FileNotFoundError."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
    from rapid_tpu_torch.serving.supervisor import Supervisor
    from rapid_tpu_torch.tenancy.fleet import TenantFleet

    read_clock = clock if clock is not None else time.monotonic  # wall-clock-ok: default MTTR clock when none injected
    t0 = read_clock()
    path, loaded, corrupt = latest_valid_checkpoint(checkpoint_dir, device)
    if ledger is not None:
        for bad in corrupt:
            ledger.emit(
                LedgerEvent.RECOVERY_CHECKPOINT_CORRUPT,
                stage=ledger_stage, path=str(bad),
            )
    if path is None:
        raise FileNotFoundError(
            f"no valid checkpoint under {checkpoint_dir!s} "
            f"({len(corrupt)} corrupt file(s) skipped) — nothing to resume "
            f"from; restart the stream from scratch"
        )
    cfg, state, faults, knobs, meta = loaded
    if knobs is not None:
        target = TenantFleet(cfg, state, faults, knobs)
    else:
        target = VirtualCluster(cfg, state)
        target.faults = faults
    wave_index = int(meta["wave_index"])
    supervisor = Supervisor(
        target,
        rounds_per_wave=int(meta["rounds_per_wave"]),
        depth=int(meta["depth"]),
        budgets=budgets,
        backoff=backoff,
        poll_ms=poll_ms,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=(
            int(checkpoint_every) if checkpoint_every is not None else 0
        ),
        checkpoint_keep=checkpoint_keep,
        wave_offset=wave_index,
        fault_plan=fault_plan,
        ledger=ledger,
        ledger_stage=ledger_stage,
        clock=clock,
        sleep=sleep,
    )
    supervisor.last_resume_ms = (read_clock() - t0) * 1000.0
    target.metrics.inc("engine_recovery_resumes")
    if ledger is not None:
        ledger.emit(
            LedgerEvent.RECOVERY_RESUME, stage=ledger_stage,
            wave=wave_index, checkpoint=str(path),
            mttr_ms=round(supervisor.last_resume_ms, 3),
            corrupt_skipped=len(corrupt),
        )
    return supervisor, wave_index


def fast_forward(churn, waves: int):
    """Advance a seeded churn generator past the checkpointed waves: the
    schedule is a pure function of its seed, so discarding ``waves`` draws
    reproduces exactly the deltas the killed run already applied. Returns
    the generator."""
    for _ in range(int(waves)):
        churn.wave()
    return churn


# ---------------------------------------------------------------------------
# Quarantine repro export / replay
# ---------------------------------------------------------------------------


def write_quarantine_repro(directory, fleet, tenant: int, violations) -> Path:
    """Export one quarantined tenant as a replayable single-tenant repro
    directory: its state and fault slice and knob lanes (a ``[1]``-stacked
    fleet checkpoint, so the poison travels with the repro) and the
    health-report violations. ``fleet.json`` carries the
    ``kind: "quarantine"`` marker."""
    directory = Path(directory) / f"tenant{tenant}"
    directory.mkdir(parents=True, exist_ok=True)

    def slice_lanes(tree):
        return map_lanes(lambda x: x[tenant : tenant + 1], tree)

    save_serving_state(
        directory / "state.npz",
        fleet.cfg,
        slice_lanes(fleet.state),
        slice_lanes(fleet.faults),
        knobs=slice_lanes(fleet.knobs),
        meta={"kind": "quarantine", "tenant_index": int(tenant)},
    )
    (directory / "fleet.json").write_text(json.dumps({
        "version": 1,
        "kind": "quarantine",
        "tenant_index": int(tenant),
        "fleet_size": int(fleet.b),
        "violations": list(violations),
    }, indent=1) + "\n")
    # violations.txt holds what a replay sees: the slice is a single-tenant
    # fleet, so its report names tenant 0 (fleet.json keeps the original).
    verified = replay_quarantine_repro(directory, fleet.device)
    (directory / "violations.txt").write_text(
        "".join(f"{v}\n" for v in verified) or "(none)\n"
    )
    return directory


def replay_quarantine_repro(directory, device=None) -> List[str]:
    """Re-run a quarantine repro on ``device`` (CUDA unless named): load the
    single-tenant fleet slice and re-run the health scan and report; the
    recorded violations must reproduce."""
    from rapid_tpu_torch.tenancy.fleet import TenantFleet

    directory = Path(directory)
    cfg, state, faults, knobs, _meta = load_serving_state(directory / "state.npz", device)
    if knobs is None:
        raise CheckpointCorruptError(
            f"{directory}: quarantine repro lacks the knob lanes (not a "
            f"fleet slice)"
        )
    fleet = TenantFleet(cfg, state, faults, knobs)
    poisoned = fleet.health_scan()
    if not bool(poisoned[0]):
        return []
    return fleet.tenant_health_report(0)


__all__ = [
    "fast_forward",
    "latest_valid_checkpoint",
    "replay_quarantine_repro",
    "resume",
    "write_checkpoint",
    "write_quarantine_repro",
]
