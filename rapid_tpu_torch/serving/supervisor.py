"""The self-healing supervision tier over the streaming pipeline (port of
``rapid_tpu/serving/supervisor.py``). Three disciplines over
:class:`~rapid_tpu_torch.serving.stream.StreamDriver`:

- **Deadline-bounded waits.** Every ticket wait (``submit`` backpressure,
  the ``drain`` sweep, the ``stream_fetch`` epoch read, the ``checkpoint``
  settle) gets a deadline from :class:`SupervisorBudgets`. The waiter polls
  the ticket's non-blocking ``is_ready`` between sleeps of the injected
  clock, so a wedged dispatch surfaces as :class:`DispatchWedgedError`
  naming the phase and wave, never an unbounded block. Every time decision
  reads the injected clock.
- **Retry with seeded-jitter exponential backoff.** Transient admission
  failures (:class:`TransientDispatchError`) retry on the
  :class:`BackoffPolicy` schedule, a pure function of its seed (the JAX
  package's delays for the same seed). Exhausted retries escalate to
  :class:`DispatchWedgedError`.
- **Crash-consistent checkpoints and quarantine.** Every
  ``checkpoint_every`` waves the supervisor writes an xxh64-sealed,
  atomically published checkpoint with the wave cursor
  (``utils/checkpoint.py``, the JAX package's file format);
  ``serving/recovery.py`` resumes from the newest valid one. For fleets,
  :meth:`Supervisor.scan_and_quarantine` runs the health reduction,
  quarantines poisoned tenants, exports a replayable repro and keeps the
  other tenants serving.

Recovery events go to an attached ledger (any object with
``.emit(event, stage=..., **fields)``) and to ``engine_recovery_*``
counters. :class:`SupervisorFaultPlan` injects every failure class the tier
must survive: fail the Nth submit, wedge or lose a wave's ticket, kill the
process between waves, corrupt or truncate a checkpoint.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np

from rapid_tpu_torch.serving.stream import FleetWave, StreamDriver, StreamResult, Ticket
from rapid_tpu_torch.utils.ledger import LedgerEvent


class SupervisorBudgets(NamedTuple):
    """The declared per-phase deadline table (milliseconds): how long each
    ticket-wait class may block before the supervisor declares the dispatch
    wedged. Defaults are far above any healthy dispatch, so a wedge is
    named in seconds, not discovered by a session timeout."""

    submit_ms: float = 60_000.0  # backpressure wait on the oldest ticket
    drain_ms: float = 120_000.0  # the drain sweep's per-ticket waits
    stream_fetch_ms: float = 60_000.0  # the epoch-fetch readiness wait
    checkpoint_ms: float = 120_000.0  # state settle before a checkpoint write

    def for_phase(self, phase: str) -> float:
        try:
            return float(getattr(self, f"{phase}_ms"))
        except AttributeError:
            raise ValueError(
                f"no deadline budget declared for phase {phase!r}; add a "
                f"<phase>_ms field to SupervisorBudgets"
            ) from None


class BackoffPolicy(NamedTuple):
    """Seeded-jitter exponential backoff: the whole retry-delay schedule is
    a pure function of ``seed`` (:meth:`delays_ms`), so a supervised run,
    retries included, replays bit-identically."""

    max_attempts: int = 4
    base_ms: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25  # fraction of the step added as seeded jitter
    seed: int = 0

    def delays_ms(self) -> Tuple[float, ...]:
        """The ``max_attempts - 1`` inter-attempt delays, in order."""
        rng = np.random.default_rng(self.seed)
        return tuple(
            self.base_ms
            * self.multiplier**attempt
            * (1.0 + self.jitter * float(rng.random()))
            for attempt in range(max(0, self.max_attempts - 1))
        )


class TransientDispatchError(RuntimeError):
    """A retryable PRE-DISPATCH admission failure: the supervisor retries
    it on the backoff schedule. Raised by the fault plan (and the class a
    real transient admission check — backend readiness, quota — should be
    translated to). Deliberately NOT caught around the wave application
    itself: once ``driver.submit`` starts, the churn delta may be
    half-applied, and re-running it would double-crash/double-join slots —
    a mid-application failure escalates instead of retrying."""


class DispatchWedgedError(RuntimeError):
    """A dispatch exceeded its phase deadline (or exhausted its retries):
    the supervision tier's loud terminal error, naming the phase and wave
    index so a wedge reads as "wave 7 wedged in submit backpressure", never
    a silent idle."""

    def __init__(self, phase: str, wave_index: int, reason: str) -> None:
        self.phase = phase
        self.wave_index = wave_index
        super().__init__(
            f"dispatch wedged: phase {phase!r}, wave {wave_index}: {reason}"
        )


class SimulatedProcessKill(RuntimeError):
    """The fault plan's between-waves process kill: raised AFTER the wave
    (and any due checkpoint) completed, exactly where SIGKILL would land in
    a real preemption. The recovery drill catches it and resumes from the
    checkpoint directory (serving/recovery.py)."""

    def __init__(self, wave_index: int) -> None:
        self.wave_index = wave_index
        super().__init__(f"simulated process kill after wave {wave_index}")


@dataclass(frozen=True)
class SupervisorFaultPlan:
    """Declarative, seed-free fault injection for the supervision seams
    (determinism rides the supervisor's own seeded backoff — the plan is a
    pure description). Wave indices are ABSOLUTE (they survive a resume's
    ``wave_offset``), matching the checkpoint meta cursor.

    - ``transient_submit``: ``(wave_index, failures)`` pairs — the wave's
      first ``failures`` submit attempts raise
      :class:`TransientDispatchError` (retry/backoff proof);
    - ``wedge_wave`` / ``lose_ticket_wave``: the wave's ticket never
      reports ready (a wedged dispatch / a dropped completion ticket) —
      the phase deadline fires (:class:`DispatchWedgedError` proof);
    - ``kill_after_wave``: :class:`SimulatedProcessKill` after the wave is
      fully submitted and any due checkpoint is written (resume proof);
    - ``corrupt_checkpoint_at`` / ``truncate_checkpoint_at``: the
      checkpoint whose CURSOR (waves submitted when written — the cadence
      multiples) equals the value is bit-flipped / truncated after the
      atomic publish (CheckpointCorruptError fallback proof: resume must
      skip it loudly and fall back to the previous valid one).
    """

    transient_submit: Tuple[Tuple[int, int], ...] = ()
    wedge_wave: Optional[int] = None
    lose_ticket_wave: Optional[int] = None
    kill_after_wave: Optional[int] = None
    corrupt_checkpoint_at: Optional[int] = None
    truncate_checkpoint_at: Optional[int] = None

    def submit_failures(self, wave_index: int) -> int:
        for wave, failures in self.transient_submit:
            if wave == wave_index:
                return failures
        return 0


class Supervisor:
    """Deadline-bounded, retrying, checkpointing front-end over a
    ``VirtualCluster`` or ``TenantFleet`` (module docstring). Owns a
    :class:`StreamDriver` with the bounded waiter installed; callers submit
    waves and drain exactly as they would the bare driver.

    ``wave_offset`` makes wave indices absolute across resumes: a resumed
    supervisor continues the killed run's numbering, so checkpoint cadence,
    fault plans, and ledger events all speak one timeline.
    """

    def __init__(
        self,
        target,
        *,
        rounds_per_wave: int = 8,
        depth: int = 2,
        budgets: Optional[SupervisorBudgets] = None,
        backoff: Optional[BackoffPolicy] = None,
        poll_ms: float = 2.0,
        checkpoint_dir=None,
        checkpoint_every: int = 0,
        checkpoint_keep: int = 2,
        wave_offset: int = 0,
        fault_plan: Optional[SupervisorFaultPlan] = None,
        ledger=None,
        ledger_stage: Optional[str] = None,
        clock=None,
        sleep=None,
    ) -> None:
        if checkpoint_every and checkpoint_dir is None:
            raise ValueError(
                "checkpoint_every needs a checkpoint_dir to write into"
            )
        if checkpoint_keep < 1:
            raise ValueError(f"checkpoint_keep must be >= 1, got {checkpoint_keep}")
        self.target = target
        self.budgets = budgets or SupervisorBudgets()
        self.backoff = backoff or BackoffPolicy()
        self._delays_ms = self.backoff.delays_ms()
        self.poll_ms = float(poll_ms)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.checkpoint_keep = int(checkpoint_keep)
        self.wave_offset = int(wave_offset)
        self.fault_plan = fault_plan
        self._ledger = ledger
        self._ledger_stage = ledger_stage
        #: Injected decision clock (seconds, monotonic) and sleep — the
        #: supervision tier's ONLY time sources; tests drive fake ones.
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else time.sleep
        self.driver = StreamDriver(
            target, rounds_per_wave=rounds_per_wave, depth=depth,
            clock=self._clock, ticket_wait=self._bounded_wait,
            ticket_ready=self._fault_aware_ready,
        )
        self.checkpoints_written = 0
        self.last_checkpoint_wave: Optional[int] = None
        self.last_resume_ms: Optional[float] = None
        # The target carries its supervisor (the JAX package's telemetry
        # snapshot reads it as the engine.recovery section).
        target.recovery = self

    # -- the supervised pipeline ----------------------------------------

    @property
    def waves_submitted(self) -> int:
        """Absolute wave count (offset + this supervisor's submissions)."""
        return self.wave_offset + self.driver.waves_submitted

    def submit(self, wave) -> None:
        """Submit one wave with retry/backoff for transient failures and
        deadline-bounded backpressure; write the cadence checkpoint; then
        honor any fault-plan kill (SimulatedProcessKill lands exactly where
        a real preemption would — after the durable state is published)."""
        w = self.waves_submitted
        wave = self._filter_quarantined(wave)
        # Retry/backoff wraps ONLY the pre-application admission gate: the
        # wave's churn delta has not touched device state yet, so a retry
        # is a pure re-attempt. driver.submit itself runs exactly once —
        # retrying a half-applied wave would double-apply its delta (see
        # TransientDispatchError).
        for attempt in range(self.backoff.max_attempts):
            try:
                self._admission_gate(w, attempt)
                break
            except TransientDispatchError as exc:
                self.target.metrics.inc("engine_recovery_retries")
                self._emit(
                    LedgerEvent.RECOVERY_RETRY, phase="submit", wave=w,
                    attempt=attempt, error=str(exc),
                )
                if attempt + 1 >= self.backoff.max_attempts:
                    self.target.metrics.inc("engine_recovery_wedges")
                    self._emit(
                        LedgerEvent.RECOVERY_WEDGED, phase="submit", wave=w,
                        reason="retries-exhausted",
                    )
                    raise DispatchWedgedError(
                        "submit", w,
                        f"retries exhausted after {attempt + 1} attempts: {exc}",
                    ) from exc
                self._sleep(self._delays_ms[attempt] / 1000.0)
        self.driver.submit(wave)
        if (
            self.checkpoint_every
            and (w + 1) % self.checkpoint_every == 0
        ):
            self.checkpoint()
        if self.fault_plan is not None and self.fault_plan.kill_after_wave == w:
            raise SimulatedProcessKill(w)

    def drain(self) -> StreamResult:
        """Drain the pipeline (every ticket wait deadline-bounded under the
        ``drain`` budget) and return the stream report."""
        return self.driver.drain()

    # -- deadline-bounded waiting ---------------------------------------

    def _presumed_lost(self, wave_index: int) -> bool:
        """True when the fault plan declares this (absolute) wave's
        completion ticket wedged or lost."""
        plan = self.fault_plan
        absolute = self.wave_offset + wave_index
        return plan is not None and (
            plan.wedge_wave == absolute or plan.lose_ticket_wave == absolute
        )

    def _fault_aware_ready(self, wave_index: int, ticket) -> bool:
        """The reaper's readiness probe: a plan-wedged/lost ticket is
        never ready — it must survive opportunistic reaping at any
        pipeline depth and reach the bounded wait, where the deadline
        fires loudly (without this, depth>1 would reap the wave through
        the REAL probe and silently bypass the injected fault)."""
        if self._presumed_lost(wave_index):
            return False
        return ticket.is_ready()

    def _bounded_wait(self, phase: str, wave_index: int, ticket) -> None:
        """The waiter installed into the stream driver: poll the ticket's
        ``is_ready`` probe between injected-clock sleeps; past the phase's
        declared budget, raise :class:`DispatchWedgedError` naming phase +
        wave. Wave indices in the error are ABSOLUTE (driver-relative index
        + wave_offset)."""
        absolute = self.wave_offset + wave_index
        plan = self.fault_plan
        # The injected wedge/lost-ticket targets COMPLETION-ticket waits
        # (backpressure and the drain sweep — the waits that carry a real
        # per-wave ticket); epoch fetches reuse the wave counter as a label
        # and must not trip a fault aimed at a wave's ticket.
        presumed_lost = (
            phase in ("submit", "drain") and self._presumed_lost(wave_index)
        )
        budget_ms = self.budgets.for_phase(phase)
        t0 = self._clock()
        while True:
            if not presumed_lost and ticket.is_ready():
                ticket.wait()
                return
            waited_ms = (self._clock() - t0) * 1000.0
            if waited_ms >= budget_ms:
                reason = (
                    "completion ticket lost"
                    if plan is not None and plan.lose_ticket_wave == absolute
                    else f"no completion after {waited_ms:.0f} ms "
                         f"(budget {budget_ms:.0f} ms)"
                )
                self.target.metrics.inc("engine_recovery_wedges")
                self._emit(
                    LedgerEvent.RECOVERY_WEDGED, phase=phase, wave=absolute,
                    waited_ms=round(waited_ms, 3), budget_ms=budget_ms,
                )
                raise DispatchWedgedError(phase, absolute, reason)
            self._sleep(
                min(self.poll_ms, max(0.0, budget_ms - waited_ms)) / 1000.0
            )

    # -- checkpoints -----------------------------------------------------

    def checkpoint(self):
        """Write one crash-consistent checkpoint at the current wave
        boundary (a deliberate sync point: materializing the state waits
        for every enqueued dispatch — bounded under the ``checkpoint``
        budget first, so a wedged pipeline cannot masquerade as a slow
        write). Prunes to ``checkpoint_keep`` newest files; returns the
        published path."""
        from rapid_tpu_torch.serving import recovery

        if self.checkpoint_dir is None:
            raise ValueError(
                "checkpoint() needs a checkpoint_dir (pass one at "
                "construction, with or without a cadence)"
            )
        wave_index = self.waves_submitted
        self._bounded_wait(
            "checkpoint", wave_index - self.wave_offset, Ticket(self.target.device)
        )
        path = recovery.write_checkpoint(
            self.checkpoint_dir, self.target, wave_index,
            rounds_per_wave=self.driver.rounds_per_wave,
            depth=self.driver.depth, keep=self.checkpoint_keep,
        )
        self.checkpoints_written += 1
        self.last_checkpoint_wave = wave_index
        self.target.metrics.inc("engine_recovery_checkpoints")
        self._emit(
            LedgerEvent.RECOVERY_CHECKPOINT, wave=wave_index, path=str(path),
        )
        plan = self.fault_plan
        if plan is not None and plan.corrupt_checkpoint_at == wave_index:
            _damage_file(path, truncate=False)
        if plan is not None and plan.truncate_checkpoint_at == wave_index:
            _damage_file(path, truncate=True)
        return path

    # -- quarantine (fleet targets) --------------------------------------

    def scan_and_quarantine(self, repro_dir=None):
        """Run the device-side health reduction over a fleet target and
        quarantine every newly-poisoned tenant (TenantFleet.quarantine: the
        per-tenant freeze lanes of the wave loop). The fleet's step keeps
        running a quarantined tenant's rounds, so the supervisor also stops
        feeding it churn and the stream's cut accounting masks its epochs
        out; the other tenants are untouched either way. With
        ``repro_dir`` set, each quarantined tenant is exported as a
        replayable repro directory holding its state AT DETECTION
        (serving/recovery.py; the JAX package's ``chaosrun replay`` reads
        it). Returns the newly-quarantined tenant indices; single-cluster
        targets have no tenant axis and scan as an empty list."""
        scan = getattr(self.target, "health_scan", None)
        if scan is None:
            return []
        poisoned = scan()
        already = set(self.target.quarantined)
        fresh = [
            int(t) for t in np.nonzero(poisoned)[0].tolist()
            if int(t) not in already
        ]
        if not fresh:
            return []
        self.target.quarantine(fresh)
        for t in fresh:
            violations = self.target.tenant_health_report(t)
            self.target.metrics.inc("engine_recovery_quarantines")
            self._emit(
                LedgerEvent.RECOVERY_QUARANTINE, tenant=t,
                violations=violations,
            )
            if repro_dir is not None:
                from rapid_tpu_torch.serving import recovery

                recovery.write_quarantine_repro(
                    repro_dir, self.target, t, violations
                )
        return fresh

    # -- observability ----------------------------------------------------

    def snapshot(self) -> dict:
        """The ``engine.recovery`` telemetry section, the JAX package's
        dict (its exposition renders the gauges as
        ``rapid_engine_recovery_*``); None until a value exists, so the key
        set is the same from attach."""
        counters = self.target.metrics.counters
        return {
            "waves_submitted": self.waves_submitted,
            "checkpoint_every": self.checkpoint_every,
            "checkpoints_written": self.checkpoints_written,
            "last_checkpoint_wave": self.last_checkpoint_wave,
            "retries": int(counters.get("engine_recovery_retries", 0)),
            "wedges": int(counters.get("engine_recovery_wedges", 0)),
            "resumes": int(counters.get("engine_recovery_resumes", 0)),
            "quarantined": len(getattr(self.target, "quarantined", ())),
            "mttr_ms": (
                round(self.last_resume_ms, 3)
                if self.last_resume_ms is not None else None
            ),
        }

    # -- internals --------------------------------------------------------

    def _admission_gate(self, wave_index: int, attempt: int) -> None:
        """The retryable pre-dispatch seam: raises TransientDispatchError
        while the wave may not proceed. Today the fault plan's injection
        point; a real deployment's transient admission checks (backend
        readiness, quota) belong here — BEFORE any state mutates."""
        if (
            self.fault_plan is not None
            and attempt < self.fault_plan.submit_failures(wave_index)
        ):
            raise TransientDispatchError(
                f"injected transient failure (wave {wave_index}, "
                f"attempt {attempt})"
            )

    def _filter_quarantined(self, wave):
        """Stop feeding churn to quarantined tenants: their freeze is the
        wave-path done lane, and new fault deltas for a frozen tenant would
        sit unresolved forever (and muddy the repro). Other tenants' pairs
        pass through untouched."""
        quarantined = set(getattr(self.target, "quarantined", ()))
        if not quarantined or not isinstance(wave, FleetWave):
            return wave
        kept = tuple(p for p in wave.crash if p[0] not in quarantined)
        if len(kept) != len(wave.crash):
            self.target.metrics.inc(
                "engine_recovery_quarantine_dropped_events",
                len(wave.crash) - len(kept),
            )
        return FleetWave(crash=kept)

    def _emit(self, event: LedgerEvent, **fields) -> None:
        if self._ledger is not None:
            self._ledger.emit(event, stage=self._ledger_stage, **fields)


def _damage_file(path, truncate: bool) -> None:
    """The fault plan's checkpoint damage: truncate to half, or flip one
    payload byte (both must surface as CheckpointCorruptError on load)."""
    data = bytearray(path.read_bytes())
    if truncate:
        path.write_bytes(bytes(data[: len(data) // 2]))
    else:
        data[len(data) // 2] ^= 0xFF
        path.write_bytes(bytes(data))


__all__ = [
    "BackoffPolicy",
    "DispatchWedgedError",
    "SimulatedProcessKill",
    "Supervisor",
    "SupervisorBudgets",
    "SupervisorFaultPlan",
    "TransientDispatchError",
]
