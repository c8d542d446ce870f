"""The streaming dispatch pipeline (port of ``rapid_tpu/serving/stream.py``):
rounds queued on the card wave after wave, the host building the next wave
while the card runs the last, and the host waiting only at explicit fetch
boundaries.

The batch drivers run build -> upload -> converge -> read, and the single
cluster's batch round reads the host two or three times a round.
:class:`StreamDriver` restructures the loop for a continuous churn stream:

- **Queued rounds.** Each submitted wave applies its churn delta (scatters on
  the device; only slot indices cross to it) and queues ``rounds_per_wave``
  rounds through the target's ``stream_step``, which makes no host read.
  PyTorch launches asynchronously, so the host returns at once and builds
  the next wave while the card runs this one.
- **Double-buffered uploads.** A wave's slot indices are copied into a fresh
  pinned host buffer and uploaded with ``non_blocking=True``
  (``rapid_tpu_torch._host.upload``): a pageable upload would synchronize
  the stream and wait for every wave still in flight. Each buffer stays
  referenced with its wave's ticket until that ticket completes, so the host
  never reuses memory a queued copy still reads.
- **Explicit fetch boundaries.** The host waits only on completion tickets
  (:class:`Ticket`: a CUDA event recorded after the wave's last round) and
  at the drain's one read of the summed epoch, both under the
  ``stream_fetch`` dispatch phase. Overlap efficiency is the share of the
  stream's wall time the host did NOT spend there.

:class:`PoissonChurn` supplies the traffic: a seeded arrival process drawn
wave by wave with numpy (one ``default_rng(seed)``, the JAX package's
draws, so a seed gives the same schedule in both packages), in the sim
families' fault vocabulary (:func:`waves_from_schedule`).

A schedule driven wave by wave through the driver gives the cuts, config
ids and final state of the same schedule driven through the batch seams:
the streamed round equals the batch round lane for lane, and only the
synchronization differs.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rapid_tpu_torch import _host
from rapid_tpu_torch.sim.faults import FaultEvent
from rapid_tpu_torch.utils.histogram import LogHistogram

#: The subset of the sim fault vocabulary the streaming pipeline carries:
#: membership churn. Environment faults (loss, delay, partitions) ride the
#: engine's delivery knobs instead (sim.faults.loss_as_engine_delivery) —
#: they are configuration, not per-wave traffic.
STREAMABLE_KINDS = frozenset({"crash", "join"})


@dataclass(frozen=True)
class StreamWave:
    """One wave of single-cluster churn: slots to crash and fresh slots to
    admit, applied together before the wave's engine rounds."""

    crash: Tuple[int, ...] = ()
    join: Tuple[int, ...] = ()

    def fault_events(self) -> List[FaultEvent]:
        """This wave in the sim families' fault vocabulary, the exact
        inverse of :func:`waves_from_schedule`, so a stream schedule is a
        chaos schedule. A wave carrying
        both deltas emits them OVERLAPPED (``settle=False`` on all but the
        last event): one wave applies its whole delta before any engine
        round, which is precisely the schedule's no-convergence-between
        shape.

        An EMPTY wave — pure pacing, ``rounds_per_wave`` engine rounds with
        no churn (Poisson emits one whenever a draw lands on k=0) — is
        rejected loudly: the schedule grammar forbids membership events
        without slots, so the wave has no spelling, and silently dropping
        it would replay FEWER engine rounds than the stream ran — a
        different scenario (failure-detector counters advance per round).
        Filter pacing waves out explicitly if round counts do not matter to
        the replay."""
        if not (self.crash or self.join):
            raise ValueError(
                "an empty wave has no sim-vocabulary spelling (the schedule "
                "grammar forbids membership events without slots), and "
                "dropping it would replay fewer engine rounds than the "
                "stream ran; filter pacing waves explicitly if round counts "
                "do not matter to the replay"
            )
        events = []
        if self.crash:
            events.append(FaultEvent(
                kind="crash", slots=tuple(self.crash),
                settle=not self.join,
            ))
        if self.join:
            events.append(FaultEvent(kind="join", slots=tuple(self.join)))
        return events


@dataclass(frozen=True)
class FleetWave:
    """One wave of fleet churn: ``(tenant, slot)`` crash pairs (fleet
    streaming carries crash churn; joins need per-tenant gatekeeper
    derivation, a pre-stacking ``VirtualCluster`` operation)."""

    crash: Tuple[Tuple[int, int], ...] = ()


def waves_from_schedule(schedule) -> List[StreamWave]:
    """Convert a sim ``FaultSchedule`` (or an iterable of ``FaultEvent``)
    into stream waves, one wave per SETTLED membership event in schedule
    order: an event marked ``settle=False`` overlaps with its successor, so
    it folds into the successor's wave (the wave's whole delta applies
    before any engine round — the schedule's no-convergence-between shape,
    preserved rather than serialized away). Everything the stream cannot
    represent is rejected loudly — kinds outside :data:`STREAMABLE_KINDS`
    and nonzero ``dwell_ms`` (waves advance in engine rounds, not simulated
    milliseconds): silently dropping either would stream a DIFFERENT
    scenario than the schedule describes."""
    events = getattr(schedule, "events", schedule)
    waves: List[StreamWave] = []
    crash: List[int] = []
    join: List[int] = []
    for event in events:
        if event.kind not in STREAMABLE_KINDS:
            raise ValueError(
                f"fault kind {event.kind!r} is not streamable (only "
                f"{sorted(STREAMABLE_KINDS)} carry per-wave deltas); "
                f"environment faults compile onto engine delivery knobs "
                f"(rapid_tpu_torch.sim.faults.loss_as_engine_delivery)"
            )
        if getattr(event, "dwell_ms", 0.0):
            raise ValueError(
                f"dwell_ms={event.dwell_ms!r} is not streamable: the "
                f"pipeline advances in engine rounds (rounds_per_wave), "
                f"not simulated milliseconds — zero the dwell or replay "
                f"the schedule through the sim harness instead"
            )
        if event.kind == "crash":
            crash.extend(event.slots)
        else:
            join.extend(event.slots)
        if getattr(event, "settle", True):
            waves.append(StreamWave(crash=tuple(crash), join=tuple(join)))
            crash, join = [], []
    if crash or join:
        # A trailing settle=False event has nothing to overlap with; it
        # still needs its engine rounds, so it closes the final wave.
        waves.append(StreamWave(crash=tuple(crash), join=tuple(join)))
    return waves


class PoissonChurn:
    """Seeded Poisson arrival process over the engine's slot table.

    Each wave draws ``k ~ Poisson(rate)`` churn events; each event is a
    join of a fresh slot with probability ``join_fraction`` (while fresh
    slots remain — the generator never reuses a slot, which is what lets
    the stream driver skip the admissibility fetch) or a crash of a live
    member. The whole schedule is a pure function of ``seed``.
    """

    def __init__(
        self,
        n_members: int,
        n_slots: int,
        rate: float,
        seed: int = 0,
        join_fraction: float = 0.5,
    ) -> None:
        if rate <= 0:
            raise ValueError(f"arrival rate must be positive, got {rate}")
        if not 0.0 <= join_fraction <= 1.0:
            raise ValueError(f"join_fraction must be in [0, 1], got {join_fraction}")
        if not 0 < n_members <= n_slots:
            raise ValueError(
                f"need 0 < n_members <= n_slots, got {n_members}/{n_slots}"
            )
        self.rate = float(rate)
        self._rng = np.random.default_rng(seed)
        # Host-side slot bookkeeping mirrors the engine's lifecycle rules:
        # crash candidates are the original members still standing (a
        # joiner may still be pending admission — crashing it would model a
        # different scenario than "churn on members"); joins pop fresh
        # slots and never reuse one (the engine's UUIDAlreadySeenError).
        self._live: List[int] = list(range(n_members))
        self._fresh: Deque[int] = deque(range(n_members, n_slots))
        self.join_fraction = float(join_fraction)

    def wave(self) -> StreamWave:
        crash: List[int] = []
        join: List[int] = []
        for _ in range(int(self._rng.poisson(self.rate))):
            wants_join = self._fresh and (
                float(self._rng.random()) < self.join_fraction
            )
            if wants_join:
                join.append(self._fresh.popleft())
            elif self._live:
                victim = int(self._rng.integers(len(self._live)))
                crash.append(self._live.pop(victim))
        return StreamWave(crash=tuple(crash), join=tuple(join))

    def waves(self, count: int) -> List[StreamWave]:
        return [self.wave() for _ in range(count)]

    @classmethod
    def fleet(
        cls,
        tenants: int,
        n_members: int,
        rate: float,
        seed: int = 0,
    ) -> "FleetPoissonChurn":
        """The fleet-shaped generator: independent per-tenant Poisson crash
        streams folded into per-wave ``(tenant, slot)`` pair sets."""
        return FleetPoissonChurn(tenants, n_members, rate, seed)


class FleetPoissonChurn:
    """B independent per-tenant Poisson crash streams (one seeded rng,
    tenant-ordered draws — deterministic per seed), emitting
    :class:`FleetWave` pair sets."""

    def __init__(self, tenants: int, n_members: int, rate: float, seed: int = 0):
        if tenants <= 0:
            raise ValueError(f"need at least one tenant, got {tenants}")
        if rate <= 0:
            raise ValueError(f"arrival rate must be positive, got {rate}")
        self.rate = float(rate)
        self._rng = np.random.default_rng(seed)
        self._live: List[List[int]] = [
            list(range(n_members)) for _ in range(tenants)
        ]

    def wave(self) -> FleetWave:
        pairs: List[Tuple[int, int]] = []
        for tenant, live in enumerate(self._live):
            for _ in range(int(self._rng.poisson(self.rate))):
                if not live:
                    break
                victim = int(self._rng.integers(len(live)))
                pairs.append((tenant, live.pop(victim)))
        return FleetWave(crash=tuple(pairs))

    def waves(self, count: int) -> List[FleetWave]:
        return [self.wave() for _ in range(count)]


class StreamResult(NamedTuple):
    """Drain-time stream report (cumulative since driver construction)."""

    waves: int  # waves submitted
    rounds: int  # engine rounds enqueued (waves * rounds_per_wave)
    cuts: int  # view changes committed (config-epoch delta, fetched once)
    wall_ms: float  # first submit -> drain completion
    view_changes_per_sec: float  # cuts over wall (0.0 on zero-wave/zero-elapsed drains)
    p99_alert_to_commit_ms: Optional[float]  # submit -> observed-complete p99
    overlap_efficiency: Optional[float]  # 1 - fetch-blocked/wall, in [0, 1]
    fetch_blocked_ms: float  # host time in stream_fetch (the un-overlapped part)
    h2d_bytes: int  # bytes uploaded during the stream (delta deltas + indices)


def _stream_fetch_ms(metrics) -> float:
    """Total host-blocked milliseconds in the ``stream_fetch`` phase, read
    from the shared ``engine_dispatch_ms`` histogram family — the overlap
    ratio's denominator input comes from the SAME instrument dashboards
    render, so the published number is checkable from any scrape."""
    family = metrics.phase_timings.get("engine_dispatch", {})
    hist = family.get("stream_fetch")
    if hist is None or not hist.count:
        return 0.0
    return float(hist.summary()["sum"])


class Ticket:
    """A completion ticket: on a card, a CUDA event recorded on the current
    stream when the ticket is made, so it completes when everything queued
    before it has run. :meth:`is_ready` is the non-blocking probe
    (``Event.query``), :meth:`wait` the blocking wait
    (``Event.synchronize``). On the CPU the work is done when the call that
    queued it returns, so the ticket is ready at once. ``keep`` holds what
    must live until the ticket completes: the wave's pinned upload
    buffers."""

    __slots__ = ("_event", "_keep")

    def __init__(self, device: torch.device, keep: Sequence[torch.Tensor] = ()) -> None:
        self._keep = list(keep)
        self._event = None
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()  # host-sync-ok: the explicit fetch boundary


class StreamDriver:
    """Pipelined streaming front-end over a ``VirtualCluster`` or
    ``TenantFleet`` (module docstring: the pipeline, the buffers, the fetch
    boundaries).

    ``rounds_per_wave`` engine rounds are enqueued per submitted wave;
    ``depth`` bounds the waves in flight — at the bound, :meth:`submit`
    first blocks on the OLDEST wave's ticket (a ``stream_fetch`` boundary),
    which is the pipeline's backpressure. :meth:`drain` completes every
    outstanding wave, fetches the committed-cut count (one scalar), and
    returns the :class:`StreamResult` with the sustained metrics.
    """

    def __init__(
        self,
        target,
        rounds_per_wave: int = 8,
        depth: int = 2,
        clock=None,
        ticket_wait=None,
        ticket_ready=None,
    ) -> None:
        if rounds_per_wave < 1:
            raise ValueError(f"rounds_per_wave must be >= 1, got {rounds_per_wave}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.target = target
        self.rounds_per_wave = int(rounds_per_wave)
        self.depth = int(depth)
        #: Injected timing source (seconds; monotonic). Every latency/wall
        #: decision below reads THIS, so a supervisor (or a test) owns time;
        #: the default is the process clock.
        self._clock = clock if clock is not None else time.perf_counter  # wall-clock-ok: default timing source when no supervisor injects one
        #: Injected blocking-wait seam: ``(budget_phase, wave_index, ticket)
        #: -> None``. The supervision tier (serving/supervisor.py) installs
        #: its deadline-bounded waiter here; the default waits
        #: unboundedly (the pre-supervision behavior). ``budget_phase`` is
        #: the budget-table key ("submit" for backpressure waits, "drain",
        #: "stream_fetch"), distinct from the telemetry phase label (always
        #: ``stream_fetch`` — the histogram measures host-blocked time
        #: regardless of WHY the host blocked).
        self._ticket_wait = ticket_wait
        #: Injected non-blocking readiness probe: ``(wave_index, ticket) ->
        #: bool``, consulted by the opportunistic reaper. The supervisor
        #: installs one that reports its fault plan's wedged/lost tickets
        #: as never-ready — without it, a depth>1 pipeline would reap a
        #: plan-wedged wave through the REAL probe before any bounded wait
        #: ever saw it, silently bypassing the injected fault.
        self._ticket_ready = ticket_ready
        self._is_fleet = hasattr(target, "knobs")
        # Host-side admissibility mirror (single-cluster path): ONE
        # pre-stream fetch of the slot-lifecycle lanes, then pure host
        # bookkeeping on every wave — the stream enforces the batch path's
        # reused-slot discipline (the engine's UUIDAlreadySeenError) for
        # ALL wave sources, not just PoissonChurn's fresh-slots-only
        # contract, without putting the per-wave [j]-bool fetch back on
        # the pipeline. Fleet waves carry only crashes — no admissibility.
        if self._is_fleet:
            self._inadmissible = None
        else:
            with target._dispatch("stream_fetch"):
                state = target.state
                # A copy: the mirror is mutated per wave.
                self._inadmissible = (
                    (state.alive | state.join_pending | state.retired).cpu().numpy().copy()  # host-sync-ok: one pre-stream lifecycle snapshot
                )
            target._account_d2h(int(self._inadmissible.nbytes))
        #: (wave index, submit clock reading, completion ticket).
        self._pending: Deque[Tuple[int, float, Ticket]] = deque()
        self.waves_submitted = 0
        self.waves_completed = 0
        self._cuts_reported = 0  # already inc'd into engine_stream_cuts
        self._latency = LogHistogram()
        self._t0_stream: Optional[float] = None
        self._last_result: Optional[StreamResult] = None
        # Baselines for the drain-time deltas (epoch fetch is the one
        # pre-stream sync; its cost is excluded from the overlap ratio by
        # snapshotting the fetch-phase sum AFTER it).
        self._epoch0 = self._fetch_epoch_total()
        self._fetch_ms0 = _stream_fetch_ms(target.metrics)
        self._h2d0 = int(target.metrics.counters.get("engine_h2d_bytes", 0))
        # Round-trace attribution (trace>0 targets): every wave enqueues
        # exactly rounds_per_wave rounds through stream_step, so wave i
        # spans ring sequence [base + i*rpw, base + (i+1)*rpw) per lane —
        # pure host arithmetic from a submit-time cursor snapshot, ZERO
        # added fetches on the pipelined path. The base cursor comes from
        # the decoded cache refreshed here (construction is already a
        # fetch boundary — the epoch/admissibility fetches above).
        self._has_trace = getattr(target, "trace_ring", None) is not None
        self._wave_queue_depth: List[int] = []
        #: Drain-time queue-wait vs rounds-to-decision decomposition
        #: (:meth:`_round_trajectory`), or None before the first drain.
        self.last_trajectory: Optional[dict] = None
        if self._has_trace:
            target._refresh_activity()
            self._trace_base = [
                s["rounds_recorded"] for s in self._trace_summaries()
            ]
        # The target carries its stream (the JAX package's telemetry
        # snapshot reads it as the engine.stream section).
        target.stream = self

    # -- pipeline -------------------------------------------------------

    def submit(self, wave) -> None:
        """Enqueue one wave: apply its churn delta, enqueue
        ``rounds_per_wave`` engine rounds, remember the completion ticket.
        Returns as soon as everything is QUEUED — the only blocking path is
        backpressure at ``depth`` waves in flight."""
        if self._t0_stream is None:
            self._t0_stream = self._clock()
        while len(self._pending) >= self.depth:
            self._complete_wave("submit")
        self._reap_ready()
        if self._has_trace:
            # Submit-time cursor snapshot, spelled as queue depth: the
            # waves still in flight ahead of this one each own rpw ring
            # records this wave must wait behind.
            self._wave_queue_depth.append(len(self._pending))
        t_submit = self._clock()
        self._apply(wave)
        for _ in range(self.rounds_per_wave):
            self.target.stream_step()
        # The wave's ticket completes when its last round has run; it holds
        # the wave's pinned uploads until then.
        staged, self.target._staged = self.target._staged, []
        ticket = Ticket(self.target.device, keep=staged)
        self._pending.append((self.waves_submitted, t_submit, ticket))
        self.waves_submitted += 1
        self.target.metrics.inc("engine_stream_waves")

    def drain(self) -> StreamResult:
        """Complete every outstanding wave, fetch the committed-cut count,
        and report the sustained metrics (cumulative since construction).

        Degenerate streams are well-defined, never NaN/inf: a zero-wave
        drain (nothing ever submitted) and a zero-elapsed drain (a clock
        too coarse to observe the stream's wall time) both report rate 0.0
        — dividing by a ~0 wall would publish an absurd rate into bench
        JSON, and ``None`` would erase the difference between "not yet
        drained" and "drained, nothing to rate"."""
        while self._pending:
            self._complete_wave("drain")
        epoch_total = self._fetch_epoch_total()
        # Drain is a stream_fetch boundary, so the device telemetry plane
        # refreshes here too (the lanes' digest fetch carries its own
        # telemetry-fetch-ok marker inside _refresh_activity) — never per
        # submitted wave, which would put a sync on the pipelined path.
        self.target._refresh_activity()
        if self._has_trace:
            self.last_trajectory = self._round_trajectory()
        cuts = epoch_total - self._epoch0
        wall_ms = (
            (self._clock() - self._t0_stream) * 1000.0
            if self._t0_stream is not None
            else 0.0
        )
        fetch_blocked_ms = _stream_fetch_ms(self.target.metrics) - self._fetch_ms0
        overlap = (
            max(0.0, min(1.0, 1.0 - fetch_blocked_ms / wall_ms))
            if wall_ms > 0
            else None
        )
        self.target.metrics.inc("engine_stream_cuts", cuts - self._cuts_reported)
        self._cuts_reported = cuts
        counters = self.target.metrics.counters
        self._last_result = StreamResult(
            waves=self.waves_submitted,
            rounds=self.waves_submitted * self.rounds_per_wave,
            cuts=cuts,
            wall_ms=wall_ms,
            view_changes_per_sec=(
                cuts / (wall_ms / 1000.0) if wall_ms > 0 else 0.0
            ),
            p99_alert_to_commit_ms=(
                float(self._latency.quantile(0.99)) if self._latency.count else None
            ),
            overlap_efficiency=overlap,
            fetch_blocked_ms=fetch_blocked_ms,
            h2d_bytes=int(counters.get("engine_h2d_bytes", 0)) - self._h2d0,
        )
        return self._last_result

    # -- internals ------------------------------------------------------

    def _apply(self, wave) -> None:
        """Enqueue one wave's churn delta through the target's injection
        seams (device-side scatters; only indices upload)."""
        if isinstance(wave, FleetWave):
            if not self._is_fleet:
                raise TypeError(
                    "FleetWave submitted to a single-cluster stream "
                    "(build the driver over a TenantFleet)"
                )
            if wave.crash:
                self.target.stream_crash(wave.crash)
            return
        if self._is_fleet:
            raise TypeError(
                "StreamWave submitted to a fleet stream (use FleetWave — "
                "PoissonChurn.fleet generates them)"
            )
        if wave.crash:
            self.target.crash(list(wave.crash))
            # Crashed slots retire once their cut commits — inadmissible
            # for rejoin either way (members already were).
            self._inadmissible[list(wave.crash)] = True
        if wave.join:
            # The admissibility check runs against the HOST mirror — same
            # rule as the batch path's device fetch, zero pipeline syncs.
            # Out-of-range slots fall through to inject_join_wave's own
            # bounds check (the canonical IndexError).
            bad = [
                s for s in wave.join
                if 0 <= s < self._inadmissible.size and self._inadmissible[s]
            ]
            if bad:
                raise ValueError(
                    f"slots not admissible as joiners (member/pending/"
                    f"retired): {bad}"
                )
            self.target.inject_join_wave(list(wave.join), check_admissible=False)
            self._inadmissible[list(wave.join)] = True

    def _complete_wave(self, budget_phase: str = "stream_fetch") -> None:
        """Block on the OLDEST wave's ticket — an explicit ``stream_fetch``
        boundary — and record its alert->commit latency. ``budget_phase``
        names WHY the host is blocking (backpressure inside ``submit``, the
        ``drain`` sweep) for the injected deadline waiter; the telemetry
        phase stays ``stream_fetch`` either way."""
        idx, t_submit, ticket = self._pending.popleft()
        with self.target._dispatch("stream_fetch"):
            if self._ticket_wait is not None:
                self._ticket_wait(budget_phase, idx, ticket)
            else:
                ticket.wait()
        self._record_completion(t_submit)

    def _reap_ready(self) -> None:
        """Retire already-completed waves without blocking (is_ready probe,
        or the injected fault-aware probe) so alert->commit latencies are
        observed close to actual completion instead of at the next forced
        boundary."""
        while self._pending and (
            self._ticket_ready(self._pending[0][0], self._pending[0][2])
            if self._ticket_ready is not None
            else self._pending[0][2].is_ready()
        ):
            _idx, t_submit, _ticket = self._pending.popleft()
            self._record_completion(t_submit)

    def _record_completion(self, t_submit: float) -> None:
        latency_ms = (self._clock() - t_submit) * 1000.0
        self._latency.observe(latency_ms)
        self.target.metrics.record_ms("engine_stream_alert_to_commit", latency_ms)
        self.waves_completed += 1

    def _trace_summaries(self) -> List[dict]:
        """The target's cached decoded ring summaries, one per lane (the
        single cluster is one lane; a fleet is one per tenant). Reads the
        host cache only — never the device."""
        if self._is_fleet:
            return self.target._trace or []
        return [self.target._trace] if self.target._trace is not None else []

    def _round_trajectory(self) -> dict:
        """Decompose the streamed latency story into queue-wait vs
        rounds-to-decision, from the decoded rings at a drain boundary.

        Wave ``i`` owns ring sequence ``[base + i*rpw, base + (i+1)*rpw)``
        in every lane (each submit enqueues exactly ``rounds_per_wave``
        rounds; the cursor is write-per-round). A wave's rounds-to-decision
        is the 1-based offset of the first decided record in its span,
        maxed across lanes (a fleet wave completes when its slowest tenant
        decides); a wave whose span slid out of the bounded ring is counted
        EVICTED, never silently attributed — the ring holds the last R
        rounds only. Queue-wait rides the submit-time snapshot: each wave
        in flight ahead at submit owns ``rpw`` records this wave queued
        behind."""
        rpw = self.rounds_per_wave
        summaries = self._trace_summaries()
        decisions: List[int] = []
        undecided = evicted = 0
        for w in range(self.waves_submitted):
            lane_hits: List[int] = []
            known = True
            for lane, s in enumerate(summaries):
                lo = self._trace_base[lane] + w * rpw
                oldest = s["rounds_recorded"] - s["rounds_held"]
                if lo < oldest:
                    known = False
                    break
                # Records are oldest-first with contiguous seq, so the
                # span is a direct slice.
                span = s["records"][lo - oldest : lo - oldest + rpw]
                hit = next(
                    (r["seq"] - lo + 1 for r in span if r["path"]), None
                )
                if hit is not None:
                    lane_hits.append(hit)
            if not known:
                evicted += 1
            elif lane_hits:
                decisions.append(max(lane_hits))
            else:
                undecided += 1
        queue_waits = [d * rpw for d in self._wave_queue_depth]
        actives = [
            r["active"] for s in summaries for r in s["records"]
        ]

        def q(vals, p):
            return float(np.percentile(vals, p)) if vals else None

        return {
            "rounds_per_wave": rpw,
            "waves_attributed": len(decisions) + undecided,
            "waves_evicted": evicted,
            "decided_waves": len(decisions),
            "undecided_waves": undecided,
            "rounds_to_decision_p50": q(decisions, 50),
            "rounds_to_decision_p99": q(decisions, 99),
            "rounds_to_decision_max": max(decisions) if decisions else None,
            "queue_wait_rounds_p99": q(queue_waits, 99),
            "active_p99": q(actives, 99),
        }

    def _fetch_epoch_total(self) -> int:
        """Total committed view changes across the SERVING tenants (sum of
        config_epoch: a scalar for a cluster, ``[t]`` lanes for a fleet), one
        counted read under the ``stream_fetch`` phase. Quarantined fleet
        tenants are masked out: the fleet's step keeps running their rounds,
        so a poisoned tenant's epochs must not reach the published cut
        counts and rates. With a deadline waiter installed, the wait for the
        queued work is bounded BEFORE the read, so a wedged pipeline
        surfaces as the waiter's named error, never an unbounded block
        inside the read."""
        with self.target._dispatch("stream_fetch"):
            epoch = self.target.state.config_epoch
            if self._ticket_wait is not None:
                self._ticket_wait("stream_fetch", self.waves_submitted, Ticket(self.target.device))
            quarantined = getattr(self.target, "quarantined", ())
            if quarantined:
                serving = np.ones(epoch.shape, dtype=bool)
                serving[list(quarantined)] = False
                self.target._account_h2d(serving)
                epoch = torch.where(torch.from_numpy(serving).to(epoch.device), epoch, 0)  # upload-ok: at the fetch boundary, the read below waits anyway
            total = int(_host.read(epoch.sum(), "stream_fetch"))  # host-sync-ok: fetch boundary
        self.target._account_d2h(4)
        return total

    # -- observability --------------------------------------------------

    def snapshot(self) -> dict:
        """The ``engine.stream`` telemetry section, the JAX package's dict
        (JSON-serializable; its exposition renders the gauges as
        ``rapid_engine_stream_*``). Pre-drain snapshots carry None for the
        drain-derived rates, so the key set is the same from the start."""
        last = self._last_result
        tj = self.last_trajectory or {}
        return {
            "waves_submitted": self.waves_submitted,
            "waves_completed": self.waves_completed,
            "waves_in_flight": len(self._pending),
            "rounds_per_wave": self.rounds_per_wave,
            "depth": self.depth,
            "view_changes_per_sec": (
                # Always a float after a drain (0.0 on degenerate streams);
                # None means "not yet drained", nothing else.
                round(last.view_changes_per_sec, 3)
                if last is not None
                else None
            ),
            "overlap_efficiency": (
                round(last.overlap_efficiency, 4)
                if last is not None and last.overlap_efficiency is not None
                else None
            ),
            "p99_alert_to_commit_ms": (
                round(float(self._latency.quantile(0.99)), 3)
                if self._latency.count
                else None
            ),
            # Ring-derived decomposition, present only on trace>0 targets
            # (a trace=0 stream's keys are unchanged); None before the first
            # drain.
            **(
                {
                    "rounds_to_decision_p99": tj.get("rounds_to_decision_p99"),
                    "queue_wait_rounds_p99": tj.get("queue_wait_rounds_p99"),
                    "waves_evicted": tj.get("waves_evicted"),
                }
                if self._has_trace
                else {}
            ),
        }


__all__ = [
    "FleetPoissonChurn",
    "FleetWave",
    "PoissonChurn",
    "StreamDriver",
    "StreamResult",
    "StreamWave",
    "STREAMABLE_KINDS",
    "Ticket",
    "waves_from_schedule",
]
