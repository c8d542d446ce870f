"""Declarative, serializable fault schedules over the in-process seams.

A :class:`FaultSchedule` is an ordered list of :class:`FaultEvent` records —
JSON-serializable, validated, and *slot-indexed* (slots are indices into the
scenario's endpoint table, the same indexing the device engine uses), so one
schedule drives both the asyncio stack and the device engine. Every source
of nondeterminism is seeded: the statistical link faults draw from one
``random.Random(seed)``, clock faults act on per-node
:class:`~rapid_tpu_torch.utils.clock.NodeClock` wrappers over the scenario's one
``ManualClock``, and the runner applies events in schedule order — a whole
run is a pure function of the schedule.

Event vocabulary (reference seams in parentheses):

==================  ========================================================
kind                 semantics
==================  ========================================================
``crash``            crash-stop the slots: blackholed + failure detectors
                     observe it (``StaticFailureDetector`` blacklist — the
                     reference's fault fixture, StaticFailureDetector.java)
``restart``          a previously removed slot rejoins at the same endpoint
                     with a fresh identity (UUID re-use is rejected by the
                     protocol, so a restart is a new incarnation)
``join``             admit fresh slots through the seed (a join wave)
``leave``            one slot departs gracefully (LeaveMessage path)
``partition_oneway`` all ingress INTO the victim drops; it still sends.
                     Observers lose probe responses, so detection fires
                     (the reference's asymmetric-failure scenarios)
``partition``        symmetric isolation of the slot set: links both ways
                     drop, detection does NOT fire (a pure network fault
                     below the detection threshold). The isolated members
                     can neither hear nor be heard — if they gatekeep a
                     concurrent cut, detection can wedge below H until the
                     heal; if never healed, they go stale forever. This is
                     the canonical oracle-violating shape the shrinker
                     regression pins.
``ingress_block``    one-way isolation of each slot in the set: all links
                     INTO it drop, its egress stays open, detection does
                     NOT fire. Its alerts/votes still reach the cluster and
                     its config pulls ride request/response THROUGH the
                     partition (the catch-up shape of the chaos soak)
``heal_partitions``  clear every link-level block
``link_block``       one directional link drops (``blackholed_links`` seam)
``link_heal``        re-open one directional link
``loss``             seeded symmetric message loss, permille, all links
``delay``            seeded per-message delivery delay, uniform in
                     [min_ms, max_ms] of simulated time
``duplicate``        seeded per-message duplication, permille (the server
                     handles the request twice — receiver-side dedup)
``drop_first_n``     drop the first N requests of one type at a slot's
                     server (MessageDropInterceptor.java:24-49 semantics)
``wan_asym``         WAN-shaped asymmetry: messages crossing the boundary
                     between ``slots`` and the rest suffer ADDITIONAL
                     seeded loss (``loss_permille``) and delay
                     (``delay_min_ms``..``delay_max_ms``) on top of any
                     global shaping; intra-group links are untouched (the
                     inter-cohort adverse-network shape of the
                     hierarchical-membership families). Empty slots +
                     zero parameters clears it.
``clock_skew``       shift one slot's clock readings by offset_ms
``clock_pause``      freeze one slot's clock and park its timers (GC pause)
``clock_resume``     thaw a paused clock; parked timers fire late
``false_alert``      a Byzantine observer (``slots[0]``) broadcasts edge
                     reports it never observed about a healthy ``subject``:
                     one alert claiming the given ``rings``. DOWN claims
                     accumulate in every receiver's H/L cut detector; the
                     paper's stability claim is that a cumulative count held
                     in [L, H) DELAYS (never triggers) a view change, while
                     a count pushed past H evicts the healthy subject — but
                     the eviction must still be one agreed, chain-consistent
                     cut. UP claims about a present host are filtered by
                     every receiver (a no-op lie, kept for coverage).
``alert_storm``      K-1-style collusion: every slot in ``slots`` lies
                     simultaneously about ``subject``, the claimed ``rings``
                     distributed round-robin across the liars. Cumulative
                     ring semantics identical to ``false_alert`` (receivers
                     dedup per (subject, ring), so colluders re-claiming
                     the same rings add nothing).
``committee_crash``  arm a tripwire that crash-stops ``slots[0]`` (a
                     hierarchical global-committee member) the instant the
                     first ``CohortCutMessage`` hits any server — i.e.
                     BETWEEN cohort-cut forwarding and the global decision,
                     the hier reconfiguration window (the committee-crash
                     shape of arXiv:1906.01365). Hier-profile only; must be
                     ``settle=False`` (it overlaps the membership event
                     whose reconfiguration trips it).
==================  ========================================================

``dwell_ms`` on every event is how much simulated time the runner advances
after applying it; membership-changing events additionally convergence-wait
(unless ``settle=False``, which overlaps them with the next event — the
crash-during-join shape).
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Tuple

from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import (
    BatchedAlertMessage,
    FastRoundPhase2bMessage,
    JoinMessage,
    PreJoinMessage,
    ProbeMessage,
)
from rapid_tpu_torch.utils.clock import Clock

#: The protocol watermarks adversarial schedules are judged against — the
#: reference defaults every sim profile boots with (Settings(); the engine
#: twins compile the same triple in compile_tenant). Schedule-level
#: accounting (does this false-report total evict?) must use ONE definition
#: or the runner, the oracles, and the tenancy compiler would disagree
#: about what a hostile schedule is expected to do. Per-tenant knob
#: overrides in the fleet deliberately diverge from these (the
#: knob/schedule-mismatch repro shape of tests/test_tenancy_chaos.py).
_DEFAULTS = Settings()
WATERMARK_K = _DEFAULTS.k
WATERMARK_H = _DEFAULTS.h
WATERMARK_L = _DEFAULTS.l

#: drop_first_n message-type vocabulary: the serializable names a schedule
#: may target (mirrors the reference interceptor fixtures' targeted types).
#: Lives with the schedule model so validate() can reject a typo'd name
#: instead of letting the runner KeyError mid-scenario.
DROPPABLE_MESSAGES = {
    "prejoin": PreJoinMessage,
    "join": JoinMessage,
    "probe": ProbeMessage,
    "batched_alert": BatchedAlertMessage,
    "fast_round_vote": FastRoundPhase2bMessage,
}

#: Events that change the expected membership (and are therefore replayable
#: through the device engine by the differential oracle).
MEMBERSHIP_KINDS = frozenset({"crash", "restart", "join", "leave", "partition_oneway"})

#: Expected membership delta per slot for each membership kind.
MEMBER_DELTA = {"crash": -1, "restart": +1, "join": +1, "leave": -1, "partition_oneway": -1}

#: Network/clock events: applied instantaneously, never convergence-waited.
ENVIRONMENT_KINDS = frozenset({
    "partition", "ingress_block", "heal_partitions", "link_block", "link_heal",
    "loss", "delay", "duplicate", "drop_first_n", "wan_asym",
    "clock_skew", "clock_pause", "clock_resume",
})

#: Hostile events: observers that LIE (false_alert / alert_storm — their
#: membership effect is conditional on the cumulative false-report count
#: crossing H) and the committee-member crash armed on the hier
#: reconfiguration window (always -1, applied when the tripwire fires).
ADVERSARIAL_KINDS = frozenset({"false_alert", "alert_storm", "committee_crash"})

ALL_KINDS = MEMBERSHIP_KINDS | ENVIRONMENT_KINDS | ADVERSARIAL_KINDS


class LinkPlan(NamedTuple):
    """One message's fate under the shaper."""

    drop: bool
    delay_ms: float
    duplicate: bool


class LinkShaper:
    """Seeded statistical link faults, consulted per in-process send attempt
    (the ``InProcessNetwork.shaper`` seam).

    One ``random.Random`` drives every draw, so given a fixed schedule of
    protocol operations the sequence of drops/delays/duplications is a pure
    function of the seed. Delays hold the message for *simulated* time (the
    scenario's ManualClock), so a delayed message interleaves exactly where
    the schedule says it does, independent of host speed.
    """

    def __init__(self, rng: random.Random, clock: Clock) -> None:
        self._rng = rng
        self._clock = clock
        self.loss_permille = 0
        self.delay_min_ms = 0.0
        self.delay_max_ms = 0.0
        self.dup_permille = 0
        # WAN asymmetry (the ``wan_asym`` event): links CROSSING the
        # boundary between ``asym_group`` and everyone else pay additional
        # loss/delay; intra-group links are untouched.
        self.asym_group: set = set()
        self.asym_loss_permille = 0
        self.asym_delay_min_ms = 0.0
        self.asym_delay_max_ms = 0.0
        # Observability: totals per fate, for artifacts and assertions.
        self.dropped = 0
        self.delayed = 0
        self.duplicated = 0
        self.asym_dropped = 0
        self.asym_delayed = 0

    def plan(self, src, dst) -> LinkPlan:
        drop = self.loss_permille > 0 and self._rng.randrange(1000) < self.loss_permille
        if drop:
            self.dropped += 1
            return LinkPlan(True, 0.0, False)
        cross = bool(self.asym_group) and (
            (src in self.asym_group) != (dst in self.asym_group)
        )
        if (
            cross
            and self.asym_loss_permille > 0
            and self._rng.randrange(1000) < self.asym_loss_permille
        ):
            self.dropped += 1
            self.asym_dropped += 1
            return LinkPlan(True, 0.0, False)
        delay = 0.0
        if self.delay_max_ms > 0:
            delay = self._rng.uniform(self.delay_min_ms, self.delay_max_ms)
        if cross and self.asym_delay_max_ms > 0:
            delay += self._rng.uniform(self.asym_delay_min_ms, self.asym_delay_max_ms)
            self.asym_delayed += 1
        if delay > 0:
            self.delayed += 1
        dup = self.dup_permille > 0 and self._rng.randrange(1000) < self.dup_permille
        if dup:
            self.duplicated += 1
        return LinkPlan(False, delay, dup)

    async def hold_ms(self, delay_ms: float) -> None:
        await self._clock.sleep_ms(delay_ms)


class ScheduleError(ValueError):
    """The schedule is ill-formed (unknown kind, slot-lifecycle violation,
    seed-node fault, ...). Raised by :meth:`FaultSchedule.validate`, and at
    :class:`FaultEvent` construction for kinds outside the registered
    vocabulary."""


@dataclass(frozen=True)
class FaultEvent:
    """One schedule entry. ``slots`` carries the subject slot indices (empty
    for global events); ``args`` the kind-specific parameters; ``dwell_ms``
    the simulated time advanced after the event; ``settle=False`` overlaps a
    membership event with the next one instead of convergence-waiting.

    Construction with an unregistered ``kind`` raises immediately: the
    vocabulary (ALL_KINDS), the fuzz FAMILIES table, and the JAX package's
    chaosrun CLI all index on these strings, and a typo'd kind must fail at
    the point it is minted — never ride silently into a schedule file the
    runner then crashes on mid-scenario (the chaosvocab lint family pins
    the static half of this)."""

    kind: str
    slots: Tuple[int, ...] = ()
    args: Dict[str, object] = field(default_factory=dict)
    dwell_ms: float = 0.0
    settle: bool = True

    def __post_init__(self) -> None:
        if self.kind not in ALL_KINDS:
            raise ScheduleError(
                f"unknown kind {self.kind!r}; registered kinds: "
                f"{sorted(ALL_KINDS)}"
            )

    def to_dict(self) -> Dict[str, object]:
        out: Dict[str, object] = {"kind": self.kind}
        if self.slots:
            out["slots"] = list(self.slots)
        if self.args:
            out["args"] = dict(self.args)
        if self.dwell_ms:
            # Coerced: an int-valued dwell must serialize identically before
            # and after a round trip (repro files diff clean).
            out["dwell_ms"] = float(self.dwell_ms)
        if not self.settle:
            out["settle"] = False
        return out

    @classmethod
    def from_dict(cls, data: Dict[str, object]) -> "FaultEvent":
        return cls(
            kind=str(data["kind"]),
            slots=tuple(int(s) for s in data.get("slots", ())),
            args=dict(data.get("args", {})),  # type: ignore[arg-type]
            dwell_ms=float(data.get("dwell_ms", 0.0)),  # type: ignore[arg-type]
            settle=bool(data.get("settle", True)),
        )


@dataclass
class FaultSchedule:
    """A complete, replayable fault scenario.

    ``n0`` slots [0, n0) boot as the initial cluster; slots [n0, n_slots)
    are the joiner pool. Slot 0 is the seed and reference observer — the
    oracles anchor the configuration chain at it — and may never be faulted.
    ``converge_budget_ms`` bounds (in simulated time) the final
    all-live-nodes convergence the bounded-convergence oracle asserts.
    """

    n0: int
    n_slots: int
    seed: int = 0
    events: List[FaultEvent] = field(default_factory=list)
    converge_budget_ms: float = 120_000.0
    #: Simulated-time budget for each settling membership phase (how long a
    #: single decision + catch-up may take before the run counts as wedged).
    phase_budget_ms: float = 90_000.0
    name: str = ""
    #: Protocol profile the runner boots the cluster with: "flat" (the
    #: classic O(N) protocol) or "hier" (two-level hierarchical membership,
    #: rapid_tpu_torch/hier — the WAN-shaped families run under it).
    profile: str = "flat"

    # -- serialization (the repro artifact format) ----------------------

    def to_dict(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "version": 1,
            "name": self.name,
            "n0": self.n0,
            "n_slots": self.n_slots,
            "seed": self.seed,
            "converge_budget_ms": self.converge_budget_ms,
            "phase_budget_ms": self.phase_budget_ms,
            "events": [e.to_dict() for e in self.events],
        }
        if self.profile != "flat":
            # Written only when non-default: pre-hier repro files stay
            # byte-identical through a load/save round trip.
            out["profile"] = self.profile
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1) + "\n"

    @classmethod
    def from_dict(cls, data: Dict[str, object]) -> "FaultSchedule":
        version = data.get("version", 1)
        if version != 1:
            raise ScheduleError(f"unknown schedule version {version!r}")
        try:
            return cls(
                n0=int(data["n0"]),  # type: ignore[arg-type]
                n_slots=int(data["n_slots"]),  # type: ignore[arg-type]
                seed=int(data.get("seed", 0)),  # type: ignore[arg-type]
                events=[FaultEvent.from_dict(e) for e in data.get("events", ())],  # type: ignore[union-attr]
                converge_budget_ms=float(data.get("converge_budget_ms", 120_000.0)),  # type: ignore[arg-type]
                phase_budget_ms=float(data.get("phase_budget_ms", 90_000.0)),  # type: ignore[arg-type]
                name=str(data.get("name", "")),
                profile=str(data.get("profile", "flat")),
            )
        except (KeyError, TypeError, ValueError) as exc:
            # A hand-edited or corrupted schedule file must surface as a
            # schedule error (the CLIs' clean-exit contract), not a raw
            # KeyError traceback.
            raise ScheduleError(f"malformed schedule: {exc!r}") from exc

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        return cls.from_dict(json.loads(text))

    # -- adversarial accounting ----------------------------------------

    def adversarial_crossings(self) -> Dict[int, Tuple[int, Tuple[int, ...]]]:
        """``{event index: (subject slot, cumulative claimed rings)}`` for
        every ``false_alert``/``alert_storm`` event whose cumulative
        distinct-ring count about its subject crosses the H watermark —
        THE definition of "this lie evicts", shared by the runner (expected
        membership), the oracles (stability judgment), the phase grouping
        (engine replay), and the tenancy compiler. Receivers dedup reports
        per (subject, ring), so only DISTINCT rings count, and only DOWN
        claims (UP about a present host is filtered by every receiver)."""
        crossings: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        rings_of: Dict[int, set] = {}
        evicted: set = set()
        for i, event in enumerate(self.events):
            if event.kind not in ("false_alert", "alert_storm"):
                continue
            if str(event.args.get("status", "DOWN")) != "DOWN":
                continue
            subject = int(event.args["subject"])  # type: ignore[arg-type]
            if subject in evicted:
                continue
            acc = rings_of.setdefault(subject, set())
            acc.update(int(r) for r in event.args.get("rings", ()))  # type: ignore[union-attr]
            if len(acc) >= WATERMARK_H:
                crossings[i] = (subject, tuple(sorted(acc)))
                evicted.add(subject)
        return crossings

    def _adversarial_removed(self) -> set:
        """Slots the hostile events remove: committee-crash victims plus
        every subject whose false-report count crosses H."""
        removed = {
            s for s, _ in self.adversarial_crossings().values()
        }
        for event in self.events:
            if event.kind == "committee_crash":
                removed |= set(event.slots)
        return removed

    # -- static validation ---------------------------------------------

    def validate(self) -> None:
        """Simulate the slot lifecycle and reject ill-formed schedules —
        the same rules the generator obeys and the shrinker re-checks, so a
        shrink step can never produce a schedule the runner would crash on."""
        if not 1 <= self.n0 <= self.n_slots:
            raise ScheduleError(f"n0 must be in [1, n_slots], got {self.n0}/{self.n_slots}")
        if self.profile not in ("flat", "hier"):
            raise ScheduleError(f"unknown profile {self.profile!r}")
        live = set(range(self.n0))
        fresh = set(range(self.n0, self.n_slots))
        removed: set = set()
        paused: set = set()
        false_rings: Dict[int, set] = {}
        armed_tripwire: int = -1  # index of a committee_crash awaiting its trigger
        for i, event in enumerate(self.events):
            where = f"event {i} ({event.kind})"
            if 0 in event.slots and event.kind in (
                MEMBERSHIP_KINDS
                | {"partition", "ingress_block", "clock_pause", "committee_crash"}
            ):
                raise ScheduleError(f"{where}: slot 0 (seed/observer) may not be faulted")
            if event.dwell_ms < 0:
                raise ScheduleError(f"{where}: negative dwell_ms")
            if event.kind in MEMBERSHIP_KINDS and not event.slots:
                raise ScheduleError(f"{where}: membership event needs slots")
            if event.kind in MEMBERSHIP_KINDS:
                armed_tripwire = -1  # this event's reconfiguration trips it
            if event.kind == "crash":
                bad = set(event.slots) - live
                if bad:
                    raise ScheduleError(f"{where}: crash of non-live slots {sorted(bad)}")
                live -= set(event.slots)
                removed |= set(event.slots)
            elif event.kind == "join":
                bad = set(event.slots) - fresh
                if bad:
                    raise ScheduleError(f"{where}: join of non-fresh slots {sorted(bad)}")
                fresh -= set(event.slots)
                live |= set(event.slots)
            elif event.kind == "restart":
                bad = set(event.slots) - removed
                if bad:
                    raise ScheduleError(f"{where}: restart of never-removed slots {sorted(bad)}")
                removed -= set(event.slots)
                live |= set(event.slots)
            elif event.kind in ("leave", "partition_oneway"):
                if len(event.slots) != 1:
                    raise ScheduleError(f"{where}: takes exactly one slot")
                if event.slots[0] not in live:
                    raise ScheduleError(f"{where}: slot {event.slots[0]} not live")
                live -= set(event.slots)
                removed |= set(event.slots)
            elif event.kind in ("partition", "ingress_block"):
                bad = set(event.slots) - live
                if bad:
                    raise ScheduleError(f"{where}: {event.kind} of non-live slots {sorted(bad)}")
                if not event.slots:
                    raise ScheduleError(f"{where}: empty {event.kind}")
            elif event.kind in ("link_block", "link_heal"):
                if {"src", "dst"} - set(event.args):
                    raise ScheduleError(f"{where}: needs src/dst args")
            elif event.kind == "loss":
                p = int(event.args.get("permille", -1))  # type: ignore[arg-type]
                if not 0 <= p <= 1000:
                    raise ScheduleError(f"{where}: permille must be in [0, 1000]")
            elif event.kind == "duplicate":
                p = int(event.args.get("permille", -1))  # type: ignore[arg-type]
                if not 0 <= p <= 1000:
                    raise ScheduleError(f"{where}: permille must be in [0, 1000]")
            elif event.kind == "delay":
                lo = float(event.args.get("min_ms", 0.0))  # type: ignore[arg-type]
                hi = float(event.args.get("max_ms", -1.0))  # type: ignore[arg-type]
                if not 0 <= lo <= hi:
                    raise ScheduleError(f"{where}: need 0 <= min_ms <= max_ms")
            elif event.kind == "drop_first_n":
                if len(event.slots) != 1:
                    raise ScheduleError(f"{where}: takes exactly one slot")
                message = event.args.get("message")
                if message not in DROPPABLE_MESSAGES:
                    raise ScheduleError(
                        f"{where}: message must be one of "
                        f"{sorted(DROPPABLE_MESSAGES)}, got {message!r}"
                    )
                if int(event.args.get("count", 0)) < 1:  # type: ignore[arg-type]
                    raise ScheduleError(f"{where}: needs count >= 1")
            elif event.kind == "wan_asym":
                bad = set(event.slots) - live
                if bad:
                    raise ScheduleError(f"{where}: wan_asym over non-live slots {sorted(bad)}")
                p = int(event.args.get("loss_permille", 0))  # type: ignore[arg-type]
                if not 0 <= p <= 1000:
                    raise ScheduleError(f"{where}: loss_permille must be in [0, 1000]")
                lo = float(event.args.get("delay_min_ms", 0.0))  # type: ignore[arg-type]
                hi = float(event.args.get("delay_max_ms", 0.0))  # type: ignore[arg-type]
                if not 0 <= lo <= max(hi, 0.0) or hi < 0:
                    raise ScheduleError(f"{where}: need 0 <= delay_min_ms <= delay_max_ms")
                if event.slots and p == 0 and hi == 0:
                    raise ScheduleError(f"{where}: a non-empty group needs loss or delay")
            elif event.kind in ("false_alert", "alert_storm"):
                subject = event.args.get("subject")
                if not isinstance(subject, int):
                    raise ScheduleError(f"{where}: needs an int subject arg")
                if subject == 0:
                    raise ScheduleError(
                        f"{where}: slot 0 (seed/observer) may not be the subject"
                    )
                if subject not in live:
                    raise ScheduleError(f"{where}: subject {subject} not live")
                status = str(event.args.get("status", "DOWN"))
                if status not in ("DOWN", "UP"):
                    raise ScheduleError(f"{where}: status must be DOWN or UP")
                rings = list(event.args.get("rings", ()))  # type: ignore[arg-type]
                if not rings or not all(
                    isinstance(r, int) and 0 <= r < WATERMARK_K for r in rings
                ):
                    raise ScheduleError(
                        f"{where}: rings must be a non-empty list of ints in "
                        f"[0, {WATERMARK_K})"
                    )
                if event.kind == "false_alert":
                    if len(event.slots) != 1:
                        raise ScheduleError(f"{where}: takes exactly one liar slot")
                else:
                    if not event.slots:
                        raise ScheduleError(f"{where}: a storm needs liar slots")
                liars = set(event.slots)
                if 0 in liars:
                    raise ScheduleError(
                        f"{where}: slot 0 (reference observer) never lies"
                    )
                if subject in liars:
                    raise ScheduleError(f"{where}: the subject cannot lie about itself")
                bad = liars - live
                if bad:
                    raise ScheduleError(f"{where}: non-live liars {sorted(bad)}")
                if status == "DOWN":
                    acc = false_rings.setdefault(subject, set())
                    acc.update(int(r) for r in rings)
                    if len(acc) >= WATERMARK_H:
                        # Past H the lie evicts: the subject leaves the
                        # expected membership like any schedule-removed slot.
                        live.discard(subject)
                        removed.add(subject)
            elif event.kind == "committee_crash":
                if self.profile != "hier":
                    raise ScheduleError(
                        f"{where}: only the hier profile has a global committee"
                    )
                if len(event.slots) != 1:
                    raise ScheduleError(f"{where}: takes exactly one victim slot")
                if event.slots[0] not in live:
                    raise ScheduleError(f"{where}: slot {event.slots[0]} not live")
                if event.settle:
                    raise ScheduleError(
                        f"{where}: must be settle=False — the crash fires "
                        f"during the NEXT membership event's reconfiguration"
                    )
                live -= set(event.slots)
                removed |= set(event.slots)
                armed_tripwire = i
            elif event.kind == "clock_skew":
                if len(event.slots) != 1 or "offset_ms" not in event.args:
                    raise ScheduleError(f"{where}: needs one slot and offset_ms")
                if event.slots[0] in paused:
                    # NodeClock rejects re-skewing a frozen clock; catch the
                    # shape here so a shrink step can never produce a
                    # schedule the runner would crash on.
                    raise ScheduleError(f"{where}: slot {event.slots[0]} is paused")
            elif event.kind == "clock_pause":
                if len(event.slots) != 1 or event.slots[0] in paused:
                    raise ScheduleError(f"{where}: needs one un-paused slot")
                paused |= set(event.slots)
            elif event.kind == "clock_resume":
                if len(event.slots) != 1 or event.slots[0] not in paused:
                    raise ScheduleError(f"{where}: needs one paused slot")
                paused -= set(event.slots)
        if armed_tripwire >= 0:
            # The tripwire only fires when a reconfiguration forwards a
            # cohort cut; a schedule with nothing membership-changing after
            # the arming would leave the victim alive while the expected-
            # membership accounting (runner + oracles) counts it removed —
            # false violations against a correct cluster.
            raise ScheduleError(
                f"event {armed_tripwire} (committee_crash): no membership "
                f"event follows to trigger the reconfiguration tripwire"
            )
        if self.events and not self.events[-1].settle:
            raise ScheduleError("last event must settle (nothing follows to absorb it)")

    # -- derived views --------------------------------------------------

    def membership_phases(self) -> List[List[FaultEvent]]:
        """The membership-changing events, grouped: consecutive
        ``settle=False`` events merge with the next settling one into one
        overlapped group (the runner converges once per group, and the
        differential oracle replays group-at-a-time).

        Adversarial events ride along exactly when they change membership:
        a ``committee_crash`` always (its victim is evicted), a
        ``false_alert``/``alert_storm`` only at its H-crossing event — and
        the crossing event is NORMALIZED to carry the cumulative claimed
        ring set in ``args["rings"]``, so a group consumer (engine replay,
        tenancy compiler) sees the full ≥H report load in one entry without
        re-deriving the accumulation. Sub-H lies are environment-shaped:
        they delay, never change, membership, and appear in no group."""
        crossings = self.adversarial_crossings()
        groups: List[List[FaultEvent]] = []
        current: List[FaultEvent] = []
        for i, event in enumerate(self.events):
            if event.kind in ADVERSARIAL_KINDS:
                if event.kind == "committee_crash":
                    current.append(event)
                elif i in crossings:
                    subject, rings = crossings[i]
                    current.append(FaultEvent(
                        event.kind, event.slots,
                        {"subject": subject, "rings": list(rings)},
                        event.dwell_ms, event.settle,
                    ))
                else:
                    continue
            elif event.kind in MEMBERSHIP_KINDS:
                current.append(event)
            else:
                continue
            if event.settle:
                groups.append(current)
                current = []
        if current:
            groups.append(current)
        return groups

    def expected_members(self) -> int:
        """Final expected membership after every phase resolves."""
        n = self.n0
        for event in self.events:
            if event.kind in MEMBERSHIP_KINDS:
                n += MEMBER_DELTA[event.kind] * len(event.slots)
        return n - len(self._adversarial_removed())

    def expected_removed_slots(self) -> set:
        """Slots the schedule itself removes from membership (crashed, left,
        evicted by an asymmetric partition, committee-crashed, or falsely
        accused past H) and never restarts — the set absent from the
        expected FINAL membership."""
        removed: set = set()
        for event in self.events:
            if event.kind in ("crash", "leave", "partition_oneway", "committee_crash"):
                removed |= set(event.slots)
            elif event.kind == "restart":
                removed -= set(event.slots)
        crossed = {s for s, _ in self.adversarial_crossings().values()}
        for event in self.events:
            if event.kind == "restart":
                crossed -= set(event.slots)
        return removed | crossed

    def ever_removed_slots(self) -> set:
        """Slots removed at ANY point, restarts notwithstanding — the set
        whose KICKED signals are legitimate (a restarted slot's PREVIOUS
        incarnation may rightly learn of its own eviction)."""
        removed: set = set()
        for event in self.events:
            if event.kind in ("crash", "leave", "partition_oneway", "committee_crash"):
                removed |= set(event.slots)
        return removed | {s for s, _ in self.adversarial_crossings().values()}

    @property
    def engine_compatible(self) -> bool:
        """Whether the differential oracle can replay this schedule through
        the device engine. Restarts cannot: a restarted endpoint maps to its
        original (now retired) engine slot — identity lanes are spent
        forever there (the engine's UUIDAlreadySeen discipline) — while the
        host correctly admits the fresh incarnation."""
        return not any(e.kind == "restart" for e in self.events)


def loss_as_engine_delivery(
    loss_permille: int, retry_horizon_rounds: int = 2
) -> Dict[str, int]:
    """Compile a symmetric-loss fault onto the device engine's delivery
    knobs: a message lost on a broadcast link is re-delivered by the alert
    redelivery machinery one interval later, which the round-granular engine
    models as a delivery *delayed* up to ``retry_horizon_rounds`` rounds
    with probability ``loss_permille``/1000 (``EngineConfig``'s
    delivery_prob_permille / delivery_spread pair). Used by bench.py's
    churn_under_loss variant so host schedules and engine benchmarks share
    one definition of "5% loss"."""
    if not 0 <= loss_permille <= 1000:
        raise ScheduleError(f"loss permille must be in [0, 1000], got {loss_permille}")
    return {
        "delivery_prob_permille": loss_permille,
        "delivery_spread": retry_horizon_rounds if loss_permille else 0,
    }


def schedule_rng(schedule: FaultSchedule) -> random.Random:
    """THE seeded stream for a schedule's statistical faults — one
    definition, so the runner and any replay derive identical draws."""
    return random.Random(f"rapid-sim:{schedule.seed}")
