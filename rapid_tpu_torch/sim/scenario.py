"""Scenario runner: apply a fault schedule to a simulated cluster.

Two layers:

- :class:`SimHarness` — the reusable asyncio-stack scaffolding (bootstrap
  through the seed, per-node :class:`~rapid_tpu_torch.utils.clock.NodeClock` over
  one shared ``ManualClock``, cut/configuration capture on every node, and
  the fault primitives compiled onto the in-process transport seams). The
  cross-stack oracle tests drive it directly with bespoke scenarios; the
  runner below drives it from a declarative schedule.
- :class:`ScenarioRunner` — interprets a :class:`FaultSchedule` over a
  harness: applies events in order, convergence-waits after each settling
  membership phase, advances simulated time by each event's dwell, and
  captures everything a replay needs (the schedule, a fault log stamped in
  simulated time, per-node flight recordings, the outcome) into a repro
  directory ``tools/traceview.py`` can render end-to-end.

A run is deterministic: one seed fixes the statistical link faults, node
rngs are derived from slot numbers, and all time is the schedule's.
"""

from __future__ import annotations

import asyncio
import json
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from rapid_tpu_torch.errors import JoinError
from rapid_tpu_torch.messaging.inprocess import (
    InProcessNetwork,
    RequestTripwire,
    ServerDropFirstN,
)
from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
from rapid_tpu_torch.protocol.cluster import Cluster
from rapid_tpu_torch.protocol.events import ClusterEvents
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.sim.faults import (
    DROPPABLE_MESSAGES,
    MEMBERSHIP_KINDS,
    FaultEvent,
    FaultSchedule,
    LinkShaper,
    schedule_rng,
)
from rapid_tpu_torch.types import CohortCutMessage, EdgeStatus, Endpoint, NodeId
from rapid_tpu_torch.utils.clock import ManualClock, NodeClock


async def _drain(loop_yields: int = 60) -> None:
    for _ in range(loop_yields):
        await asyncio.sleep(0)


class SimHarness:
    """Simulated-cluster scaffolding: lifecycle, fault primitives, capture.

    ``endpoints[slot]`` is the address of slot ``slot``; slot 0 is the seed.
    Every node runs on its own :class:`NodeClock` over the one shared
    ``ManualClock`` (so clock faults are per-node), with ``random.Random(slot)``
    as its protocol rng (so jitter is a function of the slot number).
    """

    def __init__(
        self,
        endpoints: Sequence[Endpoint],
        settings: Optional[Settings] = None,
        id_seed: Optional[int] = None,
    ) -> None:
        self.endpoints = list(endpoints)
        self.settings = settings if settings is not None else Settings()
        #: Seed for deterministic node identities: configuration ids (which
        #: fold the member identifiers) then replay bit-identically run to
        #: run. None = UUID identities, as production mints them.
        self.id_seed = id_seed
        self._incarnation: Dict[int, int] = {}
        self.network = InProcessNetwork()
        self.clock = ManualClock()
        self.node_clocks: Dict[int, NodeClock] = {}
        self.fd = StaticFailureDetectorFactory()
        self.clusters: Dict[int, Cluster] = {}
        self.live_ids: set = set()
        #: Slots currently symmetrically partitioned away (cannot even pull):
        #: phase convergence excludes them; the post-heal final convergence
        #: does not.
        self.blocked_slots: set = set()
        #: node 0's view-change deltas after bootstrap, each a frozenset of
        #: (Endpoint, EdgeStatus) — the cut sequence the oracles compare.
        self.cuts: List[frozenset] = []
        #: Per-slot delivered configuration history, from birth:
        #: (configuration_id, membership tuple) per VIEW_CHANGE.
        self.configs: Dict[int, List[Tuple[int, Tuple[Endpoint, ...]]]] = {}
        #: Slots that observed their own eviction (KICKED).
        self.kicked: List[int] = []
        self.shaper: Optional[LinkShaper] = None

    # -- construction ---------------------------------------------------

    def attach_shaper(self, rng: random.Random) -> LinkShaper:
        self.shaper = LinkShaper(rng, self.clock)
        self.network.shaper = self.shaper
        return self.shaper

    def node_clock(self, slot: int) -> NodeClock:
        if slot not in self.node_clocks:
            self.node_clocks[slot] = NodeClock(self.clock)
        return self.node_clocks[slot]

    def _node_id(self, slot: int) -> Optional[NodeId]:
        """Deterministic per-(slot, incarnation) identity — a restarted slot
        is a NEW identity (the protocol rejects reuse), still derived purely
        from the seed."""
        if self.id_seed is None:
            return None
        incarnation = self._incarnation.get(slot, 0)
        rng = random.Random(f"node-id:{self.id_seed}:{slot}:{incarnation}")
        return NodeId(high=rng.getrandbits(64), low=rng.getrandbits(64))

    def _subscriptions(self, slot: int) -> Dict[ClusterEvents, List]:
        self.configs.setdefault(slot, [])

        def on_view(change) -> None:
            self.configs[slot].append(
                (change.configuration_id, tuple(change.membership))
            )

        def on_kicked(_change) -> None:
            self.kicked.append(slot)

        return {
            ClusterEvents.VIEW_CHANGE: [on_view],
            ClusterEvents.KICKED: [on_kicked],
        }

    async def _drive(self, *tasks: asyncio.Future) -> None:
        """Pump the shared clock until every task completes."""
        while not all(t.done() for t in tasks):
            await self.advance(200)
        for t in tasks:
            t.result()  # surface failures here, not as pending warnings

    async def advance(self, total_ms: float, step_ms: float = 50) -> None:
        advanced = 0.0
        while advanced < total_ms:
            self.clock.advance_ms(step_ms)
            advanced += step_ms
            await _drain()

    async def bootstrap(self, n0: int) -> None:
        self.clusters[0] = await Cluster.start(
            self.endpoints[0], settings=self.settings, network=self.network,
            fd_factory=self.fd, clock=self.node_clock(0),
            rng=random.Random(0), subscriptions=self._subscriptions(0),
            node_id=self._node_id(0),
        )
        self.live_ids = {0}
        for i in range(1, n0):
            await self.join_one(i)
        assert all(c.membership_size == n0 for c in self.clusters.values())
        self.clusters[0].register_subscription(
            ClusterEvents.VIEW_CHANGE,
            lambda change: self.cuts.append(
                frozenset(
                    (sc.endpoint, sc.status) for sc in change.status_changes
                )
            ),
        )

    async def join_one(self, slot: int) -> None:
        task = asyncio.ensure_future(
            Cluster.join(self.endpoints[0], self.endpoints[slot],
                         settings=self.settings, network=self.network,
                         fd_factory=self.fd, clock=self.node_clock(slot),
                         rng=random.Random(slot),
                         subscriptions=self._subscriptions(slot),
                         node_id=self._node_id(slot))
        )
        await self._drive(task)
        self.clusters[slot] = task.result()
        self.live_ids.add(slot)

    async def join_wave(self, slots: Sequence[int]) -> None:
        """Concurrent joins through the seed — one thundering batch."""
        tasks = [
            asyncio.ensure_future(
                Cluster.join(self.endpoints[0], self.endpoints[s],
                             settings=self.settings, network=self.network,
                             fd_factory=self.fd, clock=self.node_clock(s),
                             rng=random.Random(s),
                             subscriptions=self._subscriptions(s),
                             node_id=self._node_id(s))
            )
            for s in slots
        ]
        await self._drive(*tasks)
        for s, t in zip(slots, tasks):
            self.clusters[s] = t.result()
        self.live_ids |= set(slots)

    # -- fault primitives (the InProcessNetwork / clock seams) ----------

    def crash(self, slots: Sequence[int]) -> None:
        for s in slots:
            self.network.blackholed.add(self.endpoints[s])
        self.fd.add_failed_nodes([self.endpoints[s] for s in slots])
        self.live_ids -= set(slots)

    async def restart(self, slot: int) -> None:
        """A removed slot rejoins at the same endpoint as a fresh incarnation
        (new identity — the protocol rejects UUID reuse, so this is how a
        real restarted process returns)."""
        old = self.clusters.pop(slot, None)
        if old is not None:
            await old.shutdown()
        endpoint = self.endpoints[slot]
        self.network.blackholed.discard(endpoint)
        self.network.blackholed_links = {
            link for link in self.network.blackholed_links if endpoint not in link
        }
        self.fd.blacklist.discard(endpoint)
        self._incarnation[slot] = self._incarnation.get(slot, 0) + 1
        await self.join_one(slot)

    async def leave(self, slot: int) -> None:
        task = asyncio.ensure_future(self.clusters[slot].leave_gracefully())
        await self._drive(task)
        self.live_ids -= {slot}

    def partition_one_way(self, victim: int) -> None:
        """Everything INTO the victim drops (it can still send); its
        observers lose probe responses, so detection fires."""
        for i in self.clusters:
            if i != victim:
                self.network.blackholed_links.add(
                    (self.endpoints[i], self.endpoints[victim])
                )
        self.fd.add_failed_nodes([self.endpoints[victim]])
        self.live_ids -= {victim}

    def partition(self, slots: Sequence[int]) -> None:
        """Symmetric isolation of ``slots`` from the rest — a pure network
        fault: detection does NOT fire (the members remain in every view)
        and the set can still talk among itself."""
        inside = set(slots)
        for s in inside:
            for o in range(len(self.endpoints)):
                if o not in inside:
                    self.network.blackholed_links.add(
                        (self.endpoints[o], self.endpoints[s])
                    )
                    self.network.blackholed_links.add(
                        (self.endpoints[s], self.endpoints[o])
                    )
        self.blocked_slots |= inside

    def ingress_block(self, slots: Sequence[int]) -> None:
        """One-way isolation: all links INTO each slot drop; its egress
        stays open, so its alerts still reach the cluster and its config
        pulls work through the partition (requests out, responses back on
        the same call). Detection does not fire — the member stays in every
        view and re-joins each configuration by pulling."""
        for s in slots:
            for o in range(len(self.endpoints)):
                if o != s:
                    self.network.blackholed_links.add(
                        (self.endpoints[o], self.endpoints[s])
                    )

    def heal_partitions(self) -> None:
        self.network.blackholed_links.clear()
        self.blocked_slots.clear()

    def block_link(self, src: int, dst: int) -> None:
        self.network.blackholed_links.add((self.endpoints[src], self.endpoints[dst]))

    def heal_link(self, src: int, dst: int) -> None:
        self.network.blackholed_links.discard(
            (self.endpoints[src], self.endpoints[dst])
        )

    def drop_first_n(self, slot: int, message: str, count: int) -> None:
        server = self.network.servers[self.endpoints[slot]]
        server.drop_interceptors.append(
            ServerDropFirstN(DROPPABLE_MESSAGES[message], count)
        )

    # -- adversarial primitives (Byzantine observers, committee crash) --

    async def false_alert(
        self, liar: int, subject: int, rings: Sequence[int], status: str = "DOWN"
    ) -> None:
        """Slot ``liar`` broadcasts edge reports it never observed about
        ``subject``, claiming the given ring numbers — the hostile half of
        the paper's flaky-observer stability story (sim/faults.py
        ``false_alert``). The lie rides the real alert machinery (batching,
        broadcast, redelivery) via the service's Byzantine seam."""
        await self.clusters[liar].service.inject_byzantine_alert(
            self.endpoints[subject],
            EdgeStatus.DOWN if status == "DOWN" else EdgeStatus.UP,
            rings,
        )

    async def alert_storm(
        self, liars: Sequence[int], subject: int, rings: Sequence[int],
        status: str = "DOWN",
    ) -> None:
        """Simultaneous collusion: the claimed rings are distributed
        round-robin across the liars, so the RECEIVER-side cumulative tally
        is identical to one liar claiming them all — but the reports arrive
        from distinct senders in distinct batches (exercising per-ring
        dedup across senders)."""
        liars = list(liars)
        for j, liar in enumerate(liars):
            share = [r for i, r in enumerate(rings) if i % len(liars) == j]
            if share:
                await self.false_alert(liar, subject, share, status)

    def arm_committee_crash(self, victim: int) -> None:
        """Crash ``victim`` the instant the first CohortCutMessage hits any
        server: the window between cohort-cut forwarding and the global
        decision — the hier reconfiguration gap of arXiv:1906.01365. The
        tripwire fires synchronously before the triggering message is
        handled, so a victim that was the recipient loses the message with
        the process."""

        def fire() -> None:
            if victim in self.live_ids:
                self.crash([victim])

        self.network.tripwires.append(RequestTripwire(CohortCutMessage, fire))

    # -- convergence ----------------------------------------------------

    def _agreeing(self, expected: int, include_blocked: bool) -> bool:
        ids = self.live_ids if include_blocked else self.live_ids - self.blocked_slots
        live = [self.clusters[i] for i in ids]
        if not all(c.membership_size == expected for c in live):
            return False
        return len({tuple(c.membership) for c in live}) == 1

    async def try_converge(
        self, expected: int, budget_ms: float, include_blocked: bool = True
    ) -> Optional[float]:
        """Advance simulated time until every (reachable) live node holds
        the identical ``expected``-member view; returns the simulated ms it
        took, or None if the budget ran out."""
        start = self.clock.now_ms()
        while self.clock.now_ms() - start < budget_ms:
            if self._agreeing(expected, include_blocked):
                return self.clock.now_ms() - start
            await self.advance(400)
        return self.clock.now_ms() - start if self._agreeing(expected, include_blocked) else None

    async def converge_members(self, expected: int, budget_ms: float = 12_000) -> None:
        """Raise-on-timeout convergence (the bespoke-scenario tests' form)."""
        elapsed = await self.try_converge(
            expected, budget_ms, include_blocked=False
        )
        if elapsed is None:
            raise AssertionError(
                f"did not converge to {expected}: "
                f"{[self.clusters[i].membership_size for i in sorted(self.live_ids)]}"
            )

    # -- teardown -------------------------------------------------------

    async def shutdown(self) -> set:
        for nc in self.node_clocks.values():
            nc.resume()  # a paused node must not hang its own teardown
        final = set(self.clusters[0].membership) if 0 in self.clusters else set()
        await asyncio.gather(
            *(c.shutdown() for c in self.clusters.values()),
            return_exceptions=True,
        )
        return final


@dataclass
class RunResult:
    """Everything a repro or an oracle needs from one simulated run."""

    schedule: FaultSchedule
    endpoints: List[Endpoint]
    cuts: List[frozenset]
    configs: Dict[int, List[Tuple[int, Tuple[Endpoint, ...]]]]
    kicked: List[int]
    final_membership: set
    live_slots: List[int]
    expected_members: int
    phase_converged: List[bool]
    final_converged: bool
    final_converge_sim_ms: Optional[float]
    aborted_at_event: Optional[int]
    faultlog: List[dict]
    shaper_stats: Dict[str, int]
    snapshots: Dict[int, dict] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "schedule": self.schedule.to_dict(),
            "endpoints": [str(e) for e in self.endpoints],
            "cuts": [
                sorted([str(ep), status.name] for ep, status in cut)
                for cut in self.cuts
            ],
            "configs": {
                str(slot): [
                    {"config_id": cid, "membership": [str(m) for m in members]}
                    for cid, members in history
                ]
                for slot, history in self.configs.items()
            },
            "kicked": sorted(self.kicked),
            "final_membership": sorted(str(e) for e in self.final_membership),
            "live_slots": sorted(self.live_slots),
            "expected_members": self.expected_members,
            "phase_converged": self.phase_converged,
            "final_converged": self.final_converged,
            "final_converge_sim_ms": self.final_converge_sim_ms,
            "aborted_at_event": self.aborted_at_event,
            "shaper_stats": self.shaper_stats,
        }

    def write_repro(self, directory) -> Path:
        """Write the replayable artifact set: the schedule (the repro
        itself), the outcome, the fault log, and one telemetry snapshot per
        node (flight recordings included) for ``tools/traceview.py``."""
        directory = Path(directory)
        (directory / "nodes").mkdir(parents=True, exist_ok=True)
        (directory / "schedule.json").write_text(self.schedule.to_json())
        (directory / "result.json").write_text(
            json.dumps(self.to_dict(), indent=1) + "\n"
        )
        (directory / "faultlog.json").write_text(
            json.dumps(self.faultlog, indent=1) + "\n"
        )
        for slot, snapshot in self.snapshots.items():
            (directory / "nodes" / f"slot{slot:03d}.json").write_text(
                json.dumps(snapshot, indent=1) + "\n"
            )
        return directory


def endpoints_for(seed: int, n_slots: int) -> List[Endpoint]:
    """THE slot->endpoint derivation for generated scenarios — one
    definition, shared by the runner and by family generators that need to
    reason about endpoint-dependent structure (the hierarchical families
    compute the cohort map of the initial cluster to pick delegates and
    cross-cohort links deterministically)."""
    return [
        Endpoint(f"10.83.{seed % 250}.{i % 250}", 7800 + i)
        for i in range(n_slots)
    ]


def sim_settings() -> Settings:
    """The chaos-simulation settings profile: reference protocol defaults,
    with the anti-entropy idle pull fast enough that members healed out of a
    symmetric partition re-join the configuration within a few simulated
    seconds (the 30 s production default would dominate every scenario's
    convergence tail; see settings.py on why the pull is the ONLY channel
    that reaches an evidence-free partition survivor)."""
    settings = Settings()
    settings.config_sync_idle_interval_ms = 2_000
    return settings


#: Cohort size for hierarchical simulation profiles: 4 over the shared
#: 8-member geometry gives exactly two cohorts — the smallest topology where
#: the global reconfiguration tier does real work (cross-cohort stitching,
#: delegate failover) while every cohort stays big enough to self-detect.
HIER_SIM_COHORT_SIZE = 4


def hier_sim_settings() -> Settings:
    """The chaos settings profile for two-level hierarchical membership
    (rapid_tpu_torch/hier): the flat sim profile plus cohort mode."""
    settings = sim_settings()
    settings.hier_target_cohort_size = HIER_SIM_COHORT_SIZE
    return settings


class ScenarioRunner:
    """Interpret a :class:`FaultSchedule` over a fresh simulated cluster."""

    def __init__(
        self,
        schedule: FaultSchedule,
        settings: Optional[Settings] = None,
        wall_timeout_s: float = 300.0,
    ) -> None:
        schedule.validate()
        self.schedule = schedule
        if settings is not None:
            self.settings = settings
        elif schedule.profile == "hier":
            self.settings = hier_sim_settings()
        else:
            self.settings = sim_settings()
        self.wall_timeout_s = wall_timeout_s

    def endpoints(self) -> List[Endpoint]:
        return endpoints_for(self.schedule.seed, self.schedule.n_slots)

    def run(self) -> RunResult:
        async def with_timeout() -> RunResult:
            return await asyncio.wait_for(self._run(), timeout=self.wall_timeout_s)

        return asyncio.run(with_timeout())

    async def _run(self) -> RunResult:
        s = self.schedule
        harness = SimHarness(
            self.endpoints(), settings=self.settings, id_seed=s.seed
        )
        harness.attach_shaper(schedule_rng(s))
        await harness.bootstrap(s.n0)

        expected = s.n0
        phase_converged: List[bool] = []
        faultlog: List[dict] = []
        aborted_at: Optional[int] = None
        overlap_pending = 0  # unsettled membership events awaiting a settle
        # Which false_alert/alert_storm events cross H (and therefore evict
        # their subject) — precomputed once so the runner, the schedule's
        # expected-membership accounting, and the oracles share the single
        # cumulative-ring definition in faults.py.
        crossings = s.adversarial_crossings()

        for i, event in enumerate(s.events):
            faultlog.append(
                {"t_ms": harness.clock.now_ms(), **event.to_dict()}
            )
            try:
                expected += await self._apply(harness, event)
            except (JoinError, AssertionError):
                # A join that cannot complete under the injected faults (or
                # a lifecycle assertion) ends the run: the oracles judge
                # what the cluster reached, not what it never attempted.
                aborted_at = i
                break
            if i in crossings or event.kind == "committee_crash":
                # A past-H lie evicts its healthy subject; an armed
                # committee crash removes its victim once tripped. Both
                # change the expected membership like any schedule fault.
                expected -= 1
            if (
                event.kind in MEMBERSHIP_KINDS
                or i in crossings
                or event.kind == "committee_crash"
            ):
                if not event.settle:
                    overlap_pending += 1
                    # The dwell is the overlap window: how much simulated
                    # time passes before the NEXT event lands on top.
                    if event.dwell_ms:
                        await harness.advance(event.dwell_ms)
                    continue
                overlap_pending = 0
                elapsed = await harness.try_converge(
                    expected, s.phase_budget_ms, include_blocked=False
                )
                phase_converged.append(elapsed is not None)
                if elapsed is None:
                    aborted_at = i
                    break
            if event.dwell_ms:
                await harness.advance(event.dwell_ms)

        if overlap_pending and aborted_at is None:
            # Defensive: validate() rejects trailing non-settled events, so
            # an overlapped group is always closed by a settling event.
            phase_converged.append(
                await harness.try_converge(
                    expected, s.phase_budget_ms, include_blocked=False
                )
                is not None
            )

        # Final convergence: EVERY live node — including partition survivors
        # that must catch up — inside the schedule's bound. This is what the
        # bounded-convergence oracle asserts.
        final_ms = await harness.try_converge(
            expected, s.converge_budget_ms, include_blocked=True
        )

        snapshots = {
            slot: cluster.telemetry_snapshot()
            for slot, cluster in harness.clusters.items()
        }
        live_slots = sorted(harness.live_ids)
        shaper = harness.shaper
        cuts = list(harness.cuts)
        configs = {k: list(v) for k, v in harness.configs.items()}
        kicked = list(harness.kicked)
        final = await harness.shutdown()
        return RunResult(
            schedule=s,
            endpoints=harness.endpoints,
            cuts=cuts,
            configs=configs,
            kicked=kicked,
            final_membership=final,
            live_slots=live_slots,
            expected_members=expected,
            phase_converged=phase_converged,
            final_converged=final_ms is not None,
            final_converge_sim_ms=final_ms,
            aborted_at_event=aborted_at,
            faultlog=faultlog,
            shaper_stats={
                "dropped": shaper.dropped if shaper else 0,
                "delayed": shaper.delayed if shaper else 0,
                "duplicated": shaper.duplicated if shaper else 0,
                "asym_dropped": shaper.asym_dropped if shaper else 0,
                "asym_delayed": shaper.asym_delayed if shaper else 0,
            },
            snapshots=snapshots,
        )

    async def _apply(self, harness: SimHarness, event: FaultEvent) -> int:
        """Apply one event; returns the expected-membership delta."""
        kind, slots, args = event.kind, list(event.slots), event.args
        if kind == "crash":
            harness.crash(slots)
            return -len(slots)
        if kind == "join":
            await harness.join_wave(slots)
            return len(slots)
        if kind == "restart":
            for s in slots:
                await harness.restart(s)
            return len(slots)
        if kind == "leave":
            await harness.leave(slots[0])
            return -1
        if kind == "partition_oneway":
            harness.partition_one_way(slots[0])
            return -1
        if kind == "false_alert":
            await harness.false_alert(
                slots[0], int(args["subject"]),
                [int(r) for r in args["rings"]],  # type: ignore[union-attr]
                str(args.get("status", "DOWN")),
            )
            return 0  # the H-crossing delta is the run loop's (cumulative)
        if kind == "alert_storm":
            await harness.alert_storm(
                slots, int(args["subject"]),
                [int(r) for r in args["rings"]],  # type: ignore[union-attr]
                str(args.get("status", "DOWN")),
            )
            return 0
        if kind == "committee_crash":
            harness.arm_committee_crash(slots[0])
            return 0  # armed, not yet crashed; the run loop expects -1
        if kind == "partition":
            harness.partition(slots)
        elif kind == "ingress_block":
            harness.ingress_block(slots)
        elif kind == "heal_partitions":
            harness.heal_partitions()
        elif kind == "link_block":
            harness.block_link(int(args["src"]), int(args["dst"]))
        elif kind == "link_heal":
            harness.heal_link(int(args["src"]), int(args["dst"]))
        elif kind == "loss":
            assert harness.shaper is not None
            harness.shaper.loss_permille = int(args["permille"])
        elif kind == "delay":
            assert harness.shaper is not None
            harness.shaper.delay_min_ms = float(args.get("min_ms", 0.0))
            harness.shaper.delay_max_ms = float(args["max_ms"])
        elif kind == "duplicate":
            assert harness.shaper is not None
            harness.shaper.dup_permille = int(args["permille"])
        elif kind == "wan_asym":
            assert harness.shaper is not None
            harness.shaper.asym_group = {harness.endpoints[s] for s in slots}
            harness.shaper.asym_loss_permille = int(args.get("loss_permille", 0))
            harness.shaper.asym_delay_min_ms = float(args.get("delay_min_ms", 0.0))
            harness.shaper.asym_delay_max_ms = float(args.get("delay_max_ms", 0.0))
        elif kind == "drop_first_n":
            harness.drop_first_n(slots[0], str(args["message"]), int(args["count"]))
        elif kind == "clock_skew":
            harness.node_clock(slots[0]).set_skew(float(args["offset_ms"]))
        elif kind == "clock_pause":
            harness.node_clock(slots[0]).pause()
        elif kind == "clock_resume":
            harness.node_clock(slots[0]).resume()
        return 0
