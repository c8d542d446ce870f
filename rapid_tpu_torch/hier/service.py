"""Two-level membership service: cohort-local fast path + global tier.

:class:`HierMembershipService` subclasses the flat
:class:`~rapid_tpu_torch.protocol.service.MembershipService` and re-scopes the
three O(N) surfaces to the cohort while leaving every safety mechanism —
join bookkeeping, config catch-up, KICKED discipline, the totally-ordered
configuration chain — untouched:

1. **Monitoring + detection** (``_monitor_topology``/``_cut_view``): failure
   detectors watch K ring-predecessors *within the node's cohort*; alert
   batches broadcast cohort-scoped (:class:`CohortBroadcaster`); the
   H/L-watermark cut detector aggregates over cohort ring numbers. A
   cohort-local failure is detected with O(cohort·K) messages.

2. **Cohort agreement** (``_new_fast_paxos``): the released cut enters a
   Fast-Paxos round whose membership is the cohort — quorum arithmetic,
   classic fallback, vote redelivery all unchanged, just over c nodes
   instead of N. The decision is a *cohort cut proposal*, not yet a view
   change.

3. **Global reconfiguration tier**: a small committee (the first
   ``COMMITTEE_PER_COHORT`` members of every cohort) runs the identical
   Fast-Paxos/classic machinery — wrapped in ``GlobalTierMessage`` envelopes
   so the two tiers' consensus traffic cannot cross — over cohort cut
   proposals. Decided cohort cuts are forwarded to the committee as
   ``CohortCutMessage``s by the cohort's delegate, with a deterministic
   staggered failover chain (every surviving cohort member re-forwards on an
   escalating timer until the view change lands, so a dead or gray delegate
   costs latency, never liveness). Committee members adopt the union of the
   cuts they know as their global proposal; the global decision is applied
   locally and disseminated to each committee member's own cohort as a
   ``DelegateDecisionMessage``. Every node therefore delivers the same
   totally-ordered configuration chain; a node that misses the decision
   recovers through the existing config-sync/catch-up machinery
   (``_consensus_pending`` keeps the anti-entropy suspicion alive while a
   cohort cut awaits its global decision).

Degenerate single-cohort configurations (membership below ~1.5× the target
cohort size) bypass the global tier: the cohort IS the cluster, and the
cohort decision applies directly — bit-identical to flat Rapid.

The device vote tally (``vote_tally_factory``) is not used in hierarchical
mode: its batched quorum test is sized for the flat N-member round, and the
cohort rounds are small by construction.
"""

from __future__ import annotations

import inspect
import random
from typing import Dict, List, Optional, Tuple

from rapid_tpu_torch.hier.broadcast import CohortBroadcaster
from rapid_tpu_torch.hier.cohorts import CohortMap, CohortTopology
from rapid_tpu_torch.protocol.fast_paxos import FastPaxos
from rapid_tpu_torch.protocol.service import (
    CONSENSUS_TYPES,
    MembershipService,
    _MARK_AGREEMENT,
)
from rapid_tpu_torch.types import (
    CohortCutMessage,
    DelegateDecisionMessage,
    Endpoint,
    GlobalTierMessage,
    NodeId,
    RapidRequest,
    RapidResponse,
    Response,
)
from rapid_tpu_torch.utils.clock import CancelHandle
from rapid_tpu_torch.utils.flight_recorder import EventName

#: Per-cohort phase SLO family: renders as
#: ``rapid_cohort_phase_ms_bucket{phase=...,path=c<idx>}`` (the "phase/path"
#: split of utils/exposition.py). ``cohort_agree`` = proposal release ->
#: cohort consensus; ``global_agree`` = cohort consensus -> global decision.
_COHORT_PHASE_TIMER = "cohort_phase"
_MARK_GLOBAL = "hier_phase_global"


class HierMembershipService(MembershipService):
    def __init__(self, *args, **kwargs) -> None:
        # Positional-compatible with MembershipService (Cluster passes
        # keywords; tests may not) — normalize the ones the hierarchy needs
        # before the base constructor runs, because the base constructor
        # already calls the overridden hooks (_new_fast_paxos,
        # broadcaster.set_membership -> _cohort_scope). The mapping is
        # derived from the base signature itself (not a hardcoded name
        # list), so a base-signature change mis-binds loudly here instead
        # of silently zipping args to the wrong names.
        signature = inspect.signature(MembershipService.__init__)
        bound = signature.bind(None, *args, **kwargs).arguments
        bound.pop("self", None)
        settings = bound["settings"]
        view = bound["view"]
        my_addr = bound["my_addr"]
        target = settings.hier_target_cohort_size
        if target <= 0:
            raise ValueError(
                "HierMembershipService requires settings.hier_target_cohort_size > 0"
            )
        self._hier_target = target
        self._hier_seed = settings.hier_seed
        self._hier_k = settings.k
        self._hier_topology_mode = settings.topology
        self._hier_addr = my_addr
        self._cohort_map = CohortMap(view.ring(0), self._hier_seed, target)
        self._cohort_topology = CohortTopology(
            self._cohort_map, self._hier_k, self._hier_topology_mode
        )
        # Hier coordination state. All of it is event-loop confined: mutated
        # either under the protocol lock (handlers) or from synchronous
        # clock callbacks, never across an await.
        self._awaiting_global = False  # guarded-by: event-loop
        self._global_proposed = False  # guarded-by: event-loop
        self._known_cohort_cuts: Dict[int, Tuple[Endpoint, ...]] = {}  # guarded-by: event-loop
        self._hier_joiner_ids: Dict[Endpoint, NodeId] = {}  # guarded-by: event-loop
        self._forward_handle: Optional[CancelHandle] = None  # guarded-by: event-loop
        self._forward_rank = 0  # guarded-by: event-loop
        self._global_paxos: Optional[FastPaxos] = None  # guarded-by: event-loop
        self._committee: Tuple[Endpoint, ...] = ()  # guarded-by: event-loop

        broadcaster = bound.get("broadcaster")
        if broadcaster is None:
            rng = bound.get("rng")
            broadcaster = CohortBroadcaster(
                bound["client"], my_addr,
                rng=rng if rng is not None else random.Random(f"cohort:{my_addr}"),
                scope_fn=self._cohort_scope,
            )
            bound["broadcaster"] = broadcaster
        elif hasattr(broadcaster, "scope_fn"):
            # An injected strategy (e.g. GossipBroadcaster) that supports
            # scoping relays inside the cohort instead of cluster-wide.
            broadcaster.scope_fn = self._cohort_scope

        super().__init__(**bound)
        self._reset_global_tier()

    # ------------------------------------------------------------------
    # cohort bookkeeping
    # ------------------------------------------------------------------

    def _cohort_scope(self, _members: List[Endpoint]) -> List[Endpoint]:
        """The broadcast fan-out: this node's cohort (it includes self, so
        self-delivery of alerts and votes keeps flat semantics)."""
        m = self._cohort_map
        if not m.is_member(self._hier_addr):
            return []  # evicted: no cohort left to speak to
        return list(m.members_of(m.cohort_of(self._hier_addr)))

    def _my_cohort(self) -> int:
        return self._cohort_map.cohort_of(self._hier_addr)

    def _rebuild_cohorts(self) -> None:
        """Rebalance point: the ONLY place the cohort map changes, entered
        exclusively from the per-configuration reset — cohort membership is
        immutable within a configuration."""
        self._cohort_map = CohortMap(
            self.view.ring(0), self._hier_seed, self._hier_target
        )
        self._cohort_topology = CohortTopology(
            self._cohort_map, self._hier_k, self._hier_topology_mode
        )

    def _reset_global_tier(self) -> None:
        if self._forward_handle is not None:
            self._forward_handle.cancel()
            self._forward_handle = None
        if self._global_paxos is not None:
            self._global_paxos.cancel_fallback()
        self._awaiting_global = False
        self._global_proposed = False
        self._known_cohort_cuts = {}
        self._hier_joiner_ids = {}
        self.metrics.clear_mark(_MARK_GLOBAL)
        m = self._cohort_map
        self._committee = m.committee()
        if m.n_cohorts > 1 and self.my_addr in self._committee:
            self._global_paxos = FastPaxos(
                my_addr=self.my_addr,
                configuration_id=self.view.configuration_id,
                membership_size=len(self._committee),
                broadcast_fn=self._broadcast_global,
                send_fn=self._send_global,
                on_decide=self._on_global_decided,
                clock=self.clock,
                consensus_fallback_base_delay_ms=(
                    self.settings.consensus_fallback_base_delay_ms
                ),
                rng=self.rng,
                on_classic_round=self._count_global_classic_round,
                recorder=self.recorder,
                trace_supplier=lambda: self._trace_id,
            )
        else:
            self._global_paxos = None

    def _count_global_classic_round(self) -> None:
        self.metrics.inc("cohort_global_classic_rounds")

    # ------------------------------------------------------------------
    # base-service seams
    # ------------------------------------------------------------------

    def _monitor_topology(self):
        return self._cohort_topology

    def _cut_view(self):
        return self._cohort_topology.view_of(self._my_cohort())

    def _consensus_pending(self) -> bool:
        # A cohort cut that is decided but not yet globally serialized keeps
        # the anti-entropy suspicion alive: if the global decision (or our
        # DelegateDecisionMessage) is lost, the config-sync pull recovers it.
        return super()._consensus_pending() or self._awaiting_global

    def _new_fast_paxos(self) -> FastPaxos:
        cohort_members = self._cohort_scope([])
        return FastPaxos(
            my_addr=self.my_addr,
            configuration_id=self.view.configuration_id,
            membership_size=max(len(cohort_members), 1),
            broadcast_fn=self.broadcaster.broadcast,  # cohort-scoped
            send_fn=self.client.send_nowait,
            on_decide=self._on_cohort_cut_decided,
            clock=self.clock,
            consensus_fallback_base_delay_ms=(
                self.settings.consensus_fallback_base_delay_ms
            ),
            rng=self.rng,
            on_classic_round=self._on_fast_round_failed,
            recorder=self.recorder,
            trace_supplier=lambda: self._trace_id,
        )

    def _reset_for_new_configuration(self) -> None:
        self._rebuild_cohorts()  # before super: _new_fast_paxos and the
        # broadcaster scope both read the NEW map
        super()._reset_for_new_configuration()
        self._reset_global_tier()

    async def shutdown(self) -> None:
        if self._forward_handle is not None:
            self._forward_handle.cancel()
            self._forward_handle = None
        if self._global_paxos is not None:
            self._global_paxos.cancel_fallback()
        await super().shutdown()

    # ------------------------------------------------------------------
    # tier 1 -> tier 2: cohort decision, forwarding, failover
    # ------------------------------------------------------------------

    def _on_cohort_cut_decided(self, hosts: Tuple[Endpoint, ...]) -> None:
        hosts = tuple(hosts)
        m = self._cohort_map
        if m.n_cohorts <= 1:
            # Degenerate hierarchy: the cohort is the cluster; the cohort
            # decision IS the view change (flat semantics, zero extra hops).
            self._decide_view_change(hosts)
            return
        my_cohort = self._my_cohort()
        now = self.clock.now_ms()
        self.metrics.inc("cohort_cuts_decided")
        if self.metrics.has_mark(_MARK_AGREEMENT):
            # Cohort-agreement slice of the SLO decomposition; the base
            # service's agreement phase keeps running until the view change
            # (it now spans both tiers).
            self.metrics.record_ms(
                _COHORT_PHASE_TIMER,
                self.metrics.elapsed_since_ms(_MARK_AGREEMENT, now),
                phase=f"cohort_agree/c{my_cohort}",
            )
        self.recorder.record(
            EventName.COHORT_CUT_DECIDED,
            config_id=self.view.configuration_id,
            trace_id=self._trace_id,
            cohort=my_cohort,
            proposal=[str(h) for h in hosts],
        )
        for ep in hosts:
            if not self.view.is_host_present(ep) and ep in self._joiner_uuid:
                self._hier_joiner_ids.setdefault(ep, self._joiner_uuid[ep])
        self._register_cohort_cut(my_cohort, hosts)
        # Forwarding with deterministic failover: every surviving cohort
        # member is a candidate, staggered by its rank — the delegate
        # (rank 0) forwards immediately, the backup after one fallback
        # period, and so on; everyone stops once the view change lands
        # (_awaiting_global clears in the per-config reset).
        candidates = m.forward_candidates(my_cohort, exclude=hosts)
        if self.my_addr not in candidates:
            return  # we are in the cut (being removed): survivors forward
        self._forward_rank = candidates.index(self.my_addr)
        if self._forward_rank == 0:
            self._forward_cohort_cut()
        self._arm_forward_timer()

    def _arm_forward_timer(self) -> None:
        if self._forward_handle is not None:
            self._forward_handle.cancel()
        delay_ms = (
            self.settings.consensus_fallback_base_delay_ms
            * (self._forward_rank + 1)
        )
        self._forward_handle = self.clock.call_later_ms(
            delay_ms, self._forward_tick
        )

    def _forward_tick(self) -> None:
        """Clock callback (no lock, like the consensus liveness tick): while
        the global decision is outstanding, (re)forward our cohort's cut —
        redelivery for a lost CohortCutMessage AND failover past a dead
        delegate in one mechanism. Reads event-loop-confined state only."""
        if self._stopped or not self._awaiting_global:
            return
        self._forward_cohort_cut()
        self._arm_forward_timer()

    def _forward_cohort_cut(self) -> None:
        my_cohort = self._my_cohort()
        cut = self._known_cohort_cuts.get(my_cohort)
        if cut is None:
            return
        joiner_pairs = [
            (ep, self._hier_joiner_ids[ep])
            for ep in cut
            if ep in self._hier_joiner_ids
        ]
        message = CohortCutMessage(
            sender=self.my_addr,
            configuration_id=self.view.configuration_id,
            cohort=my_cohort,
            endpoints=cut,
            joiner_eps=tuple(ep for ep, _ in joiner_pairs),
            joiner_ids=tuple(nid for _, nid in joiner_pairs),
            trace_id=self._trace_id,
        )
        self.metrics.inc("cohort_cuts_forwarded")
        self.recorder.record(
            EventName.COHORT_CUT_FORWARDED,
            config_id=self.view.configuration_id,
            trace_id=self._trace_id,
            cohort=my_cohort,
            committee=len(self._committee),
        )
        for member in self._committee:
            if member != self.my_addr:
                self.client.send_nowait(member, message)

    def _register_cohort_cut(
        self, cohort: int, endpoints: Tuple[Endpoint, ...]
    ) -> None:
        self._known_cohort_cuts.setdefault(cohort, tuple(endpoints))
        self._awaiting_global = True
        if not self.metrics.has_mark(_MARK_GLOBAL):
            self.metrics.mark(_MARK_GLOBAL)
        self._maybe_propose_global()

    def _maybe_propose_global(self) -> None:
        """Committee members adopt the union of every cohort cut they know
        as their global proposal — once. Concurrent cuts that race past the
        adoption point disagree on the union and fall back to the classic
        path, which decides ONE of the proposed values; the losing cohort's
        cut is re-detected and re-proposed in the next configuration (the
        same convergence story as flat Rapid's proposal races)."""
        if self._global_paxos is None or self._global_proposed:
            return
        union: set = set()
        for cut in self._known_cohort_cuts.values():
            union.update(cut)
        if not union:
            return
        self._global_proposed = True
        self._global_paxos.propose(tuple(self.view.ring_zero_sorted(union)))

    # ------------------------------------------------------------------
    # tier 2: the committee's consensus transport + decision fan-out
    # ------------------------------------------------------------------

    def _broadcast_global(self, request: RapidRequest) -> None:
        for member in self._committee:
            self.client.send_nowait(
                member, GlobalTierMessage(sender=self.my_addr, payload=request)
            )

    def _send_global(self, destination: Endpoint, request: RapidRequest) -> None:
        self.client.send_nowait(
            destination, GlobalTierMessage(sender=self.my_addr, payload=request)
        )

    def _record_global_phase(self) -> None:
        if self.metrics.has_mark(_MARK_GLOBAL):
            self.metrics.record_ms(
                _COHORT_PHASE_TIMER,
                self.metrics.elapsed_since_ms(_MARK_GLOBAL, self.clock.now_ms()),
                phase=f"global_agree/c{self._my_cohort()}",
            )
            self.metrics.clear_mark(_MARK_GLOBAL)

    def _on_global_decided(self, hosts: Tuple[Endpoint, ...]) -> None:
        hosts = tuple(hosts)
        self.metrics.inc("cohort_global_decisions")
        self.recorder.record(
            EventName.GLOBAL_DECISION,
            config_id=self.view.configuration_id,
            trace_id=self._trace_id,
            proposal=[str(h) for h in hosts],
        )
        self._record_global_phase()
        joiner_pairs = [
            (ep, self._hier_joiner_ids[ep])
            for ep in hosts
            if ep in self._hier_joiner_ids
        ]
        for ep, nid in joiner_pairs:
            self._joiner_uuid.setdefault(ep, nid)
        decision = DelegateDecisionMessage(
            sender=self.my_addr,
            configuration_id=self.view.configuration_id,
            endpoints=hosts,
            joiner_eps=tuple(ep for ep, _ in joiner_pairs),
            joiner_ids=tuple(nid for _, nid in joiner_pairs),
            trace_id=self._trace_id,
        )
        m = self._cohort_map
        if m.is_member(self.my_addr):
            # Dissemination is cohort-parallel: every committee member tells
            # its own cohort (two tellers per cohort — one lost message
            # costs nothing; two lost messages cost one config-sync pull).
            for member in m.members_of(m.cohort_of(self.my_addr)):
                if member != self.my_addr:
                    self.client.send_nowait(member, decision)
        self._decide_view_change(hosts)

    # ------------------------------------------------------------------
    # inbound hier traffic (runs under the protocol lock)
    # ------------------------------------------------------------------

    def _handle_hier_message(self, request: RapidRequest) -> RapidResponse:
        if isinstance(request, CohortCutMessage):
            if (
                request.configuration_id != self.view.configuration_id
                or self._kicked_signalled
            ):
                return Response()
            self._adopt_trace(request.trace_id)
            self.metrics.inc("cohort_cuts_received")
            self.recorder.record(
                EventName.COHORT_CUT_RX,
                config_id=request.configuration_id,
                trace_id=self._trace_id,
                cohort=request.cohort,
                sender=str(request.sender),
            )
            for ep, nid in zip(request.joiner_eps, request.joiner_ids):
                self._hier_joiner_ids.setdefault(ep, nid)
            self._register_cohort_cut(request.cohort, tuple(request.endpoints))
            return Response()
        if isinstance(request, GlobalTierMessage):
            if self._global_paxos is None or not isinstance(
                request.payload, CONSENSUS_TYPES
            ):
                # Not on the committee this configuration (stale sender map),
                # or a payload the tier never emits: acknowledge and drop.
                return Response()
            self._adopt_trace(getattr(request.payload, "trace_id", None))
            return self._global_paxos.handle_message(request.payload)
        if isinstance(request, DelegateDecisionMessage):
            if (
                request.configuration_id != self.view.configuration_id
                or self._kicked_signalled
            ):
                return Response()
            self._adopt_trace(request.trace_id)
            self.metrics.inc("cohort_decisions_received")
            for ep, nid in zip(request.joiner_eps, request.joiner_ids):
                self._joiner_uuid.setdefault(ep, nid)
            self._record_global_phase()
            self._decide_view_change(tuple(request.endpoints))
            return Response()
        return Response()

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def telemetry_snapshot(self, recorder_tail: Optional[int] = None):
        snapshot = super().telemetry_snapshot(recorder_tail=recorder_tail)
        m = self._cohort_map
        my_cohort = self._my_cohort()
        snapshot["cohort"] = my_cohort
        snapshot["hier"] = {
            "n_cohorts": m.n_cohorts,
            "cohort": my_cohort,
            "cohort_size": len(m.members_of(my_cohort)) if m.is_member(self.my_addr) else 0,
            "committee": self.my_addr in self._committee,
            "delegate": m.delegate_of(my_cohort) == self.my_addr,
        }
        return snapshot
