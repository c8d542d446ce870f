"""Multi-node cut detection: the H/L watermark filter.

Semantics follow ``MultiNodeCutDetector.java``: a subject enters the
*pre-proposal* once L distinct rings report it and graduates to the *proposal*
at H reports; the accumulated proposal is released only when no subject sits
between the watermarks (``MultiNodeCutDetector.java:84-128``). Implicit edge
invalidation co-reports edges whose observers are themselves failing
(``MultiNodeCutDetector.java:137-164``).

This class is the sequential oracle and the per-node engine for the host
protocol path; ``rapid_tpu_torch.ops.cut_detection`` is the batched device kernel
with the same per-batch semantics.

A copy of ``rapid_tpu/protocol/cut_detector.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, TYPE_CHECKING

from rapid_tpu_torch.types import AlertMessage, EdgeStatus, Endpoint
from rapid_tpu_torch.utils.flight_recorder import EventName, FlightRecorder

if TYPE_CHECKING:
    from rapid_tpu_torch.protocol.view import MembershipView

_K_MIN = 3


class MultiNodeCutDetector:
    def __init__(self, k: int, h: int, l: int) -> None:
        if h > k or l > h or k < _K_MIN or l <= 0 or h <= 0:
            raise ValueError(f"arguments must satisfy K >= H >= L >= 1, K >= 3: K={k} H={h} L={l}")
        self.k = k
        self.h = h
        self.l = l
        self._proposal_count = 0
        self._updates_in_progress = 0
        self._reports_per_host: Dict[Endpoint, Dict[int, Endpoint]] = {}
        self._proposal: Set[Endpoint] = set()
        self._pre_proposal: Set[Endpoint] = set()
        self._seen_down_events = False
        # Observability seam (bind_recorder): the owning service threads its
        # flight recorder + trace-context supplier in so watermark crossings
        # land in the same correlated event stream as the alert/consensus
        # events around them. None (standalone detector) = no recording.
        self._recorder: Optional[FlightRecorder] = None
        self._trace: Callable[[], Optional[int]] = lambda: None

    def bind_recorder(
        self, recorder: FlightRecorder, trace_supplier: Callable[[], Optional[int]]
    ) -> None:
        self._recorder = recorder
        self._trace = trace_supplier

    def _record(self, name: EventName, **fields) -> None:
        if self._recorder is not None:
            self._recorder.record(name, trace_id=self._trace(), **fields)

    @property
    def num_proposals(self) -> int:
        return self._proposal_count

    def has_pending_reports(self) -> bool:
        """True while any edge report is held for the current configuration —
        the service's alert-redelivery and config-sync loops use this as the
        'a cut may be stuck below H somewhere' suspicion signal."""
        return bool(self._reports_per_host)

    def aggregate(self, msg: AlertMessage) -> List[Endpoint]:
        """Apply one alert (all its ring numbers); returns the released
        proposal if this alert completed one, else [] (MultiNodeCutDetector.java:76-82)."""
        out: List[Endpoint] = []
        for ring_number in msg.ring_numbers:
            out.extend(
                self._aggregate_edge(msg.edge_src, msg.edge_dst, msg.edge_status, ring_number)
            )
        return out

    def _aggregate_edge(
        self, link_src: Endpoint, link_dst: Endpoint, status: EdgeStatus, ring_number: int
    ) -> List[Endpoint]:
        if status == EdgeStatus.DOWN:
            self._seen_down_events = True

        reports_for_host = self._reports_per_host.setdefault(link_dst, {})
        if ring_number in reports_for_host:
            return []  # duplicate announcement for this ring, ignore
        reports_for_host[ring_number] = link_src
        num_reports = len(reports_for_host)

        if num_reports == self.l:
            self._updates_in_progress += 1
            self._pre_proposal.add(link_dst)
            self._record(
                EventName.CUT_L_CROSSED, subject=str(link_dst), reports=num_reports
            )

        if num_reports == self.h:
            self._pre_proposal.discard(link_dst)
            self._proposal.add(link_dst)
            self._updates_in_progress -= 1
            self._record(
                EventName.CUT_H_CROSSED, subject=str(link_dst), reports=num_reports
            )
            if self._updates_in_progress == 0:
                # Every subject past H and none in (L, H): release the cut.
                self._proposal_count += 1
                ret = list(self._proposal)
                self._proposal.clear()
                self._record(
                    EventName.CUT_RELEASED,
                    subjects=[str(node) for node in ret],
                )
                return ret
        return []

    def invalidate_failing_edges(self, view: "MembershipView") -> List[Endpoint]:
        """Implicit detection of edges whose observers are themselves failing
        (MultiNodeCutDetector.java:137-164). Safe no-op without DOWN events."""
        if not self._seen_down_events:
            return []
        proposals: List[Endpoint] = []
        for node_in_flux in list(self._pre_proposal):
            observers = (
                view.observers_of(node_in_flux)
                if view.is_host_present(node_in_flux)
                else view.expected_observers_of(node_in_flux)
            )
            for ring_number, observer in enumerate(observers):
                if observer in self._proposal or observer in self._pre_proposal:
                    status = (
                        EdgeStatus.DOWN if view.is_host_present(node_in_flux) else EdgeStatus.UP
                    )
                    proposals.extend(
                        self._aggregate_edge(observer, node_in_flux, status, ring_number)
                    )
        return proposals

    def aggregate_batch(self, msgs, view: "MembershipView") -> Set[Endpoint]:
        """Apply one alert batch plus implicit invalidation; returns the union
        of released proposals — the exact quantity the membership service
        consumes per BatchedAlertMessage (MembershipService.java:300-354).

        This is the detector SPI the service calls; device-backed detectors
        override it with a single batched kernel invocation."""
        proposal: Set[Endpoint] = set()
        for msg in msgs:
            proposal.update(self.aggregate(msg))
        proposal.update(self.invalidate_failing_edges(view))
        return proposal

    def clear(self) -> None:
        """Reset after a view change (MultiNodeCutDetector.java:169-178)."""
        self._reports_per_host.clear()
        self._proposal.clear()
        self._pre_proposal.clear()
        self._updates_in_progress = 0
        self._proposal_count = 0
        self._seen_down_events = False
