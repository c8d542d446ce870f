"""Device-backed cut detection for host membership nodes (the port of
``rapid_tpu/protocol/device_cut_detector.py``): the unchanged membership
service front-end, with the multi-node cut detector's tallies running as
one ``process_alert_batch`` pass per ``BatchedAlertMessage``
(``rapid_tpu_torch.ops.cut_detection``) on the card.

The endpoint<->slot map and the invalidation-observer table are kept on the
host and mirrored on the device. A batch stages what it changed (its alerts,
and the table columns and subject-mask entries of the slots it touched) in
one int32 buffer, which goes up in one upload that does not wait
(:func:`rapid_tpu_torch._host.upload`) and lands with ``index_copy_``.
``seen_down`` is a pure function of the batches' DOWN flags, so the host
keeps it exactly and never reads it back. Each pass costs one counted read
(:func:`rapid_tpu_torch._host.read`): the indices of the proposal, empty
exactly when the pass does not propose. Semantics are held to the JAX
class's and to ``MultiNodeCutDetector``'s by ``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set, TYPE_CHECKING

import numpy as np
import torch

from rapid_tpu_torch import _host
from rapid_tpu_torch.models.state import resolve_device
from rapid_tpu_torch.ops.cut_detection import CutState, alerts_to_report_matrix, process_alert_batch
from rapid_tpu_torch.types import AlertMessage, EdgeStatus, Endpoint

if TYPE_CHECKING:
    from rapid_tpu_torch.protocol.view import MembershipView

LOG = logging.getLogger(__name__)

_K_MIN = 3


class DeviceCutDetector:
    """Drop-in for MultiNodeCutDetector (same constructor contract and
    aggregate_batch SPI), tallying on ``device``: CUDA unless the caller
    names another (``device="cpu"`` in the tests). The trailing keyword
    keeps the factory contract ``factory(k, h, l)``.

    ``batches`` and ``bytes_uploaded`` count the passes run (one counted
    read each) and the bytes they staged, since construction."""

    def __init__(self, k: int, h: int, l: int, max_slots: int = 4096, device=None) -> None:
        if h > k or l > h or k < _K_MIN or l <= 0 or h <= 0:
            raise ValueError(f"arguments must satisfy K >= H >= L >= 1, K >= 3: K={k} H={h} L={l}")
        self.k = k
        self.h = h
        self.l = l
        self.max_slots = max_slots
        self.device = resolve_device(device)
        self.batches = 0
        self.bytes_uploaded = 0
        self._proposal_count = 0
        self._reset_state()

    def _reset_state(self) -> None:
        self._slot_of: Dict[Endpoint, int] = {}
        self._endpoint_of: List[Optional[Endpoint]] = [None] * self.max_slots
        self._state = CutState.create(self.max_slots, self.k, self.device)
        # Invalidation-observer table, filled lazily per touched subject: the
        # host copy is the truth, the device copy receives the dirty columns.
        self._inval_obs = np.full((self.k, self.max_slots), -1, dtype=np.int32)
        self._subject_mask = np.zeros(self.max_slots, dtype=bool)
        self._inval_obs_dev = torch.full(
            (self.k, self.max_slots), -1, dtype=torch.int32, device=self.device
        )
        self._subject_mask_dev = torch.zeros(self.max_slots, dtype=torch.bool, device=self.device)
        self._dirty: Set[int] = set()
        self._seen_down = False
        self._keep: List[torch.Tensor] = []
        self._observers_filled: set = set()
        self._overflow_warned = False

    @property
    def num_proposals(self) -> int:
        return self._proposal_count

    def has_pending_reports(self) -> bool:
        """True while any subject occupies a report slot this configuration —
        same suspicion signal as MultiNodeCutDetector.has_pending_reports."""
        return bool(self._slot_of)

    def _slot(self, endpoint: Endpoint) -> Optional[int]:
        """Slot for an endpoint, or None when capacity is exhausted. Alerts
        for unslottable endpoints are dropped — always protocol-safe (alert
        delivery is best-effort) and strictly better than wedging the node's
        alert handler for the rest of the configuration."""
        slot = self._slot_of.get(endpoint)
        if slot is None:
            slot = len(self._slot_of)
            if slot >= self.max_slots:
                if not self._overflow_warned:
                    self._overflow_warned = True
                    LOG.warning(
                        "DeviceCutDetector slot capacity %d exhausted; dropping "
                        "alerts for new endpoints until the next view change",
                        self.max_slots,
                    )
                return None
            self._slot_of[endpoint] = slot
            self._endpoint_of[slot] = endpoint
            self._subject_mask[slot] = True
            self._dirty.add(slot)
        return slot

    def _fill_observers(self, subject: Endpoint, view: "MembershipView") -> None:
        """Populate the invalidation-observer column for a touched subject:
        ring observers for members, expected observers for joiners
        (MultiNodeCutDetector.java:147-149). Once per subject per
        configuration."""
        if subject in self._observers_filled:
            return
        slot = self._slot(subject)
        if slot is None:
            return
        self._observers_filled.add(subject)
        observers = (
            view.observers_of(subject)
            if view.is_host_present(subject)
            else view.expected_observers_of(subject)
        )
        for ring_number, observer in enumerate(observers[: self.k]):
            observer_slot = self._slot(observer)
            if observer_slot is not None:
                self._inval_obs[ring_number, slot] = observer_slot
        self._dirty.add(slot)

    def _stage(self, dst_idx: List[int], rings: List[int]):
        """One upload for the batch: its alerts, then the table columns and
        mask entries of every slot it touched, landed on the device copies.
        Returns the alerts' slot and ring tensors."""
        cols = np.fromiter(sorted(self._dirty), dtype=np.int32, count=len(self._dirty))
        self._dirty.clear()
        a, m = len(dst_idx), len(cols)
        buf = np.concatenate([
            np.asarray(dst_idx, dtype=np.int32),
            np.asarray(rings, dtype=np.int32),
            cols,
            self._inval_obs[:, cols].ravel(),
            self._subject_mask[cols].astype(np.int32),
        ])
        self.bytes_uploaded += buf.nbytes
        staged = _host.upload(buf, self.device, self._keep)
        if m:
            at = staged[2 * a:2 * a + m].to(torch.int64)
            self._inval_obs_dev.index_copy_(1, at, staged[2 * a + m:2 * a + m + self.k * m].view(self.k, m))
            self._subject_mask_dev.index_copy_(0, at, staged[2 * a + m + self.k * m:].to(torch.bool))
        return staged[:a], staged[a:2 * a]

    def aggregate_batch(self, msgs, view: "MembershipView") -> Set[Endpoint]:
        """One device pass for the whole alert batch."""
        dst_idx: List[int] = []
        rings: List[int] = []
        has_down = False
        for msg in msgs:
            slot = self._slot(msg.edge_dst)
            if slot is None:
                continue  # capacity exhausted: drop (best-effort delivery)
            self._fill_observers(msg.edge_dst, view)
            for ring_number in msg.ring_numbers:
                dst_idx.append(slot)
                rings.append(ring_number)
            has_down = has_down or msg.edge_status == EdgeStatus.DOWN
        if not dst_idx and not self._seen_down:
            return set()

        dst, ring = self._stage(dst_idx, rings)
        new_reports = alerts_to_report_matrix(self.max_slots, self.k, dst, ring, self.device)
        result = process_alert_batch(
            self._state,
            new_reports,
            has_down,
            self._inval_obs_dev,
            self._subject_mask_dev,
            self.h,
            self.l,
        )
        self._state = result.state
        self._seen_down = self._seen_down or has_down
        self.batches += 1
        # The mask is empty exactly when the pass does not propose.
        hits = _host.read(torch.nonzero(result.proposal_mask).flatten())
        self._keep.clear()  # the read waited for the stream to pass the upload
        if not hits:
            return set()
        self._proposal_count += 1
        return {self._endpoint_of[i] for i in hits}

    # -- single-alert API parity (tests, tooling) -----------------------

    def aggregate(self, msg: AlertMessage) -> List[Endpoint]:
        return sorted(self.aggregate_batch([msg], _EmptyView()), key=str)

    def invalidate_failing_edges(self, view: "MembershipView") -> List[Endpoint]:
        return sorted(self.aggregate_batch([], view), key=str)

    def clear(self) -> None:
        self._proposal_count = 0
        self._reset_state()


class _EmptyView:
    """View stand-in for single-alert aggregation without invalidation."""

    def is_host_present(self, node) -> bool:
        return False

    def observers_of(self, node):
        return []

    def expected_observers_of(self, node):
        return []
