"""Device-backed Fast Paxos vote tallying for host membership nodes (the
port of ``rapid_tpu/protocol/device_vote_tally.py``): each fast-round vote
becomes a slot of device arrays (sender slot -> proposal hash lanes), and
the quorum check is ``rapid_tpu_torch.ops.consensus.tally_candidates`` over
all slots, the tally the engine runs.

A vote before quorum touches only host mirrors of the arrays: no launch, no
copy, nothing that waits for the card. Each tally after quorum uploads the
slots written since the last one in one buffer that does not wait
(:func:`rapid_tpu_torch._host.upload`), lands them with ``index_copy_``, and
reads the decision and both winner lanes back in one counted read
(:func:`rapid_tpu_torch._host.read`). The lanes are uint32 values stored as
int32 bit patterns (:mod:`rapid_tpu_torch._u32`), so the winner is widened
back to unsigned before it is looked up.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from rapid_tpu_torch import _host, _u32
from rapid_tpu_torch.models.state import resolve_device
from rapid_tpu_torch.ops.consensus import fast_paxos_quorum, tally_candidates
from rapid_tpu_torch.types import Endpoint
from rapid_tpu_torch.utils.xxhash import xxh64

LOG = logging.getLogger(__name__)

Proposal = Tuple[Endpoint, ...]


def _proposal_hash_lanes(proposal: Proposal) -> Tuple[int, int]:
    """64-bit identity of a canonical (ring-0-sorted) endpoint list, split
    into uint32 lanes (the host analog of the engine's set hashes). The full
    64-bit running hash seeds every chaining step — truncating it would
    bottleneck distinct-proposal collisions at 2^-32."""
    h = 0x243F6A8885A308D3
    for ep in proposal:
        h = xxh64(ep.hostname.encode("utf-8"), h)
        h = xxh64(ep.port.to_bytes(4, "little"), h)
    return (h >> 32) & 0xFFFFFFFF, h & 0xFFFFFFFF


class DeviceVoteTally:
    """Drop-in vote tally for FastPaxos (see its ``vote_tally`` parameter),
    on ``device``: CUDA unless the caller names another (``device="cpu"`` in
    the tests). The trailing keyword keeps the factory contract
    ``factory(membership_size)``.

    ``add_vote(sender, proposal)`` records one fast-round vote and returns the
    decided proposal once the reference's rule holds: total votes >= N - F and
    votes for one identical proposal >= N - F, F = floor((N-1)/4)
    (FastPaxos.java:145-150). ``tallies`` and ``bytes_uploaded`` count the
    device tallies run (one counted read each) and the bytes they staged.
    """

    def __init__(
        self, membership_size: int, max_slots: int = 4096, max_proposals: int = 32, device=None
    ):
        self.n = membership_size
        self.max_slots = max(max_slots, membership_size)
        self.max_proposals = max_proposals
        self.device = resolve_device(device)
        self.tallies = 0
        self.bytes_uploaded = 0
        self._sender_slot: Dict[Endpoint, int] = {}
        self._voted: set = set()
        self._proposal_index: Dict[Tuple[int, int], int] = {}
        self._proposals: List[Proposal] = []
        # Host mirrors (stored uint32 bit patterns) and the slots written
        # since the last tally.
        self._lanes = np.zeros((2, self.max_slots), dtype=np.int32)
        self._cand_lanes = np.zeros((2, max_proposals), dtype=np.int32)
        self._dirty_votes: Set[int] = set()
        self._dirty_cands: Set[int] = set()
        self._keep: List[torch.Tensor] = []
        # Persistent device arrays, written only by the tallies' uploads.
        dev = self.device
        self._vote_hi = torch.zeros(self.max_slots, dtype=torch.int32, device=dev)
        self._vote_lo = torch.zeros(self.max_slots, dtype=torch.int32, device=dev)
        self._vote_valid = torch.zeros(self.max_slots, dtype=torch.bool, device=dev)
        self._cand_hi = torch.zeros(max_proposals, dtype=torch.int32, device=dev)
        self._cand_lo = torch.zeros(max_proposals, dtype=torch.int32, device=dev)
        self._cand_valid = torch.zeros(max_proposals, dtype=torch.bool, device=dev)

    def add_vote(self, sender: Endpoint, proposal: Proposal) -> Optional[Proposal]:
        if sender in self._voted:
            return None  # duplicate sender (FastPaxos.java:134-136)
        slot = self._sender_slot.get(sender)
        if slot is None:
            slot = len(self._sender_slot)
            if slot >= self.max_slots:
                LOG.warning(
                    "DeviceVoteTally slot capacity %d exhausted; dropping vote", self.max_slots
                )
                return None
            self._sender_slot[sender] = slot

        lanes = _proposal_hash_lanes(proposal)
        cand = self._proposal_index.get(lanes)
        if cand is None:
            cand = len(self._proposals)
            if cand >= self.max_proposals:
                LOG.warning(
                    "DeviceVoteTally proposal capacity %d exhausted; dropping vote",
                    self.max_proposals,
                )
                return None
            self._proposal_index[lanes] = cand
            self._proposals.append(tuple(proposal))
            self._cand_lanes[:, cand] = (_u32.bits(lanes[0]), _u32.bits(lanes[1]))
            self._dirty_cands.add(cand)

        # One slot per sender, on the host until the next tally.
        self._voted.add(sender)
        self._lanes[:, slot] = (_u32.bits(lanes[0]), _u32.bits(lanes[1]))
        self._dirty_votes.add(slot)

        # No decision is possible before quorum-many votes exist; skip the
        # tally (and its device->host readback) until then.
        if len(self._voted) < fast_paxos_quorum(self.n):
            return None

        self._upload_dirty()
        result = tally_candidates(
            self._vote_hi,
            self._vote_lo,
            self._vote_valid,
            self._cand_hi,
            self._cand_lo,
            self._cand_valid,
            self.n,
        )
        self.tallies += 1
        decided, hi, lo = _host.read(torch.stack((
            result.decided.to(torch.int64), _u32.widen(result.winner_hi), _u32.widen(result.winner_lo),
        )))
        self._keep.clear()  # the read waited for the stream to pass the upload
        if not decided:
            return None
        return self._proposals[self._proposal_index[(hi, lo)]]

    def _upload_dirty(self) -> None:
        """Land the votes and candidates written since the last tally on the
        device arrays: one buffer up, one ``index_copy_`` per array."""
        votes = np.fromiter(sorted(self._dirty_votes), dtype=np.int32, count=len(self._dirty_votes))
        cands = np.fromiter(sorted(self._dirty_cands), dtype=np.int32, count=len(self._dirty_cands))
        self._dirty_votes.clear()
        self._dirty_cands.clear()
        buf = np.concatenate([votes, self._lanes[:, votes].ravel(), cands, self._cand_lanes[:, cands].ravel()])
        self.bytes_uploaded += buf.nbytes
        staged = _host.upload(buf, self.device, self._keep)
        v, c = len(votes), len(cands)
        for idx, lanes, hi, lo, valid in (
            (staged[:v], staged[v:3 * v], self._vote_hi, self._vote_lo, self._vote_valid),
            (staged[3 * v:3 * v + c], staged[3 * v + c:], self._cand_hi, self._cand_lo, self._cand_valid),
        ):
            if len(idx):
                at = idx.to(torch.int64)
                m = len(idx)
                hi.index_copy_(0, at, lanes[:m])
                lo.index_copy_(0, at, lanes[m:])
                valid.index_fill_(0, at, True)
