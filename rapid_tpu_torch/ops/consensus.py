"""Fast Paxos vote tally (port of ``rapid_tpu/ops/consensus.py``).

Decided iff ``total_votes >= N - F`` and ``max identical votes >= N - F``
with ``F = floor((N-1)/4)`` (FastPaxos.java:125-156).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rapid_tpu_torch import _u32


def fast_paxos_quorum(n):
    """N - F with F = floor((N-1)/4) (FastPaxos.java:145-146). Works on
    Python ints and integer tensors alike (floor division in both)."""
    return n - (n - 1) // 4


class TallyResult(NamedTuple):
    decided: torch.Tensor  # bool, one per batch (0-d for one cluster)
    winner_hi: torch.Tensor  # stored uint32 (0 when undecided)
    winner_lo: torch.Tensor
    max_count: torch.Tensor  # int32 votes for the best proposal
    total_votes: torch.Tensor  # int32 valid votes seen


def tally_candidates(
    vote_hi: torch.Tensor,
    vote_lo: torch.Tensor,
    vote_valid: torch.Tensor,
    cand_hi: torch.Tensor,
    cand_lo: torch.Tensor,
    cand_valid: torch.Tensor,
    n_members: torch.Tensor,
) -> TallyResult:
    """Count identical votes (``[..., N]`` stored uint32 lanes + validity)
    against C candidate proposals (``[..., C]``), with ``n_members`` over
    the leading batch axes (a fleet's ``[t]``: every tenant takes its own
    quorum). The winner is the lowest-index candidate among those with the
    most votes, selected as a one-hot mask: the same tie-break as
    ``argmax``."""
    c = cand_hi.shape[-1]
    matches = (
        vote_valid[..., None, :]
        & cand_valid[..., :, None]
        & (vote_hi[..., None, :] == cand_hi[..., :, None])
        & (vote_lo[..., None, :] == cand_lo[..., :, None])
    )
    counts = matches.sum(-1, dtype=torch.int32)
    total = vote_valid.sum(-1, dtype=torch.int32)
    max_count = counts.amax(-1)
    cand_ids = torch.arange(c, dtype=torch.int32, device=counts.device)
    best = torch.where(counts == max_count[..., None], cand_ids, c).amin(-1)
    sel = cand_ids == best[..., None]
    quorum = fast_paxos_quorum(n_members)
    decided = (total >= quorum) & (max_count >= quorum)
    # max over uint32 values: widen, since the stored int32 order is signed.
    pick = decided[..., None] & sel
    return TallyResult(
        decided=decided,
        winner_hi=_u32.narrow(torch.where(pick, _u32.widen(cand_hi), 0).amax(-1)),
        winner_lo=_u32.narrow(torch.where(pick, _u32.widen(cand_lo), 0).amax(-1)),
        max_count=max_count,
        total_votes=total,
    )


def undecided_log2_bucket(rounds_undecided: torch.Tensor, buckets: int) -> torch.Tensor:
    """Log2 histogram bucket of a decision's rounds-undecided count:
    ``floor(log2(max(r, 1)))`` clamped into ``[0, buckets)``, elementwise,
    as int32. The JAX version halves ``r`` ``buckets - 1`` times and counts
    the nonzero results; the count of thresholds ``2, 4, ...,
    2**(buckets - 1)`` that ``max(r, 1)`` reaches is the same number, in
    one broadcast compare instead of a loop of launches."""
    r = rounds_undecided.clamp(min=1)
    shifts = torch.arange(1, buckets, dtype=r.dtype, device=r.device)
    return ((r[..., None] >> shifts) > 0).sum(-1, dtype=torch.int32)
