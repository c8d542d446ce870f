"""Fast Paxos vote tally (port of ``rapid_tpu/ops/consensus.py``).

Decided iff ``total_votes >= N - F`` and ``max identical votes >= N - F``
with ``F = floor((N-1)/4)`` (FastPaxos.java:125-156). Two tallies, as in
the JAX package: :func:`tally_candidates` against a candidate list (the
engine's), :func:`tally_sorted` without one. Vote hashes are uint32 under
every compaction policy, and every count accumulates at an explicit int32,
so neither depends on how narrowly the caller stores its other lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rapid_tpu_torch import _u32
from rapid_tpu_torch.ops.hashing import lex_argsort


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
    ctx=None,
) -> TallyResult:
    """Count identical votes (``[..., N]`` stored uint32 lanes + validity)
    against C candidate proposals (``[..., C]``), with ``n_members`` over
    the leading batch axes (a fleet's ``[t]``: every tenant takes its own
    quorum). The winner is the lowest-index candidate among those with the
    most votes, selected as a one-hot mask: the same tie-break as
    ``argmax``. With a collective context (``parallel/collectives.py``) the
    votes are this rank's node shard and the candidates whole: the counts
    are summed over ``'nodes'``."""
    c = cand_hi.shape[-1]
    matches = (
        vote_valid[..., None, :]
        & cand_valid[..., :, None]
        & (vote_hi[..., None, :] == cand_hi[..., :, None])
        & (vote_lo[..., None, :] == cand_lo[..., :, None])
    )
    counts = matches.sum(-1, dtype=torch.int32)
    total = vote_valid.sum(-1, dtype=torch.int32)
    if ctx is not None:
        both = ctx.sum(torch.cat([counts, total[..., None]], -1), ("nodes",), "vote tally")
        counts, total = both[..., :-1], both[..., -1]
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


def tally_sorted(
    vote_hi: torch.Tensor,
    vote_lo: torch.Tensor,
    vote_valid: torch.Tensor,
    n_members: torch.Tensor,
) -> TallyResult:
    """The tally without candidate knowledge, over ``[N]`` stored uint32
    vote lanes: sort the votes by (invalid, hi, lo), count the runs of equal
    hashes, and take the longest (the first in sort order among equals)."""
    n = vote_hi.shape[0]
    dev = vote_hi.device
    order = lex_argsort(((~vote_valid).to(torch.int64), _u32.widen(vote_hi), _u32.widen(vote_lo)))
    hi_s, lo_s, valid_s = vote_hi[order], vote_lo[order], vote_valid[order]
    idx = torch.arange(n, device=dev)
    new_run = (idx == 0) | (hi_s != torch.roll(hi_s, 1)) | (lo_s != torch.roll(lo_s, 1))
    new_run = new_run | ~valid_s  # the invalid tail forms no runs
    run_id = torch.cumsum(new_run, 0) - 1
    counts = torch.zeros((n,), dtype=torch.int32, device=dev).index_add_(
        0, run_id, valid_s.to(torch.int32)
    )
    best_run = torch.argmax(counts)
    max_count = counts[best_run]
    first_of_best = torch.argmax((run_id == best_run).to(torch.int32))
    total = vote_valid.sum(dtype=torch.int32)
    quorum = fast_paxos_quorum(n_members)
    decided = (total >= quorum) & (max_count >= quorum)
    return TallyResult(
        decided=decided,
        winner_hi=torch.where(decided, hi_s[first_of_best], 0).to(torch.int32),
        winner_lo=torch.where(decided, lo_s[first_of_best], 0).to(torch.int32),
        max_count=max_count,
        total_votes=total,
    )
