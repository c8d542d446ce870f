"""Deterministic cohort assignment + cohort-scoped monitoring topology.

The cohort map is a pure function of (membership set, seed, target size):
members are ordered by a seeded 64-bit hash (endpoint tie-break, exactly the
ring-key discipline of :mod:`rapid_tpu_torch.protocol.view`) and split into
``n_cohorts = max(1, (n + target//2) // target)`` contiguous chunks whose
sizes differ by at most one. Every node computes the identical map from the
same configuration — no coordination, no extra wire traffic — and the map is
rebuilt ONLY at reconfiguration (the service's per-configuration reset), so
cohort membership never shifts under a node mid-change.

Delegates and the global committee are positional: a cohort's delegate is
its first member in chunk order; its failover candidates are the members
after it; the global reconfiguration committee is the first
``committee_per_cohort`` members of every cohort. A committee of >1 per
cohort is what keeps the global tier live across a delegate failure — with
one delegate per cohort and two cohorts, a single dead delegate would stall
even classic Paxos (majority of 2 is 2).

A joiner (not yet a member) is assigned to the cohort whose hash-order chunk
its own key falls into, so its gatekeepers — and the cohort that runs its
admission — are computable by every node before it is admitted.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

from rapid_tpu_torch.protocol.view import MembershipView
from rapid_tpu_torch.types import Endpoint
from rapid_tpu_torch.utils.xxhash import xxh64

#: Committee members contributed by each cohort to the global tier (the
#: delegate plus its first failover candidate). See the module docstring on
#: why one per cohort is not fault tolerant at small cohort counts.
COMMITTEE_PER_COHORT = 2


def cohort_key(endpoint: Endpoint, seed: int) -> int:
    """The seeded ordering key that places an endpoint in the cohort space
    (the same keyspace whether or not the endpoint is a member yet)."""
    return xxh64(str(endpoint).encode("utf-8"), seed ^ 0xC0804)


class CohortMap:
    """One configuration's cohort partition. Immutable after construction."""

    __slots__ = (
        "seed",
        "target_size",
        "n_cohorts",
        "_ordered",
        "_keys",
        "_cohort_of",
        "_chunks",
    )

    def __init__(
        self, members: Iterable[Endpoint], seed: int, target_size: int
    ) -> None:
        if target_size < 2:
            raise ValueError(f"target cohort size must be >= 2, got {target_size}")
        self.seed = seed
        self.target_size = target_size
        ordered = sorted(set(members), key=lambda ep: (cohort_key(ep, seed), ep))
        self._ordered: Tuple[Endpoint, ...] = tuple(ordered)
        self._keys: List[int] = [cohort_key(ep, seed) for ep in ordered]
        n = len(ordered)
        self.n_cohorts = max(1, (n + target_size // 2) // target_size) if n else 1
        # Balanced contiguous chunks: sizes differ by at most one, so no
        # cohort degenerates below the detectability floor while others
        # bloat (a 1-member cohort could never detect its own failure).
        base, extra = divmod(n, self.n_cohorts)
        chunks: List[Tuple[Endpoint, ...]] = []
        cohort_of: Dict[Endpoint, int] = {}
        pos = 0
        for idx in range(self.n_cohorts):
            size = base + (1 if idx < extra else 0)
            chunk = self._ordered[pos : pos + size]
            chunks.append(chunk)
            for ep in chunk:
                cohort_of[ep] = idx
            pos += size
        self._chunks = tuple(chunks)
        self._cohort_of = cohort_of

    # -- queries --------------------------------------------------------

    def cohort_of(self, endpoint: Endpoint) -> int:
        """The cohort index of ``endpoint``: its chunk when it is a member,
        else the chunk its hash key falls into (the joiner assignment — the
        cohort that gatekeeps its admission)."""
        idx = self._cohort_of.get(endpoint)
        if idx is not None:
            return idx
        if not self._ordered:
            return 0
        pos = bisect.bisect_left(
            self._keys, cohort_key(endpoint, self.seed)
        )
        return self._cohort_of[self._ordered[min(pos, len(self._ordered) - 1)]]

    def is_member(self, endpoint: Endpoint) -> bool:
        return endpoint in self._cohort_of

    def members_of(self, cohort: int) -> Tuple[Endpoint, ...]:
        return self._chunks[cohort]

    def delegate_of(
        self, cohort: int, exclude: Iterable[Endpoint] = ()
    ) -> Optional[Endpoint]:
        """The cohort's current forwarder: first chunk member not excluded
        (callers exclude the members a decided cut is removing)."""
        excluded = set(exclude)
        for ep in self._chunks[cohort]:
            if ep not in excluded:
                return ep
        return None

    def forward_candidates(
        self, cohort: int, exclude: Iterable[Endpoint] = ()
    ) -> Tuple[Endpoint, ...]:
        """Deterministic failover order for forwarding a decided cohort cut
        to the global tier: chunk order minus the excluded (cut) members."""
        excluded = set(exclude)
        return tuple(ep for ep in self._chunks[cohort] if ep not in excluded)

    def committee(self) -> Tuple[Endpoint, ...]:
        """The global reconfiguration tier's membership: the first
        ``COMMITTEE_PER_COHORT`` members of every cohort, in cohort order.
        Static for the configuration — quorums need a fixed membership — so
        no dynamic exclusion; a dead committee member is tolerated by the
        classic-majority arithmetic, not by re-selection."""
        out: List[Endpoint] = []
        for chunk in self._chunks:
            out.extend(chunk[:COMMITTEE_PER_COHORT])
        return tuple(out)

    def to_dict(self) -> Dict[str, object]:
        """Telemetry shape: cohort index -> member strings."""
        return {
            "seed": self.seed,
            "n_cohorts": self.n_cohorts,
            "cohorts": {
                str(idx): [str(ep) for ep in chunk]
                for idx, chunk in enumerate(self._chunks)
            },
        }


class CohortTopology:
    """Cohort-scoped expander monitoring rings over one configuration.

    Each cohort gets its own K-ring :class:`MembershipView` built over just
    its members (identifier history is irrelevant for ring queries, so the
    mini-views carry none). ``subjects_of``/``observers_of``/``ring_numbers``
    then answer within the node's cohort — a cohort-local failure is
    detected, reported, and aggregated entirely inside the cohort. Built
    lazily per cohort and only at reconfiguration, alongside the map.
    """

    __slots__ = ("k", "topology", "_map", "_views")

    def __init__(self, cohort_map: CohortMap, k: int, topology: str) -> None:
        self.k = k
        self.topology = topology
        self._map = cohort_map
        self._views: Dict[int, MembershipView] = {}

    def view_of(self, cohort: int) -> MembershipView:
        view = self._views.get(cohort)
        if view is None:
            view = MembershipView(
                self.k,
                endpoints=self._map.members_of(cohort),
                topology=self.topology,
            )
            self._views[cohort] = view
        return view

    def _cohort_view(self, endpoint: Endpoint) -> MembershipView:
        return self.view_of(self._map.cohort_of(endpoint))

    # -- the monitoring-topology SPI the service consults ----------------

    def subjects_of(self, node: Endpoint) -> List[Endpoint]:
        return self._cohort_view(node).subjects_of(node)

    def observers_of(self, node: Endpoint) -> List[Endpoint]:
        return self._cohort_view(node).observers_of(node)

    def expected_observers_of(self, joiner: Endpoint) -> List[Endpoint]:
        return self._cohort_view(joiner).expected_observers_of(joiner)

    def ring_numbers(self, observer: Endpoint, subject: Endpoint) -> List[int]:
        return self._cohort_view(subject).ring_numbers(observer, subject)
