"""Cohort-scoped broadcast: the O(cohort) fan-out of the fast path.

Flat Rapid's ``UnicastToAllBroadcaster`` sends every alert batch and
fast-round vote to all N members. In hierarchical mode the only nodes that
can act on that traffic are the sender's cohort-mates — they hold the
cohort's cut detector and vote in the cohort's fast round — so the
broadcaster restricts the fan-out to them. The scope is recomputed from the
service's cohort map at each ``set_membership`` (i.e. at reconfiguration,
when the map itself was just rebuilt), never mid-configuration.
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional

from rapid_tpu_torch.messaging.base import Broadcaster, MessagingClient
from rapid_tpu_torch.types import Endpoint, RapidRequest

#: scope_fn(full_membership) -> the subset this node fans out to.
ScopeFn = Callable[[List[Endpoint]], List[Endpoint]]


class CohortBroadcaster(Broadcaster):
    def __init__(
        self,
        client: MessagingClient,
        self_endpoint: Endpoint,
        rng: Optional[random.Random] = None,
        scope_fn: Optional[ScopeFn] = None,
    ) -> None:
        self._client = client
        self._self = self_endpoint
        # Identity-seeded default, as everywhere (determinism audit).
        self._rng = rng if rng is not None else random.Random(f"cohort:{self_endpoint}")
        #: Set by the owning service after construction (the service owns
        #: the cohort map the scope is computed from).
        self.scope_fn: Optional[ScopeFn] = scope_fn
        self._members: List[Endpoint] = []  # guarded-by: event-loop

    def broadcast(self, request: RapidRequest) -> None:
        for member in self._members:
            self._client.send_nowait(member, request)

    def set_membership(self, members: List[Endpoint]) -> None:
        scoped = list(self.scope_fn(members)) if self.scope_fn is not None else list(members)
        self._rng.shuffle(scoped)
        self._members = scoped
