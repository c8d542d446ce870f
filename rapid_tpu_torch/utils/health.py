"""Per-node health model and its cluster-wide aggregation (a copy of
``rapid_tpu/utils/health.py``).

The protocol's suspicion machinery names "how is this node doing" as a
small ordered vocabulary, so that ``telemetry_snapshot()``, the Prometheus
exposition and ``tools/clustertop.py`` speak the same states:

- ``STABLE``      — no membership change in flight; the steady state.
- ``DETECTING``   — edge reports held below the H watermark.
- ``PROPOSING``   — a cut proposal is announced and consensus is undecided.
- ``CATCHING_UP`` — a decided configuration could not be applied locally.
- ``WEDGED``      — the catch-up loop escalated, or the node was evicted.

States are severity-ordered; a node in several conditions reports the worst.
``aggregate_health`` folds many nodes' states into one cluster view.
"""
from __future__ import annotations

import enum
from typing import Dict, Iterable, Union


class NodeHealth(enum.Enum):
    """Severity-ordered node health vocabulary (worst last)."""

    STABLE = "stable"
    DETECTING = "detecting"
    PROPOSING = "proposing"
    CATCHING_UP = "catching_up"
    WEDGED = "wedged"

    @property
    def severity(self) -> int:
        return _SEVERITY[self]


_SEVERITY: Dict[NodeHealth, int] = {
    NodeHealth.STABLE: 0,
    NodeHealth.DETECTING: 1,
    NodeHealth.PROPOSING: 2,
    NodeHealth.CATCHING_UP: 3,
    NodeHealth.WEDGED: 4,
}


def parse_health(value: Union[str, NodeHealth, None]) -> NodeHealth:
    """Lenient parse for snapshot JSON: enum value ('stable') or member name
    ('STABLE'); unknown/absent values read as STABLE (an old snapshot
    predating the health model must not render a node as unhealthy)."""
    if isinstance(value, NodeHealth):
        return value
    if isinstance(value, str):
        try:
            return NodeHealth(value.lower())
        except ValueError:
            pass
    return NodeHealth.STABLE


def aggregate_health(
    states: Iterable[Union[str, NodeHealth, None]],
) -> Dict[str, object]:
    """Cluster-wide fold of per-node health states: the worst state present
    (the cluster is only as healthy as its sickest member) plus per-state
    counts — zero-filled over the full vocabulary so consumers see a stable
    shape. An empty input aggregates to STABLE with all-zero counts."""
    counts = {state.value: 0 for state in NodeHealth}
    worst = NodeHealth.STABLE
    for raw in states:
        state = parse_health(raw)
        counts[state.value] += 1
        if state.severity > worst.severity:
            worst = state
    return {"overall": worst.value, "counts": counts}
