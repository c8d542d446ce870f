"""The fault vocabulary of the sim families (a copy of ``FaultEvent``,
``ScheduleError`` and the kind sets of ``rapid_tpu/sim/faults.py``).

The streaming pipeline speaks it: a :class:`~rapid_tpu_torch.serving.stream.StreamWave`
spells itself as ``crash``/``join`` events
(:meth:`~rapid_tpu_torch.serving.stream.StreamWave.fault_events`), and
:func:`~rapid_tpu_torch.serving.stream.waves_from_schedule` turns a schedule
back into waves. The schedule model, its serialization, the runner and the
link shaper stay in the JAX package: they drive its host stack, which the
port does not have.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

#: Events that change the expected membership.
MEMBERSHIP_KINDS = frozenset({"crash", "restart", "join", "leave", "partition_oneway"})

#: Network and clock events: applied at once, never waited on.
ENVIRONMENT_KINDS = frozenset({
    "partition", "ingress_block", "heal_partitions", "link_block", "link_heal",
    "loss", "delay", "duplicate", "drop_first_n", "wan_asym",
    "clock_skew", "clock_pause", "clock_resume",
})

#: Hostile events: observers that lie, and the committee-member crash.
ADVERSARIAL_KINDS = frozenset({"false_alert", "alert_storm", "committee_crash"})

ALL_KINDS = MEMBERSHIP_KINDS | ENVIRONMENT_KINDS | ADVERSARIAL_KINDS


class ScheduleError(ValueError):
    """An ill-formed schedule entry; raised at :class:`FaultEvent`
    construction for a kind outside :data:`ALL_KINDS`."""


@dataclass(frozen=True)
class FaultEvent:
    """One schedule entry. ``slots`` carries the subject slot indices (empty
    for global events); ``args`` the kind-specific parameters; ``dwell_ms``
    the simulated time advanced after the event; ``settle=False`` overlaps a
    membership event with the next one instead of waiting for convergence.
    An unregistered ``kind`` raises at construction."""

    kind: str
    slots: Tuple[int, ...] = ()
    args: Dict[str, object] = field(default_factory=dict)
    dwell_ms: float = 0.0
    settle: bool = True

    def __post_init__(self) -> None:
        if self.kind not in ALL_KINDS:
            raise ScheduleError(
                f"unknown kind {self.kind!r}; registered kinds: "
                f"{sorted(ALL_KINDS)}"
            )
