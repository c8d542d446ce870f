"""Streaming serving mode (port of ``rapid_tpu/serving``): queue rounds on
the card wave after wave while the host builds the next wave, and measure
sustained throughput rather than one-shot convergence.

``stream`` holds the pipeline: :class:`~rapid_tpu_torch.serving.stream.StreamDriver`
applies each wave's churn through uploads that do not wait, queues the
read-free ``stream_step`` rounds and waits only on completion tickets at
explicit fetch boundaries; :class:`~rapid_tpu_torch.serving.stream.PoissonChurn`
turns a seeded arrival rate into per-wave churn in the sim families' fault
vocabulary.

``supervisor`` and ``recovery`` hold the self-healing tier over it:
deadline-bounded waits with seeded-backoff retries
(:class:`~rapid_tpu_torch.serving.supervisor.Supervisor`), crash-consistent
checkpoint/resume with deterministic replay, per-tenant quarantine of
poisoned fleet tenants, and the seeded
:class:`~rapid_tpu_torch.serving.supervisor.SupervisorFaultPlan` that
injects every failure class the tier must survive.
"""

from rapid_tpu_torch.serving import recovery  # noqa: F401
from rapid_tpu_torch.serving.stream import (  # noqa: F401
    STREAMABLE_KINDS,
    FleetPoissonChurn,
    FleetWave,
    PoissonChurn,
    StreamDriver,
    StreamResult,
    StreamWave,
    waves_from_schedule,
)
from rapid_tpu_torch.serving.supervisor import (  # noqa: F401
    BackoffPolicy,
    DispatchWedgedError,
    SimulatedProcessKill,
    Supervisor,
    SupervisorBudgets,
    SupervisorFaultPlan,
    TransientDispatchError,
)

__all__ = [
    "BackoffPolicy",
    "DispatchWedgedError",
    "FleetPoissonChurn",
    "FleetWave",
    "PoissonChurn",
    "SimulatedProcessKill",
    "StreamDriver",
    "StreamResult",
    "StreamWave",
    "STREAMABLE_KINDS",
    "Supervisor",
    "SupervisorBudgets",
    "SupervisorFaultPlan",
    "TransientDispatchError",
    "recovery",
    "waves_from_schedule",
]
