"""Deterministic chaos-simulation subsystem.

The reference validates Rapid's headline claim — stable, consistent
membership under adverse networks — with fault-injection test fixtures
(``MessageDropInterceptor.java``) driven by hand-written scenarios. This
package turns that into a subsystem in the FoundationDB/Jepsen mold:

- :mod:`rapid_tpu_torch.sim.faults` — a declarative, serializable fault-schedule
  model (link loss/delay/duplication, symmetric and asymmetric partitions,
  crash/restart, clock skew/pause) compiled onto the in-process transport's
  fault seams and the injected clock, so a whole run is a pure function of
  one seed;
- :mod:`rapid_tpu_torch.sim.scenario` — the scenario runner: builds a cluster,
  steps simulated time, applies the schedule, and captures a replayable
  repro artifact (schedule + per-node flight recordings + outcome);
- :mod:`rapid_tpu_torch.sim.oracles` — invariant checkers executed after every
  run: configuration-chain consistency (no split-brain), per-node
  monotonicity, final agreement, eviction discipline, bounded convergence,
  and the differential host<->device oracle that replays the same schedule
  through the engine (on CUDA unless ``device`` names another device);
- :mod:`rapid_tpu_torch.sim.fuzz` — seeded random-schedule generation plus a
  greedy shrinker that minimizes any oracle-violating schedule into the
  smallest repro that still fails.

``tools/chaosrun.py``, the CLI over all four, drives the JAX package only;
here they are called as a library (:func:`~rapid_tpu_torch.sim.fuzz.replay`
reads the repro directories either package writes).
"""

from rapid_tpu_torch.sim.faults import FaultEvent, FaultSchedule, LinkShaper
from rapid_tpu_torch.sim.scenario import RunResult, ScenarioRunner, SimHarness

__all__ = [
    "FaultEvent",
    "FaultSchedule",
    "LinkShaper",
    "RunResult",
    "ScenarioRunner",
    "SimHarness",
]
