"""The engine side of the chaos-simulation subsystem (port of
``rapid_tpu/sim``):

- :mod:`rapid_tpu_torch.sim.faults`: the declarative, serializable fault
  schedule model, its validation and the accounting the engine compilers
  read (membership phases, expected members, adversarial crossings);
- :mod:`rapid_tpu_torch.sim.scenario`: the slot->endpoint derivation and
  the simulation settings profiles;
- :mod:`rapid_tpu_torch.sim.fuzz`: the named scenario families, seeded
  random schedules and the shrinker's candidate reductions;
- :mod:`rapid_tpu_torch.sim.oracles`: the engine half of the oracles
  (the engine replay, the refinement check and the differential oracle).

The scenario runner, the link shaper and the host oracles drive the JAX
package's asyncio stack, which the port does not have.
"""

from rapid_tpu_torch.sim.faults import FaultEvent, FaultSchedule

__all__ = ["FaultEvent", "FaultSchedule"]
