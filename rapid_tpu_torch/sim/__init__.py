"""The part of ``rapid_tpu/sim`` the port's serving tier speaks: the fault
vocabulary (:mod:`rapid_tpu_torch.sim.faults`)."""
