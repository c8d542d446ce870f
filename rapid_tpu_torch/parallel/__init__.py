"""The sharded engine (port of ``rapid_tpu/parallel``): the device mesh and
its placements (:mod:`~rapid_tpu_torch.parallel.mesh`), the collective
context the round body communicates through
(:mod:`~rapid_tpu_torch.parallel.collectives`), multi-process set-up
(:mod:`~rapid_tpu_torch.parallel.multihost`) and the collective audit
(:mod:`~rapid_tpu_torch.parallel.collective_facts`, re-exported by
:mod:`~rapid_tpu_torch.parallel.audit`). ``__all__`` is the JAX package's.
"""

from rapid_tpu_torch.parallel.mesh import (
    COHORT_AXIS,
    NODE_AXIS,
    PARTITION_RULES,
    ShardingShapeError,
    fault_shardings,
    make_mesh,
    make_sharded_step,
    make_sharded_wave,
    match_partition_rules,
    pad_to_multiple,
    shard_faults,
    shard_state,
    state_shardings,
)

__all__ = [
    "COHORT_AXIS",
    "NODE_AXIS",
    "PARTITION_RULES",
    "ShardingShapeError",
    "fault_shardings",
    "make_mesh",
    "make_sharded_step",
    "make_sharded_wave",
    "match_partition_rules",
    "pad_to_multiple",
    "shard_faults",
    "shard_state",
    "state_shardings",
]
