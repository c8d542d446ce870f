"""rapid_tpu_torch: the membership engine of ``rapid_tpu`` ported to
PyTorch, with its alert-delivery kernel written in CUDA C++ for NVIDIA
Hopper (``csrc/delivery.cu``).

Entry points: :class:`rapid_tpu_torch.models.virtual_cluster.VirtualCluster`
(one cluster, built from a seed or from real endpoints, in the wide or the
compact state layout) and :class:`rapid_tpu_torch.tenancy.TenantFleet` (B
independent clusters per round), the serving tier
(:mod:`rapid_tpu_torch.serving`) and the engine side of the chaos
subsystem (:mod:`rapid_tpu_torch.sim`, :mod:`rapid_tpu_torch.tenancy.chaos`).
They run on CUDA unless given ``device="cpu"``. uint32 lanes are stored as
int32 bit patterns (:mod:`rapid_tpu_torch._u32`), uint16 lanes as int16 bit
patterns (:mod:`rapid_tpu_torch._narrow`). The package imports ``torch``
and numpy only.
"""
