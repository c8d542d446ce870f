"""rapid_tpu_torch: the single-cluster membership engine of ``rapid_tpu``
ported to PyTorch, with its alert-delivery kernel written in CUDA C++ for
NVIDIA Hopper (``csrc/delivery.cu``).

Entry point: :class:`rapid_tpu_torch.models.virtual_cluster.VirtualCluster`.
It runs on CUDA unless given ``device="cpu"``. uint32 lanes are stored as
int32 bit patterns (:mod:`rapid_tpu_torch._u32`). The package imports
``torch`` and numpy only.
"""
