"""Multi-process deployment (port of ``rapid_tpu/parallel/multihost.py``).

The JAX package joins each host process to a ``jax.distributed`` job and
lets XLA route the engine's collectives. Here each process is one rank of a
``torch.distributed`` process group (NCCL between cards, gloo on the CPU),
one card per rank, and the engine's N axis shards across the global mesh
(:func:`global_mesh`); the round body's collectives
(``parallel/collectives.py``) run on the mesh's axis groups.

Nothing here discovers a cluster: every process is told the rendezvous,
the world size and its rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from rapid_tpu_torch.parallel.mesh import make_mesh, shard_pytree


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
) -> None:
    """Join this process to a multi-process job as rank ``process_id`` of
    ``num_processes``. ``coordinator_address``: ``'<host>:<port>'`` of the
    rank-0 rendezvous, or any ``init_method`` URL (``file:///path`` for a
    shared file); None reads ``MASTER_ADDR`` / ``MASTER_PORT`` from the
    environment. NCCL on ``cuda`` (rank r takes card ``r % cards``), gloo
    when ``device_type="cpu"``."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA job was asked for but no card is available "
                               "(pass device_type='cpu')")
        torch.cuda.set_device((process_id or 0) % torch.cuda.device_count())
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend="nccl" if device_type == "cuda" else "gloo",
        init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def global_mesh():
    """A 1-D ``'nodes'`` mesh over every rank of the job, on the job's
    device type. Use with ``parallel.make_sharded_step``."""
    return make_mesh(device_type=_device_type())


def local_device_count() -> int:
    """Cards this process can address (1 on a CPU host: the process is its
    own device)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def is_coordinator() -> bool:
    """True on rank 0 (and in a process that joined no job)."""
    return not dist.is_initialized() or dist.get_rank() == 0


# Multi-controller placement lives in mesh.py (one mechanism for a single
# process and a global job); re-exported as the multi-host vocabulary.
shard_host_pytree = shard_pytree
