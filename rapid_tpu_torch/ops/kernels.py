"""The engine's bitmask cores and its one hand-written kernel (port of
``rapid_tpu/ops/pallas_kernels.py``).

- :func:`popcount32` and :func:`watermark_merge_classify`: plain torch, as
  they are plain jnp in the JAX package (its Mosaic watermark kernel was
  measured slower than XLA's fusion and deleted).
- :func:`delivery_new_bits`: the alert-delivery kernel, CUDA C++ for
  Hopper in ``csrc/delivery.cu`` (it replaces the Pallas kernel
  ``delivery_new_bits_pallas``), with its plain version
  :func:`delivery_new_bits_ref`. The wrapper takes the plain version only
  for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from rapid_tpu_torch import _build, _u32


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of stored uint32 lanes as int32 (Hacker's Delight 5-1 on
    the widened values)."""
    v = _u32.widen(v)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def watermark_merge_classify(old_bits, new_bits, subject_mask, h, l):
    """OR-merge ring-report bitmasks (stored uint32), clear non-subjects,
    and classify each slot's tally: 0 none, 1 flux ``[l, h)``, 2 stable
    ``>= h``. Returns (merged bits, int32 class)."""
    merged = torch.where(subject_mask, old_bits | new_bits, 0)
    tally = popcount32(merged)
    stable = tally >= h
    flux = (tally >= l) & (tally < h)
    cls = torch.where(stable, 2, torch.where(flux, 1, 0)).to(torch.int32)
    return merged, cls


def delivery_new_bits_ref(blocked_rows, age_kn, epoch, k: int, c: int, spread: int, permille: int):
    """The plain PyTorch delivery pass (the JAX engine's jnp path,
    ``virtual_cluster._deliver_alerts``), ``[c, n]`` stored uint32.

    blocked_rows: ``[w*k, n]`` stored uint32, row ``wi*k + ring``, bit j =
    cohort ``32*wi + j`` cannot hear the edge's observer. age_kn: ``[k, n]``
    int32 rounds since each edge fired (negative = not fired). epoch: 0-d or
    ``[1]`` int32, the configuration epoch salting the delay draws."""
    n = age_kn.shape[-1]
    dev = age_kn.device
    c_ids = torch.arange(c, dtype=torch.int64, device=dev)
    word_idx = c_ids // 32
    bit_idx = c_ids % 32
    slot_salt = _u32.mul(torch.arange(n, dtype=torch.int64, device=dev), 0x85EBCA77)
    epoch_salt = _u32.mul(_u32.widen(epoch.reshape(())), 0x27D4EB2F)
    base = _u32.mul(c_ids, 0x9E3779B1)[:, None] ^ slot_salt[None, :] ^ epoch_salt
    new_bits = torch.zeros((c, n), dtype=torch.int64, device=dev)
    for ring in range(k):
        words = _u32.widen(blocked_rows[word_idx * k + ring, :])  # [c, n]
        blocked = (words >> bit_idx[:, None]) & 1
        if spread > 0:
            rnd = _u32.mix32_w(base ^ ((ring * 0xC2B2AE3D) & _u32.MASK))
            if permille >= 1000:
                delay = rnd % (spread + 1)
            else:
                gate = (_u32.mix32_w(rnd ^ 0xA511E9B3) % 1000) < permille
                delay = torch.where(gate, 1 + rnd % spread, 0)
        else:
            delay = 0
        delivered = (age_kn[ring][None, :] >= delay) & (blocked == 0)
        new_bits |= delivered.to(torch.int64) << ring
    return _u32.narrow(new_bits)


def _check_delivery_args(blocked_rows, age_kn, epoch, k, c, spread, permille):
    """Shapes, types, layout and device of a delivery call; raises on
    anything the kernel does not take. Returns the common device."""
    tensors = {"blocked_rows": blocked_rows, "age_kn": age_kn, "epoch": epoch}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 (uint32 lanes are stored as int32), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"delivery inputs lie on different devices: {sorted(map(str, devices))}")
    if not 1 <= k <= 32 or not 1 <= c <= 1024 or spread < 0 or not 0 <= permille <= 1000:
        raise ValueError(f"bad delivery parameters k={k} c={c} spread={spread} permille={permille}")
    w = (c + 31) // 32
    if age_kn.dim() != 2 or age_kn.shape[0] != k:
        raise ValueError(f"age_kn must be [k={k}, n], got {tuple(age_kn.shape)}")
    n = age_kn.shape[1]
    if tuple(blocked_rows.shape) != (w * k, n):
        raise ValueError(f"blocked_rows must be [{w * k}, {n}], got {tuple(blocked_rows.shape)}")
    if epoch.numel() != 1:
        raise ValueError(f"epoch must hold one value, got shape {tuple(epoch.shape)}")
    return devices.pop()


def _delivery_fn():
    fn = _build.load("delivery").rapid_delivery_new_bits
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def delivery_new_bits(blocked_rows, age_kn, epoch, k: int, c: int, spread: int, permille: int):
    """Per-cohort delivered alert bitmasks ``[c, n]`` (stored uint32): the
    CUDA kernel ``csrc/delivery.cu`` on CUDA tensors, the plain version on
    CPU tensors. Arguments as :func:`delivery_new_bits_ref`."""
    device = _check_delivery_args(blocked_rows, age_kn, epoch, k, c, spread, permille)
    if device.type == "cpu":
        return delivery_new_bits_ref(blocked_rows, age_kn, epoch, k, c, spread, permille)
    if device.type != "cuda":
        raise ValueError(f"delivery_new_bits runs on cuda or cpu tensors, got {device}")
    n = age_kn.shape[1]
    out = torch.empty((c, n), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _delivery_fn()(
            blocked_rows.data_ptr(), age_kn.data_ptr(), epoch.data_ptr(), out.data_ptr(),
            n, k, c, spread, permille, stream,
        )
    if err != 0:
        raise RuntimeError(f"delivery kernel launch failed: cudaError {err}")
    delivery_new_bits.launches += 1
    return out


#: Kernel launches made by :func:`delivery_new_bits` (not by the plain path).
delivery_new_bits.launches = 0
