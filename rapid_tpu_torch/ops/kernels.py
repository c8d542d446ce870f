"""The engine's bitmask cores and its one hand-written kernel (port of
``rapid_tpu/ops/pallas_kernels.py``).

- :func:`popcount32` and :func:`watermark_merge_classify`: plain torch, as
  they are plain jnp in the JAX package (its Mosaic watermark kernel was
  measured slower than XLA's fusion and deleted). Both keep a bitmask lane
  at its own width (uint8, uint16 as int16 bits, or uint32 as int32 bits;
  :mod:`rapid_tpu_torch._narrow`): the merge stays at the lane's dtype,
  the tally counts at int32.
- :func:`reports_matrix_to_bits` / :func:`bits_to_reports_matrix`: a
  ``[..., n, k]`` bool report matrix and ``[..., n]`` ring bitmasks.
- :func:`delivery_new_bits`: the alert-delivery kernel, CUDA C++ for
  Hopper in ``csrc/delivery.cu`` (it replaces the Pallas kernel
  ``delivery_new_bits_pallas``), with its plain version
  :func:`delivery_new_bits_ref`. Both take one cluster or a fleet (a
  leading tenant axis). The wrapper takes the plain version only for
  tensors on the CPU; for CUDA tensors it launches the kernel or raises.

Every op of the engine takes optional leading batch axes (the fleet's
tenant axis); :func:`per_batch` lines a per-tenant value up against them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rapid_tpu_torch import _build, _narrow, _u32


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of a stored bitmask lane of any width as int32 (Hacker's
    Delight 5-1 on the values widened by the lane's own width, so an int16
    lane holding uint16 bits counts at most 16)."""
    v = _narrow.unsigned(v)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def per_batch(x, like: torch.Tensor):
    """``x`` shaped to broadcast against ``like``: a Python int (one
    cluster's knob) as it is, a tensor over the leading batch axes of
    ``like`` (a fleet's ``[t]`` knob or lane) with ones appended."""
    if not isinstance(x, torch.Tensor):
        return x
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def watermark_merge_classify(old_bits, new_bits, subject_mask, h, l):
    """OR-merge ring-report bitmasks (stored uint32), clear non-subjects,
    and classify each slot's tally: 0 none, 1 flux ``[l, h)``, 2 stable
    ``>= h``. ``h`` and ``l`` are ints or per-batch tensors (see
    :func:`per_batch`). Returns (merged bits, int32 class)."""
    merged = torch.where(subject_mask, old_bits | new_bits, 0)
    tally = popcount32(merged)
    h, l = per_batch(h, tally), per_batch(l, tally)
    stable = tally >= h
    flux = (tally >= l) & (tally < h)
    cls = torch.where(stable, 2, torch.where(flux, 1, 0)).to(torch.int32)
    return merged, cls


def reports_matrix_to_bits(reports: torch.Tensor) -> torch.Tensor:
    """``[..., n, k]`` bool report matrix -> ``[..., n]`` stored uint32 ring
    bitmasks (bit r = ring r reported)."""
    k = reports.shape[-1]
    weights = 1 << torch.arange(k, dtype=torch.int64, device=reports.device)
    return _u32.narrow((reports.to(torch.int64) * weights).sum(-1))


def bits_to_reports_matrix(bits: torch.Tensor, k: int) -> torch.Tensor:
    """``[..., n]`` stored ring bitmasks (any width) -> ``[..., n, k]`` bool
    report matrix."""
    shifts = torch.arange(k, dtype=torch.int64, device=bits.device)
    return ((_narrow.unsigned(bits)[..., None] >> shifts) & 1).to(torch.bool)



def delivery_new_bits_ref(blocked_rows, age_kn, epoch, k: int, c: int, spread: int, permille: int):
    """The plain PyTorch delivery pass (the JAX engine's jnp path,
    ``virtual_cluster._deliver_alerts``), stored uint32.

    One cluster: blocked_rows ``[w*k, n]`` stored uint32, row ``wi*k +
    ring``, bit j = cohort ``32*wi + j`` cannot hear the edge's observer;
    age_kn ``[k, n]`` int32 rounds since each edge fired (negative = not
    fired); epoch one int32 (0-d or ``[1]``), the configuration epoch
    salting the delay draws. Returns ``[c, n]``.

    A fleet: the same with a leading tenant axis, blocked_rows ``[t, w*k,
    n]``, age_kn ``[t, k, n]`` and epoch ``[t]`` (each tenant's own epoch).
    Returns ``[t, c, n]``; tenant i equals the one-cluster call on its
    slices."""
    if age_kn.dim() == 2:
        return delivery_new_bits_ref(
            blocked_rows[None], age_kn[None], epoch.reshape(1), k, c, spread, permille
        )[0]
    t, _, n = age_kn.shape
    dev = age_kn.device
    c_ids = torch.arange(c, dtype=torch.int64, device=dev)
    word_idx = c_ids // 32
    bit_idx = c_ids % 32
    slot_salt = _u32.mul(torch.arange(n, dtype=torch.int64, device=dev), 0x85EBCA77)
    epoch_salt = _u32.mul(_u32.widen(epoch.reshape(t)), 0x27D4EB2F)
    base = (_u32.mul(c_ids, 0x9E3779B1)[:, None] ^ slot_salt[None, :]) ^ epoch_salt[:, None, None]
    new_bits = torch.zeros((t, c, n), dtype=torch.int64, device=dev)
    for ring in range(k):
        words = _u32.widen(blocked_rows[:, word_idx * k + ring, :])  # [t, c, n]
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
        delivered = (age_kn[:, ring, None, :] >= delay) & (blocked == 0)
        new_bits |= delivered.to(torch.int64) << ring
    return _u32.narrow(new_bits)


#: Most tenants one kernel call takes (they ride ``gridDim.z``).
MAX_TENANTS = 65535


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
    if not 1 <= k <= 32 or not 1 <= c <= 1024 or not 0 <= spread < 2**31 or not 0 <= permille <= 1000:
        raise ValueError(f"bad delivery parameters k={k} c={c} spread={spread} permille={permille}")
    w = (c + 31) // 32
    if age_kn.dim() not in (2, 3) or age_kn.shape[-2] != k:
        raise ValueError(f"age_kn must be [k={k}, n] or [t, k={k}, n], got {tuple(age_kn.shape)}")
    batch, n = tuple(age_kn.shape[:-2]), age_kn.shape[-1]
    if tuple(blocked_rows.shape) != batch + (w * k, n):
        raise ValueError(
            f"blocked_rows must be {list(batch + (w * k, n))}, got {tuple(blocked_rows.shape)}"
        )
    if (batch[0] if batch else 1) * w * n >= 2**31:
        raise ValueError(f"delivery call too large: t * ceil(c/32) * n must be below 2**31, "
                         f"got {batch[0] if batch else 1} * {w} * {n}")
    if batch:
        if not 1 <= batch[0] <= MAX_TENANTS:
            raise ValueError(f"tenant count must be in [1, {MAX_TENANTS}], got {batch[0]}")
        if tuple(epoch.shape) != batch:
            raise ValueError(f"epoch must be [t={batch[0]}], one per tenant, got {tuple(epoch.shape)}")
    elif epoch.numel() != 1:
        raise ValueError(f"epoch must hold one value, got shape {tuple(epoch.shape)}")
    return devices.pop()


def fastmod_multiplier(d: int) -> int:
    """The kernel's constant for ``x % d`` (``1 <= d < 2**32``): Lemire's
    ``ceil(2**64 / d) mod 2**64``. With it, ``x % d`` for every 32-bit
    ``x`` is the high word of ``(m * x mod 2**64) * d``."""
    if not 1 <= d < 2**32:
        raise ValueError(f"fastmod divisor must be in [1, 2**32), got {d}")
    return ((2**64 - 1) // d + 1) % 2**64


def delivery_divisor(spread: int, permille: int) -> int:
    """The divisor of the delivery draw's ``rnd % d``: ``spread + 1`` for a
    uniform delay in ``[0, spread]``, ``spread`` for the gated ``1 + rnd %
    spread``; 1 (unused) when every delay is 0."""
    if spread == 0:
        return 1
    return spread + 1 if permille >= 1000 else spread


@functools.cache
def _delivery_fn():
    fn = _build.load("delivery").rapid_delivery_new_bits
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_uint64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def delivery_new_bits(blocked_rows, age_kn, epoch, k: int, c: int, spread: int, permille: int):
    """Per-cohort delivered alert bitmasks, ``[c, n]`` for one cluster or
    ``[t, c, n]`` for a fleet (stored uint32): the CUDA kernel
    ``csrc/delivery.cu`` on CUDA tensors, one launch per call whatever
    ``t``; the plain version on CPU tensors. Arguments as
    :func:`delivery_new_bits_ref`."""
    device = _check_delivery_args(blocked_rows, age_kn, epoch, k, c, spread, permille)
    if device.type == "cpu":
        return delivery_new_bits_ref(blocked_rows, age_kn, epoch, k, c, spread, permille)
    if device.type != "cuda":
        raise ValueError(f"delivery_new_bits runs on cuda or cpu tensors, got {device}")
    t = age_kn.shape[0] if age_kn.dim() == 3 else 1
    n = age_kn.shape[-1]
    out = torch.empty(age_kn.shape[:-2] + (c, n), dtype=torch.int32, device=device)
    m = fastmod_multiplier(delivery_divisor(spread, permille))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _delivery_fn()(
            blocked_rows.data_ptr(), age_kn.data_ptr(), epoch.data_ptr(), out.data_ptr(),
            t, n, k, c, spread, permille, m, stream,
        )
    if err != 0:
        raise RuntimeError(f"delivery kernel launch failed: cudaError {err}")
    delivery_new_bits.launches += 1
    return out


#: Kernel launches made by :func:`delivery_new_bits` (not by the plain path).
delivery_new_bits.launches = 0
