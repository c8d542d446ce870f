"""The yardstick of the delivery kernel: the H100's peaks and the bytes and
operations that one call of ``csrc/delivery.cu`` needs, from its inputs.

A frozen copy of ``chip_smoke.py``'s ``delivery_ops_per_draw``,
``delivery_needed_draws`` and ``delivery_bound`` (PR 15), with the peaks
beside them, so that a later change to the program cannot move the bound it
is measured against. Each call's bound is computed from the call's own
captured inputs (:func:`delivery_bound`), with torch ops on their device,
after the profiled stretch.
"""

from __future__ import annotations

import torch

#: Published H100 SXM peaks (NVIDIA data sheet, 700 W): 3.35 TB/s of HBM;
#: 67 TFLOP/s fp32 outside the tensor cores counts an FMA as two operations
#: on 128 lanes per SM, and Hopper has 64 INT32 lanes per SM, so its int32
#: issue peak is a quarter of that figure.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

MASK32 = 0xFFFFFFFF


def delivery_ops_per_draw(spread: int, permille: int) -> int:
    """Integer operations of one needed delay draw, counted from
    csrc/delivery.cu: the ring salt (2), a mix32 (8) and a modulus (1); in
    the gated mode also the second stream's xor, mix32, modulus and compare
    (11) and the magnitude's add and select (2). None are drawn when every
    delay is 0."""
    if spread == 0:
        return 0
    return 11 if permille >= 1000 else 24


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values below 2**32 (Hacker's Delight 5-1)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def delivery_needed_draws(blocked, age, k: int, c: int, spread: int) -> int:
    """Delay draws these inputs need: unblocked (tenant, cohort, slot, ring)
    edges with ``0 <= age < spread``. Below 0 an edge is not delivered
    whatever the draw; at or above ``spread`` (the largest delay) it is
    delivered iff unblocked."""
    if spread == 0:
        return 0
    if age.dim() == 2:
        blocked, age = blocked[None], age[None]
    t, _, n = age.shape
    words = blocked.reshape(t, -1, k, n)
    pending = ((age >= 0) & (age < spread)).to(torch.int64)
    total = 0
    for wi in range(words.shape[1]):
        cohort_bits = (1 << min(32, c - 32 * wi)) - 1
        stored = words[:, wi].to(torch.int64) & MASK32
        unblocked = _popcount32((stored ^ MASK32) & cohort_bits)
        total += int((unblocked * pending).sum())
    return total


def delivery_bound(blocked, age, epoch, k: int, c: int, spread: int, permille: int,
                   *offsets) -> tuple:
    """(bound_s, bound_by, needed draws) of one delivery call on these
    inputs (one cluster or a fleet). Bytes: each input read once and the
    ``[t, c, n]`` output written once. Operations: the draws these inputs
    need times the operations of one draw; the per-edge test is not counted,
    since a word-wide kernel forms 32 outputs with a few operations. The
    larger of the two times, at the H100's HBM rate and int32 issue rate. A
    shard's ``offsets`` move no bytes and change no count."""
    n = age.shape[-1]
    nbytes = 4 * (blocked.numel() + age.numel() + epoch.numel() + epoch.numel() * c * n)
    draws = delivery_needed_draws(blocked, age, k, c, spread)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = draws * delivery_ops_per_draw(spread, permille) / INT32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), draws
