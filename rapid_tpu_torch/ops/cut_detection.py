"""Per-cohort watermark cut detection (port of
``rapid_tpu/ops/cut_detection.py``: ``cohort_watermark_pass`` and the
telemetry plane's ``telemetry_cut_masks``)."""

from __future__ import annotations

import torch

from rapid_tpu_torch import _host, _u32
from rapid_tpu_torch.ops.kernels import per_batch, popcount32, watermark_merge_classify


def cohort_watermark_pass(
    report_bits: torch.Tensor,
    new_bits: torch.Tensor,
    seen_down: torch.Tensor,
    released: torch.Tensor,
    announced: torch.Tensor,
    subject_mask: torch.Tensor,
    inval_obs: torch.Tensor,
    heard_down: torch.Tensor,
    h,
    l,
    k: int,
    select: bool = False,
):
    """C independent watermark detectors over ``[c, n]`` stored uint32
    ring-report bitmasks (MultiNodeCutDetector.java:84-164 per cohort).

    report_bits/released: ``[c, n]``; seen_down/announced/heard_down:
    ``[c]`` bool; subject_mask: ``[n]`` bool; inval_obs: ``[k, n]`` int32;
    h/l: ints. A fleet adds a leading tenant axis to every lane, and h/l
    may then be ``[t]`` tensors. Returns ``(report_bits, released,
    announced, seen_down, propose, proposal_mask)``.

    The implicit-invalidation pass is needed only when a cohort has a
    subject in flux after a DOWN alert. The JAX version gates it with
    ``lax.cond``. By default it is a host branch on one counted read
    (:mod:`rapid_tpu_torch._host`): the pass is K gathers over ``[c, n]``,
    and in pure crash or join rounds every subject jumps past H, so it is
    rarely needed. With ``select=True`` (the fleet, where vmap makes the
    cond a select) it is computed for every batch with no read: where a
    batch's gate is clear, no subject is in flux after a DOWN alert, so
    the pass ORs in no bit and leaves that batch as it was."""
    n = report_bits.shape[-1]
    report_bits, cls = watermark_merge_classify(
        report_bits, new_bits, subject_mask[..., None, :], h, l
    )
    seen_down = seen_down | heard_down
    stable = cls == 2
    flux = cls == 1

    if select or _host.read(torch.any(flux & seen_down[..., None])):
        in_union = (stable & ~released) | flux
        implicit = torch.zeros_like(report_bits)
        for ring in range(k):
            obs_r = inval_obs[..., ring, :]
            at = obs_r.clamp(0, n - 1).to(torch.int64)[..., None, :].expand(in_union.shape)
            gathered = torch.gather(in_union, -1, at)
            implicit_r = flux & gathered & (obs_r >= 0)[..., None, :] & seen_down[..., None]
            implicit |= torch.where(implicit_r, _u32.bits(1 << ring), 0).to(torch.int32)
        report_bits = torch.where(subject_mask[..., None, :], report_bits | implicit, 0)

    tally2 = popcount32(report_bits)
    h, l = per_batch(h, tally2), per_batch(l, tally2)
    stable2 = tally2 >= h
    flux2 = (tally2 >= l) & (tally2 < h)
    fresh_stable = stable2 & ~released
    propose = ~announced & fresh_stable.any(-1) & ~flux2.any(-1)
    proposal_mask = fresh_stable & propose[..., None]
    return (
        report_bits,
        released | proposal_mask,
        announced | propose,
        seen_down,
        propose,
        proposal_mask,
    )


def telemetry_cut_masks(prev_bits, new_bits, final_bits, subject_mask, h, l):
    """The telemetry plane's view of one :func:`cohort_watermark_pass`:
    ``(active, invalidated)`` bool masks over ``[..., c, n]``, from the
    pass's inputs and outputs only, so the pass is the same with the plane
    on or off. ``subject_mask`` is ``[..., n]``; ``h``/``l`` are ints or
    per-batch tensors.

    ``active``: nonzero report bits, or a tally in the ``[l, h)`` flux band.
    A nonzero word is active whatever its tally, and a zero word has tally
    0, so the JAX version's popcount reduces to one per-batch test: a zero
    word is active iff ``l <= 0 < h``.

    ``invalidated``: bits in ``final_bits`` that the merge did not deliver
    (absent from ``prev_bits | new_bits`` on a subject), which only the
    implicit-invalidation pass sets (MultiNodeCutDetector.java:137-164)."""
    active = final_bits != 0
    zero_in_band = (l <= 0) & (h > 0)
    if isinstance(zero_in_band, torch.Tensor):
        active = active | per_batch(zero_in_band, active)
    elif zero_in_band:
        active = torch.ones_like(active)
    delivered = torch.where(subject_mask[..., None, :], prev_bits | new_bits, 0)
    invalidated = (final_bits & ~delivered) != 0
    return active, invalidated
