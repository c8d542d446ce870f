"""Per-cohort watermark cut detection (port of
``rapid_tpu/ops/cut_detection.py::cohort_watermark_pass``)."""

from __future__ import annotations

import torch

from rapid_tpu_torch import _host, _u32
from rapid_tpu_torch.ops.kernels import popcount32, watermark_merge_classify


def cohort_watermark_pass(
    report_bits: torch.Tensor,
    new_bits: torch.Tensor,
    seen_down: torch.Tensor,
    released: torch.Tensor,
    announced: torch.Tensor,
    subject_mask: torch.Tensor,
    inval_obs: torch.Tensor,
    heard_down: torch.Tensor,
    h: int,
    l: int,
    k: int,
):
    """C independent watermark detectors over ``[c, n]`` stored uint32
    ring-report bitmasks (MultiNodeCutDetector.java:84-164 per cohort).

    report_bits/released: ``[c, n]``; seen_down/announced/heard_down:
    ``[c]`` bool; subject_mask: ``[n]`` bool; inval_obs: ``[k, n]`` int32.
    Returns ``(report_bits, released, announced, seen_down, propose,
    proposal_mask)``.

    The implicit-invalidation pass runs only when some cohort has a subject
    in flux after a DOWN alert. The JAX version gates it with ``lax.cond``;
    here it is a host branch on one counted read (:mod:`rapid_tpu_torch._host`):
    the pass is K gathers over ``[c, n]``, and in pure crash or join rounds
    every subject jumps past H, so it is rarely needed."""
    c, n = report_bits.shape
    report_bits, cls = watermark_merge_classify(
        report_bits, new_bits, subject_mask[None, :], h, l
    )
    seen_down = seen_down | heard_down
    stable = cls == 2
    flux = cls == 1

    if _host.read(torch.any(flux & seen_down[:, None])):
        in_union = (stable & ~released) | flux
        implicit = torch.zeros_like(report_bits)
        for ring in range(k):
            obs_r = inval_obs[ring]
            gathered = in_union[:, obs_r.clamp(0, n - 1).to(torch.int64)]
            implicit_r = flux & gathered & (obs_r >= 0)[None, :] & seen_down[:, None]
            implicit |= torch.where(implicit_r, _u32.bits(1 << ring), 0).to(torch.int32)
        report_bits = torch.where(subject_mask[None, :], report_bits | implicit, 0)

    tally2 = popcount32(report_bits)
    stable2 = tally2 >= h
    flux2 = (tally2 >= l) & (tally2 < h)
    fresh_stable = stable2 & ~released
    propose = ~announced & fresh_stable.any(1) & ~flux2.any(1)
    proposal_mask = fresh_stable & propose[:, None]
    return (
        report_bits,
        released | proposal_mask,
        announced | propose,
        seen_down,
        propose,
        proposal_mask,
    )
