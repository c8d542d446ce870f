"""Watermark cut detection (port of ``rapid_tpu/ops/cut_detection.py``).

Two grains, as in the JAX package: :func:`process_alert_batch`, ONE
detector over an ``[n, k]`` bool report matrix (the host twin's grain), and
:func:`cohort_watermark_pass`, C detectors over ``[c, n]`` ring bitmasks at
the report lane's own dtype (the engine's round body), with the telemetry
plane's :func:`telemetry_cut_masks` beside it.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from rapid_tpu_torch import _host, _narrow
from rapid_tpu_torch.models.state import resolve_device
from rapid_tpu_torch.ops.kernels import per_batch, popcount32, watermark_merge_classify


class CutState(NamedTuple):
    """One detector: ``reports [n, k]`` bool report bits, ``seen_down`` (a
    0-d bool: a DOWN alert was applied since the last clear) and
    ``released [n]`` (subjects already in an earlier batch's proposal)."""

    reports: torch.Tensor
    seen_down: torch.Tensor
    released: torch.Tensor

    @staticmethod
    def create(n: int, k: int, device=None) -> "CutState":
        """An empty detector on ``device`` (CUDA unless the caller names
        another, as every entry point of the port)."""
        device = resolve_device(device)
        return CutState(
            reports=torch.zeros((n, k), dtype=torch.bool, device=device),
            seen_down=torch.zeros((), dtype=torch.bool, device=device),
            released=torch.zeros((n,), dtype=torch.bool, device=device),
        )


class CutResult(NamedTuple):
    state: CutState
    propose: torch.Tensor  # 0-d bool: a cut is ready
    proposal_mask: torch.Tensor  # [n] bool: members of the cut
    tally: torch.Tensor  # [n] int32 report counts


def process_alert_batch(
    state: CutState,
    new_reports: torch.Tensor,
    batch_has_down: torch.Tensor,
    inval_obs_idx: torch.Tensor,
    subject_mask: torch.Tensor,
    h: int,
    l: int,
) -> CutResult:
    """Apply one batch of alerts to one detector
    (MultiNodeCutDetector.java:84-164): OR in ``new_reports [n, k]``,
    tally, run the implicit invalidation for subjects in flux (edges whose
    observer, ``inval_obs_idx [k, n]`` of any index dtype, -1 disabling,
    is itself in the pending union), tally again, and propose the fresh
    stable subjects iff none sits in ``[l, h)``. ``subject_mask [n]`` clears
    reports on anything but present members and pending joiners."""
    n = state.reports.shape[0]
    reports = (state.reports | new_reports) & subject_mask[:, None]
    seen_down = state.seen_down | batch_has_down

    tally = reports.sum(1, dtype=torch.int32)
    stable = tally >= h
    flux = (tally >= l) & (tally < h)
    in_union = (stable & ~state.released) | flux

    obs = inval_obs_idx.T.to(torch.int64)  # [n, k]
    obs_in_union = (obs >= 0) & in_union[obs.clamp(0, n - 1)]
    implicit = flux[:, None] & obs_in_union
    reports = torch.where(seen_down, reports | implicit, reports) & subject_mask[:, None]

    tally2 = reports.sum(1, dtype=torch.int32)
    stable2 = tally2 >= h
    flux2 = (tally2 >= l) & (tally2 < h)
    fresh_stable = stable2 & ~state.released
    propose = fresh_stable.any() & ~flux2.any()
    proposal_mask = fresh_stable & propose
    return CutResult(
        state=CutState(reports=reports, seen_down=seen_down, released=state.released | proposal_mask),
        propose=propose,
        proposal_mask=proposal_mask,
        tally=tally2,
    )


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
    ctx=None,
):
    """C independent watermark detectors over ``[c, n]`` ring-report
    bitmasks (MultiNodeCutDetector.java:84-164 per cohort), at the report
    lane's own stored dtype (``new_bits`` must match it): the merge and the
    implicit bits stay at that width, the tallies count at int32.

    report_bits/released: ``[c, n]``; seen_down/announced/heard_down:
    ``[c]`` bool; subject_mask: ``[n]`` bool; inval_obs: ``[k, n]`` of the
    index lane's dtype;
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
    the pass ORs in no bit and leaves that batch as it was.

    Sharded (``ctx``, the engine's ``[t, ...]`` lanes on one rank's shard):
    the gate is reduced over the whole mesh, so every rank branches alike;
    the pass gathers ``in_union`` over ``'nodes'`` (observers are global
    slots), inside its gate; the proposal tests are reduced over
    ``'nodes'``."""
    report_bits, cls = watermark_merge_classify(
        report_bits, new_bits, subject_mask[..., None, :], h, l
    )
    seen_down = seen_down | heard_down
    stable = cls == 2
    flux = cls == 1

    gate = None if select else torch.any(flux & seen_down[..., None])
    if gate is not None and ctx is not None:
        gate = ctx.max(gate, ("cohort", "nodes"), "invalidation gate")
    if select or _host.read(gate, "invalidation_gate"):
        with contextlib.nullcontext() if ctx is None else ctx.gate():
            in_union = (stable & ~released) | flux
            if ctx is not None:
                in_union = ctx.gather(in_union, "nodes", "invalidation union", sharded=("cohort",))
            n = in_union.shape[-1]
            implicit = torch.zeros_like(report_bits)
            bdt = report_bits.dtype
            for ring in range(k):
                obs_r = inval_obs[..., ring, :]
                at = obs_r.clamp(0, n - 1).to(torch.int64)[..., None, :].expand(report_bits.shape)
                gathered = torch.gather(in_union, -1, at)
                implicit_r = flux & gathered & (obs_r >= 0)[..., None, :] & seen_down[..., None]
                implicit |= torch.where(implicit_r, _narrow.bit(ring, bdt), 0).to(bdt)
            report_bits = torch.where(subject_mask[..., None, :], report_bits | implicit, 0)

    tally2 = popcount32(report_bits)
    h, l = per_batch(h, tally2), per_batch(l, tally2)
    stable2 = tally2 >= h
    flux2 = (tally2 >= l) & (tally2 < h)
    fresh_stable = stable2 & ~released
    fresh_any, flux_any = fresh_stable.any(-1), flux2.any(-1)
    if ctx is not None:
        both = ctx.max(torch.stack([fresh_any, flux_any]), ("nodes",), "proposal gate",
                       sharded=("cohort",))
        fresh_any, flux_any = both[0], both[1]
    propose = ~announced & fresh_any & ~flux_any
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


def alerts_to_report_matrix(n: int, k: int, dst_idx, ring_numbers, device=None) -> torch.Tensor:
    """Scatter (subject slot, ring) alerts, two equal-length index lists,
    into an ``[n, k]`` bool matrix; entries with a negative slot or a ring
    outside ``[0, k)`` are dropped (padding). The matrix lands on
    ``device``; without one, on the device of the index lists when they
    are already tensors, else on CUDA (:func:`resolve_device`)."""
    if device is None:
        device = next((x.device for x in (dst_idx, ring_numbers) if torch.is_tensor(x)), None)
    device = resolve_device(device)
    dst = torch.as_tensor(dst_idx, dtype=torch.int64, device=device).reshape(-1)
    rings = torch.as_tensor(ring_numbers, dtype=torch.int64, device=device).reshape(-1)
    valid = (dst >= 0) & (rings >= 0) & (rings < k)
    flat = torch.where(valid, dst * k + rings, n * k).clamp(max=n * k)
    # index_fill_ takes the value as a kernel argument: ``out[flat] = True``
    # would copy a host scalar to the card, which waits for the stream.
    out = torch.zeros((n * k + 1,), dtype=torch.bool, device=dst.device)
    out.index_fill_(0, flat, True)
    return out[: n * k].reshape(n, k)
