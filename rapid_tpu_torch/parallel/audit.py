"""The collective audit — thin re-export of
:mod:`rapid_tpu_torch.parallel.collective_facts` under the JAX package's
``rapid_tpu.parallel.audit`` names."""

from __future__ import annotations

from rapid_tpu_torch.parallel.collective_facts import (  # noqa: F401 — re-exported
    COLLECTIVE_KINDS,
    DTYPE_BITS,
    audit_collectives,
    classify_location,
    collective_violations,
    payload_class,
    shape_bytes,
    source_of,
)

__all__ = [
    "COLLECTIVE_KINDS",
    "DTYPE_BITS",
    "audit_collectives",
    "classify_location",
    "collective_violations",
    "payload_class",
    "shape_bytes",
    "source_of",
]
