"""Collective facts of a sharded run (the counterpart of
``rapid_tpu/parallel/hlo_facts.py``).

The JAX package reads its collectives, transfers and donation aliases off
the compiled HLO text. There is no HLO in the port: the sharded round body
issues its collectives itself, and the context that issues them records
each one (``parallel/collectives.py``: kind, wire dtype, local shape,
payload bytes, the group's ranks, the site and a label). This module turns
that log into the JAX audit's rows and holds the same invariants over them.

Copied from the JAX module as they are: :data:`COLLECTIVE_KINDS`,
:func:`payload_class`, :data:`PAYLOAD_CLASS_RANK`,
:func:`collective_violations` and :func:`groups_cross_blocks`.
In place of the HLO parsers:

- :data:`DTYPE_BITS` / :func:`shape_bytes` price torch dtypes and shapes;
- :func:`audit_collectives` reads a collective log;
- :func:`count_transfer_ops` counts the host reads and uploads a sharded
  call makes (``_host.read`` / ``_host.upload``), the analog of the HLO's
  infeed/outfeed/send/recv ops;
- :func:`input_output_aliases` names the state lanes a call hands back in
  their input's storage, the analog of the compiled donation table.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from rapid_tpu_torch import _host
from rapid_tpu_torch.parallel.collectives import classify_location

__all__ = [
    "COLLECTIVE_KINDS", "DTYPE_BITS", "PAYLOAD_CLASS_RANK", "audit_collectives",
    "classify_location", "collective_violations", "count_transfer_ops",
    "groups_cross_blocks", "input_output_aliases", "payload_class", "round_sequence",
    "shape_bytes", "source_of",
]

COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)

#: Bits per element by torch dtype (a bool travels as a byte).
DTYPE_BITS = {
    torch.bool: 8,
    torch.uint8: 8, torch.int8: 8,
    torch.int16: 16, torch.uint16: 16, torch.float16: 16, torch.bfloat16: 16,
    torch.int32: 32, torch.uint32: 32, torch.float32: 32,
    torch.int64: 64, torch.uint64: 64, torch.float64: 64,
}

_DTYPE_NAMES = {str(dt).replace("torch.", ""): dt for dt in DTYPE_BITS}


def shape_bytes(shape: Sequence[int], dtype, unknown: Optional[List[str]] = None) -> int:
    """Payload bytes of an array of ``shape`` and ``dtype`` (a torch dtype
    or its name). A dtype missing from :data:`DTYPE_BITS` is never guessed:
    it is appended to ``unknown`` when a list is passed (pricing 0), else
    raises ``ValueError``."""
    dt = _DTYPE_NAMES.get(dtype) if isinstance(dtype, str) else dtype
    bits = DTYPE_BITS.get(dt)
    if bits is None:
        if unknown is None:
            raise ValueError(f"unknown dtype {dtype!r}")
        unknown.append(str(dtype))
        return 0
    elems = 1
    for d in shape:
        elems *= int(d)
    return (elems * bits + 7) // 8


#: Labels of the round body's collective points -> the JAX audit's source
#: vocabulary (``hlo_facts.source_of``).
_SOURCES = (
    ("ring", "view-change topology rebuild"),
    ("view-change", "view-change topology rebuild"),
    ("classic", "classic-fallback attempt"),
    ("tally", "fast-round vote tally"),
    ("edge", "cross-slot gather"),
    ("union", "cross-slot gather"),
)


def source_of(label: str) -> str:
    """The JAX audit's source label for a collective point's label."""
    for needle, source in _SOURCES:
        if needle in label:
            return source
    return "round-body reduction"


def payload_class(nbytes: int, n: int, c: int) -> str:
    """Scale class of a collective payload at engine shapes: ``cn`` ([c,n]
    or larger), ``n`` (at least [n]-proportional), ``scalar`` otherwise.
    The lockfile freezes the CLASS, not raw bytes, so a benign constant
    tweak does not drift the gate while a scale-class jump always does."""
    if nbytes >= c * n:
        return "cn"
    if nbytes >= n:
        return "n"
    return "scalar"


PAYLOAD_CLASS_RANK = {"scalar": 0, "n": 1, "cn": 2}


def audit_collectives(log: Sequence[Dict], n: int, c: int) -> List[Dict]:
    """One row per logged collective, with the JAX audit's keys: kind,
    shape, payload bytes, location, source, scale flags (n_scale = at least
    [n]-proportional payload, cn_scale = at least [c,n]), groups and
    unknown dtypes, plus the round, the mesh axis and the label.

    ``bytes`` is the payload of the whole array the collective assembles or
    reduces (the log's ``logical_bytes``: the rank's payload times the
    sizes of the axes it is split over), so a point's class does not change
    with the mesh's size; ``wire_bytes`` is what this rank sent."""
    rows = []
    for rec in log:
        unknown: List[str] = []
        shape_bytes(rec["shape"], rec["dtype"], unknown=unknown)
        payload = rec["logical_bytes"]
        rows.append({
            "kind": rec["kind"],
            "shape": f"{rec['dtype']}{list(rec['shape'])}",
            "bytes": payload,
            "operand_bytes": [payload],
            "largest_operand_bytes": payload,
            "wire_bytes": rec["bytes"],
            "location": rec["site"],
            "source": source_of(rec["label"]),
            "cn_scale": payload >= c * n,
            "n_scale": payload >= n,
            "groups": [list(rec["ranks"])],
            "unknown_dtypes": sorted(set(unknown)),
            "round": rec["round"],
            "axis": rec["axis"],
            "label": rec["label"],
        })
    return rows


def groups_cross_blocks(
    groups: Optional[List[List[int]]], block: int
) -> bool:
    """True when any group spans two device blocks of size ``block`` —
    with the tenant axis leading the mesh, device ids are contiguous per
    tenant slice, so a group containing ids from two blocks is a
    cross-tenant collective. ``None`` groups (all-participants) cross by
    definition whenever more than one block exists."""
    if groups is None:
        return True
    for group in groups:
        if len({device // block for device in group}) > 1:
            return True
    return False


def collective_violations(rows: List[Dict]) -> Dict[str, List[Dict]]:
    """The two invariants the sharded design guarantees."""
    return {
        # Every round, unconditionally: reductions only — an unconditional
        # gather here would ship O(n)+ bytes per round for no reason.
        "hot_loop_non_reduce": [
            r for r in rows
            if r["location"] == "hot-loop" and r["kind"] != "all-reduce"
        ],
        # [c,n]-sized traffic must be cond-gated (implicit invalidation,
        # classic attempt, view-change re-sort) — never unconditional. The
        # prologue may hold the hoisted [n]-scale edge gathers, nothing
        # [c,n]-scale.
        "unconditional_cn_anywhere": [
            r for r in rows if r["cn_scale"] and "cond" not in r["location"]
        ],
    }


def round_sequence(rows: Sequence[Dict], n: int, c: int) -> Dict[int, List[Tuple]]:
    """round -> the ``(kind, location, payload class, axis, label)`` of its
    collectives in issue order: the sequence every rank, and every mesh
    size of one mesh shape, must issue alike."""
    out: Dict[int, List[Tuple]] = {}
    for r in rows:
        out.setdefault(r["round"], []).append(
            (r["kind"], r["location"], payload_class(r["bytes"], n, c), r["axis"], r["label"])
        )
    return out


def count_transfer_ops(run: Callable[[], object]) -> Tuple[object, Dict[str, int]]:
    """``run()``'s result and the host transfers it made: counted reads
    (``_host.read``, each a device-to-host copy that waits) and uploads
    (``_host.upload``), zero entries omitted."""
    reads, uploads = _host.read.count, _host.upload.count
    result = run()
    counts = {"read": _host.read.count - reads, "upload": _host.upload.count - uploads}
    return result, {kind: v for kind, v in counts.items() if v}


def input_output_aliases(before, after) -> List[Tuple[int, str]]:
    """The lanes of ``after`` (a state, or any lane tree) held in the same
    storage as the same lane of ``before``: ``(index, name)`` per lane the
    call handed back without a copy. DTensors compare their local
    tensors."""
    def ptr(x):
        x = x.to_local() if hasattr(x, "to_local") else x
        return x.untyped_storage().data_ptr()

    return [
        (i, name) for i, (name, a, b) in enumerate(zip(type(before)._fields, before, after))
        if ptr(a) == ptr(b)
    ]
