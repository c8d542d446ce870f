"""Configuration, engine and serving checkpoints (port of
``rapid_tpu/utils/checkpoint.py``).

- host path: a ``Configuration`` (identifiers seen, ring-0 member list)
  <-> bytes in the wire codec's field layout
  (:func:`configuration_to_bytes`, :func:`save_configuration`, ...), and
  :func:`view_from_configuration` to resume a host view from one. Native
  configurations are written as version 1, java ones as version 2 with a
  trailing topology byte, as in the JAX package;
- engine path: a cluster's :class:`EngineState` <-> one ``.npz`` file
  (:func:`save_engine_state`, :func:`load_engine_state`);
- serving path: one crash-consistent checkpoint of a whole serving target,
  state and faults, and for a fleet the per-tenant knob lanes, plus a JSON
  meta block (the supervisor's wave cursor; ``serving/recovery.py``)
  (:func:`save_serving_state`, :func:`load_serving_state`).

The files are the JAX package's format: a configuration's bytes are JAX's
byte for byte, and every engine lane is written at the JAX package's numpy
dtype (uint32 as uint32, uint16 as uint16) through
:func:`rapid_tpu_torch.convert.state_to_numpy` and read back through
:func:`~rapid_tpu_torch.convert.state_from_numpy`, so a file written by
either package loads in the other, in the wide, compact, bit-packed or
fleet-stacked layout. The config is keyed by field name.

Durability: the payload is sealed with an xxh64 trailer
(:mod:`rapid_tpu_torch.utils.xxhash`) and published by an atomic tmp-file
and ``os.replace``, so a reader never sees a half-written file, and a torn,
truncated or bit-flipped one raises :class:`CheckpointCorruptError`.

One part of the JAX module has no counterpart here:
``_settle_device_owned``, which works around buffer donation on JAX's CPU
backend; torch tensors loaded from numpy are ordinary owned tensors.
"""

from __future__ import annotations

import io
import json
import logging
import os
import struct
import zipfile
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from rapid_tpu_torch.convert import (
    faults_from_numpy,
    knobs_from_numpy,
    knobs_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from rapid_tpu_torch.messaging.codec import (
    Reader,
    Writer,
    read_endpoint,
    read_node_id,
    write_endpoint,
    write_node_id,
)
from rapid_tpu_torch.models.state import (
    EngineConfig,
    EngineState,
    FaultInputs,
    compaction_policy,
    lane_dims,
    lane_dtypes,
    lane_storage,
    resolve_device,
)
from rapid_tpu_torch.ops.rings import ring_perms
from rapid_tpu_torch.protocol.view import (
    TOPOLOGY_JAVA,
    TOPOLOGY_NATIVE,
    Configuration,
    MembershipView,
)
from rapid_tpu_torch.tenancy.fleet import KNOB_FIELDS
from rapid_tpu_torch.utils.xxhash import xxh64

LOG = logging.getLogger(__name__)


class CheckpointCorruptError(ValueError):
    """A checkpoint file failed its framing or integrity checks (truncated,
    bit-flipped, bad magic, or an unreadable archive). The recovery tier
    catches this name to fall back to an older checkpoint."""


#: Integrity trailer: payload || 8-byte LE xxh64(payload) || magic.
_TRAILER_MAGIC = b"RTXS"
_TRAILER_LEN = 8 + len(_TRAILER_MAGIC)


def _seal(payload: bytes) -> bytes:
    return payload + struct.pack("<Q", xxh64(payload)) + _TRAILER_MAGIC


def _unseal(data: bytes, path) -> bytes:
    """Verify and strip the integrity trailer. A file without the magic
    (from a writer that predates the trailer) passes through unverified;
    its archive framing is still checked on load."""
    if len(data) >= _TRAILER_LEN and data[-len(_TRAILER_MAGIC):] == _TRAILER_MAGIC:
        payload = data[:-_TRAILER_LEN]
        (digest,) = struct.unpack("<Q", data[-_TRAILER_LEN:-len(_TRAILER_MAGIC)])
        if xxh64(payload) != digest:
            raise CheckpointCorruptError(
                f"{path}: checkpoint integrity trailer mismatch (the file "
                f"was corrupted after it was written)"
            )
        return payload
    return data


def _atomic_write(path, data: bytes) -> None:
    """Publish ``data`` at ``path`` via tmp-file + rename: a crash mid-write
    leaves the previous file intact, never a half-written one."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


_MAGIC = b"RTCF"
# v2 appends a topology-mode byte; v1 checkpoints (which predate the
# java-compat mode and were always native) still load. Native configs are
# WRITTEN as v1: the trailing byte buys nothing in the default case, and
# emitting v2 would make every checkpoint unreadable to older readers that
# only accept v1 — forward incompatibility reserved for java-mode configs,
# which older readers could not resume correctly anyway.
_VERSION = 2
_TOPOLOGY_CODES = {TOPOLOGY_NATIVE: 0, TOPOLOGY_JAVA: 1}
_TOPOLOGY_NAMES = {code: name for name, code in _TOPOLOGY_CODES.items()}


def configuration_to_bytes(config: Configuration) -> bytes:
    w = Writer()
    w.raw(_MAGIC)
    version = 1 if config.topology == TOPOLOGY_NATIVE else _VERSION
    w.u8(version)
    w.u32(len(config.node_ids))
    for nid in config.node_ids:
        write_node_id(w, nid)
    w.u32(len(config.endpoints))
    for ep in config.endpoints:
        write_endpoint(w, ep)
    if version >= 2:
        w.u8(_TOPOLOGY_CODES[config.topology])
    return w.getvalue()


def configuration_from_bytes(data: bytes) -> Configuration:
    if data[:4] != _MAGIC:
        raise CheckpointCorruptError("not a rapid_tpu configuration checkpoint")
    r = Reader(data[4:])
    try:
        version = r.u8()
        if version not in (1, _VERSION):
            raise ValueError(f"unsupported checkpoint version {version}")
        node_ids = tuple(read_node_id(r) for _ in range(r.u32()))
        endpoints = tuple(read_endpoint(r) for _ in range(r.u32()))
        if version == 1:
            topology = TOPOLOGY_NATIVE
        else:
            code = r.u8()
            if code not in _TOPOLOGY_NAMES:
                raise ValueError(f"unknown topology code {code} in checkpoint")
            topology = _TOPOLOGY_NAMES[code]
    except CheckpointCorruptError:
        raise
    except (struct.error, IndexError, ValueError, EOFError) as exc:
        # A truncated/bit-flipped blob must surface as the NAMED error, not
        # a struct/codec traceback — the recovery tier dispatches on it.
        raise CheckpointCorruptError(
            f"truncated or corrupt configuration checkpoint: {exc}"
        ) from exc
    return Configuration(node_ids, endpoints, topology=topology)


def save_configuration(path, config: Configuration) -> None:
    """Durable twin of :func:`configuration_to_bytes`: xxh64-sealed payload
    published by atomic tmp+rename."""
    _atomic_write(path, _seal(configuration_to_bytes(config)))


def load_configuration(path) -> Configuration:
    """Load a :func:`save_configuration` file (or a raw pre-trailer blob);
    truncation/corruption raises :class:`CheckpointCorruptError`."""
    return configuration_from_bytes(_unseal(Path(path).read_bytes(), path))


def view_from_configuration(config: Configuration, k: int) -> MembershipView:
    """Resume: rebuild the K rings from a configuration snapshot (the
    snapshot's topology mode rides along, so a java-compat cluster resumes
    java-compat)."""
    return MembershipView(
        k,
        node_ids=config.node_ids,
        endpoints=config.endpoints,
        topology=config.topology,
    )


def _cfg_entries(cfg: EngineConfig) -> Dict[str, np.ndarray]:
    return {
        "__cfg__": np.asarray(list(cfg), dtype=np.int64),
        # Field names pin each value to its field across config changes.
        "__cfg_fields__": np.asarray(cfg._fields, dtype=np.str_),
    }


def _cfg_from(data) -> EngineConfig:
    """The saved config, keyed by field name: fields the file lacks take
    their defaults, fields the config no longer has are dropped. Files
    without the name map (written before it existed) are positional over
    their first 12 fields."""
    vals = [int(v) for v in data["__cfg__"]]
    if "__cfg_fields__" not in data:
        return EngineConfig(*vals[:12])
    saved = dict(zip([str(f) for f in data["__cfg_fields__"]], vals))
    return EngineConfig(**{f: saved[f] for f in EngineConfig._fields if f in saved})


def _npz_bytes(entries: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **entries)
    return buf.getvalue()


def _open_npz(path) -> Dict[str, np.ndarray]:
    """Read, integrity-check and fully decompress a sealed ``.npz``; every
    corruption class raises :class:`CheckpointCorruptError`."""
    payload = _unseal(Path(path).read_bytes(), path)
    try:
        with np.load(io.BytesIO(payload)) as data:
            return {k: data[k] for k in data.files}
    except (zipfile.BadZipFile, zlib.error, ValueError, OSError, EOFError, KeyError) as exc:
        raise CheckpointCorruptError(
            f"{path}: truncated or corrupt checkpoint archive: {exc}"
        ) from exc


def save_engine_state(path, cfg: EngineConfig, state: EngineState) -> None:
    """One cluster's state, sealed and published atomically. ``ring_perm``
    is derived from the key lanes and is not written: loading recomputes
    it."""
    arrays = state_to_numpy(state)
    arrays.pop("ring_perm")
    _atomic_write(path, _seal(_npz_bytes({**_cfg_entries(cfg), **arrays})))


def load_engine_state(path, device=None) -> Tuple[EngineConfig, EngineState]:
    """Inverse of :func:`save_engine_state` (the JAX package's files too),
    on ``device`` (CUDA unless named). Lanes added since the file was
    written take their initial values at the saved config's policy dtypes
    (a missing ``retired`` lane is logged: retirement history is lost).
    ``ring_perm`` is always recomputed from the key lanes."""
    dev = resolve_device(device)
    data = _open_npz(path)
    cfg = _cfg_from(data)
    dts = lane_dtypes(cfg)
    dims = lane_dims(cfg)
    n, k = dims["n"], dims["k"]
    defaults = {
        "cp_rnd_r": lambda: np.zeros((n,), dts["cp_rnd_r"]),
        "cp_rnd_i": lambda: np.zeros((n,), dts["cp_rnd_i"]),
        "cp_vrnd_r": lambda: np.zeros((n,), dts["cp_vrnd_r"]),
        "cp_vrnd_i": lambda: np.zeros((n,), dts["cp_vrnd_i"]),
        "cp_vval_src": lambda: np.full((n,), -1, dts["cp_vval_src"]),
        "classic_epoch": lambda: np.zeros((), dts["classic_epoch"]),
        "fire_round": lambda: np.where(
            data["fd_fired"], 0, compaction_policy(cfg).fire_never
        ).astype(dts["fire_round"]),
        "round_idx": lambda: np.zeros((), np.int32),
        "fd_hist": lambda: np.zeros((n, k), dts["fd_hist"]),
        "retired": lambda: _default_retired(n),
    }
    arrays = {}
    for field in EngineState._fields:
        if field == "ring_perm":
            arrays[field] = np.zeros((k, n), dts[field])  # recomputed below
        elif field in data:
            arrays[field] = data[field]
        elif field in defaults:
            arrays[field] = defaults[field]()
        else:
            raise KeyError(f"checkpoint missing field {field!r} with no known default")
    state = state_from_numpy(cfg, arrays, dev)
    perm = ring_perms(state.key_hi, state.key_lo).to(lane_storage(cfg)["ring_perm"])
    return cfg, state._replace(ring_perm=perm)


def _default_retired(n: int) -> np.ndarray:
    LOG.warning(
        "checkpoint predates the 'retired' field: retirement history is "
        "unrecoverable — do not re-admit previously-removed slots after "
        "this resume"
    )
    return np.zeros((n,), dtype=bool)


def save_serving_state(
    path,
    cfg: EngineConfig,
    state: EngineState,
    faults: FaultInputs,
    knobs=None,
    meta: Optional[Dict[str, Any]] = None,
) -> None:
    """One crash-consistent checkpoint of a serving target: the state and
    fault lanes (and for a fleet the ``[t]`` knob lanes) exactly as they
    stand, ``ring_perm`` included, so the compact, bit-packed and
    fleet-stacked layouts come back bit for bit. ``meta`` is a small
    JSON-serializable dict. Sealed and atomic."""
    entries = dict(_cfg_entries(cfg))
    entries["__meta__"] = np.frombuffer(
        json.dumps(meta or {}, sort_keys=True).encode(), dtype=np.uint8
    )
    for prefix, lanes in (
        ("state", state_to_numpy(state)),
        ("faults", state_to_numpy(faults)),
        ("knobs", knobs_to_numpy(knobs) if knobs is not None else {}),
    ):
        for field, value in lanes.items():
            entries[f"{prefix}__{field}"] = value
    _atomic_write(path, _seal(_npz_bytes(entries)))


def load_serving_state(path, device=None):
    """Inverse of :func:`save_serving_state` (the JAX package's files too):
    ``(cfg, state, faults, knobs_or_None, meta)`` on ``device`` (CUDA
    unless named), every lane at its saved shape and dtype. The layout is
    read from the file: a leading tenant axis on the state, bit-packed
    uint8 masks. Corruption raises :class:`CheckpointCorruptError`; a
    missing lane raises KeyError naming it."""
    dev = resolve_device(device)
    data = _open_npz(path)
    cfg = _cfg_from(data)
    meta = json.loads(bytes(data["__meta__"]).decode() or "{}")

    def lanes(fields, prefix):
        out = {}
        for field in fields:
            key = f"{prefix}__{field}"
            if key not in data:
                raise KeyError(
                    f"serving checkpoint missing {key!r} (not written by "
                    f"save_serving_state, or damaged)"
                )
            out[field] = data[key]
        return out

    state_np = lanes(EngineState._fields, "state")
    faults_np = lanes(FaultInputs._fields, "faults")
    alive = state_np["alive"]
    packed = alive.dtype == np.uint8
    tenants = alive.shape[0] if alive.ndim == 2 else None
    state = state_from_numpy(cfg, state_np, dev, tenants, packed=packed)
    faults = faults_from_numpy(cfg, faults_np, dev, tenants, packed=packed)
    knobs = None
    if any(k.startswith("knobs__") for k in data):
        knobs = knobs_from_numpy(lanes(KNOB_FIELDS, "knobs"), dev)
    return cfg, state, faults, knobs, meta

