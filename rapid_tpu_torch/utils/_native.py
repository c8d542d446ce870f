"""ctypes bridge to the native host-runtime library (port of
``rapid_tpu/utils/_native.py``).

Loads the port's own build of ``csrc/rapid_native.cpp`` (a copy of the JAX
package's ``native/rapid_native.cpp``), exposing batch ring-key
construction and the configuration-id fold. Every entry point has a
pure-Python fallback producing bit-identical values;
``RAPID_TPU_NO_NATIVE=1`` disables the native path.

One departure from the JAX module: the library is compiled by
``_build.build_host`` (``g++`` with ``native/Makefile``'s flags) into the
port's ``build/`` as ``librapid_native-<hash>.so``, never under
``native/``; a failed build's error text is logged and kept in
``_build.build_log["rapid_native"]``.
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import Optional, Sequence

import numpy as np

from rapid_tpu_torch import _build

LOG = logging.getLogger(__name__)

_LIB_PATH = _build.host_target("rapid_native")

_lib: Optional[ctypes.CDLL] = None
_attempted = False


def _try_build() -> bool:
    error = _build.build_host("rapid_native")
    if error:
        LOG.warning("native build failed: %s", error)
    return _LIB_PATH.exists()


def ensure_built() -> bool:
    """Build the native library if missing. Call from setup paths (bench,
    test session start, packaging) — never from the event loop: the compile
    can take tens of seconds and would stall the protocol."""
    global _attempted
    if os.environ.get("RAPID_TPU_NO_NATIVE"):
        return False
    if _LIB_PATH.exists():
        return True
    built = _try_build()
    _attempted = False  # allow get_lib to pick up a fresh build
    return built


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None (Python fallback). Load-only:
    runtime code paths never compile (see ensure_built)."""
    global _lib, _attempted
    if _attempted:
        return _lib
    _attempted = True
    if os.environ.get("RAPID_TPU_NO_NATIVE"):
        return None
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.rapid_xxh64.restype = ctypes.c_uint64
        lib.rapid_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.rapid_ring_key.restype = ctypes.c_uint64
        lib.rapid_ring_key.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_int32,
            ctypes.c_uint64,
        ]
        lib.rapid_ring_keys_batch.restype = None
        lib.rapid_ring_keys_batch.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_uint64,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rapid_configuration_id.restype = ctypes.c_uint64
        lib.rapid_configuration_id.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_uint64,
        ]
        _lib = lib
    except OSError as exc:  # pragma: no cover
        LOG.debug("native load failed: %r", exc)
        _lib = None
    return _lib


def native_xxh64(data: bytes, seed: int) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.rapid_xxh64(data, len(data), ctypes.c_uint64(seed)))


def _pack_hostnames(hostnames: Sequence[bytes]):
    offsets = np.zeros(len(hostnames) + 1, dtype=np.uint64)
    for i, h in enumerate(hostnames):
        offsets[i + 1] = offsets[i] + len(h)
    blob = b"".join(hostnames)
    return blob, offsets


def native_ring_keys_batch(
    hostnames: Sequence[bytes], ports: Sequence[int], k: int
) -> Optional[np.ndarray]:
    """[k, n] uint64 ring keys, or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(hostnames)
    blob, offsets = _pack_hostnames(hostnames)
    ports_arr = np.asarray(ports, dtype=np.int32)
    out = np.empty((k, n), dtype=np.uint64)
    lib.rapid_ring_keys_batch(
        blob,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ports_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_uint64(n),
        ctypes.c_uint32(k),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out


def native_configuration_id(
    id_highs: Sequence[int],
    id_lows: Sequence[int],
    hostnames: Sequence[bytes],
    ports: Sequence[int],
) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    highs = np.asarray(id_highs, dtype=np.uint64)
    lows = np.asarray(id_lows, dtype=np.uint64)
    blob, offsets = _pack_hostnames(hostnames)
    ports_arr = np.asarray(ports, dtype=np.int32)
    return int(
        lib.rapid_configuration_id(
            highs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_uint64(len(highs)),
            blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ports_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_uint64(len(hostnames)),
        )
    )
