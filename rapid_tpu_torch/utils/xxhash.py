"""Seeded XXH64, on the host, for ring keys (a copy of what the port needs
from ``rapid_tpu/utils/xxhash.py``, plus a batch form).

The reference orders its K monitoring rings by a seeded xxHash of each
endpoint (MembershipView.java:562-587). :func:`xxh64` and :func:`xxh64_int`
hash one input in plain Python. :func:`xxh64_rows` hashes many equal-length
inputs at once under many seeds with numpy's wrapping uint64 arithmetic,
bit for bit the same function: it is what turns the 100,000 endpoints of a
real cluster into ring keys in well under a second, where the scalar loop
takes tens of seconds. No device is involved: the keys go to the card as
uint32 hi/lo lanes.
"""

from __future__ import annotations

import struct

import numpy as np

_MASK64 = (1 << 64) - 1

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _MASK64
    acc = _rotl(acc, 31)
    return (acc * _P1) & _MASK64


def _merge_round(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return ((acc * _P1) + _P4) & _MASK64


def _avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P2) & _MASK64
    h ^= h >> 29
    h = (h * _P3) & _MASK64
    h ^= h >> 32
    return h


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` with ``seed``; returns an unsigned 64-bit int."""
    n = len(data)
    seed &= _MASK64

    if n >= 32:
        v1 = (seed + _P1 + _P2) & _MASK64
        v2 = (seed + _P2) & _MASK64
        v3 = seed
        v4 = (seed - _P1) & _MASK64
        i = 0
        limit = n - 32
        while i <= limit:
            l1, l2, l3, l4 = struct.unpack_from("<QQQQ", data, i)
            v1 = _round(v1, l1)
            v2 = _round(v2, l2)
            v3 = _round(v3, l3)
            v4 = _round(v4, l4)
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _MASK64
        h = _merge_round(h, v1)
        h = _merge_round(h, v2)
        h = _merge_round(h, v3)
        h = _merge_round(h, v4)
    else:
        h = (seed + _P5) & _MASK64
        i = 0

    h = (h + n) & _MASK64

    while i + 8 <= n:
        (lane,) = struct.unpack_from("<Q", data, i)
        h ^= _round(0, lane)
        h = (_rotl(h, 27) * _P1 + _P4) & _MASK64
        i += 8

    if i + 4 <= n:
        (lane32,) = struct.unpack_from("<I", data, i)
        h ^= (lane32 * _P1) & _MASK64
        h = (_rotl(h, 23) * _P2 + _P3) & _MASK64
        i += 4

    while i < n:
        h ^= (data[i] * _P5) & _MASK64
        h = (_rotl(h, 11) * _P1) & _MASK64
        i += 1

    return _avalanche(h)


def xxh64_int(value: int, seed: int = 0) -> int:
    """Hash an integer by its little-endian 8-byte encoding (signed or
    unsigned)."""
    value &= _MASK64
    return xxh64(struct.pack("<q", value - (1 << 64) if value >= (1 << 63) else value), seed)


# -- the batch form: numpy uint64 lanes, wrapping ------------------------

_U = np.uint64


def _rotl_v(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U(r)) | (x >> _U(64 - r))


def _round_v(acc: np.ndarray, lane: np.ndarray) -> np.ndarray:
    return _rotl_v(acc + lane * _U(_P2), 31) * _U(_P1)


def _merge_round_v(acc: np.ndarray, val: np.ndarray) -> np.ndarray:
    return (acc ^ _round_v(_U(0), val)) * _U(_P1) + _U(_P4)


def _lanes(data: np.ndarray, at: int, width: int) -> np.ndarray:
    """Little-endian ``width``-byte words at byte ``at`` of every row, as
    uint64."""
    word = np.ascontiguousarray(data[:, at:at + width]).view(f"<u{width}")[:, 0]
    return word.astype(np.uint64)


def xxh64_rows(data: np.ndarray, seeds) -> np.ndarray:
    """XXH64 of every row of ``data`` (``[m, L]`` uint8: m inputs of L bytes
    each) under every seed: ``[len(seeds), m]`` uint64, entry ``[s, i]``
    equal to ``xxh64(data[i].tobytes(), seeds[s])``."""
    data = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
    m, n = data.shape
    seed = (np.asarray(seeds, dtype=np.uint64) & _U(_MASK64))[:, None]
    zeros = np.zeros((seed.shape[0], m), dtype=np.uint64)
    with np.errstate(over="ignore"):
        if n >= 32:
            v1 = zeros + seed + _U((_P1 + _P2) & _MASK64)
            v2 = zeros + seed + _U(_P2)
            v3 = zeros + seed
            v4 = zeros + seed - _U(_P1)
            i = 0
            while i <= n - 32:
                v1 = _round_v(v1, _lanes(data, i, 8))
                v2 = _round_v(v2, _lanes(data, i + 8, 8))
                v3 = _round_v(v3, _lanes(data, i + 16, 8))
                v4 = _round_v(v4, _lanes(data, i + 24, 8))
                i += 32
            h = _rotl_v(v1, 1) + _rotl_v(v2, 7) + _rotl_v(v3, 12) + _rotl_v(v4, 18)
            for v in (v1, v2, v3, v4):
                h = _merge_round_v(h, v)
        else:
            h = zeros + seed + _U(_P5)
            i = 0
        h = h + _U(n)
        while i + 8 <= n:
            h = h ^ _round_v(_U(0), _lanes(data, i, 8))
            h = _rotl_v(h, 27) * _U(_P1) + _U(_P4)
            i += 8
        if i + 4 <= n:
            h = h ^ (_lanes(data, i, 4) * _U(_P1))
            h = _rotl_v(h, 23) * _U(_P2) + _U(_P3)
            i += 4
        while i < n:
            h = h ^ (data[:, i].astype(np.uint64) * _U(_P5))
            h = _rotl_v(h, 11) * _U(_P1)
            i += 1
        h = h ^ (h >> _U(33))
        h = h * _U(_P2)
        h = h ^ (h >> _U(29))
        h = h * _U(_P3)
        return h ^ (h >> _U(32))
