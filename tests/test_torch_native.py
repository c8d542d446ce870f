"""The port's native host library against the JAX package's, exactly.

- ``rapid_tpu_torch/csrc/rapid_native.cpp`` is ``native/rapid_native.cpp``
  byte for byte.
- ``tests/test_native.py``'s grid (xxh64 over 14 lengths x 5 seeds, the
  ring keys of 200 endpoints at K=10, the configuration id of 50 members)
  through the port's library (``rapid_tpu_torch/utils/_native.py``, built
  by ``_build.build_host`` into the port's ``build/``) equals the JAX
  package's library and the port's Python and numpy paths.
- ``RAPID_TPU_NO_NATIVE=1`` and a failed build give the same values through
  the fallbacks, and the failed build's error text is kept and logged.
- Two processes building at once leave one whole library.
"""

import ctypes
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rapid_tpu.protocol import view as j_view
from rapid_tpu.types import Endpoint as JEndpoint
from rapid_tpu.types import NodeId as JNodeId
from rapid_tpu.utils import _native as j_native
from rapid_tpu_torch import _build
from rapid_tpu_torch.ops import rings
from rapid_tpu_torch.protocol import view as t_view
from rapid_tpu_torch.types import Endpoint, NodeId
from rapid_tpu_torch.utils import _native as t_native
from rapid_tpu_torch.utils.xxhash import to_signed64, xxh64, xxh64_int

REPO = Path(__file__).resolve().parent.parent
K = 10


@pytest.fixture(scope="module")
def built():
    """Both libraries, built and loaded (the JAX package's by the suite's
    conftest, the port's here)."""
    assert t_native.ensure_built(), _build.build_log.get("rapid_native")
    t_native._attempted = False
    assert t_native.get_lib() is not None
    assert j_native.get_lib() is not None
    return t_native._LIB_PATH


def _python_fold(node_ids, endpoints):
    """The configuration-id fold in Python (``configuration_id_of`` itself
    takes the native path when it can)."""
    h = 1
    for nid in node_ids:
        h = (h * 37 + xxh64_int(nid.high)) & t_view._MASK64
        h = (h * 37 + xxh64_int(nid.low)) & t_view._MASK64
    for ep in endpoints:
        h = (h * 37 + xxh64(ep.hostname.encode())) & t_view._MASK64
        h = (h * 37 + xxh64_int(ep.port)) & t_view._MASK64
    return to_signed64(h)


def _endpoints():
    rng = np.random.default_rng(1)
    return [(f"host-{i}.example.{rng.integers(0, 100)}", int(rng.integers(1, 65536)))
            for i in range(200)]


def _members():
    rng = np.random.default_rng(2)
    ids = sorted((int(rng.integers(0, 2**63)), int(rng.integers(0, 2**63))) for _ in range(50))
    return ids, [(f"10.2.{i}.{i}", 1000 + i) for i in range(50)]


def test_source_is_the_jax_packages_byte_for_byte():
    port = (REPO / "rapid_tpu_torch" / "csrc" / "rapid_native.cpp").read_bytes()
    assert port == (REPO / "native" / "rapid_native.cpp").read_bytes()


def test_library_is_built_into_the_ports_build_directory(built):
    assert built.parent == REPO / "rapid_tpu_torch" / "build"
    assert built.name.startswith("librapid_native-") and built.suffix == ".so"
    assert built == _build.host_target("rapid_native")


@pytest.mark.parametrize("length", [0, 1, 3, 4, 7, 8, 15, 16, 31, 32, 33, 64, 100, 1000])
def test_xxh64_equals_jax_and_python(built, length):
    data = bytes(np.random.default_rng(length).integers(0, 256, size=length, dtype=np.uint8))
    for seed in (0, 1, 7, 2**63, 2**64 - 1):
        want = xxh64(data, seed)
        assert t_native.native_xxh64(data, seed) == want, (length, seed)
        assert j_native.native_xxh64(data, seed) == want, (length, seed)


def test_ring_keys_equal_jax_python_and_numpy(built):
    pairs = _endpoints()
    hosts, ports = [h.encode() for h, _ in pairs], [p for _, p in pairs]
    keys = t_native.native_ring_keys_batch(hosts, ports, K)
    assert keys.dtype == np.uint64 and keys.shape == (K, len(pairs))
    np.testing.assert_array_equal(keys, j_native.native_ring_keys_batch(hosts, ports, K))
    np.testing.assert_array_equal(keys, rings._ring_keys_numpy(hosts, ports, K))
    eps = [Endpoint(h, p) for h, p in pairs]
    for seed in range(K):
        assert [int(x) for x in keys[seed]] == [t_view.ring_key(ep, seed) for ep in eps]
    hi, lo = rings.endpoint_ring_keys(eps, K)
    np.testing.assert_array_equal(hi, (keys >> np.uint64(32)).astype(np.uint32))
    np.testing.assert_array_equal(lo, (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def test_configuration_id_equals_jax_and_python(built):
    ids, pairs = _members()
    t_ids, t_eps = [NodeId(*i) for i in ids], [Endpoint(*e) for e in pairs]
    want = _python_fold(t_ids, t_eps)
    got = t_native.native_configuration_id(
        [i[0] for i in ids], [i[1] for i in ids], [h.encode() for h, _ in pairs],
        [p for _, p in pairs])
    assert to_signed64(got) == want
    assert t_view.configuration_id_of(t_ids, t_eps) == want
    assert j_view.configuration_id_of([JNodeId(*i) for i in ids],
                                      [JEndpoint(*e) for e in pairs]) == want


def _values():
    """What the host path computes through the native library when it is
    loaded: ring keys, a configuration id and a view's rings."""
    ids, pairs = _members()
    t_ids, t_eps = [NodeId(*i) for i in ids], [Endpoint(*e) for e in pairs]
    view = t_view.MembershipView(K, node_ids=t_ids, endpoints=t_eps)
    hi, lo = rings.endpoint_ring_keys([Endpoint(*e) for e in _endpoints()], K)
    return (hi.tolist(), lo.tolist(), t_view.configuration_id_of(t_ids, t_eps),
            view.configuration_id, [view.ring(r) for r in range(K)])


def _jax_values():
    ids, pairs = _members()
    view = j_view.MembershipView(K, node_ids=[JNodeId(*i) for i in ids],
                                 endpoints=[JEndpoint(*e) for e in pairs])
    return view.configuration_id, [[(e.hostname, e.port) for e in view.ring(r)] for r in range(K)]


def _port_rings(values):
    return [[(e.hostname, e.port) for e in ring] for ring in values[4]]


def test_no_native_environment_gives_the_same_values(built, monkeypatch):
    native = _values()
    assert (native[3], _port_rings(native)) == _jax_values()
    monkeypatch.setenv("RAPID_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(t_native, "_attempted", False)
    monkeypatch.setattr(t_native, "_lib", None)
    assert t_native.get_lib() is None and t_native.ensure_built() is False
    assert t_native.native_xxh64(b"x", 0) is None
    assert t_native.native_ring_keys_batch([b"a"], [1], K) is None
    assert t_native.native_configuration_id([1], [2], [b"a"], [1]) is None
    assert _values() == native


def test_failed_build_keeps_its_error_and_falls_back(built, monkeypatch, tmp_path, caplog):
    native = _values()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "rapid_native.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(t_native, "_LIB_PATH", _build.host_target("rapid_native"))
    monkeypatch.setattr(t_native, "_attempted", False)
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setitem(_build.build_log, "rapid_native", "")
    with caplog.at_level(logging.WARNING, logger=t_native.__name__):
        assert t_native.ensure_built() is False
    assert "error" in _build.build_log["rapid_native"]
    assert "g++ failed on csrc/rapid_native.cpp" in caplog.text
    assert t_native.get_lib() is None
    assert not list((tmp_path / "build").glob("*.tmp"))
    assert _values() == native


_BUILD_ONE = """
import sys
from pathlib import Path
from rapid_tpu_torch import _build
_build.BUILD = Path(sys.argv[1])
print(repr(_build.build_host("rapid_native")))
"""


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [out.strip() for out, _ in outs] == ["''", "''"]
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == [_build.host_target("rapid_native").name]
    lib = ctypes.CDLL(str(tmp_path / files[0]))
    lib.rapid_xxh64.restype = ctypes.c_uint64
    lib.rapid_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    assert lib.rapid_xxh64(b"rapid", 5, 7) == xxh64(b"rapid", 7)
