"""Builds the sources under ``csrc/``: the CUDA kernels at first use, the
native host library when asked.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` into ``build/lib<name>-<hash>.so`` inside this package (a directory
git ignores), then loaded with ``ctypes``. The hash covers the source and
the flags, so an edited source is rebuilt. No PyTorch header is included,
so a build takes seconds. ptxas's ``-v`` report (registers, shared memory,
spills per kernel instance) is kept beside the ``.so`` as
``lib<name>-<hash>.ptxas``.

Every first lookup of a kernel in this process (a hit when its ``.so`` is
already built, a miss otherwise) and every build with its wall time is
reported to ``utils/engine_telemetry``'s collector.

There is no fallback: without ``nvcc``, or when it fails, the build raises.

``csrc/<name>.cpp`` is host code (``rapid_native.cpp``, the native host
runtime of ``utils/_native.py``): :func:`build_host` compiles it with
``g++`` into ``build/lib<name>-<hash>.so`` by the same naming rule. Its
caller falls back to Python when it fails, so it returns the error text
instead of raising; the text is kept in :data:`build_log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
#: ``native/Makefile``'s flags.
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra")

_lock = threading.Lock()
_loaded: dict = {}
#: Kernel names looked up in this process (each one a hit or a miss once).
_requested: set = set()
#: name -> the compiler's stderr of the last build (for a kernel, ptxas's
#: register / spill report).
build_log: dict = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def sources() -> list:
    """Kernel source names (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str, suffix: str = ".cu", flags=NVCC_FLAGS) -> Path:
    src = (CSRC / f"{name}{suffix}").read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def host_target(name: str) -> Path:
    """Where the build of ``csrc/<name>.cpp`` is (or will be) kept."""
    return _target(name, ".cpp", GXX_FLAGS)


def report_path(name: str) -> Path:
    """Where ptxas's report of the build of ``csrc/<name>.cu`` is kept."""
    return _target(name).with_suffix(".ptxas")


def _collector():
    from rapid_tpu_torch.utils.engine_telemetry import _COLLECTOR

    return _COLLECTOR


def _start(name: str):
    BUILD.mkdir(exist_ok=True)
    out = _target(name)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, proc, tmp: Path, out: Path, start: float) -> str:
    """Wait for one build; returns its error text ('' on success)."""
    stdout, stderr = proc.communicate()
    _collector().on_build((time.perf_counter() - start) * 1e3)
    build_log[name] = stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"nvcc failed on csrc/{name}.cu:\n{stdout}{stderr}"
    report_path(name).write_text(stderr)
    os.replace(tmp, out)
    return ""


def build_all(names=None) -> None:
    """Compile every (or the named) source not yet built, one ``nvcc`` per
    source, all started together. Waits for all of them, then raises if any
    failed."""
    names = sources() if names is None else list(names)
    with _lock:
        for n in names:
            if n not in _requested:
                _requested.add(n)
                _collector().on_lookup(_target(n).exists())
        started = [(n, *_start(n)) for n in names if not _target(n).exists()]
        errors = [_finish(*job) for job in started]
    if any(errors):
        raise RuntimeError("\n".join(e for e in errors if e))


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _loaded.setdefault(name, ctypes.CDLL(str(_target(name))))
    return lib


def build_host(name: str) -> str:
    """Compile ``csrc/<name>.cpp`` with ``g++`` unless it is built. Returns
    '' on success, else the error text (also kept in ``build_log[name]``).
    The output goes through a temporary file and a rename, so processes
    that build at once leave one whole library."""
    out = host_target(name)
    with _lock:
        if out.exists():
            return ""
        BUILD.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as exc:
            tmp.unlink(missing_ok=True)
            build_log[name] = f"g++ could not build csrc/{name}.cpp: {exc!r}"
            return build_log[name]
        build_log[name] = proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return f"g++ failed on csrc/{name}.cpp:\n{proc.stdout}{proc.stderr}"
        os.replace(tmp, out)
        return ""
