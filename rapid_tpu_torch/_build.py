"""Builds the CUDA sources under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` into ``build/lib<name>-<hash>.so`` inside this package (a directory
git ignores), then loaded with ``ctypes``. The hash covers the source and
the flags, so an edited source is rebuilt. No PyTorch header is included,
so a build takes seconds.

There is no fallback: without ``nvcc``, or when it fails, the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: dict = {}
#: name -> nvcc's stderr (ptxas register / spill report) of the last build.
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


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def _start(name: str):
    BUILD.mkdir(exist_ok=True)
    out = _target(name)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    """Wait for one build; returns its error text ('' on success)."""
    stdout, stderr = proc.communicate()
    build_log[name] = stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"nvcc failed on csrc/{name}.cu:\n{stdout}{stderr}"
    os.replace(tmp, out)
    return ""


def build_all(names=None) -> None:
    """Compile every (or the named) source not yet built, one ``nvcc`` per
    source, all started together. Waits for all of them, then raises if any
    failed."""
    names = sources() if names is None else list(names)
    with _lock:
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
