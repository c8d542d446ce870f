"""The PyTorch port stands alone, and its kernel wrapper never falls back.

- Importing every ``rapid_tpu_torch`` module and ``chip_smoke`` loads
  neither ``jax`` nor anything of ``rapid_tpu`` (checked in a fresh
  interpreter, since this test process has both loaded).
- The delivery wrapper raises on inputs its kernel does not take instead of
  quietly taking the plain version.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from rapid_tpu_torch.ops.kernels import delivery_new_bits

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import rapid_tpu_torch
names = ["chip_smoke"] + [
    m.name for m in pkgutil.walk_packages(rapid_tpu_torch.__path__, "rapid_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "rapid_tpu"))
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_rapid_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, check=True,
    ).stdout.split(maxsplit=1)
    assert int(out[0]) >= 12  # every module of the port was imported
    assert out[1].strip() == "[]", f"the port loaded: {out[1]}"


def _args(n=64, k=3, c=5):
    return (
        torch.zeros((k, n), dtype=torch.int32),  # blocked_rows: one cohort word
        torch.zeros((k, n), dtype=torch.int32),  # age_kn
        torch.zeros((1,), dtype=torch.int32),  # epoch
    )


def test_delivery_wrapper_takes_the_plain_version_only_on_cpu_tensors():
    before = delivery_new_bits.launches
    out = delivery_new_bits(*_args(), 3, 5, 0, 1000)
    assert out.shape == (5, 64) and bool((out == 7).all())  # age 0, nothing blocked
    assert delivery_new_bits.launches == before


@pytest.mark.parametrize("fault", ["mixed_devices", "meta_device", "dtype", "noncontiguous", "shape"])
def test_delivery_wrapper_raises_instead_of_falling_back(fault):
    blocked, age, epoch = _args()
    if fault == "mixed_devices":
        age = age.to("meta")
    elif fault == "meta_device":
        blocked, age, epoch = blocked.to("meta"), age.to("meta"), epoch.to("meta")
    elif fault == "dtype":
        age = age.to(torch.int64)
    elif fault == "noncontiguous":
        age = torch.zeros((64, 3), dtype=torch.int32).T
    else:
        blocked = blocked[:2]
    with pytest.raises((TypeError, ValueError)):
        delivery_new_bits(blocked, age, epoch, 3, 5, 0, 1000)
