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
    # Every module of the port was imported: tenancy, utils, the narrow-lane
    # rule (_narrow), the endpoint type and the host hashing (utils.xxhash)
    # included.
    assert int(out[0]) >= 22
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


def test_delivery_wrapper_takes_a_tenant_axis_on_cpu_tensors():
    blocked, age = (x.expand(4, *x.shape).contiguous() for x in _args()[:2])
    before = delivery_new_bits.launches
    out = delivery_new_bits(blocked, age, torch.arange(4, dtype=torch.int32), 3, 5, 0, 1000)
    assert out.shape == (4, 5, 64) and bool((out == 7).all())
    assert delivery_new_bits.launches == before


@pytest.mark.parametrize("fault", ["tenant_count", "tenant_epochs", "four_axes"])
def test_delivery_wrapper_raises_on_a_mismatched_tenant_axis(fault):
    blocked, age, _ = _args()
    tenants = {"tenant_count": (2, 3, 3), "tenant_epochs": (3, 3, 2), "four_axes": (3, 3, 3)}[fault]
    blocked = blocked.expand(tenants[0], *blocked.shape).contiguous()
    age = age.expand(tenants[1], *age.shape).contiguous()
    epoch = torch.zeros((tenants[2],), dtype=torch.int32)
    if fault == "four_axes":
        blocked, age = blocked[None], age[None]
    with pytest.raises(ValueError):
        delivery_new_bits(blocked, age, epoch, 3, 5, 0, 1000)


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
