"""The PyTorch port on a CUDA card.

The delivery kernel (``rapid_tpu_torch/csrc/delivery.cu``) against its plain
PyTorch version, bit for bit, and the whole engine on the card against the
engine on the CPU, lane by lane. Every test needs a CUDA card and ``nvcc``
and skips without them. On a GPU machine, from the root of a checkout
(``--noconftest`` because the suite's conftest configures JAX, which the
port does not need)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import churn_cluster, delivery_inputs, resolve
from rapid_tpu_torch import _u32
from rapid_tpu_torch.convert import state_to_numpy
from rapid_tpu_torch.ops.kernels import delivery_new_bits, delivery_new_bits_ref

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,spread,permille", [
    (2, 1000, 0, 1000),    # no jitter
    (32, 129, 1, 1000),    # one cohort word, ragged slot edge
    (64, 1000, 2, 1000),   # two words, the main path's mode
    (33, 257, 1, 250),     # sub-round gate, word boundary
    (40, 5, 3, 300),       # fewer slots than one thread block
])
def test_delivery_kernel_matches_plain_version(card, c, n, spread, permille):
    k = 10
    args = (*delivery_inputs(c, k, n, c * 100 + spread, card), k, c, spread, permille)
    before = delivery_new_bits.launches
    got = delivery_new_bits(*args)
    want = delivery_new_bits_ref(*args)
    assert delivery_new_bits.launches == before + 1
    assert got.shape == (c, n) and got.device == card
    np.testing.assert_array_equal(_u32.to_numpy(got), _u32.to_numpy(want))


@pytest.mark.cuda
def test_delivery_wrapper_raises_on_inputs_split_across_devices(card):
    blocked, age, epoch = delivery_inputs(5, 3, 64, 1, card)
    with pytest.raises(ValueError, match="different devices"):
        delivery_new_bits(blocked, age.cpu(), epoch, 3, 5, 1, 1000)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_lane_by_lane(card):
    # chip_smoke.py's 5%-churn recipe at N=512 with C=40 (two cohort words).
    n, n_churn = 512, 12
    lanes, results = {}, {}
    for device in (card, torch.device("cpu")):
        vc, _ = churn_cluster(n, n_churn, n_churn, 40, 3, device)
        launches = delivery_new_bits.launches
        results[device.type] = resolve(vc, n)
        if device.type == "cuda":
            assert delivery_new_bits.launches > launches
        lanes[device.type] = state_to_numpy(vc.state)
    assert results["cuda"] == results["cpu"]
    assert results["cuda"][2], results
    for field, want in lanes["cpu"].items():
        np.testing.assert_array_equal(lanes["cuda"][field], want, err_msg=field)
