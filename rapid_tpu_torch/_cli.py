"""Pieces shared by the port's command lines (``rapid_tpu_torch.examples``
and ``rapid_tpu_torch.tools``).

Every command line that touches a tensor takes ``--device`` (CUDA unless
the caller names another device); asking for CUDA without a card raises,
and nothing falls back to the CPU. Each module's ``main(argv)`` returns
its exit code, and its ``__main__`` block goes through :func:`run_main`,
which can also write how many times the delivery kernel was launched in
the process: set ``RAPID_TPU_TORCH_LAUNCH_REPORT`` to a file path and the
count is written there as JSON when ``main`` returns.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, List, Optional

import torch

from rapid_tpu_torch.models.state import resolve_device

#: Environment variable naming the file the launch count is written to.
LAUNCH_REPORT_ENV = "RAPID_TPU_TORCH_LAUNCH_REPORT"


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="torch device the engine runs on (default cuda; cpu for tests). "
             "Asking for cuda without a card raises; nothing falls back.",
    )


def device_of(args: argparse.Namespace) -> torch.device:
    """The parsed ``--device``, checked: CUDA without a card raises."""
    return resolve_device(args.device)


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_main(main: Callable[[Optional[List[str]]], int]) -> int:
    """``main(sys.argv[1:])``, then the launch report when it is asked for."""
    code = main(sys.argv[1:])
    path = os.environ.get(LAUNCH_REPORT_ENV)
    if path:
        from rapid_tpu_torch.ops.kernels import delivery_new_bits

        with open(path, "w") as f:
            json.dump({"delivery_new_bits": delivery_new_bits.launches}, f)
    return code
