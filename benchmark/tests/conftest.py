"""Helpers of the benchmark's CPU tests: every cell at a tiny size, run
through the harness on the CPU (the harness's look for a card is skipped;
its command line never runs without one)."""

from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch

from benchmark import core

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("paper1k.crash10", "paper1k_fleet.crash10")
#: Sizes small enough for the CPU; every protocol knob stays the cell's.
TINY_CONFIG = {
    "paper1k": {"n_members": 200, "n_slots": 200},
    "paper1k_fleet": {"tenants": 4, "n_members": 200, "n_slots": 200},
}
TINY_MIX = {
    "crash10": {"warmup": 0, "ring_share": 1.0},
}
SEED = 2**31 + 977


def tiny_plan(cell: str, root: Path = ROOT) -> core.Plan:
    plan = core.plan(core.load_spec(root), cell, root)
    return plan._replace(config={**plan.config, **TINY_CONFIG[plan.cell["config"]]},
                         mix={**plan.mix, **TINY_MIX.get(plan.cell["traffic"], {})})


def tiny_run(plan: core.Plan, seed: int = SEED, substitute=None):
    """One request (a window of 0 s) of ``plan`` on the CPU: the run and its
    result line."""
    cpu = torch.device("cpu")
    run = core.measure(plan, seed, 0.0, False, cpu, time.perf_counter(), substitute=substitute)
    return run, core.result_line(plan, run, False, cpu)


@pytest.fixture(params=CELLS)
def cell(request):
    return request.param
