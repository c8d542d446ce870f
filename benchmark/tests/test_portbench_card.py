"""On a card: one short run of each cell through the command line, traced
and not, each correct and reporting the cell's metrics. Skips without a
card (decided inside the test)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import CELLS, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 99),
         "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    group = SPEC["per_layer"] if trace else SPEC["end_to_end"]
    want = {m["name"] for m in group if "workloads" not in m or cell in m["workloads"]}
    assert set(line["metrics"]) == want
