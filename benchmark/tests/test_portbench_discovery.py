"""A cell, a traffic mix and a per-layer metric added as new files and new
entries, in a copy of the benchmark, are found and run by the harness as it
stands: no file of it is edited."""

from __future__ import annotations

import json
import shutil

import torch

from benchmark import core
from benchmark.tests.conftest import ROOT, TINY_CONFIG


def test_new_files_alone_add_a_cell_a_mix_and_a_metric(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    (tmp_path / "benchmark" / "traffic" / "crash1pct.json").write_text(json.dumps({
        "loop": "burst", "crash": 4, "join": 3, "max_steps": 96,
        "max_cuts": 2, "min_cuts": 1, "warmup": 0, "ring_share": 1.0, "trace_requests": 1}))
    (tmp_path / "benchmark" / "metrics" / "driver.cuts.py").write_text(
        '"""driver.cuts: view changes a request."""\n\n\ndef read(run):\n'
        '    return sum(r["view_changes"] for r in run.records) / len(run.records)\n')
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "paper1k.crash1pct", "config": "paper1k",
                              "traffic": "crash1pct", "chips": 1, "why": "a new cell"})
    spec["end_to_end"][0]["workloads"].append("paper1k.crash1pct")
    spec["per_layer"].append({"name": "driver.cuts", "unit": "cuts", "better": "lower",
                              "source": "program_counter", "layer": "driver loop",
                              "moves": spec["end_to_end"][0]["name"],
                              "workloads": ["paper1k.crash1pct"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    plan = core.plan(core.load_spec(tmp_path), "paper1k.crash1pct", tmp_path)
    # Spare slots for the mix's joins, which the paper's configuration has none of.
    plan = plan._replace(config={**plan.config, **TINY_CONFIG["paper1k"], "n_slots": 220})
    assert plan.mix["crash"] == 4 and [m["name"] for m in plan.per_layer] == ["driver.cuts"]
    cpu = torch.device("cpu")
    run = core.measure(plan, 41, 0.0, False, cpu, 0.0)
    e2e = core.result_line(plan, run, False, cpu)
    assert e2e["correct"] and spec["end_to_end"][0]["name"] in e2e["metrics"]
    assert core.reader(tmp_path, "driver.cuts")(run) >= 1
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*") if p.is_file() and p.suffix != ".pyc"}
    assert all(after[path] == data for path, data in before.items() if path.suffix != ".pyc")
