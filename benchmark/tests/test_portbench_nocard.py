"""Without a card the command exits non-zero and prints no result; so it
does in a directory that holds the benchmark and nothing of the program."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from benchmark.tests.conftest import ROOT

ARGS = ["--workload", "paper1k.crash10", "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]


def run_from(root, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=root,
                          capture_output=True, text=True, timeout=300, env=env)


def no_result(out):
    for text in out.stdout.splitlines():
        try:
            assert "correct" not in json.loads(text)
        except (json.JSONDecodeError, TypeError):
            pass


def test_a_run_without_a_card_fails():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = run_from(ROOT, env)
    assert out.returncode != 0
    no_result(out)
    assert "CUDA card" in out.stderr


def test_a_run_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = run_from(tmp_path, env)
    assert out.returncode != 0
    no_result(out)
