"""BENCHMARK.json against the benchmark's contract: keys, names, units,
characters and sizes, every part found as a file, and every metric
reported only where the metric it moves is."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|experts_per")


def line_text(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_sizes():
    assert set(SPEC) == TOP_KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["paths"]) <= 16 and 1 <= len(SPEC["command"]) <= 32
    for path in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", path) and not path.endswith("_torch")
        assert (ROOT / path).is_dir()
    assert all(line_text(word) and not word.startswith("/") and ".." not in word
               for word in SPEC["command"])
    assert (ROOT / SPEC["command"][1]).is_file()


def test_every_name_unit_and_text():
    names = []
    for entry in SPEC["configs"]:
        assert set(entry) == CONFIG_KEYS
        assert line_text(entry["source"]) and line_text(entry["why"])
        assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
        assert not any(WIDTH.search(k) for k in entry["reduced"])
    for entry in SPEC["workloads"]:
        assert set(entry) == CELL_KEYS and entry["chips"] in (1, 4) and line_text(entry["why"])
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
    for metric in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [entry["name"] for entry in SPEC[group]]
        assert all(NAME.match(n) for n in group_names)
        assert len(set(group_names)) == len(group_names)
        names += group_names
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_end_to_end_metrics_and_bounds():
    by_name = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in by_name and by_name["setup_s"]["bound"] <= 0.25
    for metric in SPEC["end_to_end"]:
        assert set(metric) - {"workloads"} == E2E_KEYS
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for metric in SPEC["per_layer"]:
        assert set(metric) - {"workloads"} == LAYER_KEYS
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line_text(metric["layer"]) and metric["moves"] in e2e
        layers.setdefault(metric["layer"], []).append(metric["name"])
        for cell in metric["workloads"]:
            assert reports(e2e[metric["moves"]], cell), (metric["name"], cell)
        if metric["name"].endswith("_roofline") or "_roofline." in metric["name"]:
            assert metric["unit"] == "%"
    for cell in (w["name"] for w in SPEC["workloads"]):
        reported = [m["name"] for m in SPEC["end_to_end"] if reports(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(reports(m, cell) for m in SPEC["per_layer"])


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_each_config_file_is_found_and_states_its_deployment(entry):
    path = ROOT / entry["file"]
    assert path.is_file() and entry["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
    config = json.loads(path.read_text())
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert config["guarantees"] and config["kind"] in ("cluster", "fleet")
    files = [e["file"] for e in SPEC["configs"]]
    assert len(set(files)) == len(files)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda e: e["name"])
def test_each_cell_finds_its_mix_and_readers(cell):
    assert (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").is_file()
    for metric in SPEC["end_to_end"] + SPEC["per_layer"]:
        if reports(metric, cell["name"]):
            assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()
