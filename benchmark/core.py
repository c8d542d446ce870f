"""One run of one cell: set-up, the measured window, the traced stretch, the
comparison with the reference, and the result line.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the cell's configuration file (its ``file``), its traffic
mix (``benchmark/traffic/<traffic>.json``) and a reader for each metric the
cell reports (``benchmark/metrics/<metric>.py``, whose ``read(run)`` returns
the metric's value, or None where it finds nothing to read). A later cell,
mix or metric is a new file and a new entry; no file here changes.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import torch

from benchmark import check, generator, loops, profiling, roofline, targets

#: Top-level module names that no run may hold once its window has closed:
#: the JAX package, JAX itself, and the JAX package's benchmark script.
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "rapid_tpu", "bench"})
#: Request indices of the warm-up and of the traced stretch (the window's
#: start at 0), so that no two draw the same churn.
WARMUP_BASE, TRACE_BASE = 1 << 40, 1 << 41
#: Fenced sessions tried before a traced run gives up.
PROFILE_ATTEMPTS = 3


class Plan(NamedTuple):
    name: str
    cell: dict
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list
    root: Path


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def plan(spec: dict, cell: str, root: Path) -> Plan:
    """The cell's parts, found by name; raises naming what is missing."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json: {sorted(cells)}")
    entry = cells[cell]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic" / f"{entry['traffic']}.json").read_text())
    return Plan(
        cell, entry, config, mix,
        [m for m in spec["end_to_end"] if _applies(m, cell)],
        [m for m in spec["per_layer"] if _applies(m, cell)],
        root,
    )


def reader(root: Path, metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("benchmark.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def ring_sample(mix: dict, seed: int, index: int) -> bool:
    """Whether request ``index``'s K rings are compared: a share
    ``ring_share`` of the requests, drawn from the seed."""
    return bool(generator.rng(seed, 6, index).random() < mix["ring_share"])


def _merge(profiles):
    """The sum of several fenced sessions' profiles."""
    out = {key: sum(p[key] for p in profiles) for key in (
        "wall_s", "device_s", "busy_s", "device_ops", "delivery_s", "delivery_launches",
        "host_self_s", "host_events")}
    for part in ("device_ops", "idle_gaps"):
        table = {}
        for p in profiles:
            for name, seconds in p["breakdown"][part]:
                table[name] = table.get(name, 0.0) + seconds
        out.setdefault("breakdown", {})[part] = [
            [name, seconds] for name, seconds in
            sorted(table.items(), key=lambda kv: kv[1], reverse=True)[:profiling.BREAKDOWN_ENTRIES]]
    return out


def traced_stretch(plan: Plan, target, seed: int, device):
    """``trace_requests`` requests, each made twice from the same settled state:
    once unprofiled, with the delivery kernel's bound summed over its calls
    (:func:`benchmark.roofline.delivery_bound`, on each call's inputs), and
    once, the same request again, in a fenced profiler session. Returns
    (the profiled records, their merged profile). The profile's ``rounds``
    are the rounds the program computed, counted as the delivery kernel's
    launches in the sessions: every round launches it once."""
    from rapid_tpu_torch.models import virtual_cluster

    loop, mix = loops.LOOPS[plan.mix["loop"]], plan.mix
    real = virtual_cluster.delivery_new_bits
    records, profiles, bound_s = [], [], 0.0

    def bounded(*args, **tile):
        nonlocal bound_s
        out = real(*args, **tile)
        bound_s += roofline.delivery_bound(*args)[0]
        return out

    for j in range(mix["trace_requests"]):
        for attempt in range(PROFILE_ATTEMPTS):
            index = TRACE_BASE + j + attempt * (1 << 20)
            before = bound_s
            virtual_cluster.delivery_new_bits = bounded
            try:
                loop(target, mix, seed, index, False)()
            finally:
                virtual_cluster.delivery_new_bits = real
            request = loop(target, mix, seed, index, True)
            record, profile = profiling.profile_run(
                device, request, lead_s=profiling.PROFILE_LEAD_S * 3 ** attempt)
            if profile["recorded"]:
                break
            bound_s = before
        else:
            raise RuntimeError(f"the profiler lost records in {PROFILE_ATTEMPTS} sessions")
        records.append(loops.finish(record))
        profiles.append(profile)
    profile = _merge(profiles)
    profile["rounds"] = profile["delivery_launches"]
    profile["delivery_bound_s"] = bound_s
    return records, profile


def measure(plan: Plan, seed: int, seconds: float, trace: bool, device, t0: float,
            substitute=None):
    """Set-up, the window (and with ``trace`` the traced stretch), then the
    comparison. Returns the run as a namespace that the metric readers
    read. ``substitute(reference, records, answers)``, given only by the
    control (``benchmark/control.py``), replaces the program's answers
    before they are judged."""
    loop, mix = loops.LOOPS[plan.mix["loop"]], plan.mix
    target = targets.Target(plan.config, seed, device)
    for w in range(mix["warmup"]):
        loop(target, mix, seed, WARMUP_BASE + w, False)()
    loops.sync(device)
    # Set-up's objects are kept out of the collector's passes in the window.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0

    records = []
    start = time.perf_counter()
    while not records or time.perf_counter() - start < seconds:
        index = len(records)
        records.append(loops.finish(loop(target, mix, seed, index, ring_sample(mix, seed, index))()))
    window_s = time.perf_counter() - start
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    traced, profile = ([], None) if not trace else traced_stretch(plan, target, seed, device)
    judged = records + traced
    answers = [r.pop("answer") for r in judged]
    del target
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = check.Reference(plan.config, seed)
    if substitute is not None:
        answers = substitute(reference, judged, answers)
    attempted, failed, numbers = check.judge(reference, judged, answers)
    return SimpleNamespace(
        setup_s=setup_s, window_s=window_s, records=records, traced=traced, profile=profile,
        memory_peak_bytes=peak, attempted=attempted, failed=failed, numbers=numbers,
    )


def result_line(plan: Plan, run, trace: bool, device) -> dict:
    """The contract's last line: the cell's end-to-end metrics (per-layer
    with ``trace``), the device, and the numbers compared with their
    limits, last."""
    metrics = {}
    for metric in (plan.per_layer if trace else plan.end_to_end):
        value = reader(plan.root, metric["name"])(run)
        if value is not None:
            metrics[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    within = all(value <= limit for value, limit in run.numbers.values())
    line = {
        "correct": bool(run.failed == 0 and within and run.attempted > 0),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": plan.cell["chips"],
            "memory_peak_bytes": int(run.memory_peak_bytes),
        },
    }
    if trace:
        line["device"]["busy_s"] = run.profile["busy_s"]
        line["device"]["window_s"] = run.profile["wall_s"]
        line["breakdown"] = run.profile["breakdown"]
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, (value, limit) in run.numbers.items()}
    return line


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN_MODULES)


def check_lines(line: dict) -> list:
    return [f"check {name}: {c['value']} (limit {c['limit']})" for name, c in line["checks"].items()]
