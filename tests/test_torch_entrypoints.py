"""The port's command lines and examples (``rapid_tpu_torch.tools``,
``rapid_tpu_torch.examples``) against the JAX package's scripts (``tools/``,
``examples/``), on the CPU, at small sizes, exactly.

- ``chaosrun``: ``run`` of a pinned family through both command lines
  (equal printed lines but the artifact path, equal ``result.json``,
  fault log and Chrome trace), each package's repro directory replayed by
  the other's ``replay``, exit code 2 from both on a bad schedule, a
  missing file or bad JSON, and ``fuzz --fleet 4`` with equal tallies;
- the viewers ``traceview``, ``clustertop --once`` and ``perfview`` on the
  inputs of ``tests/test_observability.py`` and ``tests/test_perfview.py``
  and on the chaos artifacts: byte-identical standard output and Chrome
  JSON, equal exit codes (one parametrised test);
- ``bootstrap_bench.run_bootstrap`` at N=200, ``khl_sensitivity.run_once``
  at n=200 and spread 128 (three seeds, a cell that conflicts), ``--small``
  of ``virtual_cluster_demo`` (its lines with times and the device line
  stripped), ``fleet_khl_autotune`` (its JSON lines) and
  ``host_scale_ceiling``'s host column;
- ``collective_audit`` on a 2-rank gloo group: the invariants
  ``tests/test_torch_parallel.py`` pins; ``udp_loss_curve`` at no loss and
  ``kernel_microbench`` on the CPU (no kernel there: ``kernel_ms`` null).

The JAX demo runs in a subprocess started with the module, so it overlaps
the in-process work; module fixtures share the rest.
"""

import asyncio
import contextlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO / "examples"))

import bootstrap_bench as jax_bootstrap  # noqa: E402  — examples/bootstrap_bench.py
import chaosrun as jax_chaosrun  # noqa: E402  — tools/chaosrun.py
import clustertop as jax_clustertop  # noqa: E402
import host_scale_ceiling as jax_ceiling  # noqa: E402
import khl_sensitivity as jax_khl  # noqa: E402
import perfview as jax_perfview  # noqa: E402
import traceview as jax_traceview  # noqa: E402
from test_observability import _clustertop_snapshot  # noqa: E402
from test_perfview import _complete_ledger  # noqa: E402

from rapid_tpu.utils.clock import ManualClock  # noqa: E402
from rapid_tpu.utils.flight_recorder import EventName, FlightRecorder  # noqa: E402
from rapid_tpu_torch.examples import bootstrap_bench, fleet_khl_autotune  # noqa: E402
from rapid_tpu_torch.examples import host_scale_ceiling, kernel_microbench  # noqa: E402
from rapid_tpu_torch.examples import khl_sensitivity, udp_loss_curve  # noqa: E402
from rapid_tpu_torch.examples import virtual_cluster_demo  # noqa: E402
from rapid_tpu_torch.ops.kernels import delivery_new_bits  # noqa: E402
from rapid_tpu_torch.tools import chaosrun, clustertop, collective_audit  # noqa: E402
from rapid_tpu_torch.tools import perfview, traceview  # noqa: E402

CPU = ["--device", "cpu"]
FAMILY, SEED = "crash_during_join", 0  # one host run with two cuts and a join


def call(main, argv, capsys):
    """``main(argv)``'s exit code and captured (stdout, stderr)."""
    capsys.readouterr()
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.fixture(scope="module", autouse=True)
def jax_demo(tmp_path_factory):
    """The JAX demo at ``--small``, started first (it takes the longest)."""
    log = tmp_path_factory.mktemp("demo") / "jax_demo.txt"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "examples" / "virtual_cluster_demo.py"), "--small",
             "--platform", "cpu"], stdout=out, stderr=subprocess.STDOUT, env=env, cwd=REPO,
        )
    yield proc, log
    if proc.poll() is None:
        proc.kill()
        proc.wait()


# -- chaosrun ----------------------------------------------------------------


@pytest.fixture(scope="module")
def chaos_runs(tmp_path_factory):
    """The pinned family through both command lines, each with its Chrome
    trace; what each printed."""
    root = tmp_path_factory.mktemp("chaos")
    out = {}
    for name, main, extra in (("jax", jax_chaosrun.main, []), ("port", chaosrun.main, CPU)):
        argv = ["run", FAMILY, "--seed", str(SEED), "--artifacts", str(root / name),
                "--chrome", str(root / f"{name}.json"), *extra]
        with open(root / f"{name}.out", "w") as out_file, contextlib.redirect_stdout(out_file):
            rc = main(argv)
        out[name] = (rc, (root / f"{name}.out").read_text().replace(str(root / name), "DIR")
                     .replace(str(root / f"{name}.json"), "CHROME"))
    return root, out


def _without_wall(value):
    """A JSON value with every wall-clock field dropped."""
    if isinstance(value, dict):
        return {k: _without_wall(v) for k, v in value.items() if "wall" not in k}
    if isinstance(value, list):
        return [_without_wall(v) for v in value]
    return value


def test_chaosrun_run_matches_jax(chaos_runs):
    root, out = chaos_runs
    assert out["port"] == out["jax"] and out["jax"][0] == 0
    for name in ("result.json", "schedule.json", "faultlog.json"):
        want = _without_wall(json.loads((root / "jax" / name).read_text()))
        assert _without_wall(json.loads((root / "port" / name).read_text())) == want, name
    assert (root / "port" / "violations.txt").read_text() == "(none)\n"
    nodes = sorted(p.name for p in (root / "jax" / "nodes").iterdir())
    assert nodes and nodes == sorted(p.name for p in (root / "port" / "nodes").iterdir())
    assert (root / "port.json").read_bytes() == (root / "jax.json").read_bytes()


@pytest.mark.parametrize("writer,replayer", [("jax", "port"), ("port", "jax")])
def test_chaosrun_repro_replays_in_the_other_package(chaos_runs, writer, replayer, capsys):
    root, _ = chaos_runs
    main, extra = (chaosrun.main, CPU) if replayer == "port" else (jax_chaosrun.main, [])
    got = call(main, ["replay", str(root / writer), *extra], capsys)
    own = call(chaosrun.main if writer == "port" else jax_chaosrun.main,
               ["replay", str(root / writer), *(CPU if writer == "port" else [])], capsys)
    assert got == own and got[0] == 0


@pytest.mark.parametrize("fault", ["bad_schedule", "missing_file", "bad_json"])
def test_chaosrun_exit_codes_on_bad_input_match_jax(tmp_path, fault, capsys):
    path = tmp_path / "schedule.json"
    if fault == "bad_schedule":
        from rapid_tpu_torch.sim.fuzz import scenario_family

        schedule = json.loads(scenario_family(FAMILY, SEED).to_json())
        schedule["version"] = 999  # ScheduleError: unknown schedule version
        path.write_text(json.dumps(schedule))
    elif fault == "bad_json":
        path.write_text("{nope")
    want = call(jax_chaosrun.main, ["run", "--schedule", str(path)], capsys)
    got = call(chaosrun.main, ["run", "--schedule", str(path), *CPU], capsys)
    assert got[0] == want[0] == 2
    assert got[1:] == want[1:] and want[2].startswith("chaosrun: ")


def test_chaosrun_fuzz_fleet_tallies_match_jax(tmp_path, capsys):
    tallies = {}
    for name, main, extra in (("jax", jax_chaosrun.main, []), ("port", chaosrun.main, CPU)):
        rc, out, _ = call(main, ["fuzz", "--fleet", "4", "--out", str(tmp_path / name),
                                 *extra], capsys)
        lines = out.splitlines()
        # The last line carries wall ms and scenarios/sec: keep its counts.
        tallies[name] = (rc, lines[:-1], lines[-1].split(" ms wall")[0].rsplit(",", 1)[0])
    assert tallies["port"] == tallies["jax"]
    assert tallies["jax"][0] == 0 and len(tallies["jax"][1]) == 4


# -- viewers -----------------------------------------------------------------


def _recorder_dumps(tmp_path):
    """Three nodes' recordings of one change on one simulated clock (the
    merge-order inputs of tests/test_observability.py), as snapshot files."""
    clock = ManualClock()
    recs = [FlightRecorder(node=f"10.0.0.{i}:9001", clock=clock, capacity=16) for i in (1, 2, 3)]
    recs[0].record(EventName.CONSENSUS_DECIDED, config_id=1, trace_id=9)
    recs[1].record(EventName.ALERT_ENQUEUED, config_id=1, trace_id=9)
    recs[1].record(EventName.FAST_ROUND_PROPOSAL, config_id=1, trace_id=9)
    clock.advance_ms(5)
    recs[2].record(EventName.ALERT_ENQUEUED, trace_id=2)
    recs[2].record(EventName.VIEW_CHANGE, config_id=2, trace_id=9)
    paths = []
    for i, rec in enumerate(recs):
        path = tmp_path / f"node{i}.json"
        path.write_text(json.dumps(rec.snapshot()))
        paths.append(str(path))
    return paths


def _viewer_case(case, tmp_path, chaos_root):
    """(viewer name, argv, the Chrome path it writes or None)."""
    chrome = str(tmp_path / "chrome.json")
    if case == "traceview_nodes":
        return "traceview", [*_recorder_dumps(tmp_path), "--chrome", chrome], chrome
    if case == "traceview_one_trace":
        return "traceview", [*_recorder_dumps(tmp_path), "--trace", "0x9"], None
    if case == "traceview_repro_dir":
        return "traceview", [str(chaos_root / "jax"), "--chrome", chrome], chrome
    if case == "traceview_invalid_json":
        bad = tmp_path / "bad.json"
        bad.write_text("{this is not json")
        return "traceview", [str(bad)], None
    if case == "clustertop_three_nodes":
        paths = []
        for i, (health, det) in enumerate((("stable", (5.0, 6.0)), ("proposing", (50.0,)),
                                           ("wedged", ()))):
            path = tmp_path / f"node{i}.json"
            path.write_text(json.dumps(_clustertop_snapshot(f"10.0.0.{i + 1}:9001", health,
                                                            detection_ms=det)))
            paths.append(str(path))
        torn = tmp_path / "torn.json"
        torn.write_text('{"node": "10.0.0.9:9001"')
        return "clustertop", [*paths, str(torn), "--once"], None
    if case == "clustertop_chaos_nodes":
        nodes = sorted(str(p) for p in (chaos_root / "jax" / "nodes").glob("*.json"))
        return "clustertop", [*nodes, "--once"], None
    if case == "clustertop_nothing":
        bad = tmp_path / "bad.json"
        bad.write_text("nope")
        return "clustertop", [str(bad), "--once"], None
    if case == "perfview_ledger":
        return "perfview", [str(_complete_ledger(tmp_path)), "--chrome", chrome], chrome
    if case == "perfview_failed_ledger":
        return "perfview", [str(_complete_ledger(tmp_path, fail_in="warmup_compile"))], None
    if case == "perfview_trajectory":
        rounds = sorted(str(p) for p in REPO.glob("BENCH_r0*.json"))
        return "perfview", [*rounds, "--chrome", chrome], chrome
    if case == "perfview_bad_input":
        scalar = tmp_path / "scalar.json"
        scalar.write_text("42")
        return "perfview", [str(scalar)], None
    raise KeyError(case)


VIEWER_CASES = [
    "traceview_nodes", "traceview_one_trace", "traceview_repro_dir", "traceview_invalid_json",
    "clustertop_three_nodes", "clustertop_chaos_nodes", "clustertop_nothing",
    "perfview_ledger", "perfview_failed_ledger", "perfview_trajectory", "perfview_bad_input",
]
VIEWERS = {"traceview": (jax_traceview.main, traceview.main),
           "clustertop": (jax_clustertop.main, clustertop.main),
           "perfview": (jax_perfview.main, perfview.main)}


@pytest.mark.parametrize("case", VIEWER_CASES)
def test_viewer_output_is_byte_identical(case, tmp_path, chaos_runs, capsys):
    viewer, argv, chrome = _viewer_case(case, tmp_path, chaos_runs[0])
    jax_main, port_main = VIEWERS[viewer]
    want = call(jax_main, argv, capsys)
    want_chrome = Path(chrome).read_bytes() if chrome else None
    got = call(port_main, argv, capsys)
    assert got == want
    if chrome:
        assert Path(chrome).read_bytes() == want_chrome
    assert got[1] or got[2]  # something was rendered or reported


# -- the paper's experiments -------------------------------------------------


def test_run_bootstrap_matches_jax():
    args = (200, 16, 4, 8, 2)
    want = jax_bootstrap.run_bootstrap(*args, seed=3)
    got = bootstrap_bench.run_bootstrap(*args, seed=3, device="cpu")
    for key in ("view_changes", "unique_sizes", "rounds", "n_total", "waves"):
        assert got[key] == want[key], key
    assert got["unique_sizes"][-1] == 200 and got["view_changes"] >= 4


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_khl_run_once_matches_jax(seed):
    h, l, f = 6, 4, 2  # a cell where early announcements conflict
    want = jax_khl.run_once(200, 10, h, l, f, 16, seed, delivery_spread=128)
    before = delivery_new_bits.launches
    got = khl_sensitivity.run_once(200, 10, h, l, f, 16, seed, delivery_spread=128,
                                   device="cpu")
    assert got == want
    assert got[0] > 0 and got[1] == 16
    assert delivery_new_bits.launches == before  # the CPU takes the plain version


def _structural(lines):
    """Printed lines with wall-clock numbers stripped."""
    return [re.sub(r"-?\d+\.\d+ ms", "<ms>", re.sub(r", -?\d+\.\d+\)", ", <ms>)", line))
            for line in lines]


def test_virtual_cluster_demo_small_matches_jax(jax_demo, capsys):
    rc, out, _ = call(virtual_cluster_demo.main, ["--small", *CPU], capsys)
    proc, log = jax_demo
    assert proc.wait(timeout=240) == 0 and rc == 0
    want = log.read_text().splitlines()
    got = out.splitlines()
    assert want[0].startswith("devices:") and got[0].startswith("device: cpu")
    assert _structural(got[1:]) == _structural(want[1:])
    assert any("members 10000, epochs 2" in line for line in got)


def test_fleet_khl_autotune_matches_jax(capsys):
    import fleet_khl_autotune as jax_autotune  # examples/fleet_khl_autotune.py

    argv = ["--n", "64", "--f", "3", "--knobs", "4/2,2/1", "--cohorts", "8", "--seeds", "1,2"]
    saved = sys.argv
    sys.argv = ["fleet_khl_autotune.py", *argv, "--platform", "cpu"]
    try:
        capsys.readouterr()
        jax_autotune.main()
        want = capsys.readouterr().out
    finally:
        sys.argv = saved
    rc, got, _ = call(fleet_khl_autotune.main, [*argv, *CPU], capsys)
    assert rc == 0 and got == want
    assert len(got.splitlines()) == 2 and json.loads(got.splitlines()[0])["best_knob"]


def test_host_scale_ceiling_host_column_matches_jax():
    want = asyncio.run(jax_ceiling.host_crash_convergence(24))
    got = asyncio.run(host_scale_ceiling.host_crash_convergence(24))
    assert got[1:] == want[1:]  # simulated ms, messages, relays (not wall)
    assert host_scale_ceiling.engine_crash_convergence(24, device="cpu") >= 0


def test_udp_loss_curve_point_without_loss():
    row = asyncio.run(udp_loss_curve.measure(0.0, 5, 42))
    assert row["n_nodes"] == 5 and row["loss_pct"] == 0.0
    assert row["datagrams_dropped"] == 0 and row["datagrams_delivered"] > 0
    assert row["forced_rejoins"] == 0 and row["kicked"] == 0


def test_kernel_microbench_on_the_cpu_reports_no_kernel(capsys):
    rc, out, _ = call(kernel_microbench.main, ["--n", "3000", *CPU], capsys)
    rows = [json.loads(line) for line in out.splitlines()]
    assert rc == 0 and rows[0]["watermark_shape"] == [8, 3000]
    assert [r["delivery_shape"] for r in rows[1:]] == [[64, 3000], [8, 3000]]
    for r in rows[1:]:
        assert r["kernel_ms"] is None and r["speedup"] is None and r["plain_ms"] > 0


# -- the collective audit ----------------------------------------------------


def test_collective_audit_on_two_gloo_ranks(tmp_path, capsys):
    out = tmp_path / "audit.json"
    rc, text, _ = call(collective_audit.main, ["--n", "256", "--devices", "2", "--cohorts", "64",
                                               "--out", str(out), *CPU], capsys)
    report = json.loads(out.read_text())
    assert rc == 0 and report["ok"] and report["backend"] == "gloo"
    assert report["mesh"] == {"nodes": 2} and report["members"] == 250
    assert "| program | location | kind | source | count | payload bytes |" in text
    rows = report["programs"]["convergence_loop"]
    hot = [r for r in rows if r["location"] == "hot-loop"]
    assert hot and all(r["kind"] == "all-reduce" for r in hot)
    assert report["violations"] == {"hot_loop_non_reduce": [], "unconditional_cn_anywhere": []}
    assert any(r["location"] == "prologue" and r["kind"] == "all-gather"
               and r["label"] == "edge masks" for r in rows)
    assert {r["label"] for r in rows if r["location"] == "hot-loop-cond"} >= {
        "ring permutations", "edge masks"}
    assert all(not r["unknown_dtypes"] for r in rows)
    assert report["facts"]["convergence_loop"]["resolved"]
    assert report["facts"]["engine_step"]["decided"]
    assert set(report["not_carried_over"]) == {"donation", "memory", "parameter_dtype_bytes",
                                               "cost"}
    assert all(r["groups"] == [[0, 1]] for r in rows)
    assert not torch.distributed.is_initialized()  # the ranks ran in their own processes
