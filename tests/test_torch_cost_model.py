"""The port's cost-model family (``rapid_tpu_torch/tools/analysis/
cost_model.py``) against the JAX package's (``tools/analysis/cost_model.py``).

- The fitter: every synthetic series of the JAX tests goes through both
  fitters to the same class, leading coefficient and residual (or the same
  refusal).
- The ladder: the port's fitted class of ``lane_bytes`` equals the class of
  JAX's committed ``argument_bytes`` for every ladder entry; the op count
  stays O(1) along N; the base point is the program facts'; the locked
  model predicts the lane bytes of a cluster off the ladder.
- The lock: the committed ``cost.lock.json`` matches the live ladder and
  round-trips byte for byte; an injected regression, a superlinear fact,
  an unexplained step and quiescent drift are each named; a change of
  torch release leaves the release-bound facts out.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

from analysis import cost_model as jax_cost  # noqa: E402

from rapid_tpu_torch.tools.analysis import core, cost_model, device_program  # noqa: E402


def _mix(n, k):
    return 108.0 + 253.0 * n + 38.0 * n * k


#: The series of the JAX package's tests/test_cost_model.py (its fitter
#: and refusal cases), with their tolerance.
SERIES = {
    "constant": ([((n, 4), 10.0) for n in (64, 128, 256, 512)], 0.02),
    "all_zero": ([((n, 4), 0.0) for n in (64, 128, 256, 512)], 0.02),
    "logarithmic": ([((64, 4), 12.0), ((128, 4), 14.0), ((256, 4), 16.0), ((512, 4), 18.0)],
                    0.02),
    "affine": ([((64, 4), 300.0), ((128, 4), 492.0), ((256, 4), 876.0), ((512, 4), 1644.0)],
               0.02),
    "nk_mixture_k_varies": ([((n, 4), _mix(n, 4)) for n in (64, 128, 256, 512)]
                            + [((256, k), _mix(256, k)) for k in (2, 8)], 0.02),
    "nk_mixture_k_fixed": ([((n, 4), _mix(n, 4)) for n in (64, 128, 256, 512)], 0.02),
    "quadratic": ([((8, 4), 32.0), ((16, 4), 128.0), ((32, 4), 512.0), ((64, 4), 2048.0)], 0.02),
    "short_ladder": ([((64, 4), 1.0), ((512, 4), 8.0)], 0.02),
    "noisy": ([((64, 4), 100.0), ((128, 4), 900.0), ((256, 4), 150.0), ((512, 4), 4000.0)],
              0.02),
    "dtype_step": ([((8, 4), 8.0), ((16, 4), 16.0), ((32, 4), 64.0), ((64, 4), 128.0)], 0.02),
    "exactly_determined_quadratic": ([((8, 4), 70.0), ((16, 4), 270.0), ((32, 4), 1060.0)],
                                     0.02),
}


@pytest.mark.parametrize("name", sorted(SERIES))
def test_fitter_agrees_with_jax_on_every_series(name):
    points, tol = SERIES[name]
    port, jax = cost_model.fit_scaling(points, tol), jax_cost.fit_scaling(points, tol)
    if "error" in jax:
        assert port == jax
        return
    assert (port["class"], port["coeff"], port["residual"]) == (
        jax["class"], jax["coeff"], jax["residual"])
    k_varies = len({k for (_n, k), _ in points}) > 1
    for (n, k), value in points:
        assert cost_model.predict(port["class"], port["coeffs"], n, k, k_varies) == \
            pytest.approx(value, rel=tol, abs=1.0)


def test_ladder_geometry_and_vocabulary_are_jaxs():
    assert cost_model.CLASSES == jax_cost.CLASSES
    assert cost_model.MIN_LADDER_POINTS == jax_cost.MIN_LADDER_POINTS
    assert (cost_model.N_LADDER, cost_model.K_LADDER, cost_model.TENANT_LADDER) == (
        jax_cost.N_LADDER, jax_cost.K_LADDER, jax_cost.TENANT_LADDER)
    assert cost_model.FLEET_TENANT_N == jax_cost.FLEET_TENANT_N
    assert cost_model.COST_REGISTRY == jax_cost.COST_REGISTRY
    for name in cost_model.COST_REGISTRY:
        assert cost_model.ladder_points(name) == jax_cost.ladder_points(name)


# ---------------------------------------------------------------------------
# The ladder (one collection per process)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ladder():
    table = cost_model.collect_ladder()
    fits, refusals = cost_model.fit_ladder(table)
    return table, fits, refusals


@pytest.fixture(scope="module")
def jax_lock():
    return json.loads((REPO / "tools" / "analysis" / "cost.lock.json").read_text())


@pytest.mark.parametrize("name", sorted(cost_model.COST_REGISTRY))
def test_lane_bytes_class_equals_jaxs_argument_bytes_class(ladder, jax_lock, name):
    _table, fits, refusals = ladder
    assert refusals == []
    locked = jax_lock["entrypoints"][name]["facts"]["argument_bytes"]
    assert fits[name]["lane_bytes"]["class"] == locked["class"]


def test_no_entry_point_grows_its_ops_or_reads_with_n(ladder):
    _table, fits, _ = ladder
    for name, per in fits.items():
        for fact in ("aten_ops", "host_reads", "host_uploads", "delivery_calls"):
            assert per[fact]["class"] == "O(1)", (name, fact, per[fact])
        for fact, fit in per.items():
            assert cost_model.CLASS_RANK[fit["class"]] <= cost_model.CLASS_RANK["O(N*K)"]


def test_op_count_is_fitted_along_n_only(ladder):
    table, fits, _ = ladder
    ops = {pt["key"]: pt["facts"]["aten_ops"] for pt in table["step"]}
    # The host loops over the rings: more rings, more operators, at one N.
    assert ops["n256_k2"] < ops["n256_k4"] < ops["n256_k8"]
    assert set(fits["step"]["aten_ops"]["points"]) == {"n64_k4", "n128_k4", "n256_k4", "n512_k4"}


def test_base_point_is_the_program_facts_entry(ladder):
    table, _fits, _ = ladder
    facts = device_program.collect_facts()
    for name, series in table.items():
        base = [pt for pt in series if pt["key"] == "n256_k4"]
        if name in facts and base:
            assert base[0]["facts"] == cost_model.entry_cost_facts(facts[name])


def test_locked_model_predicts_lane_bytes_off_the_ladder():
    from rapid_tpu_torch.models.state import pytree_nbytes

    locked = json.loads((core.REPO / cost_model.COST_LOCK_REL).read_text())
    fit = locked["entrypoints"]["step"]["facts"]["lane_bytes"]
    vc = device_program.audit_cluster("cpu", churn=False, n=4_096)
    want = pytree_nbytes(vc.state) + pytree_nbytes(vc.faults)
    got = cost_model.predict(fit["class"], fit["coeffs"], 4_096, device_program.AUDIT_K, True)
    assert got == pytest.approx(want, rel=cost_model.FACT_TOLERANCES["lane_bytes"])


def test_committed_lock_matches_the_live_ladder(ladder):
    locked = json.loads((core.REPO / cost_model.COST_LOCK_REL).read_text())
    assert cost_model.check_lock_against(locked, "cpu") == []
    assert set(locked["entrypoints"]) == set(cost_model.COST_REGISTRY)
    assert set(locked["quiescent_round_cost"]) == set(cost_model.QUIESCENT_ENTRYPOINTS)
    assert locked["quiescent_round_cost"]["step"]["collective_payload_bytes"] == 0
    assert locked["quiescent_round_cost"]["sharded_step"]["hot_loop_payload_bytes"] == 0


def test_update_cost_lock_round_trips_byte_for_byte(ladder, tmp_path, monkeypatch, capsys):
    committed = (core.REPO / cost_model.COST_LOCK_REL).read_bytes()
    target = tmp_path / "cost.lock.json"
    monkeypatch.setattr(cost_model, "COST_LOCK_REL", str(target))
    assert core.main(["--update-cost-lock"]) == 0
    assert "wrote" in capsys.readouterr().out
    assert target.read_bytes() == committed


def test_other_torch_release_compares_the_exact_facts_only(ladder, monkeypatch):
    locked = json.loads((core.REPO / cost_model.COST_LOCK_REL).read_text())
    tampered = json.loads(json.dumps(locked))
    tampered["torch_release"] = "0.0"
    tampered["entrypoints"]["step"]["facts"]["aten_ops"]["class"] = "O(N^2)"
    tampered["quiescent_round_cost"]["step"]["aten_ops"] += 1000
    assert cost_model.check_lock_against(tampered, "cpu") == []
    tampered["entrypoints"]["step"]["facts"]["lane_bytes"]["points"]["n64_k4"] += 1
    findings = cost_model.check_lock_against(tampered, "cpu")
    assert [f.check for f in findings] == ["cost-lock-drift"]
    assert "lane_bytes at ladder point n64_k4" in findings[0].message


# ---------------------------------------------------------------------------
# Findings by name, on synthetic tables (no ladder)
# ---------------------------------------------------------------------------


def _table(values, fact="lane_bytes"):
    return {"step": [{"key": f"n{n}_k4", "n_eff": n, "k": 4,
                      "facts": {fact: v, "host_reads": 2.0}} for n, v in values]}


_LINEAR = [(64, 16300.0), (128, 32492.0), (256, 64876.0), (512, 129644.0)]
_QUADRATIC = [(64, 16384.0), (128, 65536.0), (256, 262144.0), (512, 1048576.0)]
_QUIET = {"step": {"aten_ops": 614, "bytes_touched": 6740715, "host_reads": 2,
                   "collective_payload_bytes": 0, "hot_loop_payload_bytes": 0}}


@pytest.fixture
def synthetic(monkeypatch, tmp_path):
    def install(table):
        monkeypatch.setattr(cost_model, "collect_ladder", lambda *a, **kw: table)
        monkeypatch.setattr(cost_model, "collect_quiescent_cost", lambda *a, **kw: _QUIET)
        monkeypatch.setattr(device_program, "compaction_differential_ok", lambda: None)
        monkeypatch.setattr(device_program, "trace_differential_ok", lambda: None)
        target = tmp_path / "cost.lock.json"
        monkeypatch.setattr(cost_model, "COST_LOCK_REL", str(target))
        return target
    return install


def test_injected_regression_names_both_classes(synthetic, monkeypatch):
    target = synthetic(_table(_LINEAR))
    assert cost_model.update_cost_lock()[0] == []
    locked = json.loads(target.read_text())
    monkeypatch.setitem(cost_model.COST_CEILINGS, "step", "O(N^2)")
    fits, refusals = cost_model.fit_ladder(_table(_QUADRATIC))
    assert refusals == []
    findings = cost_model.compare_cost_lock(fits, _QUIET, locked, str(target))
    regressions = [f for f in findings if f.check == "cost-scaling-regression"]
    assert len(regressions) == 1
    message = regressions[0].message
    assert "step" in message and "lane_bytes" in message and "WORSENED" in message
    assert "O(N)" in message and "O(N^2)" in message


def test_superlinear_fact_is_refused_by_name(synthetic):
    target = synthetic(_table(_QUADRATIC))
    findings, path = cost_model.update_cost_lock()
    assert path is None and not target.exists()
    assert [f.check for f in findings] == ["cost-superlinear"]
    assert "step" in findings[0].message and "lane_bytes" in findings[0].message
    assert "O(N^2)" in findings[0].message and "O(N*K)" in findings[0].message


def test_unexplained_step_is_refused_by_name(synthetic):
    target = synthetic(_table([(8, 8.0), (16, 16.0), (32, 64.0), (64, 128.0)]))
    findings, path = cost_model.update_cost_lock()
    assert path is None and not target.exists()
    assert [f.check for f in findings] == ["cost-unexplained"]
    assert "step" in findings[0].message and "lane_bytes" in findings[0].message


def test_quiescent_drift_is_named(synthetic):
    target = synthetic(_table(_LINEAR))
    assert cost_model.update_cost_lock()[0] == []
    locked = json.loads(target.read_text())["quiescent_round_cost"]
    moved = {"step": dict(_QUIET["step"], host_reads=3)}
    findings = cost_model.compare_quiescent(moved, locked, str(target))
    assert [f.check for f in findings] == ["cost-quiescent"]
    assert "host_reads" in findings[0].message
    near = {"step": dict(_QUIET["step"], aten_ops=650)}
    assert cost_model.compare_quiescent(near, locked, str(target)) == []
    far = {"step": dict(_QUIET["step"], aten_ops=900)}
    assert [f.check for f in cost_model.compare_quiescent(far, locked, str(target))] == [
        "cost-quiescent"]
    assert cost_model.compare_quiescent(far, locked, str(target), release=False) == []


def test_cost_checks_are_registered_and_selectable():
    new = {"cost-unexplained", "cost-scaling-regression", "cost-superlinear",
           "cost-quiescent", "cost-lock-drift"}
    assert new <= set(core.ALL_CHECK_NAMES)
    assert any(name == "cost_model" for name, _ in core.FAMILIES)
