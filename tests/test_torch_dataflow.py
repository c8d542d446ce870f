"""The port's dataflow family (``rapid_tpu_torch/tools/analysis/
dataflow.py``) against the JAX package's live proofs
(``tools/analysis/dataflow.py``).

- The proofs: observer silence and tenant isolation hold over every traced
  entry point of the port, and JAX's own ``observer_effect_findings`` /
  ``cross_tenant_findings`` hold over the same names on its live trace.
- The relation: for ``step``, ``step_telem`` and ``fleet3d_step`` every
  data edge of the port's relation is an edge of JAX's live relation, so
  no edge that JAX's whole-program proof rules out appears in the port.
- The tracer: per-storage carries, views and in-place operators fabricate
  no edge; a host read becomes a control edge, kept apart from data.
- The lock: the committed ``dataflow.lock.json`` matches the live trace
  and round-trips byte for byte; drift is reported per block; the map's
  totals equal the cost lock's quiescent round and keep the coverage
  floor; the corpus probes give their findings.

JAX's committed ``dataflow.lock.json`` is not used: its opportunity map's
byte total drifts with the XLA release, which the JAX tests report.
"""

from __future__ import annotations

import ast
import json
import re
import sys
from pathlib import Path
from typing import NamedTuple

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

from rapid_tpu_torch.tools.analysis import (  # noqa: E402
    core,
    cost_model,
    dataflow,
    device_program,
)

TORCH_CORPUS = REPO / "tests" / "data" / "torch_lint_corpus"
_EXPECT_RE = re.compile(r"#\s*expect:\s*([a-z][a-z-]*)")


def _registry_trees():
    return [(ast.parse(""), src) for src in device_program.REGISTRY_SOURCES]


@pytest.fixture(scope="module")
def port():
    return dataflow.collect_dataflow()


@pytest.fixture(scope="module")
def jax_live():
    """JAX's live trace of its registry and the meshless fleet step: per
    name the influence relation and its two proofs' findings."""
    from analysis import dataflow as jdf
    from analysis import device_program as jdp

    registry = jdf._registry_with_fleet()
    out = {}
    for name in sorted(registry):
        entry = jdf._trace_entry(name, registry[name])
        labels = entry["in_labels"]
        taints = jdf._taint_closed(entry["closed"], [frozenset([i]) for i in range(len(labels))])
        relation = {out_label: sorted(labels[i] for i in taint)
                    for out_label, taint in zip(entry["out_labels"], taints)}
        findings = jdf.observer_effect_findings(entry, taints, ("jax", 1))
        if name.startswith("fleet"):
            axes_in = jdf._tenant_in_axes(entry, registry[name], jdp.AUDIT_TENANTS)
            fallbacks = []
            axes = jdf._axis_closed(entry["closed"], axes_in, jdp.AUDIT_TENANTS, fallbacks)
            findings += jdf.cross_tenant_findings(entry, axes, fallbacks, ("jax", 1))
        out[name] = {"relation": relation, "findings": findings}
    return out


# ---------------------------------------------------------------------------
# The proofs, in both packages
# ---------------------------------------------------------------------------


def test_port_proofs_hold_over_every_traced_entry_point(port):
    payload, findings = port
    assert findings == [], "\n".join(str(f) for f in findings)
    assert set(payload["entrypoints"]) == set(device_program.registry("cpu")) | {"fleet_step"}
    for name, entry in payload["entrypoints"].items():
        assert entry["observer_silent"] is True, name
    assert set(payload["tenant_isolation"]) == set(dataflow.FLEET_ENTRYPOINTS)
    for name, proof in payload["tenant_isolation"].items():
        assert proof == {"proven": True, "mixed_outputs": [], "axis_rule_fallbacks": []}, name


def test_jax_live_proofs_hold_over_the_same_names(port, jax_live):
    payload, _ = port
    assert set(jax_live) == set(payload["entrypoints"])
    for name, live in jax_live.items():
        assert live["findings"] == [], (name, live["findings"])


@pytest.mark.parametrize("name", ["step", "step_telem", "fleet3d_step"])
def test_port_data_edges_are_edges_of_jaxs_relation(port, jax_live, name):
    payload, _ = port
    mine = payload["entrypoints"][name]["data"]
    theirs = jax_live[name]["relation"]
    shared = set(mine) & set(theirs)
    assert {label for label in mine if "." in label} <= set(theirs)
    assert shared
    in_universe = {src for sources in theirs.values() for src in sources}
    for out_label in sorted(shared):
        extra = set(mine[out_label]) & in_universe - set(theirs[out_label])
        assert not extra, (out_label, sorted(extra))


def test_observer_lanes_reach_no_subject_lane_by_data_or_control(port):
    payload, _ = port
    for name, entry in payload["entrypoints"].items():
        for kind in ("data", "control"):
            for out_label, sources in entry[kind].items():
                if out_label.startswith(("state.", "events.")):
                    assert not [s for s in sources if s.startswith(("telem.", "trace."))], (
                        name, kind, out_label)


# ---------------------------------------------------------------------------
# The tracer on small calls
# ---------------------------------------------------------------------------


class EngineState(NamedTuple):
    alive: torch.Tensor
    cuts: torch.Tensor
    epoch: torch.Tensor


def _state():
    return EngineState(torch.ones(8, dtype=torch.bool), torch.zeros(8, dtype=torch.int32),
                       torch.zeros(8, dtype=torch.int32))


def _relation(call, state):
    trace = dataflow.trace_call({"call": lambda: call(state), "inputs": {"state": state}})
    return trace["data"], trace["control"]


def test_in_place_lanes_keep_their_own_slot():
    def call(s):
        s.cuts.add_(1)
        s.epoch.mul_(2)
        return EngineState(s.alive, s.cuts, s.epoch)

    data, control = _relation(call, _state())
    assert data == {"state.alive": ["state.alive"], "state.cuts": ["state.cuts"],
                    "state.epoch": ["state.epoch"]}
    assert all(not v for v in control.values())


def test_in_place_write_through_a_view_is_an_edge_and_only_that():
    def call(s):
        s.cuts.view(2, 4)[0].add_(s.epoch[:4].view(4))
        return EngineState(s.alive, s.cuts, s.epoch)

    data, _ = _relation(call, _state())
    assert data["state.cuts"] == ["state.cuts", "state.epoch"]
    assert data["state.epoch"] == ["state.epoch"]
    assert data["state.alive"] == ["state.alive"]


def test_reused_storage_does_not_carry_an_old_taint():
    def call(s):
        for _ in range(4):  # temporaries freed and their memory reused
            scratch = s.cuts * 3
            del scratch
        fresh = s.epoch + 1
        return EngineState(s.alive, s.cuts.clone(), fresh)

    data, _ = _relation(call, _state())
    assert data["state.epoch"] == ["state.epoch"]
    assert data["state.cuts"] == ["state.cuts"]


def test_a_host_branch_is_a_control_edge():
    from rapid_tpu_torch import _host

    def call(s):
        cuts = s.cuts
        if _host.read(s.alive.any(), "branch_point"):
            cuts = cuts + 1
        return EngineState(s.alive, cuts, s.epoch + 0)

    data, control = _relation(call, _state())
    assert data["state.cuts"] == ["state.cuts"]
    assert control["state.cuts"] == ["state.alive"]
    assert control["state.epoch"] == ["state.alive"]


def test_the_delivery_kernel_is_one_opaque_node():
    from rapid_tpu_torch.models import virtual_cluster

    spec = device_program.registry("cpu")["step"]()
    seen = []
    real = virtual_cluster.delivery_new_bits

    def spy(*args, **kwargs):
        seen.append(kwargs.get("lanes"))
        return real(*args, **kwargs)

    virtual_cluster.delivery_new_bits = spy
    try:
        trace = dataflow.trace_call(spec, record=True)
    finally:
        virtual_cluster.delivery_new_bits = real
    records = trace["tracer"].records
    assert [r["op"] for r in records if r.get("opaque")] == ["delivery_new_bits"]
    assert seen == [128]
    # Its operators are counted (the cost lock counts them) but not traced.
    assert trace["aten_ops"] > len(records)
    assert not [r for r in records if "delivery_new_bits_ref" in r["source"]]
    assert trace["data"]["state.report_bits"]


# ---------------------------------------------------------------------------
# The opportunity map and the lock
# ---------------------------------------------------------------------------


def test_opportunity_map_prices_the_cost_locks_quiescent_round(port):
    payload, _ = port
    opp = payload["opportunity_map"]
    locked = json.loads((core.REPO / cost_model.COST_LOCK_REL).read_text())
    quiet = locked["quiescent_round_cost"][dataflow.OPPORTUNITY_ENTRYPOINT]
    assert opp["total_aten_ops"] == quiet["aten_ops"]
    assert opp["total_bytes_touched"] == quiet["bytes_touched"]
    assert opp["claimed_aten_ops"] == sum(b["aten_ops"] for b in opp["dense_gated"])
    for bucket in opp["dense_gated"]:
        assert bucket["gated_by"]
        assert bucket["source"].startswith("rapid_tpu_torch/") and "/tools/" not in bucket["source"]
    floor = json.loads((core.REPO / dataflow.DATAFLOW_LOCK_REL).read_text())["coverage_floor_pct"]
    assert floor == dataflow.coverage_floor(opp["coverage_pct"])


def test_coverage_floor_and_two_lock_totals_are_enforced():
    opp = {"total_aten_ops": 100, "total_bytes_touched": 1000,
           "coverage_pct": {"aten_ops": 3.0, "bytes_touched": 1.0}}
    findings = dataflow.coverage_findings(
        opp, {"aten_ops": 5, "bytes_touched": 0}, {"aten_ops": 99, "bytes_touched": 1000},
        "the cost lock's", ("probe", 1))
    messages = [f.message for f in findings]
    assert all(f.check == "dataflow-dense-op" for f in findings) and len(findings) == 2
    assert any("total_aten_ops (100) does not match" in m for m in messages)
    assert any("floor 5%" in m for m in messages)


def test_carry_only_lanes_reconcile_with_the_deadcode_collector(port):
    payload, findings = port
    referenced = dataflow._tree_reference_names()
    for lane in payload["carry_only_lanes"]:
        assert dataflow._field_of(lane) in referenced, lane
    assert not [f for f in findings if f.check == "dataflow-dead-lane"]


def test_committed_lock_matches_the_live_trace(port):
    assert dataflow.check_dataflow_lock(_registry_trees()) == []


def test_update_dataflow_lock_round_trips_byte_for_byte(port, tmp_path, monkeypatch, capsys):
    committed = (core.REPO / dataflow.DATAFLOW_LOCK_REL).read_text()
    target = tmp_path / "dataflow.lock.json"
    monkeypatch.setattr(dataflow, "DATAFLOW_LOCK_REL", str(target))
    assert core.main(["--update-dataflow-lock"]) == 0
    assert "wrote" in capsys.readouterr().out
    assert target.read_text() == committed


def test_lock_drift_is_reported_per_block(port, tmp_path, monkeypatch):
    tampered = json.loads((core.REPO / dataflow.DATAFLOW_LOCK_REL).read_text())
    tampered["carry_only_lanes"] = ["state.no_such_lane"]
    target = tmp_path / "dataflow.lock.json"
    target.write_text(json.dumps(tampered, indent=2, sort_keys=True) + "\n")
    monkeypatch.setattr(dataflow, "DATAFLOW_LOCK_REL", str(target))
    findings = dataflow.check_dataflow_lock(_registry_trees())
    assert [f.check for f in findings] == ["dataflow-lock-drift"]
    assert "carry_only_lanes" in findings[0].message


def test_update_refuses_while_any_proof_fails(tmp_path, monkeypatch):
    leak = core.Finding(dataflow.DATAFLOW_LOCK_REL, 1, "dataflow-observer-effect",
                        "observer lane telem.tl_enq influences subject lane state.cuts")
    monkeypatch.setattr(dataflow, "collect_dataflow", lambda *a, **kw: (
        {"opportunity_map": {}, "torch_release": "0.0"}, [leak]))
    monkeypatch.setattr(dataflow, "_cost_quiescent", lambda release: (None, "the live"))
    target = tmp_path / "dataflow.lock.json"
    monkeypatch.setattr(dataflow, "DATAFLOW_LOCK_REL", str(target))
    findings, path = dataflow.update_dataflow_lock()
    assert path is None and not target.exists()
    assert [f.check for f in findings] == ["dataflow-observer-effect"]
    assert findings[0].message.startswith("refusing to freeze: ")


def test_presence_gate_skips_retargeted_trees():
    assert dataflow.check_dataflow_lock([(ast.parse(""), "some/other/module.py")]) == []


# ---------------------------------------------------------------------------
# Corpus mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["dataflow_observer_leak.py", "clean_dataflow_observer_leak.py"])
def test_corpus_probes_give_their_findings(name):
    path = TORCH_CORPUS / name
    want = sorted((m.group(1), i) for i, line in enumerate(path.read_text().splitlines(), 1)
                  if (m := _EXPECT_RE.search(line)))
    findings = dataflow.check_dataflow(core.REPO / "rapid_tpu_torch/models/_corpus.py",
                                       source=path.read_text())
    assert sorted((f.check, f.lineno) for f in findings) == want


def test_corpus_mode_skips_files_without_the_marker(tmp_path):
    probe = tmp_path / "plain.py"
    probe.write_text("X = 1\n")
    assert dataflow.check_dataflow(probe) == []


def test_corpus_mode_reports_a_broken_probe_as_a_finding(tmp_path):
    probe = tmp_path / "broken_probe.py"
    probe.write_text("DATAFLOW_AUDIT_PROGRAMS = {}\nraise RuntimeError('boom')\n")
    findings = dataflow.check_dataflow(probe)
    assert [f.check for f in findings] == ["dataflow-lock-drift"]
    assert "failed to execute" in findings[0].message


def test_dataflow_checks_are_registered_and_selectable():
    new = {"dataflow-observer-effect", "dataflow-cross-tenant", "dataflow-dense-op",
           "dataflow-dead-lane", "dataflow-lock-drift"}
    assert new <= set(core.ALL_CHECK_NAMES)
    assert any(name == "dataflow" for name, _ in core.FAMILIES)
