"""The port's static gate (``rapid_tpu_torch/tools/analysis``) against the
JAX package's (``tools/analysis``), and over the port's own tree.

- The JAX seeded corpus (``tests/data/lint_corpus/``, read as data): for
  every corpus file of a family both packages share, the port's checker at
  the pretend path under ``rapid_tpu_torch/`` gives the file's embedded
  ``# expect:`` findings, and the same (check, line) pairs as JAX's checker
  at its own pretend path.
- The torch corpus (``tests/data/torch_lint_corpus/``): one defect file and
  one clean twin per torch check of the ``sharding`` and ``sync_safety``
  families, each giving exactly its expectations.
- The port's tree is finding-free under a CPU-time budget; a missing root
  fails loudly and a syntax error is a finding.
- ``program.lock.json`` round-trips byte for byte, a tampered lock fails
  naming the entry point and the delta, and two collections of the facts
  are equal.
- The committed hot set equals the names JAX jits in the counterpart
  modules (read through JAX's syntax tree); the port's ``wire.lock.json``
  equals JAX's; the narrowed-lane mirror equals the state's.
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import staticcheck as jax_staticcheck  # noqa: E402

from rapid_tpu_torch.tools.analysis import (  # noqa: E402
    core,
    cost_model,
    dataflow,
    device_program,
    sharding,
    sync_safety,
)

JAX_CORPUS = REPO / "tests" / "data" / "lint_corpus"
TORCH_CORPUS = REPO / "tests" / "data" / "torch_lint_corpus"
_EXPECT_RE = re.compile(r"#\s*expect:\s*([a-z][a-z-]*)")

#: JAX corpus file -> (JAX pretend path, checker name) for the families
#: both packages share. The port's pretend path is the same file under
#: ``rapid_tpu_torch/``. The JAX-only corpus files (trace_safety, the
#: compiled-program, cost-model and dataflow families, and the sharding
#: family's jit checks) have no torch meaning.
SHARED_CORPUS = {
    "unguarded_mutation.py": ("rapid_tpu/protocol/_corpus.py", "check_concurrency"),
    "interleaving_hazard.py": ("rapid_tpu/protocol/_corpus.py", "check_concurrency"),
    "lock_reentrancy.py": ("rapid_tpu/protocol/_corpus.py", "check_concurrency"),
    "clean_concurrency.py": ("rapid_tpu/protocol/_corpus.py", "check_concurrency"),
    "missing_decode_arm.py": ("rapid_tpu/messaging/_corpus.py", "check_wire_schema"),
    "tag_reuse.py": ("rapid_tpu/messaging/_corpus.py", "check_wire_schema"),
    "field_number_drift.py": ("rapid_tpu/interop/_corpus.py", "check_wire_schema"),
    "clean_wire_schema.py": ("rapid_tpu/messaging/_corpus.py", "check_wire_schema"),
    "unreachable_dispatch_arm.py": ("rapid_tpu/protocol/_corpus.py", "check_dispatch"),
    "shadowed_arm.py": ("rapid_tpu/protocol/_corpus.py", "check_dispatch"),
    "clean_dispatch.py": ("rapid_tpu/protocol/_corpus.py", "check_dispatch"),
    "leaked_task.py": ("rapid_tpu/messaging/_corpus.py", "check_taskflow"),
    "swallowed_exception.py": ("rapid_tpu/messaging/_corpus.py", "check_taskflow"),
    "cancellation_swallow.py": ("rapid_tpu/messaging/_corpus.py", "check_taskflow"),
    "unawaited_coroutine.py": ("rapid_tpu/messaging/_corpus.py", "check_taskflow"),
    "clean_taskflow.py": ("rapid_tpu/messaging/_corpus.py", "check_taskflow"),
    "unseeded_random.py": ("rapid_tpu/messaging/_corpus.py", "check_determinism"),
    "clean_determinism.py": ("rapid_tpu/messaging/_corpus.py", "check_determinism"),
    "unseeded_backoff.py": ("rapid_tpu/serving/_corpus.py", "check_determinism"),
    "clean_backoff.py": ("rapid_tpu/serving/_corpus.py", "check_determinism"),
    "ledger_event_name.py": ("rapid_tpu/models/_corpus.py", "check_ledger"),
    "clean_ledger.py": ("rapid_tpu/models/_corpus.py", "check_ledger"),
    "missing_partition_spec.py": ("rapid_tpu/parallel/_corpus.py", "check_sharding"),
    "missing_partition_rule.py": ("rapid_tpu/parallel/_corpus.py", "check_sharding"),
    "tenant_partition_rule.py": ("rapid_tpu/tenancy/_corpus.py", "check_sharding"),
    "dtype_widening.py": ("rapid_tpu/models/_corpus.py", "check_sharding"),
    "clean_dtype_widening.py": ("rapid_tpu/models/_corpus.py", "check_sharding"),
    "clean_sharding.py": ("rapid_tpu/parallel/_corpus.py", "check_sharding"),
    "chaos_unknown_kind.py": ("rapid_tpu/sim/_corpus.py", "check_chaosvocab"),
    "clean_chaosvocab.py": ("rapid_tpu/sim/_corpus.py", "check_chaosvocab"),
    "telemetry_unmarked_fetch.py": ("rapid_tpu/tenancy/_corpus.py", "check_telemetry"),
    "clean_telemetry.py": ("rapid_tpu/tenancy/_corpus.py", "check_telemetry"),
    "trace_unmarked_fetch.py": ("rapid_tpu/serving/_corpus.py", "check_telemetry"),
    "clean_trace_fetch.py": ("rapid_tpu/serving/_corpus.py", "check_telemetry"),
}

#: The port's checker module for each shared checker name.
_PORT_CHECKERS = {
    "check_concurrency": ("concurrency", "check_concurrency"),
    "check_wire_schema": ("wire_schema", "check_wire_schema"),
    "check_dispatch": ("dispatch", "check_dispatch"),
    "check_taskflow": ("taskflow", "check_taskflow"),
    "check_determinism": ("determinism", "check_determinism"),
    "check_ledger": ("ledger", "check_ledger"),
    "check_sharding": ("sharding", "check_sharding"),
    "check_chaosvocab": ("chaosvocab", "check_chaosvocab"),
    "check_telemetry": ("telemetry", "check_telemetry"),
}

#: Torch corpus file -> (pretend path, port check function).
TORCH_CORPUS_CHECKERS = {
    "host_sync_in_hot_path.py": ("rapid_tpu_torch/ops/_corpus.py", sharding.check_sharding),
    "clean_host_sync_in_hot_path.py": ("rapid_tpu_torch/ops/_corpus.py", sharding.check_sharding),
    "host_sync_in_stream.py": ("rapid_tpu_torch/serving/_corpus.py", sharding.check_sharding),
    "clean_host_sync_in_stream.py": ("rapid_tpu_torch/serving/_corpus.py", sharding.check_sharding),
    "torch_dtype_widening.py": ("rapid_tpu_torch/models/_corpus.py", sharding.check_sharding),
    "clean_torch_dtype_widening.py": ("rapid_tpu_torch/models/_corpus.py", sharding.check_sharding),
    "uncounted_host_read.py": ("rapid_tpu_torch/models/_corpus.py", sync_safety.check_sync_safety),
    "clean_uncounted_host_read.py": (
        "rapid_tpu_torch/models/_corpus.py", sync_safety.check_sync_safety),
    "index_store_sync.py": ("rapid_tpu_torch/models/_corpus.py", sync_safety.check_sync_safety),
    "clean_index_store_sync.py": (
        "rapid_tpu_torch/models/_corpus.py", sync_safety.check_sync_safety),
    "pageable_upload.py": ("rapid_tpu_torch/serving/_corpus.py", sync_safety.check_sync_safety),
    "clean_pageable_upload.py": (
        "rapid_tpu_torch/serving/_corpus.py", sync_safety.check_sync_safety),
    "implicit_device.py": ("rapid_tpu_torch/tenancy/_corpus.py", sync_safety.check_sync_safety),
    "clean_implicit_device.py": (
        "rapid_tpu_torch/tenancy/_corpus.py", sync_safety.check_sync_safety),
    "cost_scaling_regression.py": ("rapid_tpu_torch/models/_corpus.py", cost_model.check_cost_model),
    "clean_cost_scaling_regression.py": (
        "rapid_tpu_torch/models/_corpus.py", cost_model.check_cost_model),
    "dataflow_observer_leak.py": ("rapid_tpu_torch/models/_corpus.py", dataflow.check_dataflow),
    "clean_dataflow_observer_leak.py": (
        "rapid_tpu_torch/models/_corpus.py", dataflow.check_dataflow),
}

#: Each port hot-set file -> the JAX module it stands for.
HOT_SET_COUNTERPARTS = {
    "rapid_tpu_torch/models/virtual_cluster.py": "rapid_tpu/models/virtual_cluster.py",
    "rapid_tpu_torch/tenancy/fleet.py": "rapid_tpu/tenancy/fleet.py",
    "rapid_tpu_torch/ops/consensus.py": "rapid_tpu/ops/consensus.py",
    "rapid_tpu_torch/ops/cut_detection.py": "rapid_tpu/ops/cut_detection.py",
    "rapid_tpu_torch/ops/rings.py": "rapid_tpu/ops/rings.py",
    "rapid_tpu_torch/ops/kernels.py": "rapid_tpu/ops/pallas_kernels.py",
}


def _expected(path: Path):
    return sorted(
        (m.group(1), lineno)
        for lineno, line in enumerate(path.read_text().splitlines(), 1)
        if (m := _EXPECT_RE.search(line))
    )


def _port_checker(name: str):
    import importlib

    module, fn = _PORT_CHECKERS[name]
    return getattr(importlib.import_module(f"rapid_tpu_torch.tools.analysis.{module}"), fn)


# ---------------------------------------------------------------------------
# The corpus differential and the torch corpus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SHARED_CORPUS))
def test_shared_corpus_matches_expectations_and_jax(name):
    jax_rel, checker = SHARED_CORPUS[name]
    source = (JAX_CORPUS / name).read_text()
    port_rel = jax_rel.replace("rapid_tpu/", "rapid_tpu_torch/", 1)
    port = sorted(
        (f.check, f.lineno)
        for f in _port_checker(checker)(core.REPO / port_rel, source=source)
    )
    jax = sorted(
        (f.check, f.lineno)
        for f in getattr(jax_staticcheck, checker)(
            jax_staticcheck.core.REPO / jax_rel, source=source)
    )
    assert port == _expected(JAX_CORPUS / name) == jax


def test_torch_corpus_is_complete():
    on_disk = {p.name for p in TORCH_CORPUS.glob("*.py")}
    assert on_disk == set(TORCH_CORPUS_CHECKERS)
    defects = {n for n in on_disk if not n.startswith("clean_")}
    assert {f"clean_{n}" for n in defects} == on_disk - defects


@pytest.mark.parametrize("name", sorted(TORCH_CORPUS_CHECKERS))
def test_torch_corpus(name):
    rel, checker = TORCH_CORPUS_CHECKERS[name]
    findings = checker(core.REPO / rel, source=(TORCH_CORPUS / name).read_text())
    got = sorted((f.check, f.lineno) for f in findings)
    assert got == _expected(TORCH_CORPUS / name), "\n".join(str(f) for f in findings)


def test_each_torch_check_has_a_defect_file():
    checks = {check for name in TORCH_CORPUS_CHECKERS for check, _ in _expected(TORCH_CORPUS / name)}
    assert checks == {
        "host-sync-in-hot-path", "host-sync-in-stream", "dtype-widening",
        "uncounted-host-read", "index-store-sync", "pageable-upload", "implicit-device",
        "cost-scaling-regression", "cost-superlinear", "cost-unexplained",
        "dataflow-observer-effect", "dataflow-cross-tenant", "dataflow-dense-op",
    }


def test_corpora_are_excluded_from_tree_sweeps():
    swept = {str(p) for p in core.iter_files(("tests",))}
    assert not any("lint_corpus" in p for p in swept)


# ---------------------------------------------------------------------------
# The gate over the port's tree
# ---------------------------------------------------------------------------


def test_whole_port_tree_is_finding_free():
    # Every family runs, the program, cost and dataflow locks included;
    # their collections are warmed first, so the budget pins the ANALYSIS
    # cost (process CPU time, not wall clock: a loaded machine must not
    # fail the gate).
    device_program.collect_facts()
    cost_model.collect_ladder()
    cost_model.collect_quiescent_cost()
    dataflow.collect_dataflow()
    started = time.process_time()
    findings = core.run()
    elapsed = time.process_time() - started
    assert not findings, "\n".join(str(f) for f in findings)
    assert elapsed < 30.0, f"the port's tree sweep used {elapsed:.1f}s CPU (budget 30s)"


def test_default_roots_cover_the_port_and_its_tests():
    swept = {core.rel(p) for p in core.iter_files()}
    assert "chip_smoke.py" in swept and "mesh_smoke.py" in swept
    assert "rapid_tpu_torch/models/virtual_cluster.py" in swept
    assert "tests/test_torch_staticcheck.py" in swept
    assert not any(p.startswith("rapid_tpu/") for p in swept)
    assert not any(p.startswith("tests/test_") and not p.startswith("tests/test_torch_")
                   for p in swept)


def test_missing_root_fails_loudly():
    with pytest.raises(FileNotFoundError, match="no_such_root"):
        list(core.iter_files(["no_such_root"]))
    with pytest.raises(FileNotFoundError, match="matches nothing"):
        list(core.iter_files(["tests/test_no_such_*.py"]))


def test_syntax_error_is_a_finding_not_a_crash(tmp_path, monkeypatch):
    (tmp_path / "broken.py").write_text("def f(:\n    return 0\n")
    (tmp_path / "good.py").write_text("def g():\n    return mesage\n")
    monkeypatch.setattr(core, "REPO", tmp_path)
    monkeypatch.syspath_prepend(str(tmp_path))
    findings = core.run([str(tmp_path)])
    assert sorted(f.check for f in findings) == ["syntax-error", "undefined-name"]
    syntax = next(f for f in findings if f.check == "syntax-error")
    assert syntax.path.endswith("broken.py") and syntax.lineno == 1
    corpus = core.run([str(JAX_CORPUS / "syntax_error.py")])
    assert sorted((f.check, f.lineno) for f in corpus) == _expected(JAX_CORPUS / "syntax_error.py")


def test_optional_reference_imports_are_skipped_not_errors(tmp_path, monkeypatch):
    # A module that imports the JAX reference (or grpc) where it is not
    # installed is skipped like an importorskip; any other import failure
    # is a finding.
    from rapid_tpu_torch.tools.analysis import signatures

    (tmp_path / "needs_ref.py").write_text("import jax_ref_missing\n")
    (tmp_path / "broken_dep.py").write_text("import no_such_dependency_xyz\n")
    monkeypatch.setattr(core, "REPO", tmp_path)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(signatures, "OPTIONAL_IMPORTS", frozenset({"jax_ref_missing"}))
    assert signatures.check_call_signatures(tmp_path / "needs_ref.py") == []
    assert [f.check for f in signatures.check_call_signatures(tmp_path / "broken_dep.py")] == [
        "import-error"]


def test_test_modules_import_by_bare_name_as_pytest_imports_them():
    # tests/ is no package: its modules import by bare name (run() puts
    # tests/ on sys.path), so an installed top-level `tests` package cannot
    # shadow them; package files keep their dotted path.
    from rapid_tpu_torch.tools.analysis.signatures import _module_name_for

    assert _module_name_for(REPO / "tests" / "test_torch_lint.py") == "test_torch_lint"
    assert _module_name_for(REPO / "chip_smoke.py") == "chip_smoke"
    assert _module_name_for(
        REPO / "rapid_tpu_torch" / "tools" / "analysis" / "core.py"
    ) == "rapid_tpu_torch.tools.analysis.core"
    assert _module_name_for(REPO / "rapid_tpu_torch" / "__init__.py") == "rapid_tpu_torch"


def test_a_foreign_tests_package_is_rebound_to_the_repos(monkeypatch):
    # Some installations ship a top-level regular `tests` package, which
    # wins over the repo's namespace directory; the sweep binds `tests` to
    # the repo's test directory, as pytest's rootdir does.
    import types

    foreign = types.ModuleType("tests")
    foreign.__path__ = ["/nonexistent/site-packages/tests"]
    monkeypatch.setitem(sys.modules, "tests", foreign)
    core._bind_tests_package()
    assert list(sys.modules["tests"].__path__) == [str(REPO / "tests")]


def test_families_list_modules_2_to_15():
    names = [name for name, _ in core.FAMILIES]
    assert names == [
        "names", "signatures", "deadcode", "clocks", "concurrency", "taskflow",
        "determinism", "dispatch", "wire_schema", "ledger", "chaosvocab", "telemetry",
        "sharding", "sync_safety", "device_program", "cost_model", "dataflow",
    ]
    out = subprocess.run(
        [sys.executable, "-m", "rapid_tpu_torch.tools.staticcheck", "--families"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0
    assert [line.split()[0] for line in out.stdout.splitlines()] == names


def test_cli_select_ignore_and_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    return mesage\n")
    assert core.main(["--json", str(bad)]) == 1
    objs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(o["check"], o["lineno"]) for o in objs] == [("undefined-name", 2)]
    assert core.main(["--ignore", "undefined-name", str(bad)]) == 0
    assert capsys.readouterr().out.strip().endswith("staticcheck: 0 finding(s)")
    with pytest.raises(SystemExit) as exc:
        core.main(["--select", "no-such-check", str(bad)])
    assert exc.value.code == 2


def test_dead_definition_is_caught(tmp_path):
    from rapid_tpu_torch.tools.analysis.deadcode import check_dead_definitions

    (tmp_path / "mod_a.py").write_text(textwrap.dedent(
        """
        def used(): return 1
        def never_called(): return 2
        def lonely_recursive():
            return lonely_recursive()
        """
    ))
    (tmp_path / "mod_b.py").write_text("from mod_a import used\nprint(used())\n")
    trees = [(ast.parse(p.read_text()), p.name) for p in sorted(tmp_path.glob("*.py"))]
    assert sorted(f.message for f in check_dead_definitions(trees)) == [
        "module-level 'lonely_recursive' is referenced nowhere in the tree",
        "module-level 'never_called' is referenced nowhere in the tree",
    ]


# ---------------------------------------------------------------------------
# The torch checks' conservative resolution
# ---------------------------------------------------------------------------


def _sync(source: str, rel: str = "rapid_tpu_torch/models/_probe.py"):
    return sync_safety.check_sync_safety(core.REPO / rel, source=textwrap.dedent(source))


def test_host_copies_of_the_lanes_are_not_tensors():
    # tenant_health_report's shape: a lane tree mapped to numpy is read
    # with int() freely; the same read of the device tree is a finding.
    findings = _sync(
        """
        def report(fleet, np_of):
            s = map(np_of, fleet.state)
            host = int(s.n_members)
            dev = int(fleet.state.n_members)
            return host, dev
        """
    )
    assert [(f.check, f.lineno) for f in findings] == [("uncounted-host-read", 5)]


def test_sync_safety_gates_on_the_engine_prefixes():
    src = "def f(state):\n    return state.alive.cpu()\n"
    assert _sync(src, "rapid_tpu_torch/protocol/cluster.py") == []
    assert _sync(src, "rapid_tpu_torch/utils/_probe.py") == []
    assert [f.check for f in _sync(src, "rapid_tpu_torch/protocol/device_probe.py")] == [
        "uncounted-host-read"]


def test_pageable_upload_applies_to_stream_methods_only():
    src = textwrap.dedent(
        """
        import torch
        class VirtualCluster:
            def crash(self, arr):
                return torch.from_numpy(arr).to(self.device)
            def set_rx_block(self, arr):
                return torch.from_numpy(arr).to(self.device)
        """
    )
    findings = sync_safety.check_sync_safety(
        core.REPO / "rapid_tpu_torch/models/virtual_cluster.py", source=src)
    assert [(f.check, f.lineno) for f in findings] == [("pageable-upload", 5)]


def test_hot_set_covers_module_level_functions_only():
    src = textwrap.dedent(
        """
        from rapid_tpu_torch import _host
        def run_to_decision(state):
            return _host.read(state.n_members)
        class VirtualCluster:
            def run_to_decision(self):
                return _host.read(self.state.n_members)
        """
    )
    findings = sharding.check_sharding(
        core.REPO / "rapid_tpu_torch/models/virtual_cluster.py", source=src)
    assert [(f.check, f.lineno) for f in findings] == [("host-sync-in-hot-path", 4)]


# ---------------------------------------------------------------------------
# Mirrors held against the JAX package and the port's own modules
# ---------------------------------------------------------------------------


def test_hot_set_equals_the_names_jax_jits():
    from analysis.trace_safety import _import_aliases, _jitted_functions

    assert set(sharding.HOT_SET) == set(HOT_SET_COUNTERPARTS)
    for port_rel, jax_rel in HOT_SET_COUNTERPARTS.items():
        jax_tree = ast.parse((REPO / jax_rel).read_text())
        jitted = {
            fn.name for fn, _static in _jitted_functions(jax_tree, _import_aliases(jax_tree))
            if hasattr(fn, "name")
        }
        assert set(sharding.HOT_SET[port_rel]) == jitted, port_rel
        port_defs = {
            node.name for node in ast.parse((REPO / port_rel).read_text()).body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        for names in sharding.HOT_SET[port_rel].values():
            assert set(names) <= port_defs, (port_rel, names)


def test_wire_lock_equals_jax():
    from rapid_tpu_torch.tools.analysis import wire_schema

    # Both packages speak the same bytes: every frozen fact is equal (the
    # ``_comment`` names each package's own regenerate command).
    port = json.loads((REPO / wire_schema.LOCK_REL).read_text())
    jax = json.loads((REPO / "tools" / "analysis" / "wire.lock.json").read_text())
    assert port.pop("_comment") != jax.pop("_comment")
    assert port == jax


def test_wire_lock_round_trips(tmp_path, monkeypatch, capsys):
    from rapid_tpu_torch.tools.analysis import wire_schema

    committed = (REPO / wire_schema.LOCK_REL).read_text()
    target = tmp_path / "wire.lock.json"
    monkeypatch.setattr(wire_schema, "LOCK_REL", str(target))
    assert core.main(["--update-wire-lock"]) == 0
    assert "wrote" in capsys.readouterr().out
    assert target.read_text() == committed


def test_narrowed_lane_mirror_equals_the_state():
    from rapid_tpu_torch.models.state import NARROWABLE_LANES

    assert sharding.NARROWED_LANES == NARROWABLE_LANES


def test_shard_host_pytree_places_as_jax_twin_does():
    # The multi-host spelling of shard_pytree, in both packages; on a
    # one-rank group it places the audit cluster's state whole, lane for
    # lane equal to JAX's one-device placement.
    import jax

    from rapid_tpu.models.virtual_cluster import VirtualCluster as JaxCluster
    from rapid_tpu.parallel import mesh as jax_mesh
    from rapid_tpu.parallel import multihost as jax_multihost
    from rapid_tpu_torch.convert import state_to_numpy
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster
    from rapid_tpu_torch.parallel import mesh as pm
    from rapid_tpu_torch.parallel import multihost

    assert multihost.shard_host_pytree is pm.shard_pytree
    assert jax_multihost.shard_host_pytree is jax_mesh.shard_pytree
    jvc = JaxCluster.create(56, n_slots=64, k=3, h=3, l=1, cohorts=4, seed=5)
    jm = jax_mesh.make_mesh(jax.devices()[:1])
    jax_state = jax_multihost.shard_host_pytree(jvc.state, jax_mesh.state_shardings(jm))
    with device_program.one_rank_group("cpu"):
        pvc = VirtualCluster.create(56, n_slots=64, k=3, h=3, l=1, cohorts=4, seed=5, device="cpu")
        m = pm.make_mesh(device_type="cpu")
        port_state = pm.full_pytree(multihost.shard_host_pytree(pvc.state, pm.state_shardings(m), mesh=m))
    got = state_to_numpy(port_state)
    for field in jax_state._fields:
        want = np.asarray(getattr(jax_state, field))
        assert got[field].dtype == want.dtype, field
        np.testing.assert_array_equal(got[field], want, err_msg=field)


# ---------------------------------------------------------------------------
# The program lock
# ---------------------------------------------------------------------------


def test_program_lock_round_trips_byte_for_byte(tmp_path, monkeypatch, capsys):
    committed = (REPO / device_program.PROGRAM_LOCK_REL).read_text()
    target = tmp_path / "program.lock.json"
    monkeypatch.setattr(device_program, "PROGRAM_LOCK_REL", str(target))
    assert core.main(["--update-program-lock"]) == 0
    assert "wrote" in capsys.readouterr().out
    assert target.read_text() == committed


def test_program_lock_registers_jax_entry_points():
    lock = json.loads((REPO / device_program.PROGRAM_LOCK_REL).read_text())
    jax_lock = json.loads((REPO / "tools" / "analysis" / "hlo.lock.json").read_text())
    assert set(lock["entrypoints"]) == set(jax_lock["entrypoints"])
    assert len(lock["entrypoints"]) == 13
    audit = lock["audit_config"]
    jax_audit = jax_lock["audit_config"]
    assert (audit["n"], audit["c"], audit["k"], audit["tenants"]) == (
        jax_audit["n"], jax_audit["c"], jax_audit["k"], jax_audit["tenants"])
    assert audit["world_size"] == device_program.AUDIT_WORLD
    assert lock["telemetry"]["quiescent_round_activity"] == 0
    assert lock["trace"]["soak_cursor_delta"] == 0
    for name in ("fleet3d_step", "fleet3d_wave"):
        assert lock["entrypoints"][name]["cross_tenant_collectives"] == 0


def test_tampered_lock_fails_naming_the_entry_point_and_delta():
    lock = json.loads((REPO / device_program.PROGRAM_LOCK_REL).read_text())
    step = lock["entrypoints"]["step"]
    step["transfers"]["read"] += 1
    step["aten_ops"] = step["aten_ops"] // 2
    lock["entrypoints"]["sharded_wave"]["collectives"].pop("prologue/all-gather")
    lock["entrypoints"]["step_compact"]["memory"]["state_bytes"] += 4
    findings = device_program.check_lock_against(lock)
    by_check = {}
    for f in findings:
        by_check.setdefault(f.check, []).append(f.message)
    reads = lock["entrypoints"]["step"]["transfers"]["read"]
    assert any(f"step: host transfer read: {reads} -> {reads - 1}" in m
               for m in by_check["program-transfer-budget"])
    assert any(m.startswith("step: aten ops GREW") for m in by_check["program-op-budget"])
    assert any("sharded_wave: new collective all-gather in location prologue" in m
               for m in by_check["program-collective-budget"])
    assert any(m.startswith("step_compact: state_bytes") for m in by_check["program-memory-budget"])
    assert all("--update-program-lock" in m for ms in by_check.values() for m in ms)


def test_two_collections_of_the_facts_are_equal():
    first = device_program.collect_facts()
    second = device_program.collect_facts(force=True)
    assert first == second
    assert device_program.collect_telemetry_facts() == device_program.collect_telemetry_facts()


def test_device_independent_facts_leave_out_the_op_count():
    lock = json.loads((REPO / device_program.PROGRAM_LOCK_REL).read_text())
    for entry in lock["entrypoints"].values():
        kept = device_program.device_independent(entry)
        assert "aten_ops" not in kept
        assert set(kept) == set(entry) - {"aten_ops"}


def test_op_tolerance_allows_a_release_wobble_not_growth():
    assert device_program.within_tolerance(1000, 1090)
    assert not device_program.within_tolerance(1000, 1200)
    assert device_program.within_tolerance(20, 36)
    assert not device_program.within_tolerance(20, 37)


def test_regenerator_refuses_a_drifted_differential(monkeypatch, tmp_path):
    target = tmp_path / "program.lock.json"
    monkeypatch.setattr(device_program, "PROGRAM_LOCK_REL", str(target))
    monkeypatch.setattr(device_program, "compaction_differential_ok",
                        lambda: "wide<->compact differential disagrees on state lane 'alive'")
    findings, path = device_program.update_program_lock()
    assert path is None and not target.exists()
    assert any("'alive'" in f.message for f in findings)
