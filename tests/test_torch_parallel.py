"""The port's sharded engine (``rapid_tpu_torch/parallel``) against its
unsharded engine and the JAX package's sharded programs.

- The ported rule tables equal JAX's entry by entry, every lane is covered,
  and the placements on 1-D, 2-D and 3-D meshes are JAX's specs.
- Three gloo jobs (1, 2 and 4 spawned ranks, one ``tmp_path`` rendezvous
  file each; ``tests/torch_mesh_jobs.py``) drive every scenario through the
  sharded step, wave, join wave and telemetry / trace twins on 1-D,
  ``(2, 2)`` (``(1, 1)`` at one rank) and, for the fleet, ``(2, 1, 2)``
  meshes: each bit-identical to the unsharded port, one scenario per mesh
  shape also to JAX's sharded program on the test session's 8 CPU devices.
- The collective log holds the audit invariants, issues the same
  per-round sequence on every rank and at world sizes 1, 2 and 4, and no
  fleet collective spans the tenant axis.
- ``delivery_new_bits_ref`` on column and cohort slices with offsets,
  concatenated, is the whole call.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_mesh_jobs as jobs
from rapid_tpu.parallel import mesh as jmesh
from rapid_tpu.parallel import hlo_facts
from rapid_tpu.tenancy import fleet as jfleet
from rapid_tpu_torch import _u32
from rapid_tpu_torch.models.state import (
    EngineState,
    FaultInputs,
    TelemetryLanes,
    TraceRing,
)
from rapid_tpu_torch.ops.kernels import delivery_new_bits, delivery_new_bits_ref
from rapid_tpu_torch.parallel import collective_facts as facts
from rapid_tpu_torch.parallel import mesh as tmesh
from rapid_tpu_torch.tenancy import fleet as tfleet

SCENARIOS = sorted(jobs.SCENARIOS)
#: job -> (world, plan): (mesh shape, tasks) pairs.
JOBS = {
    "w1": (1, [(None, SCENARIOS), ((1, 1), SCENARIOS), ((1, 1, 1), ["fleet"])]),
    "w2": (2, [(None, SCENARIOS)]),
    "w4": (4, [(None, SCENARIOS + ["placements"]), ((2, 2), SCENARIOS + ["placements", "errors"]),
               ((2, 1, 2), ["fleet", "placements", "errors"])]),
}
CASES = [(job, shape, name) for job, (_, plan) in JOBS.items() for shape, names in plan
         for name in names if name in jobs.SCENARIOS or name == "fleet"]


def _jax_lanes(tree):
    return {f: np.asarray(x) for f, x in tree._asdict().items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every job's per-rank results, the unsharded references, and JAX's
    sharded runs (computed while the jobs run)."""
    started = {}
    for job, (world, plan) in JOBS.items():
        tmp = tmp_path_factory.mktemp(job)
        started[job] = (jobs.start_job(world, tmp, plan), world, tmp)
    refs = {name: jobs.reference(name) for name in SCENARIOS}
    refs["fleet"] = jobs.fleet_reference()
    jax_runs = _jax_sharded_runs()
    results = {job: jobs.finish_job(*args) for job, args in started.items()}
    return results, refs, jax_runs


def _jax_create(*args, **kwargs):
    from rapid_tpu.models.virtual_cluster import VirtualCluster

    return VirtualCluster.create(*args, **kwargs)


def _jax_sharded_runs():
    """One scenario per mesh shape through JAX's sharded programs: the
    1-D step drive of ``crash`` (4 devices), the ``(2, 2)`` wave of
    ``multi_cut``, and the ``(2, 1, 2)`` fleet step."""
    out = {}
    vc = jobs.build("crash", _jax_create)
    mesh = jmesh.make_mesh(jax.devices()[:4])
    step = jmesh.make_sharded_step(vc.cfg, mesh)
    state, faults = jmesh.shard_state(vc.state, mesh), jmesh.shard_faults(vc.faults, mesh)
    decided = []
    for _ in range(jobs.STEP_ROUNDS):
        state, events = step(state, faults)
        decided.append(bool(events.decided))
    out["crash"] = (decided, _jax_lanes(state))

    vc = jobs.build("multi_cut", _jax_create)
    mesh = jmesh.make_mesh(jax.devices()[:4], shape=(2, 2))
    wave = jmesh.make_sharded_wave(vc.cfg, mesh, max_cuts=8)
    state, steps, cuts, resolved, sizes = wave(
        jmesh.shard_state(vc.state, mesh), jmesh.shard_faults(vc.faults, mesh),
        jnp.int32(jobs.SCENARIOS["multi_cut"][4]), jnp.int32(192), jnp.int32(1),
    )
    out["multi_cut"] = ((int(steps), int(cuts), bool(resolved), tuple(np.asarray(sizes).tolist())),
                        _jax_lanes(state))

    clusters, _ = jobs.fleet_clusters(_jax_create)
    fleet = jfleet.TenantFleet.from_clusters(clusters)
    mesh = jmesh.make_mesh(jax.devices()[:4], shape=(2, 1, 2))
    step = jfleet.make_fleet_step(fleet.cfg, mesh)
    state = jmesh.shard_fleet_state(fleet.state, mesh)
    faults = jmesh.shard_fleet_faults(fleet.faults, mesh)
    knobs = jax.tree.map(lambda x, sh: jax.device_put(x, sh), fleet.knobs,
                         jfleet.knob_shardings(mesh))
    for _ in range(jobs.STEP_ROUNDS):
        state, _ = step(state, faults, knobs)
    out["fleet"] = _jax_lanes(state)
    return out


def _assert_lanes(got, want, what):
    assert set(got) == set(want), what
    for field, value in want.items():
        np.testing.assert_array_equal(got[field], value, err_msg=f"{what}: lane {field}")


# -- rule tables and placements ---------------------------------------------


def test_partition_rules_equal_jax_entry_by_entry():
    assert tmesh.PARTITION_RULES == jmesh.PARTITION_RULES
    assert tfleet.PARTITION_RULES == jfleet.PARTITION_RULES
    assert (tmesh.NODE_AXIS, tmesh.COHORT_AXIS, tmesh.TENANT_AXIS) == (
        jmesh.NODE_AXIS, jmesh.COHORT_AXIS, jmesh.TENANT_AXIS)


@pytest.mark.parametrize("cls", [EngineState, FaultInputs, TelemetryLanes, TraceRing])
def test_every_lane_is_covered_and_an_unknown_lane_raises(cls):
    specs = tmesh.match_partition_rules(tmesh.PARTITION_RULES, cls._fields)
    assert list(specs) == list(cls._fields)
    with pytest.raises(ValueError, match="no partition rule matches engine leaf 'mystery'"):
        tmesh.match_partition_rules(tmesh.PARTITION_RULES, (*cls._fields, "mystery"))


def _jax_specs(mesh):
    """JAX's placements as the jobs' specs: per array dimension its mesh
    axis (or None), trailing unmeshed dimensions made explicit."""
    vc = jobs.build("crash_trace", _jax_create)
    trees = {"state": vc.state, "faults": vc.faults, "telem": vc.telem, "trace": vc.trace_ring}
    fns = {"state": (jmesh.state_shardings, jmesh.fleet_state_shardings),
           "faults": (jmesh.fault_shardings, jmesh.fleet_fault_shardings),
           "telem": (jmesh.telemetry_shardings, jmesh.fleet_telemetry_shardings),
           "trace": (jmesh.trace_shardings, jmesh.fleet_trace_shardings)}

    def spec(sharding, ndim):
        return tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))

    out = {}
    for key, tree in trees.items():
        single, fleet = (fn(mesh) for fn in fns[key])
        out[key] = {f: spec(s, np.ndim(x)) for f, s, x in zip(tree._fields, single, tree)}
        out["fleet_" + key] = {f: spec(s, np.ndim(x) + 1)
                               for f, s, x in zip(tree._fields, fleet, tree)}
    out["knobs"] = {f: spec(s, 1) for f, s in jfleet.knob_shardings(mesh)._asdict().items()}
    return out


@pytest.mark.parametrize("shape", [None, (2, 2), (2, 1, 2)])
def test_placements_equal_jax_specs(run, shape):
    results, _, _ = run
    got = results["w4"][0][(shape, "placements")]
    want = _jax_specs(jmesh.make_mesh(jax.devices()[:4], shape=shape))
    assert got == want


def test_pad_to_multiple():
    assert tmesh.pad_to_multiple(50, 4) == jmesh.pad_to_multiple(50, 4) == 52
    assert tmesh.pad_to_multiple(52, 4) == 52
    assert tmesh.pad_to_multiple(0, 8) == 0
    with pytest.raises(ValueError):
        tmesh.pad_to_multiple(3, 0)


def test_sharding_errors_name_the_leaf_axis_and_fix(run):
    results, _, _ = run
    errors = results["w4"][0][((2, 2), "errors")]
    assert "EngineState.key_hi" in errors["slots"] and "does not divide mesh axis nodes" in errors["slots"]
    assert "pad_to_multiple(51, 2)" in errors["slots"]
    assert "EngineState.alive" in errors["packed"] and "(= 5)" in errors["packed"]
    assert "explicit mesh" in errors["no_mesh"]
    assert errors["padded_shape"] == (6, 52)
    tenants = results["w4"][0][((2, 1, 2), "errors")]["tenants"]
    assert "does not divide mesh axis tenant" in tenants and "pad_to_multiple(3, 2)" in tenants


# -- the sharded programs against the unsharded port and JAX ----------------


@pytest.mark.parametrize("job,shape,name", CASES)
def test_sharded_run_is_bit_identical_to_the_unsharded_port(run, job, shape, name):
    results, refs, _ = run
    ref = refs[name]
    for rank, per_rank in enumerate(results[job]):
        got = per_rank[(shape, name)]
        what = f"{job} {shape} {name} rank {rank}"
        if name == "fleet":
            _assert_lanes(got["fleet_step"], ref["fleet_step"], what + " step")
            _assert_lanes(got["fleet_wave"][0], ref["fleet_wave"][0], what + " wave")
            for a, b in zip(got["fleet_wave"][1], ref["fleet_wave"][1]):
                np.testing.assert_array_equal(a, b, err_msg=what)
            continue
        for part in ("state", "telem", "trace"):
            if ref[part] is not None:
                _assert_lanes(got[part], ref[part], f"{what} {part}")
        if "rounds" in ref:
            assert [r[:2] for r in got["rounds"]] == [r[:2] for r in ref["rounds"]], what
            for a, b in zip(got["rounds"], ref["rounds"]):
                np.testing.assert_array_equal(a[2], b[2], err_msg=what)
        else:
            assert got["wave"] == ref["wave"], what
            assert got["wave"][2], f"{what}: the wave did not resolve"


def test_scenarios_reach_every_gated_branch(run):
    """The grid is a parity case for the gated code: decisions in every
    step drive, the classic attempt, implicit invalidation and the view
    change's ring rebuild all issue their collectives."""
    results, refs, _ = run
    labels = {rec["label"] for name in SCENARIOS
              for rec in results["w4"][0][((2, 2), name)]["log"]}
    for label in ("classic coordinators", "classic coordinator row", "invalidation union",
                  "ring permutations", "edge masks", "winner mask", "trace counts"):
        assert label in labels, label
    for name in SCENARIOS:
        ref = refs[name]
        decisions = sum(r[0] for r in ref["rounds"]) if "rounds" in ref else ref["wave"][1]
        assert decisions >= 1, name


def test_1d_step_equals_jax_sharded_step(run):
    results, _, jax_runs = run
    decided, lanes = jax_runs["crash"]
    got = results["w4"][0][(None, "crash")]
    assert [r[0] for r in got["rounds"]] == decided
    _assert_lanes(got["state"], lanes, "1-D crash vs JAX")


def test_2d_wave_equals_jax_sharded_wave(run):
    results, _, jax_runs = run
    wave, lanes = jax_runs["multi_cut"]
    got = results["w4"][0][((2, 2), "multi_cut")]
    assert got["wave"] == wave
    _assert_lanes(got["state"], lanes, "2-D multi_cut vs JAX")


def test_3d_fleet_step_equals_jax_fleet_step(run):
    results, _, jax_runs = run
    _assert_lanes(results["w4"][0][((2, 1, 2), "fleet")]["fleet_step"], jax_runs["fleet"],
                  "3-D fleet vs JAX")


# -- the collective log -----------------------------------------------------


def _sequence(log, name):
    cfg_n = jobs.SCENARIOS[name][1].get("n_slots", jobs.SCENARIOS[name][0][0])
    cfg_c = jobs.SCENARIOS[name][1].get("cohorts", 2)
    return facts.round_sequence(facts.audit_collectives(log, cfg_n, cfg_c), cfg_n, cfg_c)


@pytest.mark.parametrize("name", SCENARIOS)
def test_collective_sequence_is_the_same_on_every_rank_and_mesh_size(run, name):
    results, _, _ = run
    one_d = [_sequence(r[(None, name)]["log"], name) for job in ("w1", "w2", "w4")
             for r in results[job]]
    assert one_d[0] and all(seq == one_d[0] for seq in one_d), name
    two_d = [_sequence(r[(shape, name)]["log"], name)
             for job, shape in (("w1", (1, 1)), ("w4", (2, 2))) for r in results[job]]
    assert all(seq == two_d[0] for seq in two_d), name


@pytest.mark.parametrize("shape", [None, (2, 2)])
def test_audit_invariants_hold_on_the_collective_log(run, shape):
    """The JAX audit's invariants (``tests/test_parallel.py``) on the wave
    at the audit's geometry (64 cohorts): only reductions unconditionally
    in the hot loop, nothing [c, n]-scale outside a gated branch, and the
    edge gathers in the prologue."""
    results, _, _ = run
    n, c = 256, 64
    for rank in results["w4"]:
        rows = facts.audit_collectives(rank[(shape, "audit")]["log"], n, c)
        hot = [r for r in rows if r["location"] == "hot-loop"]
        assert hot, "no hot-loop collectives"
        violations = facts.collective_violations(rows)
        assert not violations["hot_loop_non_reduce"], violations
        assert not violations["unconditional_cn_anywhere"], violations
        assert any(r["location"] == "prologue" and r["kind"] == "all-gather"
                   and r["label"] == "edge masks" for r in rows)
        assert all(r["kind"] in facts.COLLECTIVE_KINDS and not r["unknown_dtypes"] for r in rows)
        # The wave's view change and edge rebuild run gated in the loop.
        assert {r["label"] for r in rows if r["location"] == "hot-loop-cond"} >= {
            "ring permutations", "edge masks"}


def test_fleet_issues_no_collective_across_tenants(run):
    results, _, _ = run
    block = 2  # ranks per tenant block of the (2, 1, 2) mesh
    for rank in results["w4"]:
        for log in ("fleet_step_log", "fleet_wave_log"):
            rows = facts.audit_collectives(rank[((2, 1, 2), "fleet")][log], 64, 4)
            assert rows
            assert not any(facts.groups_cross_blocks(r["groups"], block) for r in rows)
            assert all(r["axis"] != "tenant" for r in rows)


def test_two_process_multihost_job(run):
    results, _, _ = run
    ranks = results["w2"]
    assert [r["multihost"]["is_coordinator"] for r in ranks] == [True, False]
    assert all(r["multihost"]["global_mesh"] == (("nodes",), 2) for r in ranks)
    assert all(r["multihost"]["local_device_count"] == 1 for r in ranks)


def test_copied_audit_logic_agrees_with_jax():
    rows = [
        {"kind": "all-reduce", "location": "hot-loop", "cn_scale": False},
        {"kind": "all-gather", "location": "hot-loop", "cn_scale": False},
        {"kind": "all-gather", "location": "prologue", "cn_scale": True},
        {"kind": "all-gather", "location": "hot-loop-cond", "cn_scale": True},
    ]
    assert facts.collective_violations(rows) == hlo_facts.collective_violations(rows)
    assert facts.COLLECTIVE_KINDS == hlo_facts.COLLECTIVE_KINDS
    assert facts.PAYLOAD_CLASS_RANK == hlo_facts.PAYLOAD_CLASS_RANK
    for nbytes in (0, 63, 64, 4095, 4096, 10**6):
        assert facts.payload_class(nbytes, 64, 64) == hlo_facts.payload_class(nbytes, 64, 64)
    for groups in (None, [[0, 1]], [[1, 2]], [[0], [3]]):
        assert facts.groups_cross_blocks(groups, 2) == hlo_facts.groups_cross_blocks(groups, 2)
    for in_loop in (False, True):
        for gated in (False, True):
            op = ("jit/" + ("while/body/" if in_loop else "") + ("cond/" if gated else "") + "x")
            assert facts.classify_location(in_loop, gated) == hlo_facts.classify_location(op)
    assert facts.shape_bytes((3, 5), torch.int16) == 30
    assert facts.shape_bytes((3,), "bool") == 3
    unknown = []
    assert facts.shape_bytes((2,), torch.complex64, unknown) == 0 and unknown


def test_transfer_counts_and_aliases_of_a_step():
    from rapid_tpu_torch.models.virtual_cluster import engine_step

    vc = jobs.build("crash")
    (state, *_), counts = facts.count_transfer_ops(
        lambda: engine_step(vc.cfg, vc.state, vc.faults))
    assert counts == {"read": 2}
    aliased = {name for _, name in facts.input_output_aliases(vc.state, state)}
    assert {"key_hi", "ring_perm", "id_hi"} <= aliased
    assert "round_idx" not in aliased and "fd_count" not in aliased


# -- the delivery kernel on a shard -----------------------------------------


def _pack(blocked):
    """``[c, k, n]`` bools -> ``[w*k, n]`` stored words (row wi*k + ring,
    bit j = cohort 32*wi + j)."""
    c, k, n = blocked.shape
    w = (c + 31) // 32
    words = np.zeros((w, k, n), dtype=np.uint64)
    for ci in range(c):
        words[ci // 32] |= blocked[ci].astype(np.uint64) << np.uint64(ci % 32)
    return _u32.from_numpy(words.astype(np.uint32).reshape(w * k, n), "cpu")


@pytest.mark.parametrize("c,dc", [(8, 2), (64, 2), (40, 1)])
@pytest.mark.parametrize("spread,permille", [(0, 1000), (2, 1000), (3, 300)])
def test_delivery_on_slices_with_offsets_is_the_whole_call(c, dc, spread, permille):
    k, n = 10, 200
    rng = np.random.default_rng(c * 10 + spread)
    blocked = rng.random((c, k, n)) < 0.3
    age = torch.from_numpy(rng.integers(-2, 6, size=(k, n)).astype(np.int32))
    epoch = torch.tensor([5], dtype=torch.int32)
    whole = delivery_new_bits_ref(_pack(blocked), age, epoch, k, c, spread, permille)
    c_l = c // dc
    for ci in range(dc):
        cohorts = slice(ci * c_l, (ci + 1) * c_l)
        parts = []
        # Unaligned column slices: 0, 51, 67, 133 (200 = 51 + 16 + 66 + 67).
        for lo, hi in ((0, 51), (51, 67), (67, 133), (133, 200)):
            args = (_pack(blocked[cohorts, :, lo:hi]), age[:, lo:hi].contiguous(), epoch, k, c_l,
                    spread, permille, lo, ci * c_l)
            part = delivery_new_bits_ref(*args)
            assert torch.equal(delivery_new_bits(*args), part)
            parts.append(part)
        assert torch.equal(torch.cat(parts, -1), whole[cohorts]), (c, dc, ci)
    if spread:
        shifted = delivery_new_bits_ref(_pack(blocked), age, epoch, k, c, spread, permille, 1, 0)
        assert not torch.equal(shifted, whole), "the offset must salt the draws"


def test_delivery_rejects_bad_offsets():
    blocked = torch.zeros((10, 4), dtype=torch.int32)
    age = torch.zeros((10, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="offsets"):
        delivery_new_bits(blocked, age, torch.zeros(1, dtype=torch.int32), 10, 4, 0, 1000, -1, 0)
