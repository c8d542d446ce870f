"""Checkpoints are one format in both packages: a file written by the JAX
package's ``utils/checkpoint.py`` loads in the port's
(``rapid_tpu_torch/utils/checkpoint.py``) to equal lanes and dtypes, and
the other way round, in the wide, compact, bit-packed and fleet-stacked
layouts; a JAX checkpoint directory resumes in the port to the state JAX's
own resume reaches. The shapes of ``tests/test_checkpoint.py`` (N=24 in 40
slots, K=3, C=2; a fleet of 3 x 16).

The host ``Configuration`` checkpoints are JAX's byte for byte both ways,
native ones as version 1 and java ones as version 2, on the grids of
``tests/test_checkpoint.py`` (40 members added one by one at K=10; 8 in a
file) and ``tests/test_view_java_compat.py`` (its golden members), and a
flipped, truncated, wrong-magic or unknown-version blob raises
``CheckpointCorruptError`` in both packages alike.
"""

import io

import numpy as np
import pytest
import torch

import rapid_tpu.types as jt
import rapid_tpu_torch.types as tt
from rapid_tpu.models.state import pack_masks as jax_pack_masks
from rapid_tpu.protocol import view as j_view
from rapid_tpu.models.virtual_cluster import VirtualCluster as JaxCluster
from rapid_tpu.serving import PoissonChurn as JaxChurn
from rapid_tpu.serving import SimulatedProcessKill as JaxKill
from rapid_tpu.serving import Supervisor as JaxSupervisor
from rapid_tpu.serving import SupervisorFaultPlan as JaxPlan
from rapid_tpu.serving import recovery as jax_recovery
from rapid_tpu.tenancy import TenantFleet as JaxFleet
from rapid_tpu.utils import checkpoint as jax_ckpt
from rapid_tpu_torch.convert import knobs_to_numpy, state_to_numpy
from rapid_tpu_torch.models.state import pack_masks, unpack_masks
from rapid_tpu_torch.models.virtual_cluster import VirtualCluster as TorchCluster
from rapid_tpu_torch.protocol import view as t_view
from rapid_tpu_torch.serving import PoissonChurn, recovery
from rapid_tpu_torch.tenancy import TenantFleet as TorchFleet
from rapid_tpu_torch.utils import checkpoint as ckpt

CPU = "cpu"


def cluster(make, compact=False, **kw):
    vc = make(24, n_slots=40, k=3, h=3, l=1, cohorts=2, fd_threshold=2, seed=0, compact=compact,
              **kw)
    vc.assign_cohorts_roundrobin()
    vc.crash([2, 7])
    vc.inject_join_wave([30, 31])
    for _ in range(3):
        vc.step()
    return vc


def fleet(make, fleet_cls, **kw):
    clusters = []
    for i in range(3):
        vc = make(16, k=3, h=3, l=1, cohorts=2, fd_threshold=2, seed=30 + i, **kw)
        vc.assign_cohorts_roundrobin()
        clusters.append(vc)
    f = fleet_cls.from_clusters(clusters)
    f.stream_crash([(0, 2), (2, 5)])
    f.step()
    return f


def jax_np(tree):
    return {f: np.asarray(v) for f, v in tree._asdict().items()}


def assert_same(got, want, where):
    assert set(got) == set(want), where
    for field, w in want.items():
        assert got[field].dtype == w.dtype and got[field].shape == w.shape, f"{where}: {field}"
        np.testing.assert_array_equal(got[field], w, err_msg=f"{where}: {field}", strict=True)


@pytest.fixture(scope="module")
def targets():
    """The JAX and port targets of every layout, built from the same seeds
    and driven the same way (equal lane by lane, by the port's other
    tests)."""
    return {
        "wide": (cluster(JaxCluster.create), cluster(TorchCluster.create, device=CPU)),
        "compact": (cluster(JaxCluster.create, compact=True),
                    cluster(TorchCluster.create, compact=True, device=CPU)),
        "fleet": (fleet(JaxCluster.create, JaxFleet), fleet(TorchCluster.create, TorchFleet,
                                                             device=CPU)),
    }


def layout(targets, name):
    """(jax state, jax faults, jax knobs, port ...) of one layout; ``packed``
    is the wide cluster's lanes bit-packed by each package's pack_masks."""
    jt, tt = targets["fleet" if name == "fleet" else "compact" if name == "compact" else "wide"]
    jk = getattr(jt, "knobs", None)
    tk = getattr(tt, "knobs", None)
    if name == "packed":
        return (jt.cfg, jax_pack_masks(jt.state), jax_pack_masks(jt.faults), jk,
                tt.cfg, pack_masks(tt.state), pack_masks(tt.faults), tk)
    return jt.cfg, jt.state, jt.faults, jk, tt.cfg, tt.state, tt.faults, tk


LAYOUTS = ["wide", "compact", "packed", "fleet"]


@pytest.mark.parametrize("name", LAYOUTS)
def test_jax_serving_checkpoint_loads_in_the_port(name, targets, tmp_path):
    jcfg, jstate, jfaults, jknobs, tcfg, tstate, tfaults, _ = layout(targets, name)
    path = tmp_path / "jax.npz"
    jax_ckpt.save_serving_state(path, jcfg, jstate, jfaults, knobs=jknobs, meta={"wave_index": 3})
    cfg, state, faults, knobs, meta = ckpt.load_serving_state(path, device=CPU)
    assert cfg == tcfg and meta == {"wave_index": 3} and (knobs is None) == (jknobs is None)
    assert_same(state_to_numpy(state), jax_np(jstate), f"{name} state")
    assert_same(state_to_numpy(faults), jax_np(jfaults), f"{name} faults")
    assert_same(state_to_numpy(state), state_to_numpy(tstate), f"{name} state vs port")
    if knobs is not None:
        assert_same(knobs_to_numpy(knobs), jax_np(jknobs), "knobs")
    if name == "packed":
        assert_same(state_to_numpy(unpack_masks(state)), state_to_numpy(targets["wide"][1].state),
                    "unpacked")


@pytest.mark.parametrize("name", LAYOUTS)
def test_port_serving_checkpoint_loads_in_jax(name, targets, tmp_path):
    jcfg, jstate, jfaults, jknobs, tcfg, tstate, tfaults, tknobs = layout(targets, name)
    path = tmp_path / "port.npz"
    ckpt.save_serving_state(path, tcfg, tstate, tfaults, knobs=tknobs, meta={"kind": name})
    cfg, state, faults, knobs, meta = jax_ckpt.load_serving_state(path)
    assert cfg == jcfg and meta == {"kind": name}
    assert_same(jax_np(state), state_to_numpy(tstate), f"{name} state")
    assert_same(jax_np(faults), state_to_numpy(tfaults), f"{name} faults")
    if tknobs is not None:
        assert_same(jax_np(knobs), knobs_to_numpy(tknobs), "knobs")
    else:
        assert knobs is None
    # ...and the port reads its own file back verbatim.
    again = ckpt.load_serving_state(path, device=CPU)
    assert_same(state_to_numpy(again[1]), state_to_numpy(tstate), f"{name} round trip")


def test_jax_checkpoint_directory_resumes_in_the_port(tmp_path):
    # JAX's drill (checkpoints every 2 waves, killed after wave 3), resumed
    # by JAX and, from the same directory, by the port: the two finish on
    # the same lanes.
    waves = JaxChurn(24, 40, rate=1.0, seed=7).waves(6)
    vc = JaxCluster.create(24, n_slots=40, k=3, h=3, l=1, cohorts=2, fd_threshold=2, seed=0)
    vc.assign_cohorts_roundrobin()
    sup = JaxSupervisor(vc, rounds_per_wave=4, depth=2, checkpoint_dir=tmp_path,
                        checkpoint_every=2, fault_plan=JaxPlan(kill_after_wave=3))
    with pytest.raises(JaxKill):
        for wave in waves:
            sup.submit(wave)
    port_sup, port_next = recovery.resume(tmp_path, device=CPU)
    jax_sup, jax_next = jax_recovery.resume(tmp_path)
    assert port_next == jax_next == 4
    for wave in PoissonChurn(24, 40, rate=1.0, seed=7).waves(6)[port_next:]:
        port_sup.submit(wave)
    for wave in waves[jax_next:]:
        jax_sup.submit(wave)
    assert port_sup.drain().cuts == jax_sup.drain().cuts
    for port_tree, jax_tree in ((port_sup.target.state, jax_sup.target.state),
                                (port_sup.target.faults, jax_sup.target.faults)):
        assert_same(state_to_numpy(port_tree), jax_np(jax_tree), "resumed")
    assert port_sup.target.config_id == jax_sup.target.config_id


def test_engine_state_files_cross_both_ways(targets, tmp_path):
    jt, tt = targets["compact"]
    jax_ckpt.save_engine_state(tmp_path / "jax.npz", jt.cfg, jt.state)
    cfg, state = ckpt.load_engine_state(tmp_path / "jax.npz", device=CPU)
    assert cfg == tt.cfg
    assert_same(state_to_numpy(state), jax_np(jt.state), "engine state from jax")
    ckpt.save_engine_state(tmp_path / "port.npz", tt.cfg, tt.state)
    cfg, state = jax_ckpt.load_engine_state(tmp_path / "port.npz")
    assert cfg == jt.cfg
    assert_same(jax_np(state), state_to_numpy(tt.state), "engine state from the port")


def _rewrite(path, out, edit):
    """A sealed checkpoint's archive, edited by ``edit(dict)`` and written
    back unsealed (a writer that predates the trailer)."""
    with np.load(io.BytesIO(path.read_bytes()[:-12])) as data:
        entries = {k: data[k] for k in data.files}
    edit(entries)
    buf = io.BytesIO()
    np.savez_compressed(buf, **entries)
    out.write_bytes(buf.getvalue())


def test_older_files_fill_new_fields_as_jax_does(targets, tmp_path, caplog):
    jt, tt = targets["wide"]
    ckpt.save_engine_state(tmp_path / "full.npz", tt.cfg, tt.state)

    def drop(entries):
        for field in ("retired", "cp_rnd_r", "cp_vval_src", "fire_round", "fd_hist"):
            entries.pop(field)
        names = list(entries["__cfg_fields__"])
        keep = [i for i, f in enumerate(names) if f not in ("trace", "telemetry")]
        entries["__cfg__"] = entries["__cfg__"][keep]
        entries["__cfg_fields__"] = entries["__cfg_fields__"][keep]

    _rewrite(tmp_path / "full.npz", tmp_path / "old.npz", drop)
    cfg, state = ckpt.load_engine_state(tmp_path / "old.npz", device=CPU)
    jcfg, jstate = jax_ckpt.load_engine_state(tmp_path / "old.npz")
    assert cfg == jcfg == tt.cfg
    assert_same(state_to_numpy(state), jax_np(jstate), "defaults")
    assert "retired" in caplog.text


def test_corruption_is_named(targets, tmp_path):
    _, tt = targets["wide"]
    path = tmp_path / "c.npz"
    ckpt.save_serving_state(path, tt.cfg, tt.state, tt.faults)
    data = path.read_bytes()
    for name, damaged in (("flip", data[:100] + bytes([data[100] ^ 0xFF]) + data[101:]),
                          ("truncated", data[: len(data) // 2]),
                          ("garbage", b"not a checkpoint at all")):
        (tmp_path / name).write_bytes(damaged)
        with pytest.raises(ckpt.CheckpointCorruptError):
            ckpt.load_serving_state(tmp_path / name, device=CPU)
    _rewrite(path, tmp_path / "missing.npz", lambda e: e.pop("faults__crashed"))
    with pytest.raises(KeyError, match="faults__crashed"):
        ckpt.load_serving_state(tmp_path / "missing.npz", device=CPU)
    _rewrite(path, tmp_path / "unsealed.npz", lambda e: None)
    state = ckpt.load_serving_state(tmp_path / "unsealed.npz", device=CPU)[1]
    assert_same(state_to_numpy(state), state_to_numpy(tt.state), "unsealed")
    # The published file never appears half-written: no temporary is left.
    assert sorted(p.name for p in tmp_path.iterdir() if ".tmp." in p.name) == []
    assert torch.equal(state.alive, tt.state.alive)


# -- host Configuration checkpoints -----------------------------------------

JAX_HOST = dict(t=jt, view=j_view, ckpt=jax_ckpt)
PORT_HOST = dict(t=tt, view=t_view, ckpt=ckpt)


def _added_one_by_one(pkg, n, topology):
    """``tests/test_checkpoint.py``'s view: ``n`` members added by
    ``ring_add`` at K=10."""
    view = pkg["view"].MembershipView(10, topology=topology)
    for i in range(n):
        view.ring_add(pkg["t"].Endpoint(f"10.3.0.{i}", 4000 + i), pkg["t"].NodeId(i, i * 7))
    return view.configuration


def _golden(pkg, n, topology):
    """``tests/test_view_java_compat.py``'s golden members (ids across the
    signed-long sign flip)."""
    t = pkg["t"]
    ids = [t.NodeId(1, 2), t.NodeId((1 << 63) + 7, 3), t.NodeId(42, (1 << 63) + 1)]
    eps = [t.Endpoint("alpha.rapid", 50001), t.Endpoint("beta.rapid", 50002),
           t.Endpoint("gamma.rapid", 50003)]
    return pkg["view"].Configuration(ids, eps, topology=topology)


CONFIG_CASES = [(_added_one_by_one, 40), (_added_one_by_one, 8), (_golden, 3)]


def _same_config(a, b):
    return ([(n.high, n.low) for n in a.node_ids] == [(n.high, n.low) for n in b.node_ids]
            and [str(e) for e in a.endpoints] == [str(e) for e in b.endpoints]
            and a.topology == b.topology and a.configuration_id == b.configuration_id)


@pytest.mark.parametrize("topology", ["native", "java"])
@pytest.mark.parametrize("case", range(len(CONFIG_CASES)))
def test_configuration_bytes_equal_jax_both_ways(case, topology):
    make, n = CONFIG_CASES[case]
    jax_config, port_config = make(JAX_HOST, n, topology), make(PORT_HOST, n, topology)
    blob = ckpt.configuration_to_bytes(port_config)
    assert blob == jax_ckpt.configuration_to_bytes(jax_config)
    assert blob[:4] == b"RTCF" and blob[4] == (1 if topology == "native" else 2)
    assert _same_config(jax_ckpt.configuration_from_bytes(blob), jax_config)
    assert _same_config(ckpt.configuration_from_bytes(blob), port_config)
    jax_view = jax_ckpt.view_from_configuration(ckpt.configuration_from_bytes(blob), 10)
    port_view = ckpt.view_from_configuration(jax_ckpt.configuration_from_bytes(blob), 10)
    assert port_view.topology == jax_view.topology == topology
    assert port_view.configuration_id == jax_view.configuration_id
    for ring in range(10):
        assert [str(e) for e in port_view.ring(ring)] == [str(e) for e in jax_view.ring(ring)]


def test_configuration_files_cross_both_ways(tmp_path):
    for topology in ("native", "java"):
        jax_config = _added_one_by_one(JAX_HOST, 8, topology)
        port_config = _added_one_by_one(PORT_HOST, 8, topology)
        jax_ckpt.save_configuration(tmp_path / "jax.rtcf", jax_config)
        ckpt.save_configuration(tmp_path / "port.rtcf", port_config)
        assert not list(tmp_path.glob("*.tmp.*"))
        assert (tmp_path / "jax.rtcf").read_bytes() == (tmp_path / "port.rtcf").read_bytes()
        assert _same_config(ckpt.load_configuration(tmp_path / "jax.rtcf"), port_config)
        assert _same_config(jax_ckpt.load_configuration(tmp_path / "port.rtcf"), jax_config)
        # A raw blob without the trailer (a writer before it) loads in both.
        raw = ckpt.configuration_to_bytes(port_config)
        (tmp_path / "raw.rtcf").write_bytes(raw)
        assert _same_config(ckpt.load_configuration(tmp_path / "raw.rtcf"), port_config)
        assert _same_config(jax_ckpt.load_configuration(tmp_path / "raw.rtcf"), jax_config)


def test_v1_and_v2_blobs_load_alike():
    v1 = jax_ckpt.configuration_to_bytes(_golden(JAX_HOST, 3, "native"))
    assert v1[4] == 1
    # A native configuration written as v2 (topology code 0) is native.
    v2_native = v1[:4] + bytes([2]) + v1[5:] + bytes([0])
    for blob in (v1, v2_native):
        assert ckpt.configuration_from_bytes(blob).topology == "native"
        assert _same_config(ckpt.configuration_from_bytes(blob),
                            _golden(PORT_HOST, 3, "native"))
    for bad in (v1[:4] + bytes([3]) + v1[5:], v1[:4] + bytes([2]) + v1[5:] + bytes([7])):
        for module in (jax_ckpt, ckpt):
            with pytest.raises(module.CheckpointCorruptError):
                module.configuration_from_bytes(bad)


def _load_outcome(module, path):
    try:
        return ("ok", module.load_configuration(path).configuration_id)
    except module.CheckpointCorruptError:
        return ("corrupt", None)


def test_corrupt_configuration_files_are_named_as_in_jax(tmp_path):
    config = _added_one_by_one(PORT_HOST, 8, "java")
    path = tmp_path / "config.rtcf"
    ckpt.save_configuration(path, config)
    data = path.read_bytes()
    flipped = bytearray(data)
    flipped[len(flipped) // 3] ^= 0xFF
    damaged = {"flip": bytes(flipped), "truncated": data[: len(data) // 2],
               "magic": b"XXXX" + data[4:], "empty": b""}
    for name, blob in damaged.items():
        (tmp_path / name).write_bytes(blob)
        assert _load_outcome(ckpt, tmp_path / name) == ("corrupt", None), name
        assert _load_outcome(jax_ckpt, tmp_path / name) == ("corrupt", None), name
    # Every truncation of the raw bytes raises the named error in both.
    raw = ckpt.configuration_to_bytes(config)
    for cut in range(len(raw)):
        for module in (jax_ckpt, ckpt):
            with pytest.raises(module.CheckpointCorruptError):
                module.configuration_from_bytes(raw[:cut])
    assert issubclass(ckpt.CheckpointCorruptError, ValueError)
