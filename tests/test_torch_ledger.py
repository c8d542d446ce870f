"""The port's run ledger (``rapid_tpu_torch/utils/ledger.py``) against the
JAX package's: a ledger written by either reads the same in the other, the
vocabularies and the provenance block are equal, and the wedge-point
readers agree on both packages' files."""

import json

import pytest

from rapid_tpu.utils import ledger as jl
from rapid_tpu_torch.utils import ledger as tl

PACKAGES = {"jax": jl, "torch": tl}


def _write(mod, path, fail=False, wedge=False):
    """A run through ``mod``'s writer: two stages, the second failing or
    left open on request."""
    ledger = mod.RunLedger(str(path), run_id="r1", t0=0.0)
    ledger.emit(mod.LedgerEvent.RUN_BEGIN, **mod.provenance(str(path.parent), ["src"]))
    with ledger.stage("state_build", timeout_s=5, n=64):
        pass
    if wedge:
        ledger.emit(mod.LedgerEvent.STAGE_BEGIN, stage="timed_samples")
    elif fail:
        with pytest.raises(RuntimeError):
            with ledger.stage("timed_samples"):
                raise RuntimeError("boom")
    else:
        with ledger.stage("timed_samples"):
            pass
        ledger.emit(mod.LedgerEvent.RUN_END, outcome="completed")
    ledger.close()


def _shape(events):
    """The events without the fields that differ run to run."""
    drop = {"pid", "t_s", "wall", "duration_ms"}
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


def test_vocabularies_are_equal():
    assert tl.STAGE_NAMES == jl.STAGE_NAMES
    assert [(m.name, m.value) for m in tl.LedgerEvent] == [(m.name, m.value) for m in jl.LedgerEvent]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("ending", ["completed", "failed", "wedged"])
def test_a_ledger_reads_the_same_in_the_other_package(tmp_path, writer, reader, ending):
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "a.py").write_text("x = 1\n")
    path = tmp_path / "run.jsonl"
    _write(PACKAGES[writer], path, fail=ending == "failed", wedge=ending == "wedged")
    with open(path, "a") as f:
        f.write('{"event": "torn')  # a killed writer's last line
    events, skipped = PACKAGES[reader].read_ledger(str(path))
    want, want_skipped = PACKAGES[writer].read_ledger(str(path))
    assert (events, skipped) == (want, want_skipped) and skipped == 1
    for mod in PACKAGES.values():
        assert mod.last_completed_stage(events) == (
            "timed_samples" if ending == "completed" else "state_build")
        stuck = mod.open_stage(events)
        assert (stuck or {}).get("stage") == ("timed_samples" if ending == "wedged" else None)


def test_both_writers_write_the_same_lines(tmp_path):
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "a.py").write_text("x = 1\n")
    lines = {}
    for name, mod in PACKAGES.items():
        path = tmp_path / f"{name}.jsonl"
        _write(mod, path, fail=True)
        lines[name] = _shape(mod.read_ledger(str(path))[0])
    assert lines["torch"] == lines["jax"]
    assert lines["torch"][-1]["error"] == "RuntimeError('boom')"


def test_code_hash_and_provenance_are_equal_on_the_same_tree(tmp_path):
    (tmp_path / "pkg" / "__pycache__").mkdir(parents=True)
    (tmp_path / "pkg" / "m.py").write_text("y = 2\n")
    (tmp_path / "pkg" / "__pycache__" / "m.pyc").write_bytes(b"noise")
    (tmp_path / "top.txt").write_text("t\n")
    roots = ["pkg", "top.txt", "missing"]
    assert tl.code_hash(str(tmp_path), roots) == jl.code_hash(str(tmp_path), roots)
    assert tl.provenance(str(tmp_path), roots) == jl.provenance(str(tmp_path), roots)
    before = tl.code_hash(str(tmp_path), roots)
    (tmp_path / "pkg" / "m.py").write_text("y = 3\n")
    assert tl.code_hash(str(tmp_path), roots) != before


def test_the_writer_rejects_unregistered_vocabulary(tmp_path):
    ledger = tl.RunLedger(str(tmp_path / "r.jsonl"))
    with pytest.raises(TypeError):
        ledger.emit("run_begin")
    with pytest.raises(ValueError, match="rapid_tpu_torch.utils.ledger.STAGE_NAMES"):
        ledger.emit(tl.LedgerEvent.STAGE_BEGIN, stage="not_a_stage")
    ledger.close()
    assert json.loads((tmp_path / "r.jsonl").read_text() or "null") is None
    assert tl.utc_stamp().endswith("Z") and len(tl.utc_stamp()) == 20
