"""The PyTorch port stands alone, and its kernel wrapper never falls back.

- Importing every ``rapid_tpu_torch`` module, ``chip_smoke`` and
  ``mesh_smoke`` loads neither ``jax`` nor anything of ``rapid_tpu``
  (checked in a fresh interpreter, since this test process has both
  loaded), and neither does
  importing the serving tier alone (``rapid_tpu_torch.serving``) or the
  observability tier alone (``utils``: health, clock, flight recorder,
  exposition, engine telemetry, profiling), or the host membership path
  alone (``protocol``, ``messaging``, ``monitoring``), or the hierarchical
  service, the UDP and gossip transports, the windowed detector and the
  host chaos harness alone (``hier``, ``sim``), or the reference-wire
  interop, the native library's bridge or the checkpoint module alone, or
  the sharded engine (``parallel``, the fleet's mesh entry points) or the
  run ledger alone;
  ``rapid_tpu_torch.interop`` and its protobuf conversions import with
  ``grpc`` blocked.
- The command lines and examples (``rapid_tpu_torch.tools``,
  ``rapid_tpu_torch.examples``): no source names ``jax`` or ``rapid_tpu``
  in an import, even inside a function; each one's ``--help`` exits 0
  through ``python -m`` in an interpreter where importing ``jax`` or
  ``rapid_tpu`` fails; and ``--device cuda`` without a card raises before
  any work is done on the CPU.
- The delivery wrapper raises on inputs its kernel does not take instead of
  quietly taking the plain version.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from rapid_tpu_torch.ops.kernels import delivery_new_bits

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import rapid_tpu_torch
names = ["chip_smoke", "mesh_smoke"] + [
    m.name for m in pkgutil.walk_packages(rapid_tpu_torch.__path__, "rapid_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "rapid_tpu"))
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_rapid_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, check=True,
    ).stdout.split(maxsplit=1)
    # Every module of the port was imported: tenancy, utils, the narrow-lane
    # rule (_narrow), the endpoint type, the host hashing (utils.xxhash), the
    # serving tier (serving, utils.checkpoint, ...) and the chaos subsystem
    # (settings, hier, sim, tenancy.chaos), the native library's bridge
    # (utils._native), the interop (interop.*) and the sharded engine
    # (parallel.*) included.
    assert int(out[0]) >= 85
    assert out[1].strip() == "[]", f"the port loaded: {out[1]}"


_SERVING_PROBE = """
import sys
import rapid_tpu_torch.serving
from rapid_tpu_torch.serving import recovery, stream, supervisor
from rapid_tpu_torch.utils import checkpoint
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "rapid_tpu"))
print(bad)
"""


def test_serving_tier_imports_no_jax_and_no_rapid_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _SERVING_PROBE], cwd=REPO, capture_output=True, text=True,
        check=True,
    ).stdout.strip()
    assert out == "[]", f"the serving tier loaded: {out}"


_OBSERVABILITY_PROBE = """
import sys
from rapid_tpu_torch.utils import (
    clock, engine_telemetry, exposition, flight_recorder, health, profiling,
)
from rapid_tpu_torch import CompileDelta, prometheus_text
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "rapid_tpu"))
print(bad)
"""


def test_observability_tier_imports_no_jax_and_no_rapid_tpu():
    # The copies of jax-free JAX modules (health, clock, flight recorder,
    # exposition) and the build, memory and profiler capture stand alone.
    out = subprocess.run(
        [sys.executable, "-c", _OBSERVABILITY_PROBE], cwd=REPO, capture_output=True, text=True,
        check=True,
    ).stdout.strip()
    assert out == "[]", f"the observability tier loaded: {out}"


_HOST_PATH_PROBE = """
import sys
import rapid_tpu_torch.protocol, rapid_tpu_torch.messaging, rapid_tpu_torch.monitoring
from rapid_tpu_torch.protocol import Cluster, DeviceCutDetector, DeviceVoteTally
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "rapid_tpu"))
print(bad)
"""


def test_host_path_imports_no_jax_and_no_rapid_tpu():
    # The host membership path (protocol, messaging, monitoring) with its
    # two device adapters stands alone.
    out = subprocess.run(
        [sys.executable, "-c", _HOST_PATH_PROBE], cwd=REPO, capture_output=True, text=True,
        check=True,
    ).stdout.strip()
    assert out == "[]", f"the host path loaded: {out}"


_HIER_SIM_PROBE = """
import sys
import rapid_tpu_torch.hier, rapid_tpu_torch.sim
from rapid_tpu_torch.hier import CohortTopology, CohortBroadcaster, HierMembershipService
from rapid_tpu_torch.messaging.gossip import GossipBroadcaster, GossipRouter
from rapid_tpu_torch.messaging.udp import LossyDatagramClient, UdpHybridClient, UdpHybridServer
from rapid_tpu_torch.monitoring.windowed import WindowedFailureDetectorFactory
from rapid_tpu_torch.sim import LinkShaper, RunResult, ScenarioRunner, SimHarness
from rapid_tpu_torch.sim.fuzz import fuzz, replay, run_schedule, shrink
from rapid_tpu_torch.sim.oracles import check_all
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "rapid_tpu"))
print(bad)
"""


def test_hier_and_host_sim_import_no_jax_and_no_rapid_tpu():
    # The hierarchical service, UDP, gossip, the windowed detector and the
    # host chaos harness (runner, oracles with the engine replay, fuzzer)
    # stand alone.
    out = subprocess.run(
        [sys.executable, "-c", _HIER_SIM_PROBE], cwd=REPO, capture_output=True, text=True,
        check=True,
    ).stdout.strip()
    assert out == "[]", f"the hierarchy or the host chaos harness loaded: {out}"


_HOST_RUNTIME_PROBES = {
    "interop": "import rapid_tpu_torch.interop\n"
               "from rapid_tpu_torch.interop import convert, grpc_transport, proto_schema",
    "native": "from rapid_tpu_torch.utils import _native",
    "checkpoint": "from rapid_tpu_torch.utils import checkpoint",
    "parallel": "import rapid_tpu_torch.parallel\n"
                "from rapid_tpu_torch.parallel import audit, collective_facts, collectives, mesh,"
                " multihost\n"
                "from rapid_tpu_torch.tenancy.fleet import make_fleet_step, make_fleet_wave",
    "ledger": "from rapid_tpu_torch.utils.ledger import RunLedger, read_ledger",
}


@pytest.mark.parametrize("probe", sorted(_HOST_RUNTIME_PROBES))
def test_host_runtime_modules_import_no_jax_and_no_rapid_tpu(probe):
    code = _HOST_RUNTIME_PROBES[probe] + (
        "\nimport sys\nprint(sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'rapid_tpu')))")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True,
    ).stdout.strip()
    assert out == "[]", f"{probe} loaded: {out}"


_NO_GRPC_PROBE = """
import sys
sys.modules["grpc"] = None  # import grpc raises ImportError
import rapid_tpu_torch.interop as interop
from rapid_tpu_torch.interop.convert import request_to_proto
from rapid_tpu_torch.types import Endpoint, ProbeMessage
frame = request_to_proto(ProbeMessage(Endpoint("10.0.0.1", 5000))).SerializeToString()
try:
    interop.GrpcServer
    print("grpc imported")
except ImportError:
    print(frame.hex())
"""


def test_interop_imports_without_grpc():
    pytest.importorskip("google.protobuf")
    out = subprocess.run(
        [sys.executable, "-c", _NO_GRPC_PROBE], cwd=REPO, capture_output=True, text=True,
        check=True,
    ).stdout.strip()
    frames = json.loads((REPO / "tests" / "fixtures" / "wire_frames.json").read_text())
    assert out == frames["requests"]["ProbeMessage"]


def _args(n=64, k=3, c=5):
    return (
        torch.zeros((k, n), dtype=torch.int32),  # blocked_rows: one cohort word
        torch.zeros((k, n), dtype=torch.int32),  # age_kn
        torch.zeros((1,), dtype=torch.int32),  # epoch
    )


def test_delivery_wrapper_takes_the_plain_version_only_on_cpu_tensors():
    before = delivery_new_bits.launches
    out = delivery_new_bits(*_args(), 3, 5, 0, 1000)
    assert out.shape == (5, 64) and bool((out == 7).all())  # age 0, nothing blocked
    assert delivery_new_bits.launches == before


def test_delivery_wrapper_takes_a_tenant_axis_on_cpu_tensors():
    blocked, age = (x.expand(4, *x.shape).contiguous() for x in _args()[:2])
    before = delivery_new_bits.launches
    out = delivery_new_bits(blocked, age, torch.arange(4, dtype=torch.int32), 3, 5, 0, 1000)
    assert out.shape == (4, 5, 64) and bool((out == 7).all())
    assert delivery_new_bits.launches == before


@pytest.mark.parametrize("fault", ["tenant_count", "tenant_epochs", "four_axes"])
def test_delivery_wrapper_raises_on_a_mismatched_tenant_axis(fault):
    blocked, age, _ = _args()
    tenants = {"tenant_count": (2, 3, 3), "tenant_epochs": (3, 3, 2), "four_axes": (3, 3, 3)}[fault]
    blocked = blocked.expand(tenants[0], *blocked.shape).contiguous()
    age = age.expand(tenants[1], *age.shape).contiguous()
    epoch = torch.zeros((tenants[2],), dtype=torch.int32)
    if fault == "four_axes":
        blocked, age = blocked[None], age[None]
    with pytest.raises(ValueError):
        delivery_new_bits(blocked, age, epoch, 3, 5, 0, 1000)


@pytest.mark.parametrize("fault", ["mixed_devices", "meta_device", "dtype", "noncontiguous", "shape"])
def test_delivery_wrapper_raises_instead_of_falling_back(fault):
    blocked, age, epoch = _args()
    if fault == "mixed_devices":
        age = age.to("meta")
    elif fault == "meta_device":
        blocked, age, epoch = blocked.to("meta"), age.to("meta"), epoch.to("meta")
    elif fault == "dtype":
        age = age.to(torch.int64)
    elif fault == "noncontiguous":
        age = torch.zeros((64, 3), dtype=torch.int32).T
    else:
        blocked = blocked[:2]
    with pytest.raises((TypeError, ValueError)):
        delivery_new_bits(blocked, age, epoch, 3, 5, 0, 1000)


# -- the command lines and examples ------------------------------------------

ENTRY_POINTS = [f"rapid_tpu_torch.examples.{name}" for name in (
    "agent_grpc_transport", "bootstrap_bench", "delivery_autotune", "fleet_khl_autotune",
    "host_scale_ceiling",
    "kernel_microbench", "khl_sensitivity", "standalone_agent", "udp_loss_curve",
    "virtual_cluster_demo",
)] + [f"rapid_tpu_torch.tools.{name}" for name in (
    "chaosrun", "clustertop", "collective_audit", "perfview", "traceview",
)]

_HELP_PROBE = """
import runpy, sys
sys.modules["jax"] = None  # import jax raises ImportError
sys.modules["rapid_tpu"] = None
name = sys.argv.pop(1)  # the rest is the module's own argv, as under python -m
try:
    runpy.run_module(name, run_name="__main__", alter_sys=True)
except SystemExit as exc:
    code = exc.code
bad = sorted(m for m, v in sys.modules.items()
             if v is not None and m.split(".")[0] in ("jax", "jaxlib", "rapid_tpu"))
print("RESULT", code, bad)
"""


@pytest.fixture(scope="module")
def help_runs():
    """``--help`` of every entry point, run side by side: name -> (exit
    code, modules of JAX or the JAX package loaded, output)."""
    procs = {
        name: subprocess.Popen([sys.executable, "-c", _HELP_PROBE, name, "--help"], cwd=REPO,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                               env=dict(os.environ, PYTHONPATH=str(REPO)))
        for name in ENTRY_POINTS
    }
    out = {}
    for name, proc in procs.items():
        text, _ = proc.communicate(timeout=120)
        result = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        out[name] = (result[0].split(" ", 2)[1:] if result else None, text)
    return out


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_help_exits_0_with_jax_blocked(help_runs, name):
    result, text = help_runs[name]
    assert result == ["0", "[]"], text
    assert "usage:" in text and "--help" in text


def _imported_names(source: str):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_source_imports_no_jax_and_no_rapid_tpu(name):
    source = (REPO / (name.replace(".", "/") + ".py")).read_text()
    roots = {imported.split(".")[0] for imported in _imported_names(source)}
    assert not roots & {"jax", "jaxlib", "rapid_tpu"}, roots
    assert "force_platform" not in source
    assert "rapid_tpu_torch" in roots


_NO_CARD = {
    "tools.chaosrun": ["run", "crash_during_join"],
    "tools.collective_audit": ["--n", "64", "--devices", "1"],
    "examples.standalone_agent": ["--listen-address", "127.0.0.1:1",
                                  "--seed-address", "127.0.0.1:1"],
    "examples.virtual_cluster_demo": ["--small"],
    "examples.bootstrap_bench": ["--n", "100"],
    "examples.khl_sensitivity": ["--n", "100", "--reps", "1"],
    "examples.fleet_khl_autotune": ["--n", "64"],
    "examples.host_scale_ceiling": ["--sizes", "8"],
    "examples.kernel_microbench": ["--n", "100"],
    "examples.delivery_autotune": ["--widths", "128,256"],
}


@pytest.mark.parametrize("name", sorted(_NO_CARD))
def test_entry_point_asked_for_cuda_without_a_card_raises(name, monkeypatch):
    import importlib

    from rapid_tpu_torch.models import virtual_cluster
    from rapid_tpu_torch.sim import fuzz

    def ran(*args, **kwargs):
        raise AssertionError("work ran on the CPU after cuda was asked for")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for target, attr in ((virtual_cluster.VirtualCluster, "create"),
                         (virtual_cluster.VirtualCluster, "from_endpoints"),
                         (fuzz, "run_schedule")):
        monkeypatch.setattr(target, attr, ran)
    module = importlib.import_module(f"rapid_tpu_torch.{name}")
    with pytest.raises(RuntimeError, match="CUDA was asked for but no card"):
        module.main([*_NO_CARD[name], "--device", "cuda"])


# -- the static-analysis tier ------------------------------------------------

ANALYSIS_MODULES = sorted(
    p.stem for p in (REPO / "rapid_tpu_torch" / "tools" / "analysis").glob("*.py")
)

_ANALYSIS_PROBE = """
import importlib, sys
sys.modules["jax"] = None  # import jax raises ImportError
sys.modules["rapid_tpu"] = None
sys.modules["tools"] = None
import rapid_tpu_torch.tools.staticcheck
for name in sys.argv[1:]:
    importlib.import_module(f"rapid_tpu_torch.tools.analysis.{name}")
bad = sorted(m for m, v in sys.modules.items()
             if v is not None and m.split(".")[0] in ("jax", "jaxlib", "rapid_tpu", "tools"))
print("torch" in sys.modules, bad)
"""


def test_analysis_tier_imports_no_jax_rapid_tpu_or_jax_tools():
    # Every module of the tier imports with jax, rapid_tpu and JAX's
    # tools package blocked, and only the functions of the families that
    # run the engine (device_program, cost_model, dataflow) bring in torch
    # (lazily): importing the tier alone loads no torch.
    out = subprocess.run(
        [sys.executable, "-c", _ANALYSIS_PROBE, *ANALYSIS_MODULES], cwd=REPO,
        capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    ).stdout.strip()
    assert out == "False []", out


@pytest.mark.parametrize("name", ANALYSIS_MODULES + ["staticcheck"])
def test_analysis_source_imports_no_jax_rapid_tpu_or_jax_tools(name):
    sub = "tools" if name == "staticcheck" else "tools/analysis"
    source = (REPO / "rapid_tpu_torch" / sub / f"{name}.py").read_text()
    roots = {imported.split(".")[0] for imported in _imported_names(source)}
    assert not roots & {"jax", "jaxlib", "rapid_tpu", "tools", "analysis"}, roots
    if name not in ("device_program", "cost_model", "dataflow"):
        assert "torch" not in roots, name
