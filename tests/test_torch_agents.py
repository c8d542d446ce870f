"""The port's agents (``rapid_tpu_torch.examples.standalone_agent`` and
``agent_grpc_transport``) as OS processes, in clusters shared with the JAX
package's agents (``examples/standalone_agent.py``,
``examples/agent_grpc_transport.py``).

- TCP: three port agents (their cut detector and vote tally on the CPU,
  ``--device cpu``) and two JAX agents join one cluster through a port
  seed; all five converge to 5 members; one port agent is killed and the
  four survivors converge to 4, every survivor at the same configuration
  id.
- gRPC (skips without ``grpc``): two port agents and a JAX agent converge
  to 3 at the same configuration id.
"""

import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from helpers import free_endpoints

REPO = Path(__file__).resolve().parent.parent
SIZE = re.compile(rb"membership size: (\d+) \(config (-?\d+)\)")


class Agents:
    """Agent subprocesses with their logs; the last ``membership size: N
    (config C)`` line of each is its view."""

    def __init__(self, tmp: Path):
        self.tmp = tmp
        self.procs = {}

    def spawn(self, package: str, script: str, port: int, seed_port: int, extra=()):
        env = dict(os.environ, PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}",
                   JAX_PLATFORMS="cpu")
        if package == "jax":
            cmd = [sys.executable, str(REPO / "examples" / f"{script}.py")]
        else:
            cmd = [sys.executable, "-m", f"rapid_tpu_torch.examples.{script}"]
        cmd += ["--listen-address", f"127.0.0.1:{port}",
                "--seed-address", f"127.0.0.1:{seed_port}", "--report-interval", "0.25",
                *extra]
        log = open(self.tmp / f"{package}-{port}.log", "wb")
        self.procs[port] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                             env=env, cwd=str(REPO)), log)

    def view(self, port: int):
        _, log = self.procs[port]
        found = SIZE.findall(Path(log.name).read_bytes())
        return (int(found[-1][0]), int(found[-1][1])) if found else None

    def wait(self, ports, size, timeout_s):
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            views = [self.view(p) for p in ports]
            if all(v is not None and v[0] == size for v in views):
                # Sizes agree; give the last reporter a beat to print the
                # same configuration everywhere.
                if len({v[1] for v in views}) == 1:
                    return views
            time.sleep(0.25)
        return [self.view(p) for p in ports]

    def kill(self, port: int):
        proc, log = self.procs.pop(port)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        log.close()

    def close(self):
        for port in list(self.procs):
            self.kill(port)


@pytest.fixture(scope="module")
def tcp_cluster(tmp_path_factory):
    """The mixed TCP cluster's views: after the five joined, and after a
    port agent was killed."""
    agents = Agents(tmp_path_factory.mktemp("agents"))
    out = {}
    try:
        (seed,) = [ep.port for ep in free_endpoints(1)]
        agents.spawn("port", "standalone_agent", seed, seed, ("--device", "cpu"))
        out["seed_up"] = agents.wait([seed], 1, 30)
        ports = [seed] + [ep.port for ep in free_endpoints(4)]
        packages = {seed: "port"}
        for port, package in zip(ports[1:], ("jax", "port", "jax", "port")):
            packages[port] = package
            extra = ("--device", "cpu") if package == "port" else ()
            agents.spawn(package, "standalone_agent", port, seed, extra)
        out["packages"] = packages
        out["five"] = agents.wait(ports, 5, 90)
        victim = ports[2]  # a port agent
        agents.kill(victim)
        survivors = [p for p in ports if p != victim]
        out["survivors"] = [packages[p] for p in survivors]
        out["four"] = agents.wait(survivors, 4, 120)
    finally:
        agents.close()
    return out


def test_port_and_jax_agents_converge_to_five(tcp_cluster):
    assert tcp_cluster["seed_up"][0][0] == 1
    assert sorted(tcp_cluster["packages"].values()) == ["jax", "jax", "port", "port", "port"]
    views = tcp_cluster["five"]
    assert [v[0] for v in views] == [5] * 5, views
    assert len({v[1] for v in views}) == 1, f"configuration ids differ: {views}"


def test_survivors_of_a_killed_port_agent_converge_to_four(tcp_cluster):
    assert sorted(tcp_cluster["survivors"]) == ["jax", "jax", "port", "port"]
    views = tcp_cluster["four"]
    assert [v[0] for v in views] == [4] * 4, views
    assert len({v[1] for v in views}) == 1, f"configuration ids differ: {views}"
    assert views[0][1] != tcp_cluster["five"][0][1]


def test_grpc_agents_of_both_packages_converge(tmp_path):
    pytest.importorskip("grpc")
    pytest.importorskip("google.protobuf")
    agents = Agents(tmp_path)
    try:
        ports = [ep.port for ep in free_endpoints(3)]
        agents.spawn("port", "agent_grpc_transport", ports[0], ports[0])
        assert agents.wait(ports[:1], 1, 30)[0][0] == 1
        agents.spawn("jax", "agent_grpc_transport", ports[1], ports[0])
        agents.spawn("port", "agent_grpc_transport", ports[2], ports[0])
        views = agents.wait(ports, 3, 90)
    finally:
        agents.close()
    assert [v[0] for v in views] == [3] * 3, views
    assert len({v[1] for v in views}) == 1, f"configuration ids differ: {views}"
