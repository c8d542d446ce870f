"""Check family 15: the program facts of the port's engine entry points
(the counterpart of the JAX package's ``device_program`` family).

JAX compiles 13 registered engine entry points and freezes what XLA
emitted (collectives, transfers, donation, memory) in ``hlo.lock.json``.
The port compiles no program: it runs eagerly, so its facts are what one
call of each entry point does, measured by running it. The registry holds
the port's counterparts of JAX's 13 (:func:`registry`), at JAX's audit
shapes (n=256 slots, c=8 cohorts, k=4 rings, 4 tenants, an 8-slot trace
ring) on a churn of the audit cluster (4 crashes, 8 joins), so that the
gated branches run and are counted: the port records only what ran. The
sharded entries run on a one-rank process group in this process (gloo on
the CPU, NCCL on a card); the collective sequence does not depend on the
world size, and the lock records it.

Facts per call (:func:`measure`):

- ``aten_ops`` — aten operators dispatched (``TorchDispatchMode``), the
  CPU's proxy for kernel launches; compared within tolerance, on the CPU
  under the torch release the lock records (a card dispatches its own
  kernels, and a release may decompose an operator differently);
- ``delivery_calls`` — calls of the delivery kernel's wrapper;
- ``transfers`` — host reads and uploads (``_host.read`` /
  ``_host.upload``) and the bytes read back (``d2h_bytes``);
- ``collectives`` — by location/kind, with count, bytes, largest payload
  and scale class, from the ``CollectiveContext`` record
  (``parallel/collective_facts.py``); the fleet's
  ``cross_tenant_collectives`` is frozen at zero;
- ``memory`` — state, fault, telemetry and trace bytes
  (``pytree_nbytes``);
- ``lanes_in_place`` — per lane tree, the lanes returned in their input's
  storage and the lane count: donation's counterpart;
- ``cost`` — the bytes the call's aten operators touch (each operator's
  input and output tensors) and allocate (outputs in no input's storage),
  which the ``cost_model`` family fits across its geometry ladder; not
  frozen here.

Two blocks beside them, as in JAX's lock: ``telemetry`` (lane bytes, and
the activity counted over a 16-round zero-churn soak, frozen at zero) and
``trace`` (ring bytes, capacity, and the ring cursor's drift from the
round counter over the soak, frozen at zero).

The facts freeze into ``rapid_tpu_torch/tools/analysis/program.lock.json``.
Drift fails the gate naming the entry point and the delta, until the
developer regenerates via ``python -m rapid_tpu_torch.tools.staticcheck
--update-program-lock`` and reviews the diff. The regenerator refuses
while the wide/compact or the trace-off/on differential disagrees, a
fleet collective crosses tenants, or the soak counts phantom activity.
Facts are collected once per process and device, and shared.
"""

from __future__ import annotations

import ast
import contextlib
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import core
from .core import Finding

#: The committed freeze of the program facts, repo-relative.
PROGRAM_LOCK_REL = "rapid_tpu_torch/tools/analysis/program.lock.json"

#: The sources the registry runs: the tree-mode gate runs only when a
#: sweep covers the port's engine (tests that retarget ``core.REPO`` at a
#: temporary tree skip it).
REGISTRY_SOURCES = (
    "rapid_tpu_torch/models/virtual_cluster.py",
    "rapid_tpu_torch/parallel/mesh.py",
    "rapid_tpu_torch/tenancy/fleet.py",
)

#: JAX's audit shapes (``hlo.lock.json``'s ``audit_config``).
AUDIT_N = 256
AUDIT_C = 8
AUDIT_K = 4
AUDIT_TENANTS = 4
AUDIT_TRACE_R = 8
#: JAX's audit cluster holds ``AUDIT_N - 8`` members; the port's churns it
#: (members crash, the free slots join) so the gated branches run.
AUDIT_MEMBERS = AUDIT_N - 8
AUDIT_CRASHES = (3, 61, 130, 197)
AUDIT_JOINS = tuple(range(AUDIT_MEMBERS, AUDIT_N))
AUDIT_TARGET = AUDIT_MEMBERS - len(AUDIT_CRASHES) + len(AUDIT_JOINS)
AUDIT_WORLD = 1
AUDIT_COHORT_MESH = (1, 1)
AUDIT_FLEET_MESH = (1, 1, 1)

#: Relative tolerance and absolute slack of the aten-op comparison: a
#: torch release may decompose an operator differently; growth beyond this
#: is a real change of the program.
OP_REL_TOL = 0.10
OP_ABS_SLACK = 16

#: Rounds of the zero-churn soak the telemetry and trace blocks read.
QUIESCENT_SOAK_ROUNDS = 16

#: The facts a card must reproduce exactly (``aten_ops`` is the CPU's).
DEVICE_INDEPENDENT = (
    "delivery_calls", "transfers", "collectives", "memory", "lanes_in_place",
    "cross_tenant_collectives",
)

_REGEN_HINT = (
    "if this program change is intentional, regenerate via "
    "`python -m rapid_tpu_torch.tools.staticcheck --update-program-lock` "
    "and review the diff"
)

_FACTS_CACHE: Dict[str, Dict[str, Any]] = {}


# -- the registry ------------------------------------------------------------


def audit_config() -> Dict[str, Any]:
    """The registry's shapes and scenario, as the lock records them (its
    facts are taken on the CPU)."""
    return {
        "n": AUDIT_N, "c": AUDIT_C, "k": AUDIT_K, "members": AUDIT_MEMBERS,
        "crashes": list(AUDIT_CRASHES), "joins": [AUDIT_JOINS[0], AUDIT_JOINS[-1]],
        "target": AUDIT_TARGET, "tenants": AUDIT_TENANTS, "trace": AUDIT_TRACE_R,
        "world_size": AUDIT_WORLD, "cohort_mesh": list(AUDIT_COHORT_MESH),
        "fleet_mesh": list(AUDIT_FLEET_MESH), "device": "cpu",
    }


def audit_scenario(n: int = AUDIT_N) -> Tuple[int, Tuple[int, ...], Tuple[int, ...], int]:
    """The audit churn at ``n`` slots: ``(members, crashes, joins,
    target)``. ``n - 8`` members, the four crashes at the audit's slots
    scaled by the membership (the audit's own at ``n = 256``) and the 8 free
    slots joining, so every ``n`` of the cost ladder decides in the same
    rounds."""
    members = n - (AUDIT_N - AUDIT_MEMBERS)
    crashes = tuple(slot * members // AUDIT_MEMBERS for slot in AUDIT_CRASHES)
    joins = tuple(range(members, n))
    return members, crashes, joins, members - len(crashes) + len(joins)


def audit_cluster(device, seed: int = 0, h: int = 3, l: int = 1, churn: bool = True,
                  n: int = AUDIT_N, k: int = AUDIT_K, **planes):
    """JAX's audit cluster (k=4, H/L 3/1, fd threshold 2, 8 cohorts round
    robin, spread 2) on ``device``, churned unless ``churn=False``; ``n``
    slots and ``k`` rings for the cost ladder (:func:`audit_scenario`)."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    members, crashes, joins, _ = audit_scenario(n)
    vc = VirtualCluster.create(
        members, n_slots=n, k=k, h=h, l=l, fd_threshold=2,
        cohorts=AUDIT_C, delivery_spread=2, seed=seed, device=device, **planes,
    )
    vc.assign_cohorts_roundrobin()
    if churn:
        vc.crash(list(crashes))
        vc.inject_join_wave(list(joins))
    return vc


@contextlib.contextmanager
def one_rank_group(device_type: str):
    """A one-rank process group for the sharded entries (gloo on the CPU,
    NCCL on a card, over a file store in a fresh temporary directory),
    removed after; an existing one-rank group is used as it is."""
    import torch.distributed as dist

    from rapid_tpu_torch.parallel.multihost import initialize_multihost

    if dist.is_initialized():
        if dist.get_world_size() != AUDIT_WORLD:
            raise RuntimeError(
                f"device_program audit runs on a {AUDIT_WORLD}-rank group, the "
                f"process already has one of {dist.get_world_size()} ranks"
            )
        yield
        return
    if device_type == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_IB_DISABLE", "1")
    tmp = tempfile.mkdtemp(prefix="program_facts_")
    initialize_multihost(f"file://{tmp}/store", AUDIT_WORLD, 0, device_type=device_type)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def registry(device, n: int = AUDIT_N, k: int = AUDIT_K, churn: bool = True,
             rounds: Optional[int] = None) -> Dict[str, Callable[[], Dict[str, Any]]]:
    """name -> builder of one call: ``{"call": fn, "inputs": {tree: lanes},
    "outputs": fn(result) -> {tree: lanes}, "context": ctx or None,
    "tenants": t}``. Each builder makes its own audit cluster, so no call
    sees another's state. ``n`` / ``k`` move the single-cluster entries
    along the cost ladder; ``churn=False`` leaves every cluster quiescent;
    ``rounds`` caps the round loops (96 to a decision, 192 to a membership,
    64 a fleet wave, by default).
    A fleet's spec carries its knobs (``knobs``) beside its inputs."""
    from rapid_tpu_torch import _host
    from rapid_tpu_torch.models.virtual_cluster import (
        engine_step, run_to_decision, run_until_membership, sync_checksum,
    )
    from rapid_tpu_torch.parallel import mesh as pm
    from rapid_tpu_torch.tenancy import TenantFleet
    from rapid_tpu_torch.tenancy.fleet import make_fleet_step, make_fleet_wave

    target = audit_scenario(n)[3]
    to_decision, to_membership, wave_rounds = (rounds or 96), (rounds or 192), (rounds or 64)

    def single(planes, call, outputs):
        def build():
            vc = audit_cluster(device, churn=churn, n=n, k=k, **planes)
            inputs = {"state": vc.state, "faults": vc.faults}
            if vc.telem is not None:
                inputs["telemetry"] = vc.telem
            if vc.trace_ring is not None:
                inputs["trace"] = vc.trace_ring
            return {"call": lambda: call(vc.cfg, inputs), "inputs": inputs,
                    "outputs": outputs, "context": None, "tenants": 1}
        return build

    def step_out(res):
        out = {"state": res[0]}
        if res[3] is not None:
            out["telemetry"] = res[3]
        if res[4] is not None:
            out["trace"] = res[4]
        return out

    def sharded(make, shape, telem, wave):
        def build():
            vc = audit_cluster(device, churn=churn, telemetry=telem)
            m = pm.make_mesh(shape=shape, device_type=device.type)
            prog = make(vc.cfg, m)
            inputs = {"state": pm.shard_state(vc.state, m), "faults": pm.shard_faults(vc.faults, m)}
            if telem:
                inputs["telemetry"] = pm.shard_pytree(vc.telem, pm.telemetry_shardings(m), mesh=m)

            def call():
                if wave:
                    return prog(inputs["state"], inputs["faults"], AUDIT_TARGET, to_membership, 0)
                if telem:
                    return prog(inputs["state"], inputs["telemetry"], inputs["faults"])
                return prog(inputs["state"], inputs["faults"])

            def outputs(res):
                return {"state": res[0], **({"telemetry": res[1]} if telem else {})}

            return {"call": call, "inputs": inputs, "outputs": outputs,
                    "context": prog.context, "tenants": 1}
        return build

    def fleet(wave):
        def build():
            import torch

            clusters = [audit_cluster(device, seed=i, h=(3, 4)[i % 2], l=(1, 2)[i % 2],
                                      churn=churn) for i in range(AUDIT_TENANTS)]
            fl = TenantFleet.from_clusters(clusters)
            m = pm.make_mesh(shape=AUDIT_FLEET_MESH, device_type=device.type)
            prog = (make_fleet_wave if wave else make_fleet_step)(fl.cfg, m)
            inputs = {"state": pm.shard_fleet_state(fl.state, m),
                      "faults": pm.shard_fleet_faults(fl.faults, m)}
            targets = torch.full((AUDIT_TENANTS,), AUDIT_TARGET, dtype=torch.int32, device=device)
            min_cuts = torch.zeros((AUDIT_TENANTS,), dtype=torch.int32, device=device)

            def call():
                if wave:
                    return prog(inputs["state"], inputs["faults"], fl.knobs, targets, wave_rounds,
                                min_cuts)
                return prog(inputs["state"], inputs["faults"], fl.knobs)

            return {"call": call, "inputs": inputs, "outputs": lambda res: {"state": res[0]},
                    "context": prog.context, "tenants": AUDIT_TENANTS, "knobs": fl.knobs}
        return build

    def sync_call(cfg, t):
        return _host.read(sync_checksum(t["state"], t["faults"]), "sync_checksum")

    return {
        "step": single({}, lambda cfg, t: engine_step(cfg, t["state"], t["faults"]), step_out),
        "step_compact": single(
            {"compact": True}, lambda cfg, t: engine_step(cfg, t["state"], t["faults"]), step_out),
        "step_telem": single(
            {"telemetry": True},
            lambda cfg, t: engine_step(cfg, t["state"], t["faults"], t["telemetry"]), step_out),
        "step_trace": single(
            {"telemetry": True, "trace": AUDIT_TRACE_R},
            lambda cfg, t: engine_step(cfg, t["state"], t["faults"], t["telemetry"], t["trace"]),
            step_out),
        "run_to_decision": single(
            {}, lambda cfg, t: run_to_decision(cfg, t["state"], t["faults"], to_decision),
            lambda res: {"state": res[0]}),
        "run_until_membership": single(
            {}, lambda cfg, t: run_until_membership(cfg, t["state"], t["faults"], target,
                                                    to_membership, 8, 0),
            lambda res: {"state": res[0]}),
        "sync": single({}, sync_call, lambda res: {}),
        "sharded_step": sharded(pm.make_sharded_step, None, False, False),
        "sharded_step_telem": sharded(pm.make_sharded_step_telem, None, True, False),
        "sharded_wave": sharded(pm.make_sharded_wave, None, False, True),
        "sharded2d_wave": sharded(pm.make_sharded_wave, AUDIT_COHORT_MESH, False, True),
        "fleet3d_step": fleet(False),
        "fleet3d_wave": fleet(True),
    }


# -- measuring one call -------------------------------------------------------


@contextlib.contextmanager
def counting():
    """Counts for the calls made inside: ``counts["aten_ops"]`` (aten
    operators dispatched), ``counts["delivery_calls"]`` (the delivery
    wrapper, through the engine's seam ``models.virtual_cluster.
    delivery_new_bits``), ``counts["read"]`` / ``counts["upload"]`` and
    ``counts["d2h_bytes"]`` (the bytes ``_host.read`` brought back), and
    ``counts["bytes_touched"]`` / ``counts["alloc_bytes"]`` (each
    operator's input and output tensor bytes; its outputs in no input's
    storage)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from rapid_tpu_torch import _host
    from rapid_tpu_torch.models import virtual_cluster

    counts = {"aten_ops": 0, "delivery_calls": 0, "read": 0, "upload": 0, "d2h_bytes": 0,
              "bytes_touched": 0, "alloc_bytes": 0}

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts["aten_ops"] += 1
            out = func(*args, **(kwargs or {}))
            ins = [plain_tensor(t) for t in tensor_leaves((args, kwargs))]
            outs = [plain_tensor(t) for t in tensor_leaves(out)]
            counts["bytes_touched"] += sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs))
            held = {storage_key(t) for t in ins}
            counts["alloc_bytes"] += sum(tensor_bytes(t) for t in outs if storage_key(t) not in held)
            return out

    real_read = _host.read
    real_delivery = virtual_cluster.delivery_new_bits
    reads, uploads = real_read.count, _host.upload.count

    def read(t, site):
        # _host.read counts through its module-level name, which is this
        # wrapper while it is installed: it carries the count meanwhile.
        local = t.to_local() if hasattr(t, "to_local") else t
        counts["d2h_bytes"] += local.numel() * local.element_size()
        return real_read(t, site)

    def delivery(*args, **kwargs):
        counts["delivery_calls"] += 1
        return real_delivery(*args, **kwargs)

    read.count = reads
    _host.read = read
    virtual_cluster.delivery_new_bits = delivery
    try:
        with Ops():
            yield counts
    finally:
        real_read.count = read.count
        _host.read = real_read
        virtual_cluster.delivery_new_bits = real_delivery
        counts["read"] = read.count - reads
        counts["upload"] = _host.upload.count - uploads


def tensor_leaves(tree) -> List[Any]:
    """The tensors of an operator's arguments or results."""
    import torch
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def plain_tensor(t):
    """A DTensor's local tensor, any other tensor as it is."""
    return getattr(t, "_local_tensor", t)


def tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def storage_key(t) -> int:
    """The tensor's storage, by its base address (views share it)."""
    return t.untyped_storage().data_ptr()


def measure(spec: Dict[str, Any]) -> Dict[str, Any]:
    """The facts of one call of a registry entry."""
    from rapid_tpu_torch.models.state import pytree_nbytes
    from rapid_tpu_torch.parallel.collective_facts import (
        audit_collectives, groups_cross_blocks, input_output_aliases,
    )
    from rapid_tpu_torch.tools.collective_audit import program_facts

    inputs = spec["inputs"]
    memory = {f"{name}_bytes": pytree_nbytes(_local(tree)) for name, tree in inputs.items()}
    with counting() as counts:
        result = spec["call"]()
    outputs = spec["outputs"](result)
    facts: Dict[str, Any] = {
        "aten_ops": counts["aten_ops"],
        "delivery_calls": counts["delivery_calls"],
        "transfers": {key: counts[key] for key in ("read", "upload", "d2h_bytes")},
        "memory": memory,
        "lanes_in_place": {
            name: [len(input_output_aliases(_local(inputs[name]), _local(tree))), len(tree)]
            for name, tree in sorted(outputs.items())
        },
        "collectives": {},
        "cost": {key: counts[key] for key in ("bytes_touched", "alloc_bytes")},
    }
    ctx = spec["context"]
    if ctx is not None:
        n = AUDIT_N * spec["tenants"]
        rows = audit_collectives(ctx.log, n, AUDIT_C)
        facts["collectives"] = program_facts(rows, n, AUDIT_C)
        if spec["tenants"] > 1:
            block = max(AUDIT_WORLD // AUDIT_FLEET_MESH[0], 1)
            facts["cross_tenant_collectives"] = sum(
                1 for r in rows if groups_cross_blocks(r["groups"], block)
            )
    return facts


def _local(tree):
    """A lane tree with DTensor lanes read as their local tensors."""
    return type(tree)(*(x.to_local() if hasattr(x, "to_local") else x for x in tree))


def collect_facts(device: str = "cpu", force: bool = False) -> Dict[str, Any]:
    """Every registered entry point's facts on ``device`` — once per
    process and device (every consumer shares this cache)."""
    import torch

    if device in _FACTS_CACHE and not force:
        return _FACTS_CACHE[device]
    dev = torch.device(device)
    facts: Dict[str, Any] = {}
    with one_rank_group(dev.type):
        for name, build in registry(dev).items():
            facts[name] = measure(build())
    _FACTS_CACHE[device] = facts
    return facts


def collect_telemetry_facts(device: str = "cpu") -> Dict[str, int]:
    """The plane's lock block: lane bytes, and the activity counted over a
    :data:`QUIESCENT_SOAK_ROUNDS`-round zero-churn soak (every digest
    counter but ``rounds``), which a healthy plane reads as zero."""
    from rapid_tpu_torch.models.state import telemetry_bytes_total
    from rapid_tpu_torch.utils.engine_telemetry import TELEMETRY_DIGEST_FIELDS

    vc = audit_cluster(device, churn=False, telemetry=True)
    for _ in range(QUIESCENT_SOAK_ROUNDS):
        vc.step()
    vc.sync()
    activity = vc.activity
    counters = sum(activity[f] for f in TELEMETRY_DIGEST_FIELDS) + sum(
        activity["rounds_undecided_hist"])
    return {
        "lane_bytes_per_device": int(telemetry_bytes_total(vc.cfg)),
        "quiescent_rounds": int(activity["rounds"]),
        "quiescent_round_activity": int(counters) - int(activity["rounds"]),
    }


def collect_trace_facts(device: str = "cpu") -> Dict[str, int]:
    """The ring's lock block: ring bytes, capacity, and the ring cursor
    minus the plane's round counter after the soak (zero when every round
    writes exactly one record, wrap or no wrap)."""
    from rapid_tpu_torch.models.state import trace_bytes_total

    vc = audit_cluster(device, churn=False, telemetry=True, trace=AUDIT_TRACE_R)
    for _ in range(QUIESCENT_SOAK_ROUNDS):
        vc.step()
    vc.sync()
    return {
        "ring_bytes_per_device": int(trace_bytes_total(vc.cfg)),
        "capacity": AUDIT_TRACE_R,
        "soak_cursor_delta": int(vc.trace["rounds_recorded"]) - int(vc.activity["rounds"]),
    }


# -- lock construction and comparison -----------------------------------------


def facts_to_lock(
    facts: Dict[str, Any], telemetry: Dict[str, int], trace: Dict[str, int]
) -> Dict[str, Any]:
    return {
        "audit_config": audit_config(),
        "aten_ops_release": torch_release(),
        "entrypoints": {name: {key: value for key, value in facts[name].items() if key != "cost"}
                        for name in sorted(facts)},
        "telemetry": dict(telemetry),
        "trace": dict(trace),
    }


def torch_release() -> str:
    """``major.minor`` of the running torch: the aten-op counts depend on
    its operator decompositions, so they are compared only under the
    release the lock was made with."""
    import torch

    return ".".join(torch.__version__.split("+")[0].split(".")[:2])


def device_independent(entry: Dict[str, Any]) -> Dict[str, Any]:
    """The facts of one entry a card must reproduce exactly."""
    return {key: entry[key] for key in DEVICE_INDEPENDENT if key in entry}


def within_tolerance(locked: int, current: int) -> bool:
    return abs(current - locked) <= max(int(locked * OP_REL_TOL), OP_ABS_SLACK)


def compare_facts(
    name: str,
    entry: Dict[str, Any],
    locked: Dict[str, Any],
    loc: Tuple[str, int],
) -> List[Finding]:
    """Drift report for ONE entry point against its locked facts, each
    finding naming the entry point and the delta. Sections present in the
    lock are enforced; absent ones are skipped."""
    from rapid_tpu_torch.parallel.collective_facts import PAYLOAD_CLASS_RANK

    path, lineno = loc
    findings: List[Finding] = []

    def fail(check: str, message: str) -> None:
        findings.append(Finding(path, lineno, check, f"{message} — {_REGEN_HINT}"))

    cross = entry.get("cross_tenant_collectives")
    if cross:
        findings.append(Finding(
            path, lineno, "program-cross-tenant-collective",
            f"{name}: {cross} collective(s) span tenant blocks — tenants must "
            f"never communicate (frozen at zero; cannot be locked in)",
        ))
    elif "cross_tenant_collectives" in locked and locked["cross_tenant_collectives"] != (cross or 0):
        fail("program-lock-drift",
             f"{name}: cross_tenant_collectives {locked['cross_tenant_collectives']} "
             f"in the lock, {cross or 0} now")

    if "aten_ops" in locked:
        old, cur = locked["aten_ops"], entry["aten_ops"]
        if not within_tolerance(old, cur):
            slack = max(int(old * OP_REL_TOL), OP_ABS_SLACK)
            if cur > old:
                fail("program-op-budget",
                     f"{name}: aten ops GREW beyond tolerance: {old} -> {cur} "
                     f"(+{cur - old}, allowed ±{slack})")
            else:
                fail("program-lock-drift",
                     f"{name}: aten ops shrank beyond tolerance: {old} -> {cur} "
                     f"({cur - old}, allowed ±{slack}) — bank the gain in the lock")

    if "delivery_calls" in locked and locked["delivery_calls"] != entry["delivery_calls"]:
        fail("program-op-budget",
             f"{name}: delivery kernel calls {locked['delivery_calls']} -> "
             f"{entry['delivery_calls']}")

    if "transfers" in locked:
        cur_t, old_t = entry["transfers"], locked["transfers"]
        for key in sorted(set(cur_t) | set(old_t)):
            if cur_t.get(key, 0) != old_t.get(key, 0):
                fail("program-transfer-budget",
                     f"{name}: host transfer {key}: {old_t.get(key, 0)} -> {cur_t.get(key, 0)}")

    if "collectives" in locked:
        cur, old = entry["collectives"], locked["collectives"]
        for key in sorted(set(cur) | set(old)):
            location, kind = key.split("/", 1)
            if key not in old:
                hot = "NEW HOT-LOOP collective" if location.startswith("hot-loop") else "new collective"
                fail("program-collective-budget",
                     f"{name}: {hot} {kind} in location {location} "
                     f"({cur[key]['count']} op(s), {cur[key]['bytes']} bytes, "
                     f"class {cur[key]['class']}) not in the program lock")
            elif key not in cur:
                fail("program-collective-budget",
                     f"{name}: collective {kind} in location {location} vanished "
                     f"since the program lock (was {old[key]['count']} op(s), "
                     f"{old[key]['bytes']} bytes)")
            elif PAYLOAD_CLASS_RANK[cur[key]["class"]] > PAYLOAD_CLASS_RANK[old[key]["class"]]:
                fail("program-collective-budget",
                     f"{name}: payload-class INCREASE for {kind} in {location}: "
                     f"{old[key]['class']} -> {cur[key]['class']} (largest payload "
                     f"{old[key]['max_bytes']} -> {cur[key]['max_bytes']} bytes)")
            elif (cur[key]["count"], cur[key]["bytes"]) != (old[key]["count"], old[key]["bytes"]):
                fail("program-collective-budget",
                     f"{name}: collective budget drift for {kind} in {location}: "
                     f"{old[key]['count']} op(s)/{old[key]['bytes']} bytes -> "
                     f"{cur[key]['count']} op(s)/{cur[key]['bytes']} bytes")

    if "memory" in locked:
        cur_m, old_m = entry["memory"], locked["memory"]
        for key in sorted(set(cur_m) | set(old_m)):
            if cur_m.get(key) != old_m.get(key):
                fail("program-memory-budget",
                     f"{name}: {key} {old_m.get(key)} -> {cur_m.get(key)}")

    if "lanes_in_place" in locked:
        cur_l, old_l = entry["lanes_in_place"], locked["lanes_in_place"]
        for key in sorted(set(cur_l) | set(old_l)):
            if list(cur_l.get(key, [])) != list(old_l.get(key, [])):
                fail("program-lanes-in-place",
                     f"{name}: {key} lanes returned in their input's storage "
                     f"{old_l.get(key)} -> {cur_l.get(key)} (in place, of)")
    return findings


def compare_telemetry_facts(
    current: Dict[str, int], locked: Dict[str, Any], lock_path: str
) -> List[Finding]:
    findings: List[Finding] = []
    if current["quiescent_round_activity"] != 0:
        findings.append(Finding(
            lock_path, 1, "program-quiescent-activity",
            f"telemetry plane counted {current['quiescent_round_activity']} unit(s) "
            f"of activity over a {current['quiescent_rounds']}-round ZERO-churn "
            f"soak — phantom activity; the fact is frozen at zero",
        ))
    for key in ("lane_bytes_per_device", "quiescent_rounds"):
        if locked.get(key) != current[key]:
            findings.append(Finding(
                lock_path, 1, "program-lock-drift",
                f"telemetry block: {key} {locked.get(key)} in the lock, "
                f"{current[key]} now — {_REGEN_HINT}",
            ))
    if locked.get("quiescent_round_activity") != 0:
        findings.append(Finding(
            lock_path, 1, "program-lock-drift",
            f"telemetry block: quiescent_round_activity must be frozen at 0, "
            f"the lock carries {locked.get('quiescent_round_activity')!r}",
        ))
    return findings


def compare_trace_facts(
    current: Dict[str, int], locked: Dict[str, Any], lock_path: str
) -> List[Finding]:
    findings: List[Finding] = []
    if current["soak_cursor_delta"] != 0:
        findings.append(Finding(
            lock_path, 1, "program-trace-cursor",
            f"trace ring cursor drifted {current['soak_cursor_delta']} record(s) "
            f"from the telemetry round counter over the zero-churn soak — every "
            f"round must write exactly one record",
        ))
    for key in ("ring_bytes_per_device", "capacity"):
        if locked.get(key) != current[key]:
            findings.append(Finding(
                lock_path, 1, "program-lock-drift",
                f"trace block: {key} {locked.get(key)} in the lock, "
                f"{current[key]} now — {_REGEN_HINT}",
            ))
    if locked.get("soak_cursor_delta") != 0:
        findings.append(Finding(
            lock_path, 1, "program-lock-drift",
            f"trace block: soak_cursor_delta must be frozen at 0, the lock "
            f"carries {locked.get('soak_cursor_delta')!r}",
        ))
    return findings


def compare_lock(
    facts: Dict[str, Any], locked: Dict[str, Any], lock_path: str
) -> List[Finding]:
    findings: List[Finding] = []
    locked_eps: Dict[str, Any] = locked.get("entrypoints", {})
    for name in sorted(set(facts) | set(locked_eps)):
        if name not in locked_eps:
            findings.append(Finding(
                lock_path, 1, "program-lock-drift",
                f"entry point {name} ran but has no entry in the program lock — {_REGEN_HINT}",
            ))
        elif name not in facts:
            findings.append(Finding(
                lock_path, 1, "program-lock-drift",
                f"entry point {name} is in the program lock but no longer "
                f"registered — {_REGEN_HINT}",
            ))
        else:
            findings.extend(compare_facts(name, facts[name], locked_eps[name], (lock_path, 1)))
    return findings


def read_lock() -> Tuple[Optional[Dict[str, Any]], List[Finding]]:
    """The committed lock, or the finding that says why it cannot be read."""
    lock_path = core.REPO / PROGRAM_LOCK_REL
    if not lock_path.exists():
        return None, [Finding(
            PROGRAM_LOCK_REL, 1, "program-lock-drift",
            "program lockfile missing — generate it via `python -m "
            "rapid_tpu_torch.tools.staticcheck --update-program-lock`",
        )]
    try:
        return json.loads(lock_path.read_text()), []
    except json.JSONDecodeError as exc:
        return None, [Finding(
            PROGRAM_LOCK_REL, 1, "program-lock-drift",
            f"program lockfile is not valid JSON ({exc.msg}) — {_REGEN_HINT}",
        )]


def check_lock_against(locked: Dict[str, Any], device: str = "cpu") -> List[Finding]:
    """Every fact of the live registry on ``device`` against ``locked``:
    all of them on the CPU under the lock's torch release, the
    device-independent ones elsewhere."""
    want = audit_config()
    if locked.get("audit_config") != want:
        return [Finding(
            PROGRAM_LOCK_REL, 1, "program-lock-drift",
            f"program lock audit_config {locked.get('audit_config')} does not match "
            f"the registry's {want} — {_REGEN_HINT}",
        )]
    facts = collect_facts(device)
    if device != "cpu" or locked.get("aten_ops_release") != torch_release():
        facts = {name: device_independent(entry) for name, entry in facts.items()}
        locked = dict(locked, entrypoints={
            name: device_independent(entry) for name, entry in locked["entrypoints"].items()
        })
    findings = compare_lock(facts, locked, PROGRAM_LOCK_REL)
    findings.extend(compare_telemetry_facts(
        collect_telemetry_facts(device), locked.get("telemetry", {}), PROGRAM_LOCK_REL))
    findings.extend(compare_trace_facts(
        collect_trace_facts(device), locked.get("trace", {}), PROGRAM_LOCK_REL))
    return findings


def check_program_lock(trees: Sequence[Tuple[ast.AST, str]]) -> List[Finding]:
    """Tree-mode gate the driver runs on full sweeps: run the registry on
    the CPU (once per process) and compare with the committed lock.
    Presence-gated on the engine sources being part of the sweep."""
    rels = {rel.replace("\\", "/") for _, rel in trees}
    if not all(src in rels for src in REGISTRY_SOURCES):
        return []
    locked, findings = read_lock()
    if locked is None:
        return findings
    return check_lock_against(locked, "cpu")


# -- the regenerator's differentials -------------------------------------------


def _differential_scenario(**knobs):
    """JAX's differential scenario: 56 members in 64 slots, three crashes
    and two joins, run until the membership is 55 after two cuts."""
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    vc = VirtualCluster.create(
        56, n_slots=64, k=3, h=3, l=1, cohorts=4, fd_threshold=2,
        delivery_spread=1, seed=17, device="cpu", **knobs,
    )
    vc.assign_cohorts_roundrobin()
    vc.crash([1, 9, 20])
    vc.inject_join_wave([60, 61])
    vc.run_until_membership(55, min_cuts=2)
    return vc


def _first_divergent(a_tree, b_tree) -> Optional[str]:
    import torch

    for field in a_tree._fields:
        a, b = getattr(a_tree, field), getattr(b_tree, field)
        if a.dtype != b.dtype or not torch.equal(a, b):
            return field
    return None


def compaction_differential_ok() -> Optional[str]:
    """None when the compact engine's widened state equals the wide
    engine's lane for lane on the differential scenario, else a message
    naming the first divergent lane."""
    from rapid_tpu_torch.models.state import widen_state

    wide, compact = _differential_scenario(), _differential_scenario(compact=True)
    field = _first_divergent(wide.state, widen_state(compact.cfg, compact.state))
    if field is not None:
        return (f"wide<->compact differential disagrees on state lane {field!r} "
                f"(crash+join scenario at n=64) — fix the compaction layer "
                f"before regenerating the lock")
    if wide.config_id != compact.config_id:
        return "wide<->compact differential disagrees on the configuration id"
    return None


def trace_differential_ok() -> Optional[str]:
    """None when the trace ring on and off leave the state and telemetry
    lanes equal on the differential scenario, else a message naming the
    first divergent lane."""
    off = _differential_scenario(telemetry=True)
    on = _differential_scenario(telemetry=True, trace=AUDIT_TRACE_R)
    for label, a, b in (("state", off.state, on.state), ("telemetry", off.telem, on.telem)):
        field = _first_divergent(a, b)
        if field is not None:
            return (f"trace-on<->trace-off differential disagrees on {label} lane "
                    f"{field!r} (crash+join scenario at n=64) — the ring must be "
                    f"write-only; fix the trace layer before regenerating the lock")
    if off.config_id != on.config_id:
        return "trace-on<->trace-off differential disagrees on the configuration id"
    return None


def update_program_lock() -> Tuple[List[Finding], Optional[Path]]:
    """Regenerate the lockfile from freshly collected CPU facts. Refuses
    while a differential disagrees, a fleet collective crosses tenants, or
    a soak fact is nonzero: a program the gate would fail must be fixed,
    not frozen."""
    facts = collect_facts("cpu", force=True)
    blocking: List[Finding] = []
    for name, entry in sorted(facts.items()):
        blocking.extend(
            f for f in compare_facts(name, entry, {}, (PROGRAM_LOCK_REL, 1))
            if f.check == "program-cross-tenant-collective"
        )
    for mismatch in (compaction_differential_ok(), trace_differential_ok()):
        if mismatch:
            blocking.append(Finding(PROGRAM_LOCK_REL, 1, "program-lock-drift", mismatch))
    telemetry, trace = collect_telemetry_facts(), collect_trace_facts()
    zero = {"quiescent_round_activity": 0, "lane_bytes_per_device": telemetry[
        "lane_bytes_per_device"], "quiescent_rounds": telemetry["quiescent_rounds"]}
    blocking.extend(compare_telemetry_facts(telemetry, zero, PROGRAM_LOCK_REL))
    blocking.extend(compare_trace_facts(
        trace, {"soak_cursor_delta": 0, "ring_bytes_per_device": trace["ring_bytes_per_device"],
                "capacity": trace["capacity"]}, PROGRAM_LOCK_REL))
    if blocking:
        return blocking, None
    payload = {
        "_comment": (
            "Frozen program facts of the port's registered engine entry points "
            "at the audit shapes, one call each on the CPU (a one-rank gloo "
            "group for the sharded ones): aten ops dispatched, delivery kernel "
            "calls, host reads/uploads/bytes, collectives by location/kind, "
            "lane bytes, lanes returned in place, and the telemetry and trace "
            "soak blocks. Generated by `python -m rapid_tpu_torch.tools."
            "staticcheck --update-program-lock`; do not edit by hand."
        ),
        **facts_to_lock(facts, telemetry, trace),
    }
    lock_path = core.REPO / PROGRAM_LOCK_REL
    lock_path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return [], lock_path
