"""Check family 16: the scaling-law cost-model gate (the counterpart of the
JAX package's ``cost_model`` family), frozen in ``cost.lock.json``.

The program lock (family 15) freezes what each entry point does at ONE
audit shape, which cannot tell O(N) from O(N·K): a per-slot Python loop
that makes launches grow with N would pass it. This family runs each
registered entry point across a small geometry **ladder** (N in {64, 128,
256, 512} at the audit K and C, a K ladder for ``step``, a tenant ladder
for the meshless fleet step), takes each point's facts, and FITS each
fact to a scaling class:

    O(1) < O(log N) < O(N) < O(N*K) < O(N^2)

by non-negative least squares over the nested basis ``{1, log2 N, N,
N·K, N²}``: the smallest class whose model explains every ladder point
within the fact's tolerance wins; if none does, the fit REFUSES
(``cost-unexplained``) rather than guess. The fitter is JAX's, copied as
it stands (pure Python, so both give the same class, coefficient and
residual on every series); it also returns every basis coefficient
(``coeffs``), so the lock can predict a fact at a shape off the ladder.

The port compiles no program, so its facts are the eager meaning of
JAX's compiled ones, measured by running one call per point through
``device_program.measure`` (its ``counting()`` dispatch mode):

========================  ================================  ================
fact                      JAX counterpart                   tolerance
========================  ================================  ================
``lane_bytes``            ``argument_bytes``                2%, exact
``bytes_touched``         ``bytes_accessed``                15%
``alloc_bytes``           ``temp_bytes``                    35%
``aten_ops``              none: the launch proxy; a class   10%, the lock's
                          that grows with N is a per-slot   torch release
                          host loop (fitted along N only)   only
``host_reads``,           ``transfer_ops``                  2%, exact
``host_uploads``,
``d2h_bytes``
``delivery_calls``        none: kernel launches a call      2%, exact
``collective_payload_     same names                        2%, exact
bytes``, ``collective_
largest_payload_bytes``
========================  ================================  ================

``lane_bytes`` is the state, fault and plane lanes a call takes
(``pytree_nbytes``); ``bytes_touched`` sums every dispatched operator's
input and output tensor bytes; ``alloc_bytes`` the bytes of its outputs in
no input's storage. FLOPs have no counterpart: ``torch.utils.
flop_counter`` prices only products, and the engine has none, so the fact
is absent, as JAX leaves out what a backend does not expose. The
release-bound facts (``aten_ops``, ``bytes_touched``, ``alloc_bytes``:
a torch release may decompose an operator differently) are fitted and
compared only under the torch release the lock records, as the program
lock's op counts are; the exact facts everywhere, a card included.

``quiescent_round_cost`` is one zero-churn round of ``step``, and of
``sharded_step`` on the one-rank group: aten ops, bytes touched, host
reads, and collective payload bytes in total and inside a round loop.
It is the eager round's dense work, the block a ``perf_opt`` that removes
launches must shrink, and the total the ``dataflow`` family's
sparse-opportunity map must price exactly.

Findings, under JAX's names: ``cost-scaling-regression`` (a fitted class
worse than the lock's), ``cost-superlinear`` (a class past the entry
point's ceiling, ``O(N*K)`` by default; never freezable),
``cost-quiescent`` (drift of the quiescent block), ``cost-unexplained``
and ``cost-lock-drift``. ``python -m rapid_tpu_torch.tools.staticcheck
--update-cost-lock`` regenerates the lock byte-identically and refuses
while any fit is unexplained, any ceiling broken, or the program lock's
differentials disagree. The ladder runs once per process and device
(``_LADDER_CACHE``); its base point (N=256, K=4) reuses
``device_program.collect_facts``.

``check_cost_model`` is the per-file mode for the seeded corpus: a module
defining ``COST_AUDIT_PROGRAMS`` (name -> a builder taking ``n`` and
returning a ``measure`` spec) and an inline ``COST_LOCK`` is run across
its own miniature ladder (``COST_LADDER``) and compared.
"""

from __future__ import annotations

import ast
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import core, device_program
from .core import Finding

#: The committed freeze of the fitted scaling classes, repo-relative.
COST_LOCK_REL = "rapid_tpu_torch/tools/analysis/cost.lock.json"

#: Scaling-class vocabulary, weakest to strongest.
CLASSES = ("O(1)", "O(log N)", "O(N)", "O(N*K)", "O(N^2)")
CLASS_RANK = {cls: rank for rank, cls in enumerate(CLASSES)}

#: Nothing in the round body may exceed O(N·K): the paper's per-node O(K)
#: claim priced at the whole-cluster grain.
DEFAULT_CEILING = "O(N*K)"
COST_CEILINGS: Dict[str, str] = {}

#: The geometry ladders (JAX's), around the program lock's audit shape.
BASE_N = device_program.AUDIT_N
BASE_K = device_program.AUDIT_K
BASE_C = device_program.AUDIT_C
N_LADDER = (64, 128, 256, 512)
K_LADDER = (2, 4, 8)
TENANT_LADDER = (2, 4, 8)
#: Per-tenant slot count of the fleet ladder: tenant count T maps to
#: N_eff = T * FLEET_TENANT_N, so linearity in tenants fits as O(N).
FLEET_TENANT_N = 64

#: Entry points the ladder sweeps and the axes each varies (JAX's
#: registry). ``step_compact``'s ladder stays inside one index-dtype
#: regime (the compact layout's bytes per slot step at n=128).
COST_REGISTRY: Dict[str, Dict[str, Any]] = {
    "step": {"axes": ("n", "k")},
    "run_to_decision": {"axes": ("n",)},
    "run_until_membership": {"axes": ("n",)},
    "sync": {"axes": ("n",)},
    "step_compact": {"axes": ("n",), "n_ladder": (128, 192, 256, 512)},
    "step_telem": {"axes": ("n",)},
    "step_trace": {"axes": ("n",)},
    "fleet_step": {"axes": ("tenants",)},
}

#: Per-fact fit tolerance (max relative residual).
FACT_TOLERANCES = {
    "lane_bytes": 0.02,
    "bytes_touched": 0.15,
    "alloc_bytes": 0.35,
    "aten_ops": 0.10,
    "host_reads": 0.02,
    "host_uploads": 0.02,
    "d2h_bytes": 0.02,
    "delivery_calls": 0.02,
    "collective_payload_bytes": 0.02,
    "collective_largest_payload_bytes": 0.02,
}
DEFAULT_TOLERANCE = 0.10

#: Facts whose per-point VALUES freeze into the lock and compare exactly:
#: shape-determined, and the same on every device (a card reproduces them).
EXACT_FACTS = (
    "lane_bytes",
    "host_reads",
    "host_uploads",
    "d2h_bytes",
    "delivery_calls",
    "collective_payload_bytes",
    "collective_largest_payload_bytes",
)

#: Facts that depend on the torch release's operator decompositions:
#: fitted and compared only under the release the lock records.
RELEASE_FACTS = ("aten_ops", "bytes_touched", "alloc_bytes")

#: Facts fitted along N only (the ladder's points at the base K). The round
#: body runs a host loop over the K rings (the plain delivery version's
#: ring loop, the ring passes), so its operator count grows with K by
#: design, the paper's O(K) per node, which the class vocabulary has no
#: name for: at N=256 ``step`` dispatches 542, 614 and 758 aten ops at K =
#: 2, 4 and 8, the same at every N. Growth with N is what the fact guards.
N_AXIS_FACTS = ("aten_ops",)

#: A fit needs at least this many ladder points, and strictly more points
#: than model bases.
MIN_LADDER_POINTS = 3

#: Relative tolerance of the quiescent aten-op and byte comparison.
QUIESCENT_REL_TOL = 0.10

#: The quiescent block's entry points and the keys each records.
QUIESCENT_ENTRYPOINTS = ("step", "sharded_step")
QUIESCENT_EXACT = ("host_reads", "collective_payload_bytes", "hot_loop_payload_bytes")
QUIESCENT_RELEASE = ("aten_ops", "bytes_touched")

_REGEN_HINT = (
    "if this scaling change is intentional, regenerate via "
    "`python -m rapid_tpu_torch.tools.staticcheck --update-cost-lock` and review the diff"
)


# -- the fitter (JAX's, as it stands) ----------------------------------------


def _basis_1(n: float, k: float) -> float:
    return 1.0


def _basis_log(n: float, k: float) -> float:
    return math.log2(n)


def _basis_n(n: float, k: float) -> float:
    return n


def _basis_nk(n: float, k: float) -> float:
    return n * k


def _basis_n2(n: float, k: float) -> float:
    return n * n


def _model_bases(cls: str, k_varies: bool):
    """The basis columns of one class's candidate model, leading term
    LAST. ``O(N*K)`` is only distinguishable when the ladder varies K:
    with K fixed it degenerates to O(N) and is skipped."""
    if cls == "O(1)":
        return [_basis_1]
    if cls == "O(log N)":
        return [_basis_1, _basis_log]
    if cls == "O(N)":
        return [_basis_1, _basis_n]
    if cls == "O(N*K)":
        if not k_varies:
            return None
        return [_basis_1, _basis_n, _basis_nk]
    if cls == "O(N^2)":
        bases = [_basis_1, _basis_n, _basis_n2]
        if k_varies:
            bases.insert(2, _basis_nk)
        return bases
    raise ValueError(f"unknown scaling class {cls!r}")


def _gauss_solve(a: List[List[float]], b: List[float]) -> Optional[List[float]]:
    """Gaussian elimination with partial pivoting; None when singular.
    Pure Python (5x5 at most), so the fit and the lockfile are
    bit-deterministic."""
    m = len(b)
    a = [row[:] for row in a]
    b = b[:]
    for col in range(m):
        piv = max(range(col, m), key=lambda r: abs(a[r][col]))
        if abs(a[piv][col]) < 1e-12:
            return None
        a[col], a[piv] = a[piv], a[col]
        b[col], b[piv] = b[piv], b[col]
        for r in range(m):
            if r != col and a[r][col] != 0.0:
                f = a[r][col] / a[col][col]
                for cc in range(col, m):
                    a[r][cc] -= f * a[col][cc]
                b[r] -= f * b[col]
    return [b[i] / a[i][i] for i in range(m)]


def _lstsq(cols: List[List[float]], y: List[float]) -> Optional[List[float]]:
    """Least squares over column-max-scaled normal equations."""
    m = len(cols)
    pts = len(y)
    scales = [max((abs(v) for v in col), default=0.0) or 1.0 for col in cols]
    ata = [
        [
            sum(cols[i][p] / scales[i] * cols[j][p] / scales[j] for p in range(pts))
            for j in range(m)
        ]
        for i in range(m)
    ]
    aty = [
        sum(cols[i][p] / scales[i] * y[p] for p in range(pts)) for i in range(m)
    ]
    sol = _gauss_solve(ata, aty)
    if sol is None:
        return None
    return [sol[i] / scales[i] for i in range(m)]


def _nnls(cols: List[List[float]], y: List[float]) -> Optional[List[float]]:
    """Non-negative least squares by iterated dropping of the most
    negative column: costs only ADD with scale."""
    active = list(range(len(cols)))
    while active:
        coef = _lstsq([cols[j] for j in active], y)
        if coef is None:
            return None
        worst = min(range(len(active)), key=lambda i: coef[i])
        if coef[worst] >= -1e-9:
            out = [0.0] * len(cols)
            for i, j in enumerate(active):
                out[j] = max(coef[i], 0.0)
            return out
        active.pop(worst)
    return [0.0] * len(cols)


def fit_scaling(
    points: Sequence[Tuple[Tuple[float, float], float]], tol: float
) -> Dict[str, Any]:
    """Fit one fact's ladder, ``(((n, k), value), ...)``, to the smallest
    adequately fitting scaling class.

    Returns ``{"class", "coeff", "residual", "coeffs"}`` on success
    (``coeff`` is the leading-term coefficient, ``coeffs`` the model's
    coefficients in basis order) or ``{"error": ...}`` when the ladder is
    too short or no eligible model explains every point within ``tol``."""
    pts = [((float(n), float(k)), float(v)) for (n, k), v in points]
    if len(pts) < MIN_LADDER_POINTS:
        return {
            "error": (
                f"ladder too short to classify ({len(pts)} point(s), "
                f"need {MIN_LADDER_POINTS})"
            )
        }
    if all(v == 0.0 for _, v in pts):
        return {"class": "O(1)", "coeff": 0.0, "residual": 0.0, "coeffs": [0.0]}
    k_varies = len({k for (_n, k), _ in pts}) > 1
    y = [v for _, v in pts]
    best: Optional[Tuple[str, float]] = None
    for cls in CLASSES:
        bases = _model_bases(cls, k_varies)
        if bases is None or len(pts) < len(bases) + 1:
            continue
        cols = [[b(n, k) for (n, k), _ in pts] for b in bases]
        coef = _nnls(cols, y)
        if coef is None:
            continue
        residual = max(
            abs(sum(c * col[p] for c, col in zip(coef, cols)) - y[p])
            / max(abs(y[p]), 1.0)
            for p in range(len(pts))
        )
        if best is None or residual < best[1]:
            best = (cls, residual)
        if residual <= tol:
            return {"class": cls, "coeff": coef[-1], "residual": residual, "coeffs": coef}
    if best is None:
        return {
            "error": (
                f"no eligible scaling model for {len(pts)} ladder point(s) "
                f"(every candidate needs more points than bases)"
            )
        }
    return {
        "error": (
            f"no scaling class explains the ladder: best candidate "
            f"{best[0]} leaves relative residual {best[1]:.3g} > "
            f"tolerance {tol:g}"
        )
    }


def predict(cls: str, coeffs: Sequence[float], n: float, k: float, k_varies: bool) -> float:
    """A fitted model's value at ``(n, k)``."""
    bases = _model_bases(cls, k_varies) or [_basis_1]
    return sum(c * b(float(n), float(k)) for c, b in zip(coeffs, bases))


# -- ladder collection ---------------------------------------------------------


def ladder_points(name: str) -> List[Dict[str, int]]:
    """The geometry points one entry point's ladder sweeps, each with the
    effective scale ``n_eff`` the fit regresses against (for the fleet,
    tenants * FLEET_TENANT_N)."""
    axes = COST_REGISTRY[name]["axes"]
    if "tenants" in axes:
        return [
            {"n": FLEET_TENANT_N, "k": BASE_K, "tenants": t, "n_eff": t * FLEET_TENANT_N}
            for t in TENANT_LADDER
        ]
    n_ladder = COST_REGISTRY[name].get("n_ladder", N_LADDER)
    pts = [{"n": n, "k": BASE_K, "n_eff": n} for n in n_ladder]
    if "k" in axes:
        pts.extend({"n": BASE_N, "k": k, "n_eff": BASE_N} for k in K_LADDER if k != BASE_K)
    return pts


def point_key(pt: Dict[str, int]) -> str:
    return f"n{pt['n_eff']}_k{pt['k']}"


def fleet_spec(device, tenants: int, n: int = FLEET_TENANT_N, k: int = BASE_K,
               churn: bool = True) -> Dict[str, Any]:
    """One call of the MESHLESS fleet step (``tenancy.fleet.fleet_step``)
    over ``tenants`` audit clusters of ``n`` slots (JAX's knob mix: H/L
    3/1 and 4/2 in turn), as a ``measure`` spec with its knobs."""
    from rapid_tpu_torch.tenancy import TenantFleet
    from rapid_tpu_torch.tenancy.fleet import fleet_step

    clusters = [
        device_program.audit_cluster(device, seed=i, h=(3, 4)[i % 2], l=(1, 2)[i % 2],
                                     churn=churn, n=n, k=k)
        for i in range(tenants)
    ]
    fl = TenantFleet.from_clusters(clusters)
    inputs = {"state": fl.state, "faults": fl.faults}
    return {"call": lambda: fleet_step(fl.cfg, inputs["state"], inputs["faults"], fl.knobs),
            "inputs": inputs, "outputs": lambda res: {"state": res[0]}, "context": None,
            "tenants": tenants, "knobs": fl.knobs}


def point_spec(name: str, pt: Dict[str, int], device) -> Dict[str, Any]:
    if "tenants" in pt:
        return fleet_spec(device, pt["tenants"], pt["n"], pt["k"])
    return device_program.registry(device, n=pt["n"], k=pt["k"])[name]()


def entry_cost_facts(entry: Dict[str, Any]) -> Dict[str, float]:
    """The cost-fact vector of one ``device_program.measure`` entry."""
    collectives = entry["collectives"].values()
    transfers = entry["transfers"]
    return {
        "lane_bytes": float(sum(entry["memory"].values())),
        "bytes_touched": float(entry["cost"]["bytes_touched"]),
        "alloc_bytes": float(entry["cost"]["alloc_bytes"]),
        "aten_ops": float(entry["aten_ops"]),
        "host_reads": float(transfers["read"]),
        "host_uploads": float(transfers["upload"]),
        "d2h_bytes": float(transfers["d2h_bytes"]),
        "delivery_calls": float(entry["delivery_calls"]),
        "collective_payload_bytes": float(sum(c["bytes"] for c in collectives)),
        "collective_largest_payload_bytes": float(max((c["max_bytes"] for c in collectives),
                                                      default=0)),
    }


#: device -> ladder table; one collection per process and device.
_LADDER_CACHE: Dict[str, Dict[str, List[Dict[str, Any]]]] = {}


def collect_ladder(device: str = "cpu", force: bool = False) -> Dict[str, List[Dict[str, Any]]]:
    """Run the ladder on ``device`` and take each point's facts, once per
    process and device: ``name -> [{"key", "n_eff", "k", "facts"}, ...]``.
    The base point (N=256, K=4) of each registered single-cluster entry is
    ``device_program.collect_facts``'s entry."""
    import torch

    if device in _LADDER_CACHE and not force:
        return _LADDER_CACHE[device]
    dev = torch.device(device)
    base_facts = device_program.collect_facts(device)
    table: Dict[str, List[Dict[str, Any]]] = {}
    for name in COST_REGISTRY:
        series: List[Dict[str, Any]] = []
        for pt in ladder_points(name):
            is_base = ("tenants" not in pt and pt["n"] == BASE_N and pt["k"] == BASE_K
                       and name in base_facts)
            entry = base_facts[name] if is_base else device_program.measure(
                point_spec(name, pt, dev))
            series.append({"key": point_key(pt), "n_eff": pt["n_eff"], "k": pt["k"],
                           "facts": entry_cost_facts(entry)})
        table[name] = series
    _LADDER_CACHE[device] = table
    return table


#: device -> quiescent block; one collection per process and device.
_QUIESCENT_CACHE: Dict[str, Dict[str, Dict[str, int]]] = {}


def collect_quiescent_cost(device: str = "cpu", force: bool = False) -> Dict[str, Dict[str, int]]:
    """One zero-churn round of each quiescent entry point: aten ops, bytes
    touched, host reads, and collective payload bytes in total and inside
    a round loop (``hot-loop`` locations). Once per process and device."""
    import torch

    if device in _QUIESCENT_CACHE and not force:
        return _QUIESCENT_CACHE[device]
    dev = torch.device(device)
    out: Dict[str, Dict[str, int]] = {}
    builders = device_program.registry(dev, churn=False)
    with device_program.one_rank_group(dev.type):
        for name in QUIESCENT_ENTRYPOINTS:
            entry = device_program.measure(builders[name]())
            collectives = entry["collectives"]
            out[name] = {
                "aten_ops": int(entry["aten_ops"]),
                "bytes_touched": int(entry["cost"]["bytes_touched"]),
                "host_reads": int(entry["transfers"]["read"]),
                "collective_payload_bytes": int(sum(c["bytes"] for c in collectives.values())),
                "hot_loop_payload_bytes": int(sum(
                    c["bytes"] for key, c in collectives.items() if key.startswith("hot-loop"))),
            }
    _QUIESCENT_CACHE[device] = out
    return out


# -- fitting + lock construction -------------------------------------------------


def fit_ladder(
    table: Dict[str, List[Dict[str, Any]]], facts: Optional[Sequence[str]] = None,
) -> Tuple[Dict[str, Dict[str, Dict[str, Any]]], List[Tuple[str, str, str]]]:
    """Fit every (entry point, fact) series (only ``facts`` when named).
    Returns ``(fits, refusals)``: ``fits[name][fact] = {"class", "coeff",
    "residual", "coeffs", "points"}`` and one ``(name, fact, why)`` per
    refused fit. A fact absent at any ladder point is skipped."""
    fits: Dict[str, Dict[str, Dict[str, Any]]] = {}
    refusals: List[Tuple[str, str, str]] = []
    for name, series in table.items():
        per: Dict[str, Dict[str, Any]] = {}
        fact_names = sorted({f for pt in series for f in pt["facts"]})
        for fact in fact_names:
            if facts is not None and fact not in facts:
                continue
            if not all(fact in pt["facts"] for pt in series):
                continue
            used = [pt for pt in series if fact not in N_AXIS_FACTS or pt["k"] == BASE_K]
            fitted = fit_scaling(
                [((pt["n_eff"], pt["k"]), pt["facts"][fact]) for pt in used],
                FACT_TOLERANCES.get(fact, DEFAULT_TOLERANCE),
            )
            if "error" in fitted:
                refusals.append((name, fact, fitted["error"]))
                continue
            fitted["points"] = {pt["key"]: _as_number(pt["facts"][fact]) for pt in used}
            per[fact] = fitted
        fits[name] = per
    return fits, refusals


def _as_number(value: float):
    return int(value) if float(value).is_integer() else float(value)


def _round_sig(value: float, digits: int) -> float:
    return float(f"{float(value):.{digits}g}")


def ceiling_for(name: str) -> str:
    return COST_CEILINGS.get(name, DEFAULT_CEILING)


def superlinear_findings(
    fits: Dict[str, Dict[str, Dict[str, Any]]], loc: Tuple[str, int]
) -> List[Finding]:
    """One ``cost-superlinear`` per (entry point, fact) whose fitted class
    exceeds the entry point's ceiling; never freezable."""
    path, lineno = loc
    findings = []
    for name in sorted(fits):
        ceiling = ceiling_for(name)
        for fact in sorted(fits[name]):
            fit = fits[name][fact]
            if CLASS_RANK[fit["class"]] > CLASS_RANK[ceiling]:
                findings.append(Finding(
                    path, lineno, "cost-superlinear",
                    f"{name}: {fact} fitted {fit['class']} (leading coeff "
                    f"{_round_sig(fit['coeff'], 4)}) exceeds the "
                    f"entry point's {ceiling} ceiling — the round body must "
                    f"never scale past O(N*K); fix the program (this budget "
                    f"cannot be locked in)",
                ))
    return findings


def _ladder_config() -> Dict[str, Any]:
    return {
        "base": {"n": BASE_N, "k": BASE_K, "c": BASE_C},
        "n_ladder": list(N_LADDER),
        "n_ladder_overrides": {
            name: list(spec["n_ladder"])
            for name, spec in sorted(COST_REGISTRY.items())
            if "n_ladder" in spec
        },
        "k_ladder": list(K_LADDER),
        "tenant_ladder": list(TENANT_LADDER),
        "fleet_tenant_n": FLEET_TENANT_N,
        "classes": list(CLASSES),
    }


def fits_to_lock(
    fits: Dict[str, Dict[str, Dict[str, Any]]],
    quiescent: Dict[str, Dict[str, int]],
) -> Dict[str, Any]:
    """The canonical freeze: per entry point the fitted classes, rounded
    coefficients (and exact per-point values of the exact facts), the
    ladder geometry, the torch release of the release-bound facts, and the
    quiescent block. Same facts, same bytes."""
    lock: Dict[str, Any] = {
        "ladder_config": _ladder_config(),
        "torch_release": device_program.torch_release(),
        "entrypoints": {},
    }
    for name in sorted(fits):
        block: Dict[str, Any] = {}
        for fact in sorted(fits[name]):
            fit = fits[name][fact]
            entry: Dict[str, Any] = {
                "class": fit["class"],
                "coeff": _round_sig(fit["coeff"], 6),
                "coeffs": [_round_sig(c, 6) for c in fit["coeffs"]],
                "residual": _round_sig(fit["residual"], 3),
            }
            if fact in EXACT_FACTS:
                entry["points"] = dict(sorted(fit["points"].items()))
            block[fact] = entry
        lock["entrypoints"][name] = {"ceiling": ceiling_for(name), "facts": block}
    lock["quiescent_round_cost"] = {name: dict(sorted(quiescent[name].items()))
                                    for name in sorted(quiescent)}
    return lock


# -- comparison ------------------------------------------------------------------


def compare_fact_fit(
    name: str,
    fact: str,
    fit: Dict[str, Any],
    locked: Dict[str, Any],
    loc: Tuple[str, int],
) -> List[Finding]:
    """Drift report for ONE (entry point, fact) fit against its locked
    entry: a worse class is a scaling regression by name; a better class,
    or exact per-point drift at the same class, is ordinary lock drift."""
    path, lineno = loc
    findings: List[Finding] = []
    old_cls = locked.get("class")
    if old_cls not in CLASS_RANK:
        findings.append(Finding(
            path, lineno, "cost-lock-drift",
            f"{name}: {fact} carries unknown locked class {old_cls!r} — {_REGEN_HINT}",
        ))
        return findings
    new_cls = fit["class"]
    if CLASS_RANK[new_cls] > CLASS_RANK[old_cls]:
        findings.append(Finding(
            path, lineno, "cost-scaling-regression",
            f"{name}: {fact} scaling class WORSENED {old_cls} -> {new_cls} "
            f"(leading coeff {_round_sig(fit['coeff'], 4)}, residual "
            f"{_round_sig(fit['residual'], 3)}) — the entry point now grows "
            f"faster with cluster size than the lock permits",
        ))
        return findings
    if CLASS_RANK[new_cls] < CLASS_RANK[old_cls]:
        findings.append(Finding(
            path, lineno, "cost-lock-drift",
            f"{name}: {fact} scaling class improved {old_cls} -> {new_cls} — {_REGEN_HINT}",
        ))
        return findings
    if fact in EXACT_FACTS and "points" in locked:
        cur_pts = fit.get("points", {})
        for key in sorted(set(cur_pts) | set(locked["points"])):
            if cur_pts.get(key) != locked["points"].get(key):
                findings.append(Finding(
                    path, lineno, "cost-lock-drift",
                    f"{name}: {fact} at ladder point {key}: "
                    f"{locked['points'].get(key)} in the lock, "
                    f"{cur_pts.get(key)} now — {_REGEN_HINT}",
                ))
    return findings


def compare_quiescent(
    current: Dict[str, Dict[str, int]],
    locked: Dict[str, Any],
    lock_path: str,
    release: bool = True,
) -> List[Finding]:
    """Drift report for the ``quiescent_round_cost`` block: reads and
    payload bytes exactly; aten ops and bytes touched within
    QUIESCENT_REL_TOL, and only with ``release`` (the lock's torch
    release)."""
    findings: List[Finding] = []
    for name in sorted(set(current) | set(locked)):
        cur, old = current.get(name), locked.get(name)
        if cur is None or old is None:
            findings.append(Finding(
                lock_path, 1, "cost-quiescent",
                f"quiescent_round_cost: entry point {name} is "
                f"{'missing now' if cur is None else 'not in the lock'} — {_REGEN_HINT}",
            ))
            continue
        for key in QUIESCENT_EXACT:
            if old.get(key) != cur.get(key):
                findings.append(Finding(
                    lock_path, 1, "cost-quiescent",
                    f"quiescent_round_cost: {name} {key} {old.get(key)} in the lock, "
                    f"{cur.get(key)} now — the zero-churn round moved; {_REGEN_HINT}",
                ))
        if not release:
            continue
        for key in QUIESCENT_RELEASE:
            if key in old and key in cur:
                was, now = float(old[key]), float(cur[key])
                if abs(now - was) > QUIESCENT_REL_TOL * max(abs(was), 1.0):
                    findings.append(Finding(
                        lock_path, 1, "cost-quiescent",
                        f"quiescent_round_cost: {name} {key} drifted beyond "
                        f"{QUIESCENT_REL_TOL:.0%}: {old[key]} in the lock, {cur[key]} "
                        f"now — {_REGEN_HINT}",
                    ))
    return findings


def compare_cost_lock(
    fits: Dict[str, Dict[str, Dict[str, Any]]],
    quiescent: Dict[str, Dict[str, int]],
    locked: Dict[str, Any],
    lock_path: str,
    release: bool = True,
) -> List[Finding]:
    """Every fit and the quiescent block against ``locked``; without
    ``release`` the release-bound facts are left out."""
    findings: List[Finding] = []
    locked_eps: Dict[str, Any] = locked.get("entrypoints", {})
    for name in sorted(set(fits) | set(locked_eps)):
        if name not in locked_eps:
            findings.append(Finding(
                lock_path, 1, "cost-lock-drift",
                f"entry point {name} fitted but has no entry in the cost lock — {_REGEN_HINT}",
            ))
            continue
        if name not in fits:
            findings.append(Finding(
                lock_path, 1, "cost-lock-drift",
                f"entry point {name} is in the cost lock but no longer cost-registered — "
                f"{_REGEN_HINT}",
            ))
            continue
        locked_facts = locked_eps[name].get("facts", {})
        for fact in sorted(fits[name]):
            if not release and fact in RELEASE_FACTS:
                continue
            if fact not in locked_facts:
                findings.append(Finding(
                    lock_path, 1, "cost-lock-drift",
                    f"{name}: fact {fact} fitted but absent from the cost lock — {_REGEN_HINT}",
                ))
                continue
            findings.extend(compare_fact_fit(
                name, fact, fits[name][fact], locked_facts[fact], (lock_path, 1),
            ))
    if "quiescent_round_cost" not in locked:
        findings.append(Finding(
            lock_path, 1, "cost-lock-drift",
            f"cost lock carries no quiescent_round_cost block — {_REGEN_HINT}",
        ))
    else:
        findings.extend(compare_quiescent(
            quiescent, locked["quiescent_round_cost"], lock_path, release))
    return findings


def unexplained_findings(refusals, prefix: str = "") -> List[Finding]:
    return [
        Finding(
            COST_LOCK_REL, 1, "cost-unexplained",
            f"{prefix}{name}: {fact} refused to classify — {why}; fix the fact or widen "
            f"the ladder, never guess a class",
        )
        for name, fact, why in refusals
    ]


# -- tree-mode gate ----------------------------------------------------------------


def read_lock() -> Tuple[Optional[Dict[str, Any]], List[Finding]]:
    """The committed cost lock, or the finding that says why it cannot be
    read."""
    lock_path = core.REPO / COST_LOCK_REL
    if not lock_path.exists():
        return None, [Finding(
            COST_LOCK_REL, 1, "cost-lock-drift",
            "cost lockfile missing — generate it via `python -m "
            "rapid_tpu_torch.tools.staticcheck --update-cost-lock`",
        )]
    try:
        return json.loads(lock_path.read_text()), []
    except json.JSONDecodeError as exc:
        return None, [Finding(
            COST_LOCK_REL, 1, "cost-lock-drift",
            f"cost lockfile is not valid JSON ({exc.msg}) — {_REGEN_HINT}",
        )]


def check_lock_against(locked: Dict[str, Any], device: str = "cpu") -> List[Finding]:
    """The ladder and the quiescent block on ``device`` against ``locked``:
    every fact on the CPU under the lock's torch release, the exact facts
    elsewhere."""
    if locked.get("ladder_config") != _ladder_config():
        return [Finding(
            COST_LOCK_REL, 1, "cost-lock-drift",
            f"cost lock ladder_config {locked.get('ladder_config')} does not match the "
            f"registry's {_ladder_config()} — {_REGEN_HINT}",
        )]
    release = device == "cpu" and locked.get("torch_release") == device_program.torch_release()
    facts = None if release else EXACT_FACTS
    fits, refusals = fit_ladder(collect_ladder(device), facts)
    findings = unexplained_findings(refusals)
    findings.extend(superlinear_findings(fits, (COST_LOCK_REL, 1)))
    findings.extend(compare_cost_lock(fits, collect_quiescent_cost(device), locked,
                                      COST_LOCK_REL, release))
    return findings


def check_cost_lock(trees: Sequence[Tuple[ast.AST, str]]) -> List[Finding]:
    """Tree-mode gate the driver runs on full sweeps: fit the ladder (once
    per process) and compare with the committed lock. Presence-gated on
    the engine sources, as the program lock is."""
    rels = {rel.replace("\\", "/") for _, rel in trees}
    if not all(src in rels for src in device_program.REGISTRY_SOURCES):
        return []
    locked, findings = read_lock()
    if locked is None:
        return findings
    return check_lock_against(locked, "cpu")


def update_cost_lock() -> Tuple[List[Finding], Optional[Path]]:
    """Regenerate the cost lockfile from a freshly fitted ladder on the
    CPU. Refuses while any fit is unexplained, any fact exceeds its
    ceiling, or the program lock's differentials (wide<->compact,
    trace-on<->trace-off) disagree. Byte-identical when nothing changed."""
    table = collect_ladder("cpu", force=True)
    quiescent = collect_quiescent_cost("cpu", force=True)
    fits, refusals = fit_ladder(table)
    blocking = unexplained_findings(refusals, "refusing to freeze ")
    blocking.extend(superlinear_findings(fits, (COST_LOCK_REL, 1)))
    for probe in (device_program.compaction_differential_ok,
                  device_program.trace_differential_ok):
        mismatch = probe()
        if mismatch:
            blocking.append(Finding(COST_LOCK_REL, 1, "cost-lock-drift", mismatch))
    if blocking:
        return blocking, None
    lock_path = core.REPO / COST_LOCK_REL
    payload = {
        "_comment": (
            "Fitted scaling classes of the port's registered engine entry points "
            "across the N/K/tenant geometry ladders, measured on the CPU: each "
            "fact's class (O(1)/O(log N)/O(N)/O(N*K)/O(N^2)), leading and model "
            "coefficients, fit residual, and the exact per-point values of the "
            "device-independent facts; plus the zero-churn quiescent_round_cost "
            "block. Generated by `python -m rapid_tpu_torch.tools.staticcheck "
            "--update-cost-lock`; do not edit by hand."
        ),
        **fits_to_lock(fits, quiescent),
    }
    lock_path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return [], lock_path


# -- per-file mode (the seeded corpus) ------------------------------------------------


def _program_key_linenos(tree: ast.AST, marker: str = "COST_AUDIT_PROGRAMS") -> Dict[str, int]:
    """lineno of each string key of the module's ``marker`` dict literal:
    where corpus findings anchor (the ``# expect:`` markers sit there)."""
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == marker
            and isinstance(node.value, ast.Dict)
        ):
            return {
                key.value: key.lineno
                for key in node.value.keys
                if isinstance(key, ast.Constant) and isinstance(key.value, str)
            }
    return {}


def check_cost_model(
    path: Path,
    source: Optional[str] = None,
    tree: "Optional[ast.AST]" = None,
) -> List[Finding]:
    """Corpus mode: run the module's own miniature programs across its
    inline ladder and compare the fitted classes with its inline
    ``COST_LOCK``. A module defines ``COST_AUDIT_PROGRAMS`` (name -> a
    builder taking ``n`` and returning a ``device_program.measure`` spec),
    ``COST_LADDER`` (the n values) and ``COST_LOCK`` (name -> ``{"ceiling",
    "facts": {fact: {"class": ...}}}``; only the facts a lock entry names
    are fitted). Modules without the registry are skipped: this check never
    runs ordinary library files."""
    src = source if source is not None else path.read_text()
    if "COST_AUDIT_PROGRAMS" not in src:
        return []
    if tree is None:
        tree = ast.parse(src, filename=str(path))
    linenos = _program_key_linenos(tree)
    if not linenos:
        return []
    rel = core.rel(path)
    namespace: Dict[str, Any] = {"__name__": f"_cost_corpus_{path.stem}"}
    exec(compile(src, str(path), "exec"), namespace)  # noqa: S102 — the corpus is
    # this repo's own fixture tree; per-file mode runs only on named files.
    programs = namespace["COST_AUDIT_PROGRAMS"]
    locked = namespace.get("COST_LOCK", {})
    ladder = tuple(namespace.get("COST_LADDER", (8, 16, 32, 64)))
    findings: List[Finding] = []
    for name, builder in programs.items():
        loc = (rel, linenos.get(name, 1))
        entry_lock = locked.get(name, {})
        fact_names = sorted(entry_lock.get("facts", {}))
        series = [(n, entry_cost_facts(device_program.measure(builder(n)))) for n in ladder]
        ceiling = entry_lock.get("ceiling", DEFAULT_CEILING)
        for fact in fact_names:
            fitted = fit_scaling(
                [((n, 1), facts[fact]) for n, facts in series],
                FACT_TOLERANCES.get(fact, DEFAULT_TOLERANCE),
            )
            if "error" in fitted:
                findings.append(Finding(
                    *loc, "cost-unexplained", f"{name}: {fact} refused to classify — "
                    f"{fitted['error']}",
                ))
                continue
            if CLASS_RANK[fitted["class"]] > CLASS_RANK[ceiling]:
                findings.append(Finding(
                    *loc, "cost-superlinear",
                    f"{name}: {fact} fitted {fitted['class']} (leading coeff "
                    f"{_round_sig(fitted['coeff'], 4)}) exceeds the entry point's "
                    f"{ceiling} ceiling",
                ))
                continue
            findings.extend(compare_fact_fit(
                name, fact, fitted, entry_lock.get("facts", {}).get(fact, {}), loc,
            ))
    return sorted(set(findings), key=lambda f: (f.lineno, f.check, f.message))
