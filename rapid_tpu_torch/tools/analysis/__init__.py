"""The port's static-analysis tier: the counterpart of the JAX package's
``tools/analysis/``, pointed at the port's own source.

The reference fails its build on error-prone (-Werror), findbugs and
checkstyle findings; ``tests/test_torch_lint.py`` is the port's AST style
gate and this package plays the error-prone role — the checks that need
RESOLUTION, not just syntax. It is built on the stdlib (``ast``,
``symtable``, ``inspect``), imports nothing of the JAX package (it keeps
its own copies of what it needs, as the port's other tools do), and
imports torch only in the families that run the engine (``device_program``,
``cost_model``, ``dataflow``), lazily.

Check families (one module each; ``core`` owns the driver/CLI/Finding),
over the roots ``rapid_tpu_torch``, ``tests/test_torch_*.py``,
``tests/torch_mesh_jobs.py``, ``chip_smoke.py`` and ``mesh_smoke.py``:

1. ``names``          — undefined names (symtable scope resolution)
2. ``signatures``     — call-signature conformance vs imported runtime
                        modules
3. ``deadcode``       — dead module-level definitions (tree-wide liveness)
4. ``clocks``         — clock-injection discipline (protocol, monitoring,
                        serving)
5. ``concurrency``    — asyncio guarded-by discipline, interleaving
                        hazards, lock re-entrancy (protocol + messaging)
6. ``taskflow``       — async failure-path hygiene (whole library)
7. ``determinism``    — no unseeded randomness in the library
8. ``dispatch``       — RapidRequest dispatch exhaustiveness, shadowed
                        arms, response return types (protocol)
9. ``wire_schema``    — the three hand-kept wire mirrors cross-checked and
                        frozen in ``wire.lock.json`` (equal to JAX's: both
                        packages speak the same bytes)
10. ``ledger``        — run-ledger vocabulary discipline
11. ``chaosvocab``    — chaos vocabulary discipline
12. ``telemetry``     — the telemetry plane's lane mirrors and marked
                        fetches
13. ``sharding``      — partition-rule coverage, dtype-widening, and host
                        syncs (torch spellings) in the hot set and the
                        streaming pipeline
14. ``sync_safety``   — the counterpart of JAX's ``trace_safety``: what
                        jit purity is to a traced program, sync safety is
                        to an eager one (uncounted blocking reads, stores
                        through advanced indexing, pageable uploads,
                        tensors built with no device)
15. ``device_program``— the program facts of the registered engine entry
                        points, frozen in ``program.lock.json``
16. ``cost_model``    — the entry points' facts fitted to scaling classes
                        across N/K/tenant ladders, with the quiescent
                        round's cost, frozen in ``cost.lock.json``
17. ``dataflow``      — lane provenance from a dispatch trace: observer
                        silence, tenant isolation and the
                        sparse-opportunity map, frozen in
                        ``dataflow.lock.json``

``staticcheck --families`` prints this catalog; ``--update-wire-lock`` /
``--update-program-lock`` / ``--update-cost-lock`` /
``--update-dataflow-lock`` regenerate the lockfiles after an intentional
change.

Shared philosophy: conservative resolution, zero-false-positive findings,
skip-don't-guess. Run via ``python -m rapid_tpu_torch.tools.staticcheck``
or the gate in ``tests/test_torch_staticcheck.py``.
"""

from __future__ import annotations

from .core import ALL_CHECK_NAMES, DEFAULT_ROOTS, FAMILIES, Finding, iter_files, main, run

__all__ = [
    "ALL_CHECK_NAMES",
    "DEFAULT_ROOTS",
    "FAMILIES",
    "Finding",
    "iter_files",
    "main",
    "run",
]
