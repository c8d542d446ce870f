"""The port's static gate, as a command line: the counterpart of the JAX
package's ``tools/staticcheck.py`` over ``rapid_tpu_torch/tools/analysis/``
(see its docstring for the families, or ``--families``).

    python -m rapid_tpu_torch.tools.staticcheck [--json] [--select CHECKS]
        [--ignore CHECKS] [--families] [--update-wire-lock]
        [--update-program-lock] [--update-cost-lock]
        [--update-dataflow-lock] [paths...]

With no paths it sweeps the port's tree (``rapid_tpu_torch``, the port's
tests, ``chip_smoke.py`` and ``mesh_smoke.py``) and exits 1 on any finding.
``--update-program-lock`` reruns the registered engine entry points on the
CPU and rewrites ``program.lock.json``; ``--update-cost-lock`` refits the
geometry ladder into ``cost.lock.json``; ``--update-dataflow-lock``
retraces the entry points into ``dataflow.lock.json``.
"""

from __future__ import annotations

import sys

from rapid_tpu_torch.tools.analysis.core import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
