#!/bin/bash
# The port's build gate, as one command: the counterpart of the JAX
# package's tools/check.sh for rapid_tpu_torch. Static checks first (the
# port's AST lint and its resolution tier, program.lock.json included),
# then the port's tests on the CPU. CI or a pre-push hook runs this.
set -euo pipefail
cd "$(dirname "$0")/../.."

echo "== static checks (port AST lint + resolution tier + program-facts lock) =="
# Program-facts regen after an intentional change of what an engine entry
# point does (aten ops, host reads/uploads, collectives, lane bytes, lanes
# in place):
#   python -m rapid_tpu_torch.tools.staticcheck --update-program-lock
# It refuses while the wide<->compact or trace-off<->on differential
# disagrees, a fleet collective crosses tenants, or the zero-churn soak
# counts activity — those must be fixed, never frozen. The cost ladder and
# the dataflow trace regenerate the same way, cost lock first:
#   python -m rapid_tpu_torch.tools.staticcheck --update-cost-lock
#   python -m rapid_tpu_torch.tools.staticcheck --update-dataflow-lock
JAX_PLATFORMS=cpu python -m rapid_tpu_torch.tools.staticcheck
JAX_PLATFORMS=cpu python -m pytest tests/test_torch_staticcheck.py tests/test_torch_lint.py \
  tests/test_torch_cost_model.py tests/test_torch_dataflow.py -q -p no:randomly

echo "== the port's tests (CPU) =="
JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q \
  --ignore=tests/test_torch_staticcheck.py --ignore=tests/test_torch_lint.py \
  --ignore=tests/test_torch_cost_model.py --ignore=tests/test_torch_dataflow.py

echo "ALL PORT CHECKS PASSED"
