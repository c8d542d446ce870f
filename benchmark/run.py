"""Runs one cell of the benchmark of ``rapid_tpu_torch`` on the CUDA card of
this machine and prints its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Without a CUDA card (or with fewer cards
than the cell asks for) it exits with 2 and prints no result; it never falls
back to the CPU. Build and kernel caches stay inside the checkout
(``.bench_cache/``; the port's own ``rapid_tpu_torch/build/``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def fix_caches() -> None:
    """Every cache the run could write goes to a fixed directory inside the
    checkout, and the host's work to one thread."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["OMP_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    args = parse(argv)
    fix_caches()
    # The checkout's root in place of this script's folder, so that the
    # benchmark's modules import as ``benchmark.*`` and shadow nothing.
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import core

    plan = core.plan(core.load_spec(ROOT), args.workload, ROOT)
    chips = plan.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run = core.measure(plan, args.seed, args.seconds, bool(args.trace), device, T0)
    line = core.result_line(plan, run, bool(args.trace), device)
    found = core.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded forbidden modules: {found}", file=sys.stderr)
        return 3
    for text in core.check_lines(line):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
