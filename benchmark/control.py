"""The control of ``correct``: the reference put in the program's place,
with one guarantee that the configuration states broken. The system states
no precision, so the control is not a lower precision but a broken
guarantee: in each tenant answer, one crash of the request is left
unresolved (the last crashed slot stays a member), and the configuration id
and the K rings follow from that view, as the reference computes them. The
comparison has to find every such answer wrong.

    python3 benchmark/control.py --workload <cell> --seeds <n,n,...> --seconds <s>

runs the cell on the card as ``run.py`` does, once per seed in one process,
at the cell's own size and load, puts the control's answers in place of the
program's, and prints the numbers compared and ``correct`` as one JSON line
per seed. The benchmark's own runs never run it.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_answers(reference, records, answers):
    """Each answer replaced by the control's: the reference's view with the
    last crash of each tenant's churn left in."""
    import numpy as np

    from benchmark.generator import Churn

    out = []
    for record, answer in zip(records, answers):
        rings = "obs_idx" in answer
        lanes = {name: np.array(lane) for name, lane in answer.items()}
        for t, churn in enumerate(record["churn"]):
            view = reference.view(t, Churn(churn.crash[:-1], churn.join), rings)
            lanes["alive"][t] = view["alive"]
            lanes["n_members"][t] = view["alive"].sum()
            lanes["join_pending"][t] = False
            lanes["config_hi"][t], lanes["config_lo"][t] = (
                np.array(view["config_id"], dtype=np.uint32).view(np.int32))
            if rings:
                lanes["obs_idx"][t], lanes["subj_idx"][t] = view["rings"]
        out.append(lanes)
    return out


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description="the control of correct, on the card")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    sys.path[0] = str(ROOT)  # as run.py does
    from benchmark import run

    run.fix_caches()
    import torch

    from benchmark import core

    plan = core.plan(core.load_spec(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        measured = core.measure(plan, seed, args.seconds, False, device, time.perf_counter(),
                                substitute=control_answers)
        line = core.result_line(plan, measured, False, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": line["correct"], "attempted": line["attempted"],
                          "failed": line["failed"], "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
