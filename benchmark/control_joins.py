"""The control of ``correct`` for a cell whose requests carry joins, as
``benchmark/control.py`` is for crashes (which leaves a crash unresolved, and
so breaks no guarantee of a request that crashes nothing): the reference put
in the program's place, with one joiner of each tenant answer left out and
still pending, and the configuration id and the K rings following from that
view, as the reference computes them. The comparison has to find every such
answer wrong.

    python3 benchmark/control_joins.py --workload <cell> --seeds <n,n,...> --seconds <s>

runs as ``control.py`` does, with these answers in place of the program's.
The benchmark's own runs never run it.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_answers(reference, records, answers):
    """Each answer replaced by the control's: the reference's view with the
    last joiner of each tenant's churn left out, and pending."""
    import numpy as np

    from benchmark.generator import Churn

    out = []
    for record, answer in zip(records, answers):
        rings = "obs_idx" in answer
        lanes = {name: np.array(lane) for name, lane in answer.items()}
        for t, churn in enumerate(record["churn"]):
            view = reference.view(t, Churn(churn.crash, churn.join[:-1]), rings)
            lanes["alive"][t] = view["alive"]
            lanes["n_members"][t] = view["alive"].sum()
            lanes["join_pending"][t] = False
            lanes["join_pending"][t][churn.join[-1:]] = True
            lanes["config_hi"][t], lanes["config_lo"][t] = (
                np.array(view["config_id"], dtype=np.uint32).view(np.int32))
            if rings:
                lanes["obs_idx"][t], lanes["subj_idx"][t] = view["rings"]
        out.append(lanes)
    return out


def main(argv=None) -> int:
    sys.path[0] = str(ROOT)  # as run.py does
    from benchmark import control

    # control.main with these answers in the place of its own.
    crash_answers, control.control_answers = control.control_answers, control_answers
    try:
        return control.main(argv)
    finally:
        control.control_answers = crash_answers


if __name__ == "__main__":
    sys.exit(main())
