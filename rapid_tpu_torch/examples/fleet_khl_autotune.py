"""Per-tenant K/H/L knob autotune over a tenant fleet: one sweep, one
dispatch per round.

The port's counterpart of the JAX package's
``examples/fleet_khl_autotune.py``, with its arguments and its JSON lines.
``khl_sensitivity`` sweeps (H, L) one engine run per cell; this example runs
the whole candidate grid as ONE :class:`~rapid_tpu_torch.tenancy.TenantFleet`
(one tenant per knob setting, identical scenario) and picks the winner with
the khl_sensitivity conflict metric as the objective
(``rapid_tpu_torch.tenancy.autotune.sweep_khl``).

JAX's ``--platform`` is replaced by ``--device`` (CUDA unless another device
is named; CUDA without a card raises).

Usage:

    python -m rapid_tpu_torch.examples.fleet_khl_autotune [--n 1000] [--f 8] \\
        [--knobs 9/4,8/3,7/2] [--spread 8] [--seeds 0]

Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from rapid_tpu_torch import _cli


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=1000)
    parser.add_argument("--f", type=int, default=8,
                        help="simultaneous failures per scenario")
    parser.add_argument("--knobs", default="9/4,8/3,7/2,6/2,5/1",
                        help="comma-separated H/L candidates, one tenant each")
    parser.add_argument("--cohorts", type=int, default=16)
    parser.add_argument("--spread", type=int, default=8,
                        help="delivery-delay support (rounds): the skew that "
                        "makes low H conflict-prone")
    parser.add_argument("--seeds", default="0",
                        help="comma-separated scenario seeds, one sweep each")
    _cli.add_device_argument(parser)
    args = parser.parse_args(argv)
    device = _cli.device_of(args)

    from rapid_tpu_torch.tenancy.autotune import sweep_khl

    knob_grid = [
        tuple(int(part) for part in cell.split("/"))
        for cell in args.knobs.split(",")
    ]
    for seed in (int(s) for s in args.seeds.split(",")):
        result = sweep_khl(
            n=args.n, f=args.f, knob_grid=knob_grid, cohorts=args.cohorts,
            seed=seed, delivery_spread=args.spread, device=device,
        )
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_cli.run_main(main))
