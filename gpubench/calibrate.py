"""The readings that a cell's limits are set from, on the card, in one process.

    python3 gpubench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 4 [--control N]

For each seed: the cell's set-up and a short window at the cell's own load,
then the numbers of the correctness check for the program (``program``),
and on the first ``--control`` seeds the same numbers for the control, the
model family's plain reference in its lower precision (fp8 convs for the
Dense U-Net) put in the program's place on the same requests (``control``).
One JSON line a seed. The limit of each number lies between the largest program reading
over a dozen seeds or more and the smallest control reading (``PERF.md``
gives both).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", type=int, default=0, metavar="N",
                   help="read the control on the first N seeds")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from gpubench import spec
    from gpubench.loops import LOOPS

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("the calibration runs on a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        loop = LOOPS[cell.traffic["loop"]](cell, seed, args.device)
        loop.setup(args.seconds)
        rec = loop.window(args.seconds, False)
        loop.release()
        row = {"workload": args.workload, "seed": seed, "attempted": rec.attempted,
               "failed": rec.failed, "program": loop.numbers(loop.readings())}
        if i < args.control:
            row["control"] = loop.numbers(loop.control_readings())
        print(json.dumps(row), flush=True)
        del loop
    return 0


if __name__ == "__main__":
    sys.exit(main())
