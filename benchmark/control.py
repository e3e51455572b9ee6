"""The control of a cell's comparison: the reference computed in the
nearest precision below the configuration's (fp8 GEMM operands for the
bf16 model, bf16 for the fp32 solver) stands in the program's place and
is judged by the same numbers and limits; it has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        [--seconds 1]

Runs on the card at the cell's own size, every seed in one process, with
a short window (the last step's checks read the program's own state);
prints one JSON line per seed with its readings. The benchmark's runs
never run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".")
                        != HERE]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("error: the control runs on the card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(cell, seed, args.seconds, False,
                               torch.device("cuda", 0), control=True)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control_correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
