"""The control's readings, that the upper ends of ``correct``'s limits are
set from: many seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 [--controls tf32,cublas_tf32]

For each seed and control, the run's own check (``harness.check``) on the
cell's compared captures, with the plain reference computed in the
control's precision put in the program's place: one line a seed and
control, with ``correct`` as a run would report it (it has to be false)
and the captures that differ most. The program's own readings are those of
the benchmark's runs, which print them. The benchmark's runs never call
this; it needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", default="tf32,cublas_tf32", help="comma-separated precisions of channel.mm")
    args = ap.parse_args(argv)

    import torch

    from portbench import compare, harness

    cell = harness.find_cell(harness.load_bench(), args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in args.controls.split(","):
            t = time.perf_counter()
            v = harness.check(cell, seed, dev, [], control=control)
            shares = compare.byte_shares(v.answers[0], v.ref)
            worst = [(int(v.idx[i]), float(shares[i])) for i in shares.argsort()[::-1][:4] if shares[i] > 0]
            print(json.dumps({"workload": args.workload, "seed": seed, "control": control, "correct": v.failed == 0,
                              "checks": v.checks, "captures_differing": int((shares > 0).sum()),
                              "compared": len(v.idx), "worst_captures": worst,
                              "seconds": round(time.perf_counter() - t, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # import as portbench.*
    sys.exit(main())
