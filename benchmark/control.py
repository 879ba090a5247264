"""The control of the comparison that decides `correct`: the reference, put
in the program's place and computed one precision below the one the
configurations state (every contraction that carries coordinates or
covariance in TF32; the voxel centroids summed in float32 instead of
float64), must come out as not correct.

    python3 -m benchmark.control --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

runs each seed as the benchmark does (set-up, a window at the cell's own
load and size), then compares the control, from the same program states
and inputs, with the reference; it prints one JSON line per seed with
every number beside its limit; with `--program` the program takes its
place, as in the benchmark (the readings the limits' lower ends come
from).  The benchmark's own runs never run it.  The CPU tests run the
control at a tiny size (benchmark/tests/test_cell_harness.py).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

from benchmark.host import pin_one_core  # noqa: E402

CORE = pin_one_core()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true",
                    help="compare the program, as the benchmark does")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    torch.set_num_threads(1)

    for seed in args.seeds:
        out = harness.run_cell(os.getcwd(), args.workload, seed,
                               args.seconds, False, "cuda",
                               control=not args.program)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "program" if args.program else "control",
                          "correct": out["correct"],
                          "checks": out["checks"],
                          "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
