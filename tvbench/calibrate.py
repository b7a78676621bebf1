"""The runs that set the benchmark's limits and rates; the benchmark's
own runs never make them.

    python3 tvbench/calibrate.py --workload <cell> --seed <n> --seconds <s>
        [--qp-delta 1] [--rate <frames/s>]

`--qp-delta 1` is the control of `correct`: the program quantises one
QP step coarser than the configuration states (its own setting), and the
reference still holds it to the configured QP; the run must come out not
correct. `--rate` replaces the mix's arrival rate (the sweep that finds
the live cell's knee). Prints the result line, as run.py does.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tvbench import harness  # noqa: E402
from tvbench.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--qp-delta", type=int, default=0)
    ap.add_argument("--rate", type=float, default=None)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    spec = harness.cell_spec(bench, args.workload)
    program = {}
    if args.qp_delta:
        program["qp"] = int(spec["config"]["settings"]["qp"]) + args.qp_delta
    traffic = {"rate_fps": args.rate} if args.rate else {}
    out = run_cell(bench, args.workload, args.seed, args.seconds, False,
                   "cuda", T_START, program=program, traffic=traffic)
    out["info"]["program"] = program
    out["info"]["traffic"] = traffic
    print(json.dumps(out), flush=True)
    for line in harness.compared_lines(out["compared"]):
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
