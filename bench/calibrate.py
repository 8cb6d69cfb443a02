"""Readings from which a cell's limits are set: for each seed, the numbers
the comparison computes for the program and for the control (the plain
reference in the precision below the configuration's, put in the
program's place), at the cell's own sizes and load, in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 10 \
        [--control 0]

Prints one JSON line a seed: the program's numbers, the control's (none
with ``--control 0``), the end-to-end values of the short window and the
seconds the run took.  The benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.join(os.path.dirname(HERE), "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import harness
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.find_cell(args.workload)
    kind = torch.cuda.get_device_name(0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = harness.run_loop(cell, seed=seed, seconds=args.seconds,
                               trace=False, device="cuda", t_start=t,
                               control=bool(args.control))
        print(json.dumps({"seed": seed, "device": kind,
                          "program": out.numbers, "control": out.control,
                          "end_to_end": out.end_to_end,
                          "memory_peak_bytes": out.memory_peak_bytes,
                          "run_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
