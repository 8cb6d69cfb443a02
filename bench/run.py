"""One run of one cell of the benchmark of ``repro_torch`` (the PyTorch and
CUDA port) on the card(s) of this machine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Set-up (the cell's data and weights made
from ``--seed`` on the card, the program built, every shape the cell uses
warmed) is timed as ``setup_s``; then the cell's loop drives the program for
``--seconds`` seconds; after the window the program's state is freed and
what the window produced is compared with the plain reference.  The last
lines on standard error are each compared number beside its limit; the last
line on standard output is the result, in JSON.  With ``--trace 1`` the
window runs under the profiler and the result carries the per-layer
metrics, without it the end-to-end ones.

Exits 2 on a bad argument, 3 without enough CUDA devices, 4 when a module
of JAX or of the JAX package is loaded, printing no result in each case.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import harness
    import torch

    try:
        cell = harness.find_cell(args.workload)
    except KeyError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = harness.run_loop(cell, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), device="cuda",
                           t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}, which the benchmark of the "
              f"port must not", file=sys.stderr)
        return 4
    line = harness.result_line(cell, out, trace=bool(args.trace),
                               device_kind=torch.cuda.get_device_name(0),
                               count=chips)
    for name, check in line["checks"].items():
        print(f"check {name}: {check['value']} limit {check['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
