"""The readings that a cell's limits are set from, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 12 --control fp8 --control-seeds 3 --seconds 2

For each seed, the cell runs as ``portbench.run`` does (set-up, a short
window at the cell's own sizes and load, the release) and its numbers
compared are read against the float32 reference: the program's readings.
On the first ``--control-seeds`` of them the reference computed in the
``--control`` precision (the step below the configuration's: fp8 for bf16,
tf32 for float32) stands in the program's place: the control's readings.
One JSON line a reading; the last line sums them up, with the largest
program reading and the smallest control reading of each number.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=3_000_000_001)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", default=None, choices=("fp8", "tf32"))
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    program, control = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        scratch = harness.scratch_dir()
        try:
            run = harness.make_run(args.workload, seed, args.seconds, False, "cuda", scratch, fault=args.fault)
            ent = harness.entry(run.workload["entry"])
            if i == 0:
                harness.build_kernels(run.device)
            cell = ent.setup(run)
            win = ent.window(run, cell)
            outputs = ent.release(run, cell)
            del cell
            t = time.perf_counter()
            got = ent.check(run, outputs, "fp32")
            check_s = time.perf_counter() - t
            line = {"seed": seed, "side": "program", "units": win.units, "window_s": win.seconds,
                    "check_s": check_s, **got}
            print(json.dumps(line), flush=True)
            for k, v in got.items():
                program.setdefault(k, []).append(v)
            if args.control and i < args.control_seeds:
                got = ent.check(run, outputs, "fp32", control=args.control)
                print(json.dumps({"seed": seed, "side": args.control, **got}), flush=True)
                for k, v in got.items():
                    control.setdefault(k, []).append(v)
        finally:
            harness.remove(scratch)
    summary = {"workload": args.workload, "program_max": {k: max(v) for k, v in program.items()},
               "program": program, "control_min": {k: min(v) for k, v in control.items()}, "control": control}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
