"""Readings that the limits in ``fembench/limits/`` are set from, on the
card at the cell's own size, in one process:

    python3 -m fembench.calibrate --workload block3d.solves --control

The cell's entry module (``fembench/entries/<entry>.py``) builds the
program and drives its timed call as a run does, and judges the answers
with every number it can read, those that no limit holds included;
with ``--control`` it judges the control (the reference put in the
program's place with its element data computed in bfloat16) on the same
inputs.  Prints one JSON line per reading; the benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness


def emit(**kw):
    print(json.dumps(kw), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fembench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", action="store_true",
                    help="also judge the bfloat16 control")
    ap.add_argument("--grid", type=int, nargs="*", default=None,
                    help="another node grid than the configuration's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fembench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    cell = harness.by_name(bench["workloads"], args.workload, "workload")
    cfg = harness.load_config(bench, cell["config"])
    if args.grid:
        cfg["grid"] = args.grid
    mix = harness.load_mix(cell["traffic"])
    t = time.perf_counter()
    harness.load_entry(mix["entry"]).calibrate(
        cfg, mix, args.control, torch.device("cuda", 0), emit)
    print(f"fembench.calibrate: {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
