"""Run one cell of the benchmark once, on the CUDA card.

    python3 -m fembench.run --workload block3d.solves --seed 1 \\
        --seconds 30 --trace 0

from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared with the reference beside its limit.  The same numbers
are the last lines of standard error.  Without a card (or with fewer
cards than the cell asks for) it prints no result and exits with 2; if
the JAX package or JAX is loaded once the window has closed, with 3.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    ap = argparse.ArgumentParser(prog="fembench.run", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / "build" / "fembench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"

    import torch

    from fembench import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.by_name(bench["workloads"], args.workload, "workload")
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"fembench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              args.trace, torch.device("cuda", 0), T0,
                              root=ROOT)
    bad = harness.forbidden_modules()
    if bad:
        print(f"fembench: modules that must not load were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
