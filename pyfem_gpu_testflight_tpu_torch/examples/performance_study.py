"""Element-Jacobian assembly timing sweep
(reference examples/SciTech2023/performance/performance_test.py).

Port of the JAX package's ``examples/performance_study.py``: times the
batched element-stiffness assembly for {elasticity, helmholtz, poisson}
on hex8 (or tet10/brick20) meshes of increasing size and reports a
table.  ``--kernel cuda`` takes the hand-written element-stiffness
kernel K8 for elasticity and Poisson (float32), ``einsum`` the einsum
path.  On a CUDA device each row is the mean of ``--repeats`` calls
timed by CUDA events after a warm-up call and a synchronize, and the
card's name and power limit are printed beside the rows; on the CPU
(``--device cpu``, the kernels' plain versions) the rows are host-clock
times and say so.

Usage:
    python -m pyfem_gpu_testflight_tpu_torch.examples.performance_study
        [--sizes 8 16 24 32] [--kernel cuda] [--etype hex8] [--device cpu]
"""

import argparse
import json
import subprocess
import time

import torch

import pyfem_gpu_testflight_tpu_torch as fem
from pyfem_gpu_testflight_tpu_torch.device import resolve_device
from pyfem_gpu_testflight_tpu_torch.ops import stiffness

_MESH_ET = {"hex8": "block", "tet10": "tet", "brick20": "brick20"}


def build(n, problem, dtype, kernel="einsum", etype="hex8", device=None):
    creator = fem.ProblemCreator(nnodes_x=n, nnodes_y=n, nnodes_z=n,
                                 element_type=_MESH_ET[etype])
    conn, X, dof_fixed = creator.create_poisson_problem()
    if problem == "elasticity":
        model = fem.LinearElasticity(etype, X, conn, [], None, {},
                                     dtype=dtype, kernel=kernel,
                                     device=device)
    elif problem == "helmholtz":
        model = fem.Helmholtz(0.05, etype, X, conn, dtype=dtype,
                              device=device)
    else:
        model = fem.LinearPoisson(etype, X, conn, [], dtype=dtype,
                                  kernel=kernel, device=device)
    return model


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_call(run, repeats, device):
    """Mean seconds per call after one warm-up call: CUDA events on a
    CUDA device, the host clock around synchronous calls on the CPU."""
    run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(repeats):
            run()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / 1e3 / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        run()
    return (time.perf_counter() - t0) / repeats


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", type=int, nargs="+", default=[8, 16, 24, 32])
    p.add_argument("--problems", nargs="+",
                   default=["poisson", "helmholtz", "elasticity"])
    p.add_argument("--dtype", default="float32")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--kernel", choices=["einsum", "cuda"], default="einsum",
                   help="model-level element kernel (cuda = kernel K8, the "
                        "A2DWrapper role extended to tet10/brick20)")
    p.add_argument("--etype", choices=["hex8", "tet10", "brick20"],
                   default="hex8",
                   help="element type for the sweep (tet10/brick20 need "
                        "odd node counts)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    on = card_line() if device.type == "cuda" else "cpu (host clock)"
    rows = []
    for problem in args.problems:
        for n in args.sizes:
            kern = args.kernel if problem != "helmholtz" else "einsum"
            model = build(n, problem, dtype, kernel=kern, etype=args.etype,
                          device=device)
            rho = torch.ones((model.nnodes,), dtype=dtype, device=device)

            if problem == "helmholtz":
                kq = torch.ones((model.nelems, model.nquads), dtype=dtype,
                                device=device)

                def run():
                    return (stiffness.poisson_stiffness(
                        model.Xe, model.dN, model.wq, kq)
                        + stiffness.mass_matrix(model.Xe, model.dN,
                                                model.N, model.wq))
            else:
                def run():
                    return model.element_jacobian(rho)

            dt = time_call(run, args.repeats, device)
            rows.append(
                {"problem": problem, "kernel": kern,
                 "etype": args.etype, "n": n, "ndof": model.ndof,
                 "nelems": model.nelems, "t_ke_s": dt,
                 "elems_per_s": model.nelems / dt, "on": on}
            )
            print(json.dumps(rows[-1]))

    print(f"\nsummary (elements/second, {on}):")
    for r in rows:
        print(f"  {r['problem']:>10s} n={r['n']:3d} ndof={r['ndof']:9d} "
              f"{r['elems_per_s']:.3e} elem/s")
    return rows


if __name__ == "__main__":
    main()
