"""Newton solve of the nonlinear Poisson problem
(reference examples/nonlinear_poisson/nonlinear_poisson_ex.py).

Port of the JAX package's ``examples/nonlinear_poisson_ex.py``.

Usage:
    python -m pyfem_gpu_testflight_tpu_torch.examples.nonlinear_poisson_ex
        [--n 32] [--ndv 10] [--method gmres] [--vtk nonlinear_poisson.vtk]
        [--device cpu]
"""

import argparse

import numpy as np

import pyfem_gpu_testflight_tpu_torch as fem


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--ndv", type=int, default=10)
    p.add_argument("--method", default="gmres", choices=["direct", "cg", "gmres"])
    p.add_argument("--vtk", default="nonlinear_poisson.vtk")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    creator = fem.ProblemCreator(nnodes_x=args.n, nnodes_y=args.n)
    conn, X, dof_fixed = creator.create_poisson_problem()
    model = fem.NonlinearPoisson("quad4", X, conn, dof_fixed,
                                 device=args.device)

    xdv = np.ones(args.ndv) / args.ndv
    u = model.solve_nonlinear(method=args.method, xdv=xdv).cpu().numpy()
    print(f"max |u| = {np.abs(u).max():.6e}")
    fem.to_vtk(conn, X, {"u": u}, args.vtk)
    return u


if __name__ == "__main__":
    main()
