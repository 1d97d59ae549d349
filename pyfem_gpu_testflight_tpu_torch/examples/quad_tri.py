"""2D Poisson on quad vs tri meshes (reference examples/triangle/quad_tri.py).

Port of the JAX package's ``examples/quad_tri.py``: solves the same
Poisson problem on a quad4 and a tri3 mesh and compares the solutions
where they share nodes.

Usage:
    python -m pyfem_gpu_testflight_tpu_torch.examples.quad_tri
        [--n 32] [--method cg] [--out-dir .] [--device cpu]
"""

import argparse
import os

import numpy as np

import pyfem_gpu_testflight_tpu_torch as fem


def gfunc(x):
    return x[..., 0] * (x[..., 0] - 5.0) * (x[..., 0] - 10.0) * x[..., 1] * (
        x[..., 1] - 4.0
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--method", default="cg", choices=["direct", "cg", "gmres"])
    p.add_argument("--out-dir", default=".",
                   help="directory of poisson_quad.vtk and poisson_tri.vtk")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    sols = {}
    for etype in ("quad", "tri"):
        creator = fem.ProblemCreator(nnodes_x=args.n, nnodes_y=args.n,
                                     element_type=etype)
        conn, X, dof_fixed = creator.create_poisson_problem()
        model = fem.LinearPoisson(etype, X, conn, dof_fixed, gfunc=gfunc,
                                  device=args.device)
        u = model.solve(method=args.method).cpu().numpy()
        sols[etype] = u
        fem.to_vtk(conn, X, {"u": u},
                   os.path.join(args.out_dir, f"poisson_{etype}.vtk"))
        print(f"{etype}: max |u| = {np.abs(u).max():.6e}")

    # same node grid -> element-type discretization difference only
    diff = np.abs(sols["quad"] - sols["tri"]).max()
    print(f"max |u_quad - u_tri| = {diff:.3e} (discretization difference)")
    return sols


if __name__ == "__main__":
    main()
