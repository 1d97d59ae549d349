"""3D hex8 linear elasticity cantilever (reference examples/block/block.py).

Port of the JAX package's ``examples/block_3d.py``: builds a structured
block mesh, clamps the x=0 face, applies a unit tip force, solves with
CG (or direct/gmres), and writes displacement VTK.

Usage:
    python -m pyfem_gpu_testflight_tpu_torch.examples.block_3d
        [--nx 16 --ny 8 --nz 8] [--method cg] [--vtk block.vtk]
        [--device cpu]
"""

import argparse

import numpy as np

import pyfem_gpu_testflight_tpu_torch as fem


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--ny", type=int, default=8)
    p.add_argument("--nz", type=int, default=8)
    p.add_argument("--method", default="cg", choices=["direct", "cg", "gmres"])
    p.add_argument("--vtk", default="block.vtk")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    creator = fem.ProblemCreator(
        nnodes_x=args.nx, nnodes_y=args.ny, nnodes_z=args.nz,
        element_type="block",
    )
    conn, X, dof_fixed, nodal_force = creator.create_linear_elasticity_problem()
    print(f"nelems={conn.shape[0]} nnodes={X.shape[0]} ndof={3 * X.shape[0]}")

    model = fem.LinearElasticity(
        "hex8", X, conn, dof_fixed, None, nodal_force, device=args.device
    )
    u = model.solve(method=args.method).cpu().numpy()
    ux, uy, uz = u[0::3], u[1::3], u[2::3]
    print(f"max |u| = {np.abs(u).max():.6e}, tip uy = {uy.min():.6e}")
    fem.to_vtk(conn, X, {"ux": ux, "uy": uy, "uz": uz}, args.vtk)
    return u


if __name__ == "__main__":
    main()
