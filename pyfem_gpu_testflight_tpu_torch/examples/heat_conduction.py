"""Heat conduction with uniform source (reference
examples/heat_conduction.py).

Port of the JAX package's ``examples/heat_conduction.py``.

Usage:
    python -m pyfem_gpu_testflight_tpu_torch.examples.heat_conduction
        [--nx 64 --ny 64 [--nz N]] [--method cg] [--vtk heat.vtk]
        [--device cpu]
"""

import argparse

import pyfem_gpu_testflight_tpu_torch as fem


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=64)
    p.add_argument("--ny", type=int, default=64)
    p.add_argument("--nz", type=int, default=None)
    p.add_argument("--method", default="cg", choices=["direct", "cg", "gmres"])
    p.add_argument("--vtk", default="heat.vtk")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    etype = "quad" if args.nz is None else "block"
    creator = fem.ProblemCreator(
        nnodes_x=args.nx, nnodes_y=args.ny, nnodes_z=args.nz,
        element_type=etype,
    )
    conn, X, dof_fixed = creator.create_poisson_problem()
    model = fem.LinearPoisson(
        etype, X, conn, dof_fixed, gfunc=lambda x: 1.0 + 0.0 * x[..., 0],
        device=args.device,
    )
    T = model.solve(method=args.method).cpu().numpy()
    print(f"max T = {T.max():.6e}")
    fem.to_vtk(conn, X, {"T": T}, args.vtk)
    return T


if __name__ == "__main__":
    main()
