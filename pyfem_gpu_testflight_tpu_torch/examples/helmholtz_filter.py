"""Helmholtz PDE filtering of a checkerboard density field
(reference examples/helmholtz/helmholtz_filter.py), with the integral
preservation check.

Port of the JAX package's ``examples/helmholtz_filter.py``.

Usage:
    python -m pyfem_gpu_testflight_tpu_torch.examples.helmholtz_filter
        [--n 64] [--r0 0.05] [--vtk helmholtz.vtk] [--device cpu]
"""

import argparse

import pyfem_gpu_testflight_tpu_torch as fem


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--r0", type=float, default=0.05)
    p.add_argument("--vtk", default="helmholtz.vtk")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    creator = fem.ProblemCreator(nnodes_x=args.n, nnodes_y=args.n,
                                 element_type="quad")
    conn, X, x = creator.create_helmholtz_problem()
    filtr = fem.Helmholtz(args.r0, "quad4", X, conn, device=args.device)
    rho = filtr.apply(x).cpu().numpy()

    R = filtr.assemble_scipy(filtr.Re)
    before, after = R.dot(x).sum(), R.dot(rho).sum()
    rel = abs(after - before) / before
    print(f"field integral before {before:.8e} after {after:.8e} "
          f"(rel change {rel:.2e})")
    fem.to_vtk(conn, X, {"x": x, "rho": rho}, args.vtk)
    return rel


if __name__ == "__main__":
    main()
