"""Topology optimization example
(reference examples/topology_optimization/topo.py + topo_heat.py).

Port of the JAX package's ``examples/topo.py``: Helmholtz-filtered RAMP
compliance minimization with a volume constraint, driven by the
package's MMA optimizer.  Supports the elasticity and thermal problems
on quad/tri/block meshes, with design-history VTKs, checkpoints and a
final result.vtk.  On structured quad/block meshes the filter runs on
stencil planes (kernel K9 in 2D), and ``--solver gmg`` solves the state
with the structured V-cycle (kernels K1 and K2 in 2D) in float32, the
precision those kernels take (bench topo's); the other solvers run in
float64.  On a CUDA device the hand-written kernels run, on the CPU
their plain versions.

Usage:
    python -m pyfem_gpu_testflight_tpu_torch.examples.topo
        [--problem elasticity] [--element_type quad] [--solver gmg]
        [--max_iterations 200] [--prefix results] [--device cpu]
"""

import argparse

import torch

import pyfem_gpu_testflight_tpu_torch as fem
from pyfem_gpu_testflight_tpu_torch.opt import TopoProblem, optimize_topology


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--problem", choices=["elasticity", "thermal"],
                   default="elasticity")
    p.add_argument("--element_type", choices=["quad", "tri", "block"],
                   default="quad")
    p.add_argument("--r0", type=float, default=0.01, help="filter radius")
    p.add_argument("--prefix", default="results",
                   help="directory of the checkpoint and the VTK files")
    p.add_argument("--max_iterations", type=int, default=200)
    p.add_argument("--fixed_volume", type=float, default=0.4)
    p.add_argument("--solver", default="cg",
                   choices=["direct", "cg", "gmres", "gmg"])
    p.add_argument("--timer_threshold", type=float, default=10.0)
    p.add_argument("--nx", type=int, default=None,
                   help="nodes in x (default 128 in 2D, 64 in 3D)")
    p.add_argument("--ny", type=int, default=None,
                   help="nodes in y (default 64 in 2D, 32 in 3D)")
    p.add_argument("--nz", type=int, default=None,
                   help="nodes in z (3D; default 32)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    fem.timer_set_threshold(args.timer_threshold)

    if args.element_type in ("quad", "tri"):
        dims = (args.nx or 128, args.ny or 64)
    else:
        dims = (args.nx or 64, args.ny or 32, args.nz or 32)
    creator = fem.ProblemCreator(*dims, element_type=args.element_type)
    dtype = torch.float32 if args.solver == "gmg" else torch.float64

    if args.problem == "elasticity":
        conn, X, dof_fixed, nodal_force = (
            creator.create_linear_elasticity_problem()
        )
        model = fem.LinearElasticity(
            args.element_type, X, conn, dof_fixed, None, nodal_force, p=5.0,
            dtype=dtype, device=args.device,
        )
    else:
        conn, X, dof_fixed = creator.create_poisson_problem()
        model = fem.LinearPoisson(
            args.element_type, X, conn, dof_fixed,
            gfunc=lambda x: 1.0 + 0.0 * x[..., 0], p=5.0,
            dtype=dtype, device=args.device,
        )

    filtr = fem.Helmholtz(args.r0, args.element_type, X, conn, dtype=dtype,
                          device=args.device)
    # stencil fast path for the two filter solves per MMA iteration
    if args.element_type != "tri":
        filtr.attach_structured_grid(*dims)

    if args.solver == "gmg":
        if args.element_type == "tri":
            raise ValueError("gmg solver requires structured quad/hex grids")
        model.attach_structured_grid(*dims)

    prob = TopoProblem(model, filtr, fixed_volume=args.fixed_volume,
                       solver=args.solver)
    if dtype == torch.float64:
        prob.checkGradients()
    else:
        # finite differences of a float32 compliance read its rounding,
        # not its slope (1.43 against an analytic 0.236 at 65x33, dh 1e-2)
        print("[checkGradients] not run: the float32 objective's finite "
              "differences are rounding noise")

    x, rho = optimize_topology(
        model, filtr,
        fixed_volume=args.fixed_volume,
        max_iterations=args.max_iterations,
        prefix=args.prefix,
        solver=args.solver,
        save_history=args.element_type != "block",
    )
    vol = float(model.volume(rho))
    print(f"final volume fraction: {vol:.4f}")
    print(f"results in {args.prefix}/result.vtk")
    return vol


if __name__ == "__main__":
    main()
