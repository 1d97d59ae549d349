"""3D unstructured topology optimization: C3D10 .inp -> AMG -> MMA.

Port of the JAX package's ``examples/bracket3d_topo.py``, the 3D
analogue of ``torque_arm_topo``, on the element type the reference can
parse (C3D10, parse_inp.py:31-35) but ships no example for:

    synthesize/parse a C3D10 .inp (ten-node tets, smoothly distorted
    so the geometry is genuinely non-uniform)
      -> LinearElasticity(tet10, RAMP p=3)
      -> cached smoothed-aggregation AMG state solves with the 6-mode
         rigid-body near-nullspace (unstructured.rigid_body_modes nd=3:
         3 translations + 3 rotations)
      -> unstructured Helmholtz filter (tet10 element assembly + CG)
      -> MMA -> design VTK.

Usage:
    python -m pyfem_gpu_testflight_tpu_torch.examples.bracket3d_topo
        [--inp mesh.inp] [--n 9] [--iters 20] [--vol 0.4] [--r0 0.15]
        [--prefix results] [--device cpu]
"""

import argparse
import os

import numpy as np
import torch

import pyfem_gpu_testflight_tpu_torch as fem
from pyfem_gpu_testflight_tpu_torch.opt import MMA, TopoProblem


def synthesize_bracket_inp(path, n=9, distort=0.12, nx=None):
    """Write a C3D10 cantilever-bracket mesh in Abaqus .inp format.

    A (2n-1, n, n)-node tet10 block (6 tets per 2x2x2 super-cell,
    mesh.py creator node ordering == the Abaqus C3D10 corner+mid-edge
    convention: edges 1-2, 2-3, 3-1, 1-4, 2-4, 3-4) is smoothly
    distorted — a sinusoidal coordinate map applied to every node keeps
    mid-edge nodes consistent with their edges and Jacobians positive
    while removing all grid uniformity.  NSETs: ``fixed`` = the x=0
    face, ``load`` = the free-end bottom edge.
    """
    nx, ny, nz = (nx or 2 * n - 1), n, n
    creator = fem.ProblemCreator(nnodes_x=nx, nnodes_y=ny, nnodes_z=nz,
                                 Lx=2.0 * (nx - 1) / (2 * (n - 1)),
                                 Ly=1.0, Lz=1.0,
                                 element_type="tet")
    conn, X, _, _ = creator.create_linear_elasticity_problem()
    X = np.asarray(X, float).copy()
    Lx, Ly, Lz = X[:, 0].max(), X[:, 1].max(), X[:, 2].max()
    # smooth distortion: zero on the fixed face and at the load edge's
    # extreme so BC geometry stays clean
    sx = np.sin(np.pi * X[:, 0] / Lx) * np.sin(np.pi * X[:, 1] / Ly)
    sz = np.sin(np.pi * X[:, 2] / Lz)
    X[:, 1] += distort * (Ly / (n - 1)) * sx * np.cos(
        2.5 * X[:, 2] / Lz
    ) * (n - 1) * 0.35
    X[:, 2] += distort * (Lz / (n - 1)) * sz * np.sin(
        1.7 * X[:, 0] / Lx
    ) * (n - 1) * 0.35

    fixed = np.where(np.abs(X[:, 0]) < 1e-12)[0]
    load = np.where(
        (np.abs(X[:, 0] - Lx) < 1e-12) & (np.abs(X[:, 1]) < 1e-12)
    )[0]

    conn = np.asarray(conn)
    with open(path, "w") as fh:
        fh.write("*Heading\n** synthesized C3D10 cantilever bracket\n")
        fh.write("*NODE\n")
        for i, (x, y, z) in enumerate(X):
            fh.write(f"{i + 1}, {x:.9f}, {y:.9f}, {z:.9f}\n")
        fh.write("*ELEMENT, type=C3D10\n")
        for i, row in enumerate(conn):
            fh.write(
                f"{i + 1}, " + ", ".join(str(v + 1) for v in row) + "\n"
            )
        fh.write("*NSET, nset=fixed\n")
        fh.write(", ".join(str(v + 1) for v in fixed) + "\n")
        fh.write("*NSET, nset=load\n")
        fh.write(", ".join(str(v + 1) for v in load) + "\n")
    return path


def bracket_model(inp_path, device=None, **model_kw):
    """(LinearElasticity, X, conn) for a bracket .inp: C3D10 elements, the
    ``fixed`` face clamped, a unit force in -y on each ``load`` node, and
    ``amg_options = {"max_offsets": 8192}`` (3D quadratic node graphs
    keep thousands of diagonals after RCM banding)."""
    conn_dict, X, groups = fem.InpParser(inp_path).parse()
    conn, _ = fem.fix_orientation(conn_dict["C3D10"], X)
    dof_fixed = []
    for nd_ in groups["fixed"]:
        dof_fixed.extend([3 * int(nd_) + c for c in range(3)])
    nodal_force = {int(nd_): [0.0, -1.0, 0.0] for nd_ in groups["load"]}
    model = fem.LinearElasticity("tet10", X, conn, dof_fixed, None,
                                 nodal_force, device=device, **model_kw)
    model.amg_options = {"max_offsets": 8192}
    return model, X, conn


def build_problem(inp_path, r0=0.15, vol=0.4, rtol=1e-8, device=None,
                  dtype=torch.float64):
    """(TopoProblem, model, filtr, conn, X) for a C3D10 .inp."""
    model, X, conn = bracket_model(inp_path, device=device, p=3.0,
                                   dtype=dtype)
    filtr = fem.Helmholtz(r0, "tet10", X, conn, rtol=rtol, dtype=dtype,
                          device=device)
    prob = TopoProblem(model, filtr, fixed_volume=vol, solver="amg")
    return prob, model, filtr, conn, X


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--inp", default=None,
                    help="Abaqus .inp with C3D10 elements and "
                         "fixed/load NSETs (default: synthesized)")
    ap.add_argument("--n", type=int, default=9)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--vol", type=float, default=0.4)
    ap.add_argument("--r0", type=float, default=0.15)
    ap.add_argument("--prefix", default="results_bracket3d")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    os.makedirs(args.prefix, exist_ok=True)
    inp = args.inp or synthesize_bracket_inp(
        os.path.join(args.prefix, "bracket3d.inp"), n=args.n
    )
    prob, model, filtr, conn, X = build_problem(
        inp, r0=args.r0, vol=args.vol, device=args.device
    )
    print(f"[bracket3d] {model.nelems} C3D10 elements, "
          f"{model.ndof} dofs, volume bound {args.vol}")
    opt = MMA(prob, {"max_iterations": args.iters, "verbose": True})
    x = opt.optimize()
    rho = filtr.apply(torch.as_tensor(x, device=model.device))
    out = os.path.join(args.prefix, "bracket3d_design.vtk")
    fem.to_vtk(conn, X, {"x": torch.as_tensor(x).cpu().numpy(),
                         "rho": rho.cpu().numpy()}, out)
    h0, h1 = opt.history[0], opt.history[-1]
    print(f"[bracket3d] obj {h0['obj']:.4e} -> {h1['obj']:.4e}, "
          f"con {h1['con'][0]:+.3e}; design -> {out}")


if __name__ == "__main__":
    main()
