"""Abaqus .inp -> plane-stress solve -> VTK pipeline
(reference examples/torque_arm/arm.py).

Port of the JAX package's ``examples/torque_arm.py``.  The reference
ships a torque-arm CPS3 mesh asset; this example synthesizes an
equivalent .inp (an annular arm-like tri mesh with ``fixed`` and
``load`` node sets), then runs the same pipeline: parse ->
LinearElasticity on CPS3 -> solve (AMG-PCG by default) -> VTK export.
Point it at a real mesh with --inp.

Usage:
    python -m pyfem_gpu_testflight_tpu_torch.examples.torque_arm
        [--inp mesh.inp] [--method amg] [--nr 6 --nt 40] [--device cpu]
"""

import argparse
import os

import numpy as np

import pyfem_gpu_testflight_tpu_torch as fem
from pyfem_gpu_testflight_tpu_torch.mesh import fix_orientation


def synthesize_arm_inp(path, nr=6, nt=40):
    """Write an annular 'arm' tri mesh (nr x nt polar nodes) in Abaqus
    .inp format: 2 (nr-1)(nt-1) CPS3 elements, NSETs ``fixed`` (the
    inner ring) and ``load`` (three nodes at the outer ring's end)."""
    r0, r1 = 0.4, 1.0
    # polar grid, stretched in x to look arm-like
    rs = np.linspace(r0, r1, nr)
    ts = np.linspace(0, np.pi, nt)
    nodes = []
    for r in rs:
        for t in ts:
            nodes.append((2.0 * r * np.cos(t), r * np.sin(t)))
    nodes = np.array(nodes)
    quads = []
    for i in range(nr - 1):
        for j in range(nt - 1):
            a = i * nt + j
            quads.append((a, a + 1, a + nt + 1, a + nt))
    tris = []
    for (a, b, c, d) in quads:
        tris.append((a, b, c))
        tris.append((c, d, a))
    # enforce positive (counterclockwise) orientation
    tris, _ = fix_orientation(np.array(tris), nodes)
    fixed = list(range(nt))  # inner ring
    load = list(range((nr - 1) * nt, (nr - 1) * nt + 3))  # outer ring end

    with open(path, "w") as fh:
        fh.write("*Heading\n** synthesized torque-arm-like mesh\n")
        fh.write("*NODE\n")
        for i, (x, y) in enumerate(nodes):
            fh.write(f"{i + 1}, {x:.9f}, {y:.9f}, 0.0\n")
        fh.write("*ELEMENT, type=CPS3\n")
        for i, (a, b, c) in enumerate(tris):
            fh.write(f"{i + 1}, {a + 1}, {b + 1}, {c + 1}\n")
        fh.write("*NSET, nset=fixed\n")
        fh.write(", ".join(str(n + 1) for n in fixed) + "\n")
        fh.write("*NSET, nset=load\n")
        fh.write(", ".join(str(n + 1) for n in load) + "\n")
    return path


def arm_model(inp_path, device=None, **model_kw):
    """(LinearElasticity, X, conn, groups) for a torque-arm .inp: CPS3 in
    the xy plane, the ``fixed`` nodes clamped, a unit downward force on
    each ``load`` node."""
    conn_dict, X, groups = fem.InpParser(inp_path).parse()
    X = X[:, :2]
    conn, _ = fix_orientation(conn_dict["CPS3"], X)
    dof_fixed = []
    for n in groups["fixed"]:
        dof_fixed.extend([2 * int(n), 2 * int(n) + 1])
    nodal_force = {int(n): [0.0, -1.0] for n in groups["load"]}
    model = fem.LinearElasticity("tri3", X, conn, dof_fixed, None,
                                 nodal_force, device=device, **model_kw)
    return model, X, conn, groups


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--inp", default=None, help="path to an Abaqus .inp mesh")
    p.add_argument("--method", default="amg",
                   choices=["direct", "cg", "gmres", "amg"])
    p.add_argument("--nr", type=int, default=6)
    p.add_argument("--nt", type=int, default=40)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args()

    inp = args.inp or synthesize_arm_inp("arm_synth.inp", nr=args.nr,
                                         nt=args.nt)
    model, X, conn, groups = arm_model(inp, device=args.device)
    print(f"nelems={conn.shape[0]} nnodes={X.shape[0]} "
          f"nsets={list(groups)}")
    u = model.solve(method=args.method).cpu().numpy()
    ux, uy = u[0::2], u[1::2]
    print(f"max |ux| = {np.abs(ux).max():.6e}, "
          f"max |uy| = {np.abs(uy).max():.6e}")
    # written to the working directory (the .inp may be read-only)
    base = os.path.splitext(os.path.basename(inp))[0]
    fem.to_vtk({"CPS3": conn}, X, {"ux": ux, "uy": uy},
               base + "_result.vtk")


if __name__ == "__main__":
    main()
