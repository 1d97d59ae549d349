"""Topology optimization on the unstructured torque-arm mesh.

Port of the JAX package's ``examples/torque_arm_topo.py``:
Helmholtz-filtered RAMP compliance minimization with a volume constraint
on the CPS3 arm mesh, a workload the reference ships no example for:

    parse .inp -> LinearElasticity(tri3, RAMP p=3)
               -> cached smoothed-aggregation AMG state solves
                  (unstructured.amg_pcg: RCM + rigid-body-mode SA,
                  a device V-cycle on CSR levels (U1); set-up cached
                  across the loop)
               -> unstructured Helmholtz filter (element assembly + CG)
               -> MMA (opt.mma) -> design VTK.

Usage:
    python -m pyfem_gpu_testflight_tpu_torch.examples.torque_arm_topo
        [--inp mesh.inp] [--iters 30] [--vol 0.5] [--r0 0.08]
        [--nr 12 --nt 80] [--prefix results] [--device cpu]
"""

import argparse
import os

import torch

import pyfem_gpu_testflight_tpu_torch as fem
from pyfem_gpu_testflight_tpu_torch.opt import MMA, TopoProblem
from pyfem_gpu_testflight_tpu_torch.examples.torque_arm import (
    arm_model, synthesize_arm_inp,
)


def build_problem(inp_path, r0=0.08, vol=0.5, rtol=1e-8, device=None,
                  dtype=torch.float64):
    """(TopoProblem, model, filtr, conn, X) for a torque-arm .inp."""
    model, X, conn, _groups = arm_model(inp_path, device=device, p=3.0,
                                        dtype=dtype)
    filtr = fem.Helmholtz(r0, "tri3", X, conn, rtol=rtol, dtype=dtype,
                          device=device)
    prob = TopoProblem(model, filtr, fixed_volume=vol, solver="amg")
    return prob, model, filtr, conn, X


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--inp", default=None,
                    help="Abaqus .inp mesh with CPS3 elements and "
                         "fixed/load NSETs (default: synthesized arm)")
    ap.add_argument("--nr", type=int, default=12)
    ap.add_argument("--nt", type=int, default=80)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--vol", type=float, default=0.5)
    ap.add_argument("--r0", type=float, default=0.08)
    ap.add_argument("--prefix", default="results_arm_topo")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    os.makedirs(args.prefix, exist_ok=True)
    inp = args.inp or synthesize_arm_inp(
        os.path.join(args.prefix, "arm_topo.inp"), nr=args.nr, nt=args.nt
    )
    prob, model, filtr, conn, X = build_problem(
        inp, r0=args.r0, vol=args.vol, device=args.device
    )
    print(f"[arm-topo] {model.nelems} CPS3 elements, "
          f"{model.ndof} dofs, volume bound {args.vol}")
    opt = MMA(prob, {"max_iterations": args.iters, "verbose": True})
    x = opt.optimize()
    rho = filtr.apply(torch.as_tensor(x, device=model.device))
    out = os.path.join(args.prefix, "arm_design.vtk")
    fem.to_vtk(conn, X, {"x": torch.as_tensor(x).cpu().numpy(),
                         "rho": rho.cpu().numpy()}, out)
    h0, h1 = opt.history[0], opt.history[-1]
    print(f"[arm-topo] compliance {h0['obj']:.5f} -> {h1['obj']:.5f}, "
          f"volume {args.vol - h1['con'][0]:.4f}, design -> {out}")


if __name__ == "__main__":
    main()
