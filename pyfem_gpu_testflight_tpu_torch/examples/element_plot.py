"""Export single quadratic elements to VTK for inspection
(reference examples/element_plot/c3d10_plot.py and c3d20_plot.py).

Port of the JAX package's ``examples/element_plot.py``; it also sums
each mesh's consistent mass on the device, the integral of 1 under the
element's quadrature, as a check of the element tables: 1 for the
brick20 unit cube, and 6 for the six tet10 of the unit cube, whose
weights keep the reference's normalization (they sum to 1 on the
reference tet, six times its volume).

Usage:
    python -m pyfem_gpu_testflight_tpu_torch.examples.element_plot
        [--out-dir .] [--device cpu]
"""

import argparse
import os

import pyfem_gpu_testflight_tpu_torch as fem
from pyfem_gpu_testflight_tpu_torch import postprocess


def _mass_sum(etype, creator, conn, device):
    model = fem.LinearPoisson(etype, creator.X, conn, [], device=device)
    return float(postprocess.mass_matrix(model).sum())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out-dir", default=".",
                   help="directory of c3d10.vtk and c3d20.vtk")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    sums = {}
    # one tet10: unit corner tet + mid-edge nodes
    creator = fem.ProblemCreator(nnodes_x=3, nnodes_y=3, nnodes_z=3,
                                 element_type="tet")
    fem.to_vtk({"tet10": creator.conn[:1]}, creator.X, {},
               os.path.join(args.out_dir, "c3d10.vtk"))
    sums["tet10"] = _mass_sum("tet10", creator, creator.conn, args.device)
    print(f"tet10 mesh: {creator.conn.shape[0]} elements (mass sum "
          f"{sums['tet10']:.6f}) -> c3d10.vtk")

    # one brick20
    creator = fem.ProblemCreator(nnodes_x=3, nnodes_y=3, nnodes_z=3,
                                 element_type="brick20")
    fem.to_vtk({"brick20": creator.conn}, creator.X, {},
               os.path.join(args.out_dir, "c3d20.vtk"))
    sums["brick20"] = _mass_sum("brick20", creator, creator.conn,
                                args.device)
    print(f"brick20 mesh: {creator.conn.shape[0]} elements (mass sum "
          f"{sums['brick20']:.6f}) -> c3d20.vtk")
    return sums


if __name__ == "__main__":
    main()
