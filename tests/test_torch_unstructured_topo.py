"""PyTorch port, topology optimization on unstructured meshes (CPU,
float64): the port's ``examples.torque_arm_topo`` and
``examples.bracket3d_topo`` loops under the JAX gates
(``tests/test_unstructured.py:110-146``,
``tests/test_unstructured3d.py:106-127``): one structural AMG set-up
for the whole loop, a finite history, the volume constraint approached
from the infeasible solid start, the filtered density within
[-0.05, 1.05], the design written as VTK — and the arm loop's
objective and constraint histories against the JAX loop's.

Tolerance of that comparison: both loops solve the state by AMG-PCG to
rtol 1e-8 and the filter by Jacobi-PCG to rtol 1e-8, in float64, and
their sums run in different orders (CSR rows on the port, DIA
diagonals in the JAX package), so each objective carries a relative
error of order 1e-8 that MMA carries into the next design; 1e-6
relative leaves a hundredfold margin over that, and is far below the
objective's change per iteration (30 to 60% on this mesh).  Measured:
1.0e-13 (both loops take the same iterates up to rounding).
"""

import importlib.util
import os
import sys

import numpy as np
import torch

from pyfem_gpu_testflight_tpu import unstructured as ju
from pyfem_gpu_testflight_tpu.opt import MMA as JaxMMA

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import unstructured
from pyfem_gpu_testflight_tpu_torch.examples import (
    bracket3d_topo, torque_arm, torque_arm_topo,
)
from pyfem_gpu_testflight_tpu_torch.opt import MMA

import torch_threads  # noqa: F401  (one torch thread per worker)

_EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
HIST_TOL = 1e-6


def _jax_example(name):
    if _EXAMPLES not in sys.path:
        sys.path.insert(0, _EXAMPLES)
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(_EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(prob, filtr, iters, vtk):
    setups0 = unstructured.AMGPreconditioner.n_structure_setups
    opt = MMA(prob, {"max_iterations": iters, "verbose": False})
    x = opt.optimize()
    # one structural set-up for the whole loop (cached across solves)
    assert unstructured.AMGPreconditioner.n_structure_setups - setups0 == 1
    objs = [h["obj"] for h in opt.history]
    cons = [h["con"][0] for h in opt.history]
    assert len(objs) == iters and all(np.isfinite(o) for o in objs)
    # volume constraint approached from the infeasible solid start
    assert cons[0] < 0 and cons[-1] > cons[0]
    rho = filtr.apply(torch.as_tensor(x)).numpy()
    assert rho.min() > -0.05 and rho.max() < 1.05
    pt.to_vtk(prob.model.conn_host, prob.model.X_host, {"rho": rho}, vtk)
    assert open(vtk).read(30).startswith("# vtk DataFile")
    return objs, cons


def test_torque_arm_topology_loop_matches_jax(tmp_path):
    inp = torque_arm.synthesize_arm_inp(str(tmp_path / "arm.inp"), nr=8,
                                        nt=48)
    prob, model, filtr, conn, X = torque_arm_topo.build_problem(
        inp, r0=0.1, vol=0.5, device="cpu")
    objs, cons = _run(prob, filtr, 6, str(tmp_path / "arm.vtk"))
    assert model.last_solve_stats["method"] == "amg"

    jprob = _jax_example("torque_arm_topo").build_problem(inp, r0=0.1,
                                                          vol=0.5)[0]
    setups0 = ju.AMGPreconditioner.n_structure_setups
    jopt = JaxMMA(jprob, {"max_iterations": 6, "verbose": False})
    jopt.optimize()
    assert ju.AMGPreconditioner.n_structure_setups - setups0 == 1
    jobjs = [h["obj"] for h in jopt.history]
    jcons = [h["con"][0] for h in jopt.history]
    np.testing.assert_allclose(objs, jobjs, rtol=HIST_TOL)
    np.testing.assert_allclose(cons, jcons, rtol=HIST_TOL, atol=HIST_TOL)


def test_bracket3d_topology_loop(tmp_path):
    inp = bracket3d_topo.synthesize_bracket_inp(str(tmp_path / "b.inp"), n=5)
    prob, model, filtr, conn, X = bracket3d_topo.build_problem(
        inp, device="cpu")
    assert model.amg_options == {"max_offsets": 8192}
    _run(prob, filtr, 4, str(tmp_path / "bracket.vtk"))
    assert model.last_solve_stats["method"] == "amg"
