"""PyTorch port, sharded topology optimization on CPU gloo ranks.

On 2 and 4 spawned gloo ranks (one spawn per rank count; the rank
program is ``tests/torch_dist.py``), float64, the gates of JAX
tests/test_sharded_topo.py:

* ``ShardedDeviceTopo`` at 33x17 (4 MMA iterations) follows the JAX
  ``DeviceTopo``: max |dx| < 1e-7, objectives within rtol 1e-8, the
  filtered density within 1e-8; the padding is cropped on the way out;
* in 3D, at 9x5x5 (3 iterations, filter radius 0.1; on 4 ranks one
  rank holds only padding) it follows the JAX ``DeviceTopo`` at the same
  bounds; the JAX loop solves the state on the fine level alone (a
  dense solve of its 675 dof, as tests/test_torch_topo3d.py runs it:
  compiling the JAX 3D assembly takes ~27 s a level on one core), so it
  is an exact-solve yardstick for the port's two-level sharded solve at
  rtol 1e-9;
* at 17x9x9 (3 iterations, two sharded levels) it follows the port's
  single-device ``DeviceTopo`` at the same bounds (compiling the JAX 3D
  loop at 17x9x9 takes minutes on one core);
* a run resumed from a JAX ``ShardedDeviceTopo`` checkpoint (2
  iterations on the 8-device virtual mesh: padded, lead-sharded arrays,
  ``convert.crop_topo_state``) follows the JAX ``DeviceTopo`` to
  iteration 4; the port's own sharded checkpoint (rank 0 writes the real
  grid) resumed on the ranks repeats the uninterrupted run bit for bit,
  and the single-device port loop resumes from it too;
* the host loop (``TopoProblem(solver="sharded_gmg")`` + ``MMA``, 3
  iterations) follows the JAX host loop on ``solver="gmg"``: max |dx|
  < 1e-7, objectives within rtol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu.opt import DeviceTopo as JDeviceTopo
from pyfem_gpu_testflight_tpu.opt import MMA as JMMA
from pyfem_gpu_testflight_tpu.opt import ShardedDeviceTopo as JSharded
from pyfem_gpu_testflight_tpu.opt import TopoProblem as JTopoProblem
from pyfem_gpu_testflight_tpu.parallel import make_mesh as jmake_mesh

import torch_dist
import torch_threads  # noqa: F401  (one torch thread per worker)

WORLDS = (2, 4)
DIMS2, DIMS3 = (33, 17), (17, 9, 9)
DIMS3_JAX, R0_3D_JAX = (9, 5, 5), 0.1


def _jax_case(sharded=False, solver=None):
    c = fem.ProblemCreator(nnodes_x=33, nnodes_y=17, element_type="quad")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m = fem.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0,
                             dtype=jnp.float64)
    f = fem.Helmholtz(0.05, "quad4", X, conn, dtype=jnp.float64)
    f.attach_structured_grid(*DIMS2)
    if solver is not None:  # the host loop
        m.attach_structured_grid(*DIMS2)
        return JTopoProblem(m, f, fixed_volume=0.4, solver=solver)
    if sharded:
        m.attach_sharded_grid(jmake_mesh(8), *DIMS2)
        return JSharded(m, f, fixed_volume=0.4, rtol=1e-9)
    m.attach_structured_grid(*DIMS2)
    return JDeviceTopo(m, f, fixed_volume=0.4, rtol=1e-9)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    jax.config.update("jax_enable_x64", True)
    tmp = tmp_path_factory.mktemp("topo")
    d = _jax_case()
    x, rho = d.optimize(max_iterations=4, verbose=False, log_every=2)
    out = {"tmp": tmp, "2d": {"x": np.asarray(x), "rho": np.asarray(rho),
                              "obj": [h["obj"] for h in d.history]}}
    ckpt = str(tmp / "jax_sharded.npz")
    _jax_case(sharded=True).optimize(max_iterations=2, verbose=False,
                                     log_every=2, checkpoint_path=ckpt)
    out["jax_sharded_ckpt"] = ckpt
    opt = JMMA(_jax_case(solver="gmg"), {"max_iterations": 3,
                                          "verbose": False})
    out["host"] = {"x": np.asarray(opt.optimize(), np.float64),
                   "obj": [h["obj"] for h in opt.history]}
    # the JAX 3D loop (fine-level state solve) and the port's single-device
    # one
    c = fem.ProblemCreator(*DIMS3_JAX, element_type="block")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m3 = fem.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0,
                              dtype=jnp.float64)
    m3.attach_structured_grid(*DIMS3_JAX, min_n=5)
    f3 = fem.Helmholtz(R0_3D_JAX, "hex8", X, conn, dtype=jnp.float64)
    f3.attach_structured_grid(*DIMS3_JAX)
    dj = JDeviceTopo(m3, f3, fixed_volume=0.4, rtol=1e-9)
    x3, rho3 = dj.optimize(max_iterations=3, verbose=False, log_every=3)
    out["3d_jax"] = {"x": np.asarray(x3), "rho": np.asarray(rho3),
                     "obj": [h["obj"] for h in dj.history]}
    d3 = torch_dist.topo(DIMS3)
    x3, rho3 = d3.optimize(max_iterations=3, verbose=False, log_every=3)
    out["3d"] = {"x": x3.numpy(), "rho": rho3.numpy(),
                 "obj": [h["obj"] for h in d3.history]}
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, refs):
    tmp = refs["tmp"]
    ckpt = str(tmp / f"port_sharded_{request.param}.npz")
    runs = [("2d", DIMS2, 0.05, 4, 2, None, None),
            ("3d", DIMS3, 0.05, 3, 3, None, None),
            ("3d_jax", DIMS3_JAX, R0_3D_JAX, 3, 3, None, None),
            ("from_jax", DIMS2, 0.05, 4, 2, refs["jax_sharded_ckpt"], None),
            ("first2", DIMS2, 0.05, 2, 2, None, ckpt),
            ("resumed", DIMS2, 0.05, 4, 2, ckpt, None)]
    outs = torch_dist.spawn(torch_dist.sharded_topo_ranks, request.param,
                            runs, 3)
    return outs[0], ckpt


def _close(run, ref, x_tol=1e-7, obj_rtol=1e-8):
    assert run["x"].shape == ref["x"].shape  # padding cropped
    assert np.abs(run["x"] - ref["x"]).max() < x_tol
    np.testing.assert_allclose(run["obj"], ref["obj"], rtol=obj_rtol)


def test_sharded_device_topo_matches_jax(ranks, refs):
    out, _ = ranks
    _close(out["2d"], refs["2d"])
    np.testing.assert_allclose(out["2d"]["rho"], refs["2d"]["rho"],
                               atol=1e-8)


def test_sharded_device_topo_3d_matches_single_device(ranks, refs):
    out, _ = ranks
    _close(out["3d"], refs["3d"])
    np.testing.assert_allclose(out["3d"]["rho"], refs["3d"]["rho"],
                               atol=1e-8)


def test_sharded_device_topo_3d_matches_jax(ranks, refs):
    out, _ = ranks
    _close(out["3d_jax"], refs["3d_jax"])
    np.testing.assert_allclose(out["3d_jax"]["rho"], refs["3d_jax"]["rho"],
                               atol=1e-8)


def test_resume_from_a_jax_sharded_checkpoint(ranks, refs):
    out, _ = ranks
    run = out["from_jax"]
    assert len(run["obj"]) == 4  # 2 replayed from the file, 2 run
    _close(run, refs["2d"])


def test_resume_repeats_the_run_and_crosses_to_one_device(ranks, refs):
    out, ckpt = ranks
    for key in ("x", "rho", "obj", "cg", "step"):
        np.testing.assert_array_equal(np.asarray(out["resumed"][key]),
                                      np.asarray(out["2d"][key]))
    d = torch_dist.topo(DIMS2)  # the single-device loop
    x, _ = d.optimize(max_iterations=4, verbose=False, log_every=2,
                      resume=ckpt)
    _close({"x": x.numpy(), "obj": [h["obj"] for h in d.history]},
           refs["2d"])


def test_host_loop_sharded_gmg_matches_jax(ranks, refs):
    out, _ = ranks
    _close(out["host"], refs["host"], obj_rtol=1e-9)
