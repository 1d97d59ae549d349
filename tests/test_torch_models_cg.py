"""PyTorch port: the general-mesh element path of the models on CPU.

Gates against the JAX package (float64 unless said):

* ``LinearElasticity`` and ``LinearPoisson`` on jittered quad4 (17x9)
  and hex8 (5x4x4) meshes: ``element_jacobian`` within 1e-12 (the
  ``kernel="cuda"`` route runs K7 / K8's plain versions here, in
  float32 within 3e-5 of the JAX einsum path), ``compute_rhs`` within
  1e-12, ``solve(method="cg")`` with the JAX iteration count exactly
  and u within 1e-10 (rtol 1e-12), ``solve(method="direct")`` within
  1e-10, ``compute_jacobian`` equal to the JAX CSR matrix;
* the ``kernel`` checks raise ``ValueError`` as the JAX ones do, and
  quadratic elements warn about float32;
* ``GMGAssembler(elem_path="einsum" | "cuda")``: every level's
  BC-eliminated planes against the JAX ``elem_path="einsum"`` hierarchy
  at 17x9 (float64 within 1e-12, float32 within 1e-5), inverse
  diagonals on free dofs likewise, and a GMG solve on the ``"cuda"``
  route takes the uniform route's iterations.  The JAX
  ``elem_path="pallas"`` hierarchy is not built: it runs the
  interpret-mode kernel on every level (tests/test_gmg_elem_paths.py
  ties it to the einsum route).
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import multigrid as jmg

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import multigrid as tmg

import torch_threads  # noqa: F401  (one torch thread per worker)
DEV = "cpu"

MESHES = {
    "quad4": dict(nnodes_x=17, nnodes_y=9),
    "hex8": dict(nnodes_x=5, nnodes_y=4, nnodes_z=4, element_type="block"),
}


def _mesh(etype, seed=0):
    c = pt.ProblemCreator(**MESHES[etype])
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    rng = np.random.RandomState(seed)
    X = X + 0.03 * rng.randn(*X.shape)
    rho = 0.3 + 0.6 * rng.rand(X.shape[0])
    return conn, X, np.asarray(fixed), force, rho


def _models(etype, physics, dtype=(jnp.float64, torch.float64),
            kernel="einsum"):
    conn, X, fixed, force, rho = _mesh(etype)
    nd = X.shape[1]
    if physics == "elasticity":
        args = (etype, X, conn, fixed, None, force)
        mj = fem.LinearElasticity(*args, p=3.0, dtype=dtype[0])
        mt = pt.LinearElasticity(*args, p=3.0, dtype=dtype[1], device=DEV,
                                 kernel=kernel)
    else:
        g = lambda x: 1.0 + x[..., 0] * x[..., 1]  # noqa: E731
        args = (etype, X, conn, fixed[::nd] // nd)
        mj = fem.LinearPoisson(*args, gfunc=g, p=3.0, dtype=dtype[0])
        mt = pt.LinearPoisson(*args, gfunc=g, p=3.0, dtype=dtype[1],
                              device=DEV, kernel=kernel)
    return mj, mt, rho


def _close(got, ref, tol):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
@pytest.mark.parametrize("etype", ["quad4", "hex8"])
def test_model_cg_direct_match_jax(etype, physics):
    mj, mt, rho = _models(etype, physics)
    _close(mt.element_jacobian(rho), mj.element_jacobian(rho), 1e-12)
    _close(mt.compute_rhs(), mj.compute_rhs(), 1e-12)
    Kj, Kt = mj.compute_jacobian(rho), mt.compute_jacobian(rho)
    assert abs(Kj - Kt).max() <= 1e-12 * abs(Kj).max()
    uj = mj.solve(method="cg", rho=rho, rtol=1e-12)
    ut = mt.solve(method="cg", rho=rho, rtol=1e-12)
    assert mt.last_solve_stats["iters"] == mj.last_solve_stats["iters"]
    assert mt.last_solve_stats["readbacks"] <= (
        mt.last_solve_stats["iters"] // 16 + 1)
    _close(ut, uj, 1e-10)
    _close(mt.solve(method="direct", rho=rho),
           mj.solve(method="direct", rho=rho), 1e-10)


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
@pytest.mark.parametrize("etype", ["quad4", "hex8"])
def test_kernel_cuda_route_f32(etype, physics):
    """kernel="cuda" (plain versions on CPU) against the JAX einsum path
    in float32, and its CG solve against the port's einsum route."""
    mj, mt, rho = _models(etype, physics, (jnp.float32, torch.float32),
                          kernel="cuda")
    Ke = mt.element_jacobian(rho)
    np.testing.assert_allclose(Ke.numpy(),
                               np.asarray(mj.element_jacobian(rho)),
                               rtol=3e-5, atol=3e-5)
    _mj, me, _ = _models(etype, physics, (jnp.float32, torch.float32))
    u = mt.solve(method="cg", rho=rho, rtol=1e-5)
    ue = me.solve(method="cg", rho=rho, rtol=1e-5)
    assert torch.isfinite(u).all()
    assert abs(mt.last_solve_stats["iters"]
               - me.last_solve_stats["iters"]) <= 2
    _close(u, ue, 1e-3)


def test_kernel_option_checks():
    conn, X, fixed, force, _rho = _mesh("quad4")
    with pytest.raises(ValueError):  # float64 default
        pt.LinearElasticity("quad4", X, conn, fixed, None, force,
                            device=DEV, kernel="cuda")
    with pytest.raises(ValueError):  # the JAX name
        pt.LinearElasticity("quad4", X, conn, fixed, None, force,
                            dtype=torch.float32, device=DEV, kernel="pallas")
    with pytest.raises(ValueError):  # tri3 has no element kernel
        pt.LinearPoisson("tri3", X, np.zeros((1, 3), int),
                         dtype=torch.float32, device=DEV, kernel="cuda")
    c = pt.ProblemCreator(5, 5, 5, element_type="brick20")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pt.LinearElasticity("brick20", X, conn, fixed, None, force,
                            dtype=torch.float32, device=DEV, kernel="cuda")
    assert any("float32" in str(w.message) for w in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # hex8 does not warn
        c = pt.ProblemCreator(3, 3, 3, element_type="block")
        conn, X, fixed, force = c.create_linear_elasticity_problem()
        pt.LinearPoisson("hex8", X, conn, dtype=torch.float32, device=DEV,
                         kernel="cuda")


def _port_levels(physics, elem_path, dtype, rho):
    a = tmg.GMGAssembler(17, 9, 2.0, 1.0, physics, p=3.0, dtype=dtype,
                         device=DEV, elem_path=elem_path)
    gmg, _ = a.assemble(torch.as_tensor(rho, dtype=dtype))
    return gmg.levels


_JAX_LEVELS = {}


def _jax_levels(physics, dtype, rho):
    key = (physics, dtype)
    if key not in _JAX_LEVELS:
        a = jmg.GMGAssembler(17, 9, 2.0, 1.0, physics, p=3.0, dtype=dtype,
                             elem_path="einsum")
        gmg, _ = a.assemble(jnp.asarray(rho, dtype))
        _JAX_LEVELS[key] = [(np.asarray(lv.coeff_e), np.asarray(lv.inv_diag),
                             np.asarray(lv.mask)) for lv in gmg.levels]
    return _JAX_LEVELS[key]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("elem_path", ["einsum", "cuda"])
@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_gmg_elem_path_levels_match_jax(physics, elem_path, dtype):
    tol = 1e-12 if dtype == "float64" else 1e-5
    rho = 0.3 + 0.6 * np.random.RandomState(2).rand(9 * 17)
    ref = _jax_levels(physics, getattr(jnp, dtype), rho)
    got = _port_levels(physics, elem_path, getattr(torch, dtype), rho)
    assert len(got) == len(ref)
    for lv, (ce, invd, mask) in zip(got, ref):
        _close(lv.coeff, ce.reshape(lv.coeff.shape), tol)
        _close(lv.inv_diag.numpy()[~mask], invd[~mask], tol)
        assert (lv.inv_diag.numpy()[mask] == 0).all()  # K1's convention


def test_gmg_elem_path_cuda_solve_matches_uniform():
    rho = 0.3 + 0.6 * np.random.RandomState(3).rand(9 * 17)
    c = pt.ProblemCreator(17, 9)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    out = {}
    for ep in ("uniform", "cuda"):
        m = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0,
                                device=DEV)
        m.attach_structured_grid(17, 9, elem_path=ep, omega="cheby",
                                 smoother_dtype=torch.bfloat16)
        out[ep] = (m.solve(method="gmg", rho=rho, rtol=1e-10),
                   m.last_solve_stats["iters"])
    assert out["cuda"][1] == out["uniform"][1]
    _close(out["cuda"][0], out["uniform"][0].numpy(), 1e-8)
    with pytest.raises(ValueError):
        tmg.GMGAssembler(17, 9, 2.0, 1.0, elem_path="pallas", device=DEV)
