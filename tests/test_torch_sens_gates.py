"""PyTorch port held to the JAX package's sensitivity and solver-failure
gates, on CPU (float64).

Twins of ``tests/test_structured_sens.py``:

* the scatter-free structured d(phi^T K psi)/drho of an attached grid
  against the einsum route (the JAX gates' yardstick, the oracle path)
  at 1e-13 of its largest entry: 2D elasticity (17x9, p = 3), 2D Poisson
  (p = 5) and 3D elasticity (5^3, p = 2);
* complex-step probes keep the einsum route after the attach: p . dS
  equals the complex step of phi^T K psi (1e-10);
* ``compliance_grad`` after the attach, on the gmg state, within 1e-6
  of the generic route's on the cg state;

and of ``tests/test_solver_failure.py``: a truncated CG (maxiter 3) and
GMRES (maxiter 1) raise ``RuntimeError`` naming the method, and a
converged solve does not.
"""

import numpy as np
import pytest
import torch

import pyfem_gpu_testflight_tpu_torch as pt

import torch_threads  # noqa: F401  (one torch thread per worker)

DEV = "cpu"


def _elasticity(dims, p):
    et = "quad" if len(dims) == 2 else "block"
    c = pt.ProblemCreator(*dims, element_type=et)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    return pt.LinearElasticity("quad4" if len(dims) == 2 else "hex8", X,
                               conn, fixed, None, force, p=p, device=DEV)


def _poisson(n, p=0.0, **kw):
    conn, X, fixed = pt.ProblemCreator(n[0], n[1]).create_poisson_problem()
    return pt.LinearPoisson("quad4", X, conn, fixed, p=p, device=DEV, **kw)


# (model maker, grid, RandomState seed): tests/test_structured_sens.py:25-72
SENS_CASES = {
    "2d-elasticity": (lambda: _elasticity((17, 9), 3.0), (17, 9), 11),
    "2d-poisson": (lambda: _poisson((17, 9), 5.0), (17, 9), 12),
    "3d-elasticity": (lambda: _elasticity((5, 5, 5), 2.0), (5, 5, 5), 13),
}


@pytest.mark.parametrize("case", list(SENS_CASES))
def test_structured_sens_matches_einsum(case):
    make, dims, seed = SENS_CASES[case]
    m = make()
    rng = np.random.RandomState(seed)
    rho = rng.rand(m.nnodes)
    phi, psi = rng.rand(m.ndof), rng.rand(m.ndof)
    ref = m.k_dv_sens(rho, phi, psi).numpy()
    m.attach_structured_grid(*dims)
    assert m._use_structured_sens(rho, phi, psi)
    fast = m.k_dv_sens(rho, phi, psi).numpy()
    assert np.abs(fast - ref).max() <= 1e-13 * np.abs(ref).max()


def test_complex_step_routes_to_einsum_path():
    rng = np.random.RandomState(14)
    m = _elasticity((9, 9), 3.0)
    m.attach_structured_grid(9, 9)
    phi, psi = rng.rand(m.ndof), rng.rand(m.ndof)
    rho = rng.rand(m.nnodes)
    h, pvec = 1e-30, rng.rand(m.nnodes)
    K = m.assemble_scipy(m.element_jacobian(rho + 1j * h * pvec))
    cs = float(np.imag(phi @ (K @ psi)) / h)
    grad = m.k_dv_sens(rho, phi, psi).numpy()
    assert abs(pvec @ grad - cs) <= 1e-10 * abs(cs)


def test_compliance_grad_uses_fast_path_after_attach():
    m = _elasticity((17, 9), 3.0)
    rho = 0.3 + 0.5 * np.random.RandomState(15).rand(m.nnodes)
    ref = m.compliance_grad(rho, m.compliance(rho)[1]).numpy()
    m.attach_structured_grid(17, 9)
    _c, u = m.compliance(rho, solver="gmg")
    fast = m.compliance_grad(rho, u).numpy()
    assert np.abs(fast - ref).max() <= 1e-6 * np.abs(ref).max()


def _g(x):
    return torch.ones(x.shape[:-1], dtype=x.dtype)


@pytest.mark.parametrize("method,maxiter", [("cg", 3), ("gmres", 1)])
def test_truncated_solve_raises(method, maxiter):
    """tests/test_solver_failure.py:29, :36 (32x32 Poisson)."""
    m = _poisson((32, 32), gfunc=_g)
    with pytest.raises(RuntimeError,
                       match=f"{method} failed to converge"):
        m.solve(method=method, maxiter=maxiter)


def test_converged_solve_does_not_raise():
    """tests/test_solver_failure.py:41 (8x8 Poisson)."""
    u = _poisson((8, 8), gfunc=_g).solve(method="cg")
    assert torch.isfinite(u).all()
