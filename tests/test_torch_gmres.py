"""PyTorch port: restarted GMRES and Newton (``solvers.gmres_loop``,
``gmres``, ``newton``) and ``_solve_system(method="gmres")``.

Mirrors ``tests/test_gmres.py`` and ``tests/test_solver_failure.py``
against the JAX package's ``solvers.gmres`` on the same seeded dense
systems, in float64 on the CPU: the solution within 1e-10 (relative to
max|x|) and the same Arnoldi step count; the result fields; right Jacobi
preconditioning; restarts and a tiny rhs; a zero rhs; the operator
products a one-cycle solve executes (``iters + 3``, the JAX loop's
count) and its host read-backs; the GMRES failure raising at the model
boundary; ``newton`` on a small nonlinear system against the JAX
``newton``; and a 9x9 quad4 Poisson system solved by
``_solve_system(method="gmres")`` in both packages.  The JAX references
are computed once per module.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import solvers as jsol

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import solvers as tsol

import torch_threads  # noqa: F401  (one torch thread per worker)

TOL = 1e-10


def _apply_np(data, x):
    return data @ x


def _fields():
    rng = np.random.RandomState(0)
    n = 120
    A = np.eye(n) * 4 + 0.5 * rng.rand(n, n)
    return A, rng.rand(n), {"rtol": 1e-10}


def _jacobi():
    rng = np.random.RandomState(1)
    n = 100
    d = 10.0 ** rng.uniform(-1, 1, n)
    A = np.diag(d) + 0.02 * rng.rand(n, n)
    return A, rng.rand(n), {"rtol": 1e-9, "inv_diag": 1.0 / np.diag(A)}


def _restarts():
    rng = np.random.RandomState(2)
    n = 150
    A = np.diag(np.linspace(0.05, 10, n)) + 0.2 * rng.rand(n, n)
    return A, A @ rng.rand(n), {"rtol": 1e-10, "restart": 20}


def _tiny():
    A, b, _ = _restarts()
    return A, b * 1e-13, {"rtol": 1e-8}


CASES = {"fields": _fields, "jacobi": _jacobi, "restarts": _restarts,
         "tiny_rhs": _tiny}


def _solve_jax(A, b, kw):
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    r = jsol.gmres(_apply_np, jnp.asarray(A), jnp.asarray(b), **kw)
    return np.asarray(r.x), int(r.iters), float(r.resnorm)


@pytest.fixture(scope="module")
def jax_refs():
    return {name: _solve_jax(*make()) for name, make in CASES.items()}


def _solve_port(A, b, kw):
    kw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    return tsol.gmres(_apply_np, torch.as_tensor(A), torch.as_tensor(b),
                      **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gmres_matches_jax(jax_refs, case):
    A, b, kw = CASES[case]()
    x_ref, it_ref, _ = jax_refs[case]
    res = _solve_port(A, b, kw)
    assert isinstance(res, tsol.GMRESResult)
    x = res.x.numpy()
    assert res.iters == it_ref
    assert np.abs(x - x_ref).max() <= TOL * np.abs(x_ref).max()
    # resnorm is the true residual, recomputed at the end of the cycle
    rn = np.linalg.norm(b - A @ x)
    np.testing.assert_allclose(float(res.resnorm), rn, rtol=1e-6,
                               atol=1e-14 * np.linalg.norm(b) + 1e-300)
    assert float(res.resnorm) <= 10 * kw["rtol"] * np.linalg.norm(b)
    if case == "restarts":
        assert res.iters > 20  # forced through restarts


def test_gmres_zero_rhs():
    res = tsol.gmres(_apply_np, torch.eye(8, dtype=torch.float64),
                     torch.zeros(8, dtype=torch.float64), rtol=1e-10)
    assert float(res.resnorm) == 0.0 and res.iters == 0
    assert torch.equal(res.x, torch.zeros(8, dtype=torch.float64))


def test_gmres_early_exit_product_and_readback_count():
    """One restart cycle: iters Arnoldi products + 1 (the initial
    residual) + 2 (the cycle's entry residual and its true-residual
    recheck), as the JAX loop; the host reads back the tolerance with
    the initial residual, the entry and end norms and one Hessenberg
    column per step."""
    rng = np.random.RandomState(3)
    n = 200
    A = torch.as_tensor(np.eye(n) + 1e-3 * rng.rand(n, n))
    b = torch.as_tensor(rng.rand(n))
    calls = []

    def counting(data, x):
        calls.append(1)
        return data @ x

    r0 = dict(tsol.readbacks)
    res = tsol.gmres(counting, A, b, rtol=1e-10, restart=30)
    assert 0 < res.iters < 30
    assert len(calls) == res.iters + 3
    assert tsol.readbacks["gmres"] - r0["gmres"] == res.iters + 3
    x_ref, it_ref, _ = _solve_jax(A.numpy(), b.numpy(), {"rtol": 1e-10})
    assert res.iters == it_ref
    assert np.abs(res.x.numpy() - x_ref).max() <= TOL * np.abs(x_ref).max()


def test_gmres_general_right_preconditioner():
    """``precond`` replaces Jacobi (``inv_diag`` ignored): the exact
    inverse converges in one Arnoldi step."""
    A, b, _ = _fields()
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    Ainv = torch.linalg.inv(At)
    x, k, rn = tsol.gmres_loop(lambda v: At @ v, bt, rtol=1e-10,
                               inv_diag=torch.zeros_like(bt),
                               precond=lambda v: Ainv @ v)
    assert k == 1
    assert float(rn) <= 1e-10 * float(torch.linalg.norm(bt))


def _poisson(nx, ny):
    c = fem.ProblemCreator(nnodes_x=nx, nnodes_y=ny, element_type="quad")
    conn, X, fixed = c.create_poisson_problem()
    jm = fem.LinearPoisson("quad4", X, conn, fixed, None,
                           gfunc=lambda x: jnp.ones(x.shape[:-1], x.dtype))
    tm = pt.LinearPoisson("quad4", X, conn, fixed, None, device="cpu",
                          gfunc=lambda x: torch.ones_like(x[..., 0]))
    return jm, tm


def test_gmres_failure_raises():
    _jm, tm = _poisson(32, 32)
    with pytest.raises(RuntimeError, match="gmres failed to converge"):
        tm.solve(method="gmres", maxiter=1)
    # converged solves do not raise
    _jm, tm = _poisson(8, 8)
    assert torch.isfinite(tm.solve(method="gmres")).all()


def test_solve_system_gmres_matches_jax():
    """A 9x9 quad4 Poisson system through ``_solve_system(method=
    "gmres")``: Jacobi on the right, the BC-constrained matrix-free
    operator, ``last_solve_stats`` — against the JAX package's."""
    jm, tm = _poisson(9, 9)
    rng = np.random.default_rng(5)
    rho = rng.uniform(0.3, 1.0, jm.nnodes)
    rhs = rng.standard_normal(jm.ndof)
    xj, bj = jm._solve_system(jm.element_jacobian(jnp.asarray(rho)),
                              jnp.asarray(rhs), "gmres", rtol=1e-10)
    sj = jm.last_solve_stats
    xt, bt = tm._solve_system(tm.element_jacobian(rho), torch.as_tensor(rhs),
                              "gmres", rtol=1e-10)
    st = tm.last_solve_stats
    xj = np.asarray(xj)
    assert np.abs(bt.numpy() - np.asarray(bj)).max() <= 1e-13 * np.abs(
        np.asarray(bj)).max()
    assert np.abs(xt.numpy() - xj).max() <= TOL * np.abs(xj).max()
    assert st["method"] == "gmres" and st["iters"] == sj["iters"]
    # one read-back for the tolerance, two per restart cycle, one per step
    ncycles = (st["readbacks"] - st["iters"] - 1) / 2
    assert ncycles == int(ncycles) >= 1
    np.testing.assert_allclose(st["resnorm"], sj["resnorm"], rtol=1e-6)


def _cubic(u, b, A):
    return A @ u + u ** 3 - b


def test_newton_matches_jax():
    """``newton`` on F(u) = A u + u^3 - b (dense Jacobian A + 3 diag(u^2))
    against the JAX ``newton``: the same iterates' residual table and
    the solution within 1e-12."""
    rng = np.random.default_rng(6)
    n = 12
    A = np.eye(n) * 3 + 0.2 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    seen = {"jax": [], "port": []}

    def jres(u):
        r = _cubic(u, jnp.asarray(b), jnp.asarray(A))
        seen["jax"].append(float(jnp.linalg.norm(r)))
        return r

    def tres(u):
        r = _cubic(u, torch.as_tensor(b), torch.as_tensor(A))
        seen["port"].append(float(torch.linalg.norm(r)))
        return r

    uj = jsol.newton(jres, lambda u, r: jnp.linalg.solve(
        jnp.asarray(A) + 3 * jnp.diag(u ** 2), r), jnp.zeros(n),
        tol=1e-12, atol=1e-14, max_iter=20, verbose=False)
    ut = tsol.newton(tres, lambda u, r: torch.linalg.solve(
        torch.as_tensor(A) + 3 * torch.diag(u ** 2), r),
        torch.zeros(n, dtype=torch.float64), tol=1e-12, atol=1e-14,
        max_iter=20, verbose=False)
    assert len(seen["port"]) == len(seen["jax"]) > 3
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=1e-9,
                               atol=1e-14)
    assert np.abs(ut.numpy() - np.asarray(uj)).max() <= 1e-12
    assert float(torch.linalg.norm(_cubic(ut, torch.as_tensor(b),
                                           torch.as_tensor(A)))) <= 1e-12


def test_exports():
    for name in ("gmres", "gmres_loop", "newton", "GMRESResult"):
        assert name in tsol.__all__ and hasattr(tsol, name)
    assert pt.NonlinearPoisson2D is pt.NonlinearPoisson
