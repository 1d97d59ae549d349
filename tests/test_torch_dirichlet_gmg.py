"""PyTorch port, GMG solves with nonzero Dirichlet values, on CPU.

``solve(method="gmg")`` lifts the right-hand side through the fine
level's un-eliminated operator, as the JAX package does on its default
route (``models/base.py:366-376``): ``b = rhs - A_raw v`` at free dofs,
``b = v`` at fixed ones, the fixed entries of u equal to the values.
Gates, on every route of the port (2D: ``uniform`` (K1), ``sym=True``
(K1-sym), ``elem_path="cuda"`` (K7's plain version here) and
``"einsum"``; 3D: ``uniform`` in half and full storage (K3),
``elem_path="otf"`` (K6) and ``"einsum"``), both physics:

* float64 at rtol 1e-12, 33x17 quad4 and 9^3 hex8: u within the JAX
  test's ``rtol=1e-7, atol=1e-10`` (``tests/test_multigrid.py:217-228``)
  of the port's direct solve and of the JAX package's direct solve, the
  lifted b equal to the JAX direct solve's BC-applied b (1e-12 of its
  largest entry), the fixed entries equal to the values, and
  ``compliance(solver="gmg")`` equal to ``solver="direct"`` (1e-10);
* the JAX gate itself (Poisson, 33x17, g = 1): u and b equal to the JAX
  package's ``solve(method="gmg")`` (its one compiled reference here: a
  JAX gmg solve compiles for 9-140 s on one core at these sizes, so the
  other cases hold the JAX direct solve's u and b, which that gate holds
  the JAX gmg solve to);
* float32 with the bf16 smoother copy (Chebyshev-node nu=2, flexible
  PCG, rtol 1e-6) on the ``elem_path="cuda"`` and ``"otf"`` routes: the
  float64 true residual against the float64 BC-applied operator at most
  4 x its float32 rounding floor (``PERF.md`` section 2) and the fixed
  entries equal to the values.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem

import pyfem_gpu_testflight_tpu_torch as pt

import torch_threads  # noqa: F401  (one torch thread per worker)

DEV = "cpu"
DIMS = {2: (33, 17), 3: (9, 9, 9)}
ROUTES = {2: [{}, {"sym": True}, {"elem_path": "cuda"},
              {"elem_path": "einsum"}],
          3: [{}, {"sym": False}, {"elem_path": "otf"},
              {"elem_path": "einsum"}]}
FLOOR_FACTOR = 4.0


def _g(x):
    return 1.0 + 0.0 * x[..., 0]


def _problem(dim, physics, package, **kw):
    """(model, rho, fixed, vals) on the gate's grid: Poisson with g = 1,
    rho = 1 and the JAX test's values; elasticity at p = 3 with a seeded
    rho in [0.3, 1] and seeded values in +-1e-3."""
    dims = DIMS[dim]
    c = package.ProblemCreator(*dims, element_type="quad" if dim == 2
                               else "block")
    etype = "quad4" if dim == 2 else "hex8"
    if package is pt:
        kw.setdefault("device", DEV)
    rng = np.random.default_rng(18 + dim)
    if physics == "poisson":
        conn, X, fixed = c.create_poisson_problem()
        vals = 0.3 + 0.01 * np.arange(len(fixed))
        m = package.LinearPoisson(etype, X, conn, fixed, vals, gfunc=_g,
                                  **kw)
        rho = np.ones(len(X))
    else:
        conn, X, fixed, force = c.create_linear_elasticity_problem()
        vals = rng.uniform(-1e-3, 1e-3, len(fixed))
        m = package.LinearElasticity(etype, X, conn, fixed, vals, force,
                                     p=3.0, **kw)
        rho = rng.uniform(0.3, 1.0, len(X))
    return m, rho, np.asarray(fixed), vals


_JAX = {}


def _jax_direct(dim, physics):
    """The JAX package's direct solve: (u, BC-applied b), once a case."""
    if (dim, physics) not in _JAX:
        jm, rho, _f, _v = _problem(dim, physics, fem, dtype=jnp.float64)
        u, b = jm._solve_system(jm.element_jacobian(jnp.asarray(rho)),
                                jm.compute_rhs(), "direct")
        _JAX[dim, physics] = (np.asarray(u), np.asarray(b))
    return _JAX[dim, physics]


def _route_id(r):
    return "-".join(f"{k}={v}" for k, v in r.items()) or "uniform"


CASES = [(d, ph, r) for d in (2, 3) for ph in ("poisson", "elasticity")
         for r in ROUTES[d]]


@pytest.mark.parametrize(
    "dim,physics,route", CASES,
    ids=[f"{d}d-{ph}-{_route_id(r)}" for d, ph, r in CASES])
def test_gmg_nonzero_dirichlet_f64(dim, physics, route):
    m, rho, fixed, vals = _problem(dim, physics, pt, dtype=torch.float64)
    c_dir, u_dir = m.compliance(rho, solver="direct")
    m.attach_structured_grid(*DIMS[dim], **route)
    u, b = m._solve_system(None, m.compute_rhs(), "gmg", rtol=1e-12,
                           rho=rho)
    u, b = u.numpy(), b.numpy()
    ju, jb = _jax_direct(dim, physics)
    for ref in (u_dir.numpy(), ju):
        np.testing.assert_allclose(u, ref, rtol=1e-7, atol=1e-10)
    assert np.abs(b - jb).max() <= 1e-12 * np.abs(jb).max()
    np.testing.assert_array_equal(u[fixed], vals)
    c_gmg, _u = m.compliance(rho, solver="gmg")
    assert abs(float(c_gmg) - float(c_dir)) <= 1e-10 * abs(float(c_dir))


def test_gmg_nonzero_dirichlet_matches_jax_gmg():
    """The JAX gate (tests/test_multigrid.py:217-228) on both packages."""
    jm, _r, _f, _v = _problem(2, "poisson", fem, dtype=jnp.float64)
    jm.attach_structured_grid(*DIMS[2])
    ju, jb = jm._solve_gmg(1.0, jm.compute_rhs(), rtol=1e-12)
    m, _r, fixed, vals = _problem(2, "poisson", pt, dtype=torch.float64)
    m.attach_structured_grid(*DIMS[2])
    u, b = m._solve_system(None, m.compute_rhs(), "gmg", rtol=1e-12)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-7,
                               atol=1e-10)
    assert np.abs(b.numpy() - np.asarray(jb)).max() <= 1e-12 * np.abs(
        np.asarray(jb)).max()
    np.testing.assert_allclose(u.numpy(), np.asarray(
        jm.solve(method="direct")), rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("dim,route", [(2, {"elem_path": "cuda"}),
                                       (3, {"elem_path": "otf"})],
                         ids=["2d-cuda", "3d-otf"])
def test_gmg_nonzero_dirichlet_f32_bf16(dim, route):
    m, rho, fixed, vals = _problem(dim, "elasticity", pt,
                                   dtype=torch.float32)
    m.attach_structured_grid(*DIMS[dim], omega="cheby",
                             smoother_dtype=torch.bfloat16, **route)
    u = m.solve(method="gmg", rho=rho, rtol=1e-6).double().numpy()
    np.testing.assert_array_equal(u[fixed], vals.astype(np.float32))
    m64, _r, _f, _v = _problem(dim, "elasticity", pt, dtype=torch.float64)
    K, b = m64.bc.apply_scipy(
        m64.assemble_scipy(m64.element_jacobian(torch.as_tensor(rho))),
        m64.compute_rhs().numpy())
    bn = np.linalg.norm(b)
    true = np.linalg.norm(b - K @ u) / bn
    floor = 2.0 ** -24 * np.linalg.norm(abs(K) @ np.abs(u)) / bn
    assert true <= FLOOR_FACTOR * floor, (true, floor)
