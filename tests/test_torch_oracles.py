"""PyTorch port against the in-repo loop oracles (``tests/oracles/``).

The independent loop-based truth sources that the JAX package's tests
hold it to, now held to the port on CPU, float64, einsum route, at the
JAX tests' sizes and their projection tolerance (p . u relative error,
seed-123 projection; the reference's comparison convention):

* ``plane_stress_oracle``: 32x32 plane stress, direct (1e-10;
  ``tests/test_elasticity.py:13``), and the Lame-form element stiffness
  equal to an explicit Voigt B^T C B assembly (1e-12; ``:79``);
* ``helmholtz_oracle``: the 32x32 filter and its gradient, r0 = 0.1
  (1e-8; ``tests/test_helmholtz.py:12``);
* ``hex8_oracle``: 8^3 hex8 elasticity (direct and CG at rtol 1e-12) and
  Poisson with g = xy + z (direct), 1e-10 (``tests/test_hex8_oracle
  .py``);
* ``quadratic_oracle``: tet10 and brick20 Poisson on 7^3 lattices, g
  affine, 1e-10 (``tests/test_quadratic_oracles.py``);
* the 3D Poisson solves per quadratic element type at 5^3: CG at rtol
  1e-12 against direct (rtol 1e-7, atol 1e-10;
  ``tests/test_element_types.py:40``).  That file's complex-step dK/dx
  gate is a case of ``tests/test_torch_complex_step.py``.
"""

import numpy as np
import pytest
import torch

import pyfem_gpu_testflight_tpu_torch as pt
from oracles.helmholtz_oracle import HelmholtzFilterOracle
from oracles.hex8_oracle import solve_elasticity_3d, solve_poisson_3d
from oracles.plane_stress_oracle import solve_plane_stress
from oracles.quad4_common import GAUSS_2D, jacobian_2d, quad4_shape
from oracles.quadratic_oracle import (
    solve_poisson_brick20, solve_poisson_tet10,
)

import torch_threads  # noqa: F401  (one torch thread per worker)

DEV = "cpu"


def _proj_rel_err(u, u_ref):
    p = np.random.RandomState(123).rand(np.shape(u_ref)[0])
    u = u.numpy() if torch.is_tensor(u) else np.asarray(u)
    return abs((p @ u - p @ u_ref) / (p @ u_ref))


def test_plane_stress_vs_oracle():
    c = pt.ProblemCreator(nnodes_x=32, nnodes_y=32)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m = pt.LinearElasticity("quad4", X, conn, fixed, None, force,
                            device=DEV)
    u = m.solve(method="direct")
    assert _proj_rel_err(u, solve_plane_stress(conn, X, fixed,
                                               force)) < 1e-10


def test_lame_form_matches_bmatrix_form():
    c = pt.ProblemCreator(nnodes_x=5, nnodes_y=4)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m = pt.LinearElasticity("quad4", X, conn, fixed, None, force,
                            device=DEV)
    Ke = m.element_jacobian().numpy()
    E, nu = m.E, m.nu
    C = (E / (1 - nu**2)) * np.array(
        [[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, 0.5 * (1 - nu)]])
    for e in range(conn.shape[0]):
        Xe = X[conn[e]]
        ke = np.zeros((8, 8))
        for xi, eta in GAUSS_2D:
            _N, dN = quad4_shape(xi, eta)
            _J, detJ, invJ = jacobian_2d(Xe, dN)
            G = dN @ invJ
            B = np.zeros((3, 8))
            for a in range(4):
                B[0, 2 * a] = G[a, 0]
                B[1, 2 * a + 1] = G[a, 1]
                B[2, 2 * a] = G[a, 1]
                B[2, 2 * a + 1] = G[a, 0]
            ke += detJ * (B.T @ C @ B)
        np.testing.assert_allclose(Ke[e], ke, rtol=1e-12, atol=1e-12)


def test_helmholtz_filter_vs_oracle():
    c = pt.ProblemCreator(nnodes_x=32, nnodes_y=32, element_type="quad")
    conn, X, x = c.create_helmholtz_problem()
    r0 = 0.1
    gradrho = np.random.RandomState(0).rand(x.shape[0])
    filt = pt.Helmholtz(r0, "quad4", X, conn, device=DEV)
    u = filt.apply(x).numpy()
    gx = filt.apply_gradient(gradrho).numpy()
    oracle = HelmholtzFilterOracle(r0, conn, X)
    u_ref, gx_ref = oracle.apply(x), oracle.apply_gradient(gradrho)
    p = np.random.RandomState(123).rand(u.shape[0])
    assert abs((p @ u - p @ u_ref) / (p @ u)) < 1e-8
    assert abs((p @ gx - p @ gx_ref) / (p @ u)) < 1e-8


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_hex8_vs_oracle(physics):
    c = pt.ProblemCreator(nnodes_x=8, nnodes_y=8, nnodes_z=8,
                          element_type="block")
    if physics == "elasticity":
        conn, X, fixed, force = c.create_linear_elasticity_problem()
        m = pt.LinearElasticity("hex8", X, conn, fixed, None, force,
                                device=DEV)
        u_ref = solve_elasticity_3d(conn, X, fixed, force)
        us = [m.solve(method="direct"), m.solve(method="cg", rtol=1e-12)]
    else:
        conn, X, fixed = c.create_poisson_problem()
        m = pt.LinearPoisson(
            "hex8", X, conn, fixed, None,
            gfunc=lambda x: x[..., 0] * x[..., 1] + x[..., 2], device=DEV)
        u_ref = solve_poisson_3d(conn, X, fixed,
                                 lambda x: x[0] * x[1] + x[2])
        us = [m.solve(method="direct")]
    for u in us:
        assert _proj_rel_err(u, u_ref) < 1e-10


def _g(x):
    return 1.0 + x[..., 0] + 2.0 * x[..., 1] - 0.5 * x[..., 2]


@pytest.mark.parametrize("etype,make,oracle", [
    ("tet10", "tet", solve_poisson_tet10),
    ("brick20", "brick20", solve_poisson_brick20)], ids=["tet10", "brick20"])
def test_quadratic_poisson_vs_oracle(etype, make, oracle):
    c = pt.ProblemCreator(nnodes_x=7, nnodes_y=7, nnodes_z=7,
                          element_type=make)
    conn, X, fixed = c.create_poisson_problem()
    m = pt.LinearPoisson(etype, X, conn, fixed, gfunc=_g, device=DEV)
    u = m.solve(method="direct")
    assert _proj_rel_err(u, oracle(conn, X, fixed, _g)) < 1e-10


@pytest.mark.parametrize("element_type", ["tet", "brick20"])
def test_solves_3d_poisson(element_type):
    c = pt.ProblemCreator(nnodes_x=5, nnodes_y=5, nnodes_z=5,
                          element_type=element_type)
    conn, X, fixed = c.create_poisson_problem()
    m = pt.LinearPoisson(element_type, X, conn, fixed,
                         gfunc=lambda x: torch.ones(x.shape[:-1],
                                                    dtype=x.dtype),
                         device=DEV)
    u_d = m.solve(method="direct").numpy()
    u_c = m.solve(method="cg", rtol=1e-12).numpy()
    np.testing.assert_allclose(u_c, u_d, rtol=1e-7, atol=1e-10)
    assert np.all(np.isfinite(u_d)) and np.abs(u_d).max() > 0
