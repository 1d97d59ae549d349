"""PyTorch port held to the JAX package's multigrid gates, on CPU.

Twins of ``tests/test_multigrid.py`` (lines 29-349) and
``tests/test_structured_3d_paths.py``, each on the JAX test's problem,
seed and tolerance, with the port's ``pcg`` / ``build_*_gmg`` /
``GMGAssembler[3D]`` in place of the JAX ones and the port's direct
solve (host scipy) as the yardstick where the JAX gate holds against
its own:

* R = P^T (2D and 3D, the slice forms) and P keeps affine fields;
* Galerkin consistency: the rediscretized coarse operator equals
  R A_f P, on the un-eliminated operators (``_dirichlet_lift``: K1 with
  every dof free, its plain version here);
* GMG-PCG against the direct solve: 65x33 elasticity, 33x33 Poisson,
  33x17 elasticity at p = 3 with a random density, 17x9x9 hex8 Poisson
  and elasticity, with the JAX gates' iteration limits;
* ``solve(method="gmg")`` and ``compliance(solver="gmg")`` at 49x25;
* the interleave, slice and convolution transfers agree (2D and 3D,
  even and odd extents) and ``_restrict_nodal`` is the stride-2 slice;
* nu = 8 (the JAX gate of the sweep budget): K2's one-call form (here
  its plain version) in float32 converges below maxiter, its true
  residual against an independently assembled float64 operator (the
  model's scipy matrix) within 2e-4 of ||b|| and the solution within
  2e-3 (rel L2) of the float64 direct solve;
* a general 3D Dirichlet mask (x = 0 face clamped, z pinned on y = max);
* hex8 gmg against direct at 9^3 (rel 1e-8) and the hex8 Helmholtz
  filter's structured path against its general one (1e-8);
* nonzero Dirichlet values refused where the JAX package refuses them
  outright (``attach_pmg``, the gmg Newton tangent path), with its
  messages.
"""

import numpy as np
import pytest
import torch

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.ops.dia import (
    interleave_to_planar, planar_to_interleave,
)

import torch_threads  # noqa: F401  (one torch thread per worker)

DEV = "cpu"
F64 = torch.float64


def _grid(u, nd, shape):
    return interleave_to_planar(torch.as_tensor(u), nd).reshape(
        (nd,) + tuple(shape))


def _vec(x, nd):
    return planar_to_interleave(x.reshape(-1), nd).numpy()


@pytest.mark.parametrize("dim", [2, 3])
def test_prolong_restrict_adjoint(dim):
    """<P c, f> == <c, R f> (tests/test_multigrid.py:29, :199)."""
    if dim == 2:
        rng = np.random.default_rng(0)
        cs, d, P, R = (5, 9), 2, tmg.prolong2d, tmg.restrict2d
    else:
        rng = np.random.default_rng(3)
        cs, d, P, R = (3, 5, 4), 3, tmg.prolong3d, tmg.restrict3d
    fs = tuple(2 * n - 1 for n in cs)
    c = torch.as_tensor(rng.standard_normal((d,) + cs))
    f = torch.as_tensor(rng.standard_normal((d,) + fs))
    lhs = float(torch.sum(P(c, fs) * f))
    rhs = float(torch.sum(c * R(f, cs)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_prolong_preserves_linears():
    nyc, nxc = 5, 7
    nyf, nxf = 2 * nyc - 1, 2 * nxc - 1
    yc, xc = np.meshgrid(np.linspace(0, 1, nyc), np.linspace(0, 2, nxc),
                         indexing="ij")
    c = torch.as_tensor((2.0 * xc - 3.0 * yc + 1.0)[None])
    f = tmg.prolong2d(c, (nyf, nxf))[0].numpy()
    yf, xf = np.meshgrid(np.linspace(0, 1, nyf), np.linspace(0, 2, nxf),
                         indexing="ij")
    np.testing.assert_allclose(f, 2.0 * xf - 3.0 * yf + 1.0, atol=1e-12)


def test_galerkin_consistency_poisson():
    """R A_f P e == A_c e for coarse unit vectors, fixed nodes included
    (tests/test_multigrid.py:56), on the un-eliminated operators."""
    fine = tmg.GMGAssembler(17, 9, 2.0, 1.0, "poisson", dtype=F64,
                            device=DEV)
    coarse = tmg.GMGAssembler(9, 5, 2.0, 1.0, "poisson", dtype=F64,
                              device=DEV)
    assert fine.sizes[1] == (9, 5)
    fs, cs = (9, 17), (5, 9)
    nc = cs[0] * cs[1]
    for j in [0, nc // 3, nc // 2, nc - 1]:
        e = torch.zeros(nc, dtype=F64)
        e[j] = 1.0
        e = e.reshape((1,) + cs)
        Pe = tmg.prolong2d(e, fs)
        RAPe = tmg.restrict2d(fine._dirichlet_lift(torch.ones(17 * 9), Pe),
                              cs)
        Ae = coarse._dirichlet_lift(torch.ones(nc), e)
        np.testing.assert_allclose(RAPe.numpy().ravel(),
                                   Ae.numpy().ravel(), atol=1e-13)


def _elasticity(dims, p=0.0, dtype=F64, **kw):
    et = "quad" if len(dims) == 2 else "block"
    c = pt.ProblemCreator(*dims, element_type=et)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m = pt.LinearElasticity("quad4" if len(dims) == 2 else "hex8", X, conn,
                            fixed, None, force, p=p, dtype=dtype,
                            device=DEV, **kw)
    return m, X


def _poisson(dims):
    et = "quad" if len(dims) == 2 else "block"
    conn, X, fixed = pt.ProblemCreator(
        *dims, element_type=et).create_poisson_problem()
    m = pt.LinearPoisson("quad4" if len(dims) == 2 else "hex8", X, conn,
                         fixed, gfunc=lambda x: 1.0 + 0.0 * x[..., 0],
                         dtype=F64, device=DEV)
    return m, X


# (dims, physics, p, density seed, maxiter, iteration limit, rtol, atol):
# tests/test_multigrid.py:73, :90, :110, :133, :162
PCG_CASES = {
    "2d-elasticity": ((65, 33), "elasticity", 0.0, None, 100, 40, 1e-6,
                      1e-9),
    "2d-poisson": ((33, 33), "poisson", 0.0, None, 60, 25, 1e-7, 1e-10),
    "2d-variable-density": ((33, 17), "elasticity", 3.0, 0, 200, 80, 1e-6,
                            1e-8),
    "3d-poisson": ((17, 9, 9), "poisson", 0.0, None, 60, 30, 1e-6, 1e-10),
    "3d-elasticity": ((17, 9, 9), "elasticity", 0.0, None, 120, 60, 1e-6,
                      1e-9),
}


@pytest.mark.parametrize("case", list(PCG_CASES))
def test_gmg_pcg_matches_direct(case):
    dims, physics, p, seed, maxiter, limit, rtol, atol = PCG_CASES[case]
    m, X = (_poisson(dims) if physics == "poisson"
            else _elasticity(dims, p=p))
    nd = m.ndof_per_node
    rho = (np.ones(m.nnodes) if seed is None
           else 0.3 + 0.7 * np.random.RandomState(seed).rand(m.nnodes))
    L = [float(X[:, k].max()) for k in range(len(dims))]
    cls = tmg.GMGAssembler if len(dims) == 2 else tmg.GMGAssembler3D
    asm = cls(*dims, *L, physics, p=p, dtype=F64, device=DEV)
    if len(dims) == 3:
        assert len(asm.sizes) >= 3
    gmg, lv0 = asm.assemble(torch.as_tensor(rho))
    b = torch.where(lv0.mask, 0.0, _grid(m.compute_rhs(), nd, dims[::-1]))
    x, k, _ = tmg.pcg(lv0.matvec, gmg.apply, b, rtol=1e-11,
                      maxiter=maxiter)
    assert k < limit, k
    u_ref = m.solve(method="direct", rho=rho).numpy()
    np.testing.assert_allclose(_vec(x, nd), u_ref, rtol=rtol, atol=atol)


def test_model_gmg_method():
    """tests/test_multigrid.py:206: solve(method="gmg") and
    compliance(solver="gmg") at 49x25, p = 3, a random density."""
    m, _X = _elasticity((49, 25), p=3.0)
    m.attach_structured_grid(49, 25)
    rho = 0.3 + 0.7 * np.random.RandomState(0).rand(m.nnodes)
    u = m.solve(method="gmg", rho=rho, rtol=1e-11).numpy()
    u_ref = m.solve(method="direct", rho=rho).numpy()
    np.testing.assert_allclose(u, u_ref, rtol=1e-6, atol=1e-9)
    c_gmg, _u = m.compliance(rho, solver="gmg")
    c_ref, _u = m.compliance(rho, solver="direct")
    np.testing.assert_allclose(float(c_gmg), float(c_ref), rtol=1e-7)


def test_interleave_transfers_match_slice_forms():
    """tests/test_multigrid.py:231: the interleave forms (the GMG
    defaults) equal the slice forms, and the convolution forms too."""
    rng = np.random.default_rng(7)
    for (nyc, nxc) in [(5, 9), (4, 6), (3, 17)]:
        fine = (2 * nyc - 1, 2 * nxc - 1)
        c = torch.as_tensor(rng.standard_normal((2, nyc, nxc)))
        f = torch.as_tensor(rng.standard_normal((2,) + fine))
        for P in (tmg.prolong2d_il, tmg.prolong2d_conv):
            np.testing.assert_allclose(P(c, fine).numpy(),
                                       tmg.prolong2d(c, fine).numpy(),
                                       atol=1e-13)
        for R in (tmg.restrict2d_il, tmg.restrict2d_conv):
            np.testing.assert_allclose(R(f, (nyc, nxc)).numpy(),
                                       tmg.restrict2d(f, (nyc, nxc)).numpy(),
                                       atol=1e-13)
    for cs in [(3, 5, 4), (4, 3, 6)]:
        fine = tuple(2 * n - 1 for n in cs)
        c = torch.as_tensor(rng.standard_normal((3,) + cs))
        f = torch.as_tensor(rng.standard_normal((3,) + fine))
        for P in (tmg.prolong3d_il, tmg.prolong3d_conv):
            np.testing.assert_allclose(P(c, fine).numpy(),
                                       tmg.prolong3d(c, fine).numpy(),
                                       atol=1e-13)
        for R in (tmg.restrict3d_il, tmg.restrict3d_conv):
            np.testing.assert_allclose(R(f, cs).numpy(),
                                       tmg.restrict3d(f, cs).numpy(),
                                       atol=1e-13)
    for shape in [(9, 17), (8, 16), (5, 9, 7)]:
        g = torch.as_tensor(rng.standard_normal(shape))
        want = g[(slice(None, None, 2),) * len(shape)]
        assert torch.equal(tmg._restrict_nodal(g), want)


def test_gmg_large_nu():
    """tests/test_multigrid.py:285: nu = 8 beyond K2's sweep budget of 4
    (two sweep groups a call on the card), float32, at 33x17."""
    nx, ny = 33, 17
    asm = tmg.GMGAssembler(nx, ny, 2.0, 1.0, "elasticity", p=0.0,
                           dtype=torch.float32, device=DEV, nu_pre=8,
                           nu_post=8, coarse_dense=True)
    gmg, lv0 = asm.assemble(torch.ones(ny * nx, dtype=torch.float32))
    m, _X = _elasticity((nx, ny))
    b = torch.where(lv0.mask, 0.0,
                    _grid(m.compute_rhs().float(), 2, (ny, nx)))
    x, k, _ = tmg.pcg(lv0.matvec, gmg.apply, b, rtol=1e-7, maxiter=200)
    assert k < 200
    # independent operator: the model's float64 matrix with its BCs
    K, _b = m.bc.apply_scipy(m.assemble_scipy(m.element_jacobian()),
                             np.zeros(m.ndof))
    u = _vec(x.double(), 2)
    b64 = _vec(b.double(), 2)
    true_r = np.linalg.norm(b64 - K @ u)
    assert true_r < 2e-4 * np.linalg.norm(b64)
    u_ref = m.solve(method="direct").numpy()
    assert np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref) < 2e-3


def test_gmg3d_general_dirichlet_mask():
    """tests/test_multigrid.py:322: x = 0 face clamped and the z
    component pinned on the y = max face, against the direct solve."""
    n = 9
    c = pt.ProblemCreator(n, n, n, element_type="block")
    conn, X, _f, force = c.create_linear_elasticity_problem()
    X = np.asarray(X, float)
    nodes = np.arange(X.shape[0])
    left = nodes[X[:, 0] == 0.0]
    back = nodes[X[:, 1] == X[:, 1].max()]
    fixed = np.concatenate([(3 * left[:, None] + np.arange(3)).ravel(),
                            3 * back + 2])
    m = pt.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0,
                            dtype=F64, device=DEV)
    m.attach_structured_grid(n, n, n)
    rho = 0.3 + 0.7 * np.random.RandomState(0).rand(m.nnodes)
    u = m.solve(method="gmg", rho=rho, rtol=1e-11).numpy()
    u_ref = m.solve(method="direct", rho=rho).numpy()
    np.testing.assert_allclose(u, u_ref, rtol=1e-6, atol=1e-9)


def test_hex8_gmg_solve_matches_direct():
    """tests/test_structured_3d_paths.py:9."""
    m, _X = _elasticity((9, 9, 9))
    m.attach_structured_grid(9, 9, 9)
    u_g = m.solve(method="gmg", rtol=1e-11).numpy()
    u_d = m.solve(method="direct").numpy()
    assert np.linalg.norm(u_g - u_d) / np.linalg.norm(u_d) < 1e-8


def test_hex8_helmholtz_fast_path_matches_slow():
    """tests/test_structured_3d_paths.py:24."""
    n = 9
    c = pt.ProblemCreator(n, n, n, element_type="block")
    conn, X, _f, _F = c.create_linear_elasticity_problem()
    filt = pt.Helmholtz(0.1, "hex8", X, conn, device=DEV)
    x = np.random.RandomState(0).rand(X.shape[0])
    r_slow = filt.apply(x).numpy()
    g_slow = filt.apply_gradient(x).numpy()
    filt.attach_structured_grid(n, n, n)
    assert np.abs(filt.apply(x).numpy() - r_slow).max() < 1e-8
    assert np.abs(filt.apply_gradient(x).numpy() - g_slow).max() < 1e-8


def test_dirichlet_refusals_match_jax():
    """Nonzero Dirichlet values are refused where the JAX package refuses
    them outright: p-multigrid and the gmg Newton tangent path.  The JAX
    package asserts; the port raises ``ValueError`` with its message."""
    import pyfem_gpu_testflight_tpu as fem

    c = pt.ProblemCreator(5, 5, 5, element_type="brick20")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    vals = np.ones(len(fixed))
    msg = "pmg supports zero Dirichlet values only"
    jm = fem.LinearElasticity("brick20", X, conn, fixed, vals, force)
    with pytest.raises(AssertionError, match=msg):
        jm.attach_pmg(5, 5, 5)
    m = pt.LinearElasticity("brick20", X, conn, fixed, vals, force,
                            device=DEV)
    with pytest.raises(ValueError, match=msg):
        m.attach_pmg(5, 5, 5)
    conn, X, fixed = pt.ProblemCreator(9, 9).create_poisson_problem()
    vals = np.ones(len(fixed))
    msg = "gmg Newton tangent path supports zero Dirichlet values only"
    with pytest.raises(AssertionError, match=msg):
        fem.NonlinearPoisson("quad4", X, conn, fixed,
                             vals).attach_structured_grid(9, 9)
    with pytest.raises(ValueError, match=msg):
        pt.NonlinearPoisson("quad4", X, conn, fixed, vals,
                            device=DEV).attach_structured_grid(9, 9)
