"""PyTorch port: post-processing against the JAX package on CPU (float64).

Gates, on the same seeded inputs as the JAX functions:

* quadrature strains and stresses (RAMP-scaled), nodal strains, the
  consistent and lumped mass, the KS aggregate and its adjoint rhs
  equal the JAX results within 1e-12 (relative to the largest entry),
  on quad4 elasticity, hex8 elasticity and quad4 Poisson;
* ``natural_frequencies`` (host eigsh) within 1e-8 of the JAX result;
* ``natural_frequencies_device`` (the port's block LOBPCG) within 1e-6
  of eigsh on the same lumped mass and of the JAX LOBPCG;
* ``solve_adjoint`` on ``cg`` and ``gmg`` within 1e-8 of the JAX direct
  solve at the same density;
* the JAX file's own checks (tests/test_postprocess.py) on the port: an
  affine field's exact strains, stress:strain energy = u^T K u, total
  mass, Rayleigh quotient of the first mode, KS bounds and its adjoint
  rhs against finite differences, and the KS design gradient against a
  complex step to 1e-12;
* one float32 structured case: a GMG solve at 33x17 with a bf16
  smoother copy (flexible PCG, the iterates of ``pcg_gmg(flexible=True)``
  bit for bit) post-processed in float32 against the same functions in
  float64 on the same u.

JAX references are built once per module.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread per worker)
import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import postprocess as jpost
import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import postprocess as post

DEV = "cpu"
TOL = 1e-12


def _rel(got, ref):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _elasticity(fem_mod, etype, dims, **kw):
    kind = {"quad4": "quad", "hex8": "block"}[etype]
    c = fem_mod.ProblemCreator(*dims, element_type=kind)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    return fem_mod.LinearElasticity(etype, X, conn, fixed, None, force,
                                    **kw)


def _poisson(fem_mod, n, **kw):
    conn, X, fixed = fem_mod.ProblemCreator(n, n).create_poisson_problem()
    return fem_mod.LinearPoisson("quad4", X, conn, fixed,
                                 gfunc=lambda x: 1.0 + 0 * x[..., 0], **kw)


@pytest.fixture(scope="module")
def pairs():
    """(port model, JAX model, u, rho) for each problem."""
    out = {}
    for name, (mk, args) in {
        "quad4": (_elasticity, ("quad4", (11, 7))),
        "hex8": (_elasticity, ("hex8", (5, 4, 3))),
    }.items():
        m = mk(pt, *args, p=3.0, device=DEV)
        j = mk(fem, *args, p=3.0)
        rng = np.random.RandomState(7)
        out[name] = (m, j, rng.standard_normal(m.ndof),
                     0.3 + 0.7 * rng.rand(m.nnodes))
    m, j = _poisson(pt, 9, p=2.0, device=DEV), _poisson(fem, 9, p=2.0)
    rng = np.random.RandomState(8)
    out["poisson"] = (m, j, rng.rand(m.ndof), rng.rand(m.nnodes))
    return out


@pytest.mark.parametrize("name", ["quad4", "hex8"])
def test_strains_stresses_match_jax(pairs, name):
    m, j, u, rho = pairs[name]
    for fn, args in ((post.quadrature_strains, ()),
                     (post.nodal_strains, ()),
                     (post.quadrature_stresses, ()),
                     (post.quadrature_stresses, (rho,))):
        got = fn(m, u, *args)
        ref = getattr(jpost, fn.__name__)(j, jnp.asarray(u), *args)
        assert tuple(got.shape) == tuple(ref.shape)
        assert _rel(got, ref) <= TOL, fn.__name__
    # the element -> node sums are deterministic
    assert torch.equal(post.nodal_strains(m, u), post.nodal_strains(m, u))


@pytest.mark.parametrize("name", ["quad4", "poisson"])
def test_mass_and_lumped_mass_match_jax(pairs, name):
    m, j, _, _ = pairs[name]
    assert _rel(post.mass_matrix(m, density=2.5),
                jpost.mass_matrix(j, density=2.5)) <= TOL
    assert _rel(post.lumped_mass(m, 1.5), jpost.lumped_mass(j, 1.5)) <= TOL


def test_ks_and_adjoint_rhs_match_jax(pairs):
    m, j, u, _ = pairs["poisson"]
    for pval in (5.0, 50.0):
        ks = float(post.ks_aggregate(m, u, pval))
        ks_ref = float(jpost.ks_aggregate(j, jnp.asarray(u), pval))
        assert abs(ks - ks_ref) <= TOL * abs(ks_ref)
        assert _rel(post.ks_adjoint_rhs(m, u, pval),
                    jpost.ks_adjoint_rhs(j, jnp.asarray(u), pval)) <= TOL


def test_natural_frequencies_match_jax():
    m = _elasticity(pt, "quad4", (24, 6), device=DEV)
    j = _elasticity(fem, "quad4", (24, 6))
    w, modes = post.natural_frequencies(m, k=4, density=1.0)
    w_ref, _ = jpost.natural_frequencies(j, k=4, density=1.0)
    np.testing.assert_allclose(w, w_ref, rtol=1e-8)
    assert np.all(w > 0) and np.all(np.diff(w) >= -1e-9)
    assert np.abs(modes[m.bc.fixed]).max() < 1e-12
    # Rayleigh quotient of the first mode
    K = m.assemble_scipy(m.element_jacobian())
    M = m.assemble_scipy(post.mass_matrix(m))
    v = modes[:, 0]
    np.testing.assert_allclose(np.sqrt((v @ (K @ v)) / (v @ (M @ v))), w[0],
                               rtol=1e-5)


def test_natural_frequencies_device_matches_eigsh_and_jax():
    from scipy.sparse import diags, linalg as sla

    m = _elasticity(pt, "quad4", (24, 12), device=DEV)
    j = _elasticity(fem, "quad4", (24, 12))
    K = m.assemble_scipy(m.element_jacobian())
    ml = post.lumped_mass(m).numpy()
    free = np.setdiff1d(np.arange(m.ndof), m.bc.fixed)
    ref, _ = sla.eigsh(K[free][:, free].tocsc(), M=diags(ml[free]).tocsc(),
                       k=4, sigma=0.0, which="LM")
    ref = np.sqrt(np.maximum(np.sort(ref), 0))
    w, modes = post.natural_frequencies_device(m, k=4)
    np.testing.assert_allclose(w.numpy(), ref, rtol=1e-6)
    w_j, _ = jpost.natural_frequencies_device(j, k=4)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-6)
    assert np.abs(modes.numpy()[m.bc.fixed]).max() < 1e-12
    st = m.last_eig_stats
    assert 0 < st["iters"] <= 200 and st["applies"] >= 2 * st["iters"]


@pytest.mark.parametrize("method", ["cg", "gmg"])
def test_solve_adjoint_matches_jax_direct(method):
    nx, ny = 17, 9
    m = _elasticity(pt, "quad4", (nx, ny), p=3.0, device=DEV)
    j = _elasticity(fem, "quad4", (nx, ny), p=3.0)
    rng = np.random.RandomState(2)
    rho = 0.3 + 0.7 * rng.rand(m.nnodes)
    rhs = np.where(m.bc.mask.numpy(), 0.0, rng.standard_normal(m.ndof))
    if method == "gmg":
        m.attach_structured_grid(nx, ny)
    psi = post.solve_adjoint(m, rhs, rho=rho, method=method, rtol=1e-12)
    ref = jpost.solve_adjoint(j, jnp.asarray(rhs), rho=jnp.asarray(rho),
                              method="direct")
    assert _rel(psi, ref) <= 1e-8


def test_strains_exact_for_linear_field():
    """An affine displacement field has constant, exact strains."""
    m = _elasticity(pt, "quad4", (8, 6), device=DEV)
    A = np.array([[2e-3, 1e-3], [-5e-4, 3e-3]])  # du_a/dx_l
    u = (m.X_host @ A.T).reshape(-1)
    expected = np.array([A[0, 0], A[1, 1], A[0, 1] + A[1, 0]])
    for fn in (post.quadrature_strains, post.nodal_strains):
        e = fn(m, u).numpy()
        np.testing.assert_allclose(e, np.broadcast_to(expected, e.shape),
                                   atol=1e-12)


def test_stress_strain_energy_and_total_mass():
    """phi^T K u equals the energy integral of stress:strain; the x
    block of the consistent mass sums to density * area."""
    from pyfem_gpu_testflight_tpu_torch.ops import geometry

    m = _elasticity(pt, "quad4", (10, 6), device=DEV)
    u = np.random.RandomState(0).standard_normal(m.ndof)
    e = post.quadrature_strains(m, u).numpy()
    s = post.quadrature_stresses(m, u).numpy()
    detJ = geometry.det_and_inv(geometry.jacobian(m.Xe, m.dN))[0].numpy()
    energy = np.einsum("eq,eqk,eqk->", detJ * m.wq.numpy()[None, :], e, s)
    K = m.assemble_scipy(m.element_jacobian())
    np.testing.assert_allclose(energy, u @ (K @ u), rtol=1e-10)
    M = m.assemble_scipy(post.mass_matrix(m, density=2.5))
    X = m.X_host
    area = np.ptp(X[:, 0]) * np.ptp(X[:, 1])
    ex = np.zeros(m.ndof)
    ex[0::2] = 1.0
    np.testing.assert_allclose(ex @ (M @ ex), 2.5 * area, rtol=1e-10)
    np.testing.assert_allclose(float(post.lumped_mass(m, 2.5).sum()),
                               2.5 * area * 2, rtol=1e-12)


def test_ks_bounds_and_adjoint_rhs_fd():
    m = _poisson(pt, 16, device=DEV)
    u = m.solve(method="direct").numpy()
    ks10 = float(post.ks_aggregate(m, u, 10.0))
    ks100 = float(post.ks_aggregate(m, u, 100.0))
    assert abs(ks100 - u.max()) < abs(ks10 - u.max()) + 1e-12
    m8 = _poisson(pt, 8, device=DEV)
    u = np.random.RandomState(1).rand(m8.nnodes)
    pval, h = 5.0, 1e-7
    g = post.ks_adjoint_rhs(m8, u, pval).numpy()
    for jdx in [3, 17, 40]:
        if u[jdx] == u.max():
            continue
        du = np.zeros_like(u)
        du[jdx] = h
        fd = (float(post.ks_aggregate(m8, u + du, pval))
              - float(post.ks_aggregate(m8, u - du, pval))) / (2 * h)
        np.testing.assert_allclose(g[jdx], fd, rtol=1e-5, atol=1e-9)


def test_ks_total_design_gradient_complex_step():
    """KS(u(rho)) design gradient: adjoint chain vs complex step."""
    from scipy.sparse.linalg import spsolve

    conn, X, fixed = pt.ProblemCreator(10, 10).create_poisson_problem()
    m = pt.LinearPoisson("quad4", X, conn, fixed, device=DEV, p=2.0,
                         gfunc=lambda x: 1 + 0 * x[..., 0])
    rng = np.random.RandomState(0)
    rho = rng.rand(m.nnodes)
    pvec = rng.rand(m.nnodes)
    pval = 10.0
    _, u = m.compliance(rho, solver="direct")
    dks = post.ks_adjoint_rhs(m, u, pval)
    psi = post.solve_adjoint(m, m.bc.zero_fixed(dks), rho=rho,
                             method="direct")
    grad = -m.k_dv_sens(rho, psi, u).numpy()
    h = 1e-30
    K = m.compute_jacobian(rho + 1j * h * pvec)
    Kbc, rhsbc = m.bc.apply_scipy(K, m.compute_rhs().numpy())
    ucs = spsolve(Kbc, rhsbc)
    fd = complex(post.ks_aggregate(m, ucs, pval)).imag / h
    assert abs(pvec.dot(grad) - fd) / abs(fd) < 1e-12


def test_float32_structured_postprocess():
    """A float32 GMG solve at 33x17: the float32 strains, stresses and
    nodal strains of u against the float64 functions on the same u."""
    nx, ny = 33, 17
    m32 = _elasticity(pt, "quad4", (nx, ny), p=3.0, dtype=torch.float32,
                      device=DEV)
    m64 = _elasticity(pt, "quad4", (nx, ny), p=3.0, device=DEV)
    rho = np.random.default_rng(0).uniform(0.3, 1.0, m32.nnodes)
    m32.attach_structured_grid(nx, ny, omega="cheby",
                               smoother_dtype=torch.bfloat16)
    u = pt.Assembler(m32).solve(method="gmg", rtol=1e-6, rho=rho)
    assert u.dtype == torch.float32 and m32.last_solve_stats["iters"] <= 20
    # a bf16 smoother copy: the model's solve is flexible PCG, the same
    # iterates as pcg_gmg(flexible=True) on its hierarchy
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops.dia import (
        interleave_to_planar, planar_to_interleave)

    gmg, lv0 = m32._gmg_asm.assemble(torch.as_tensor(rho,
                                                     dtype=torch.float32))
    b = torch.where(lv0.mask, 0.0, interleave_to_planar(
        m32.compute_rhs(), 2).reshape(2, ny, nx))
    x, k, _ = multigrid.pcg_gmg(gmg, lv0, b, rtol=1e-6, maxiter=400,
                                flexible=True)
    assert k == m32.last_solve_stats["iters"]
    assert torch.equal(planar_to_interleave(x.reshape(-1), 2), u)
    for fn, args in ((post.quadrature_strains, ()),
                     (post.quadrature_stresses, (rho,)),
                     (post.nodal_strains, ())):
        got = fn(m32, u, *args)
        assert got.dtype == torch.float32
        assert _rel(got, fn(m64, u.double(), *args).numpy()) <= 1e-5
