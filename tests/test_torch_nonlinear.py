"""PyTorch port: the nonlinear Poisson model (``models/nonlinear_poisson.py``).

``-div(h(x)(1+u^2) grad u) = g``, Newton-solved.  Gated on the CPU in
float64 unless said (kernels K1, K2 and K9 run their plain versions)
against the JAX package on the same meshes and design vector:

* ``compute_rhs``, ``element_jacobian`` and the CSR ``compute_jacobian``
  within 1e-12, and the tangent against finite differences of the
  residual (``tests/test_nonlinear_poisson.py``'s check);
* ``solve_nonlinear("direct" | "gmres")`` against the NumPy oracle (p^T u
  1e-8) and against JAX (u within 1e-10, the same Newton count); the
  fused ``gmres`` route equal to the host loop (1e-12); the fused ``cg``
  route raising "tangent solve failed";
* the ``gmg`` route at 17x17 against JAX ``solve_nonlinear(method=
  "gmg")``: u within 1e-10, the same Newton count, the first tangent
  solve's GMRES iterations within 1 of JAX's, fused equal to host
  (1e-10); at 33x33 (the port alone) the first tangent solve in <= 30
  GMRES iterations; on a jittered raster (no raster tables: the
  einsum tangent and ``Stencil2D.assemble``) against JAX's gmg Newton;
* the raster fast path against the generic einsum path (1e-13), port
  against port and against JAX; the float32 route's float64-flux
  residual norm against a numpy float64 evaluation of the same float32
  planes (1e-12 of ||load||);
* the reference faults not inherited (ADVICE.md): a raster off the
  origin solves its own problem, a non-raster node numbering raises at
  attach time, and re-attaching leaves no solve state of the old
  assembler.

The JAX references are built once per module.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu.models.nonlinear_poisson import (
    _tangent_elem as j_tangent_elem,
)
from oracles.nonlinear_poisson_oracle import NonlinearPoissonOracle

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch.models.nonlinear_poisson import (
    _tangent_elem,
)

import torch_threads  # noqa: F401  (one torch thread per worker)

XDV = np.ones(10) / 10
DEV = "cpu"


def _mesh(n):
    return fem.ProblemCreator(nnodes_x=n, nnodes_y=n).create_poisson_problem()


def _counted(model):
    """Count the Newton loop's residual evaluations (Newton iterations)."""
    calls = []
    inner = model.residual

    def residual(xdv, u):
        calls.append(1)
        return inner(xdv, u)

    model.residual = residual
    return calls


def _solve(model, method, **kw):
    calls = _counted(model)
    u = model.solve_nonlinear(method=method, xdv=XDV, verbose=False, **kw)
    del model.residual
    return np.asarray(u), len(calls)


@pytest.fixture(scope="module")
def refs16():
    """16x16: the oracle and JAX's host-loop solves."""
    conn, X, fixed = _mesh(16)
    jm = fem.NonlinearPoisson("quad4", X, conn, fixed)
    out = {"mesh": (conn, X, fixed),
           "oracle": NonlinearPoissonOracle(conn, X, fixed).solve(XDV)}
    for method in ("direct", "gmres"):
        out[method] = _solve(jm, method)
    return out


@pytest.fixture(scope="module")
def refs17():
    """17x17 gmg: JAX's host-loop solve and its first tangent solve."""
    conn, X, fixed = _mesh(17)
    jm = fem.NonlinearPoisson("quad4", X, conn, fixed)
    jm.attach_structured_grid(17, 17)
    u, k = _solve(jm, "gmg")
    u0 = jnp.zeros(jm.ndof)
    res0 = jm.residual(jnp.asarray(XDV), u0)
    li = int(jm._gmg_newton_jit(jnp.asarray(XDV), u0, res0, 1e-8)[1])
    return dict(mesh=(conn, X, fixed), u=u, k=k, li=li)


def test_rhs_and_jacobian_match_jax():
    conn, X, fixed = _mesh(9)
    rng = np.random.default_rng(0)
    xdv = rng.uniform(0.0, 1.0, 6)
    u = 0.3 * rng.standard_normal(81)
    jm = fem.NonlinearPoisson("quad4", X, conn, fixed)
    tm = pt.NonlinearPoisson("quad4", X, conn, fixed, device=DEV)
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()
    assert rel(tm.compute_rhs(xdv, u).numpy(),
               np.asarray(jm.compute_rhs(xdv, u))) <= 1e-12
    assert rel(tm.residual(xdv, u).numpy(),
               np.asarray(jm.residual(xdv, u))) <= 1e-12
    assert rel(tm.element_jacobian(xdv, u).numpy(),
               np.asarray(jm.element_jacobian(xdv, u))) <= 1e-12
    Kt, Kj = tm.compute_jacobian(xdv, u), jm.compute_jacobian(xdv, u)
    assert rel(Kt.toarray(), Kj.toarray()) <= 1e-12
    assert np.array_equal(Kt.indptr, Kj.indptr)


def test_tangent_consistency():
    """The assembled tangent matches finite differences of the residual."""
    conn, X, fixed = _mesh(6)
    m = pt.NonlinearPoisson("quad4", X, conn, fixed, device=DEV)
    rng = np.random.RandomState(3)
    xdv = rng.rand(4)
    u = 0.1 * rng.standard_normal(m.ndof)
    K = m.compute_jacobian(xdv, u).toarray()
    h = 1e-7
    for j in [0, 7, 20]:
        du = np.zeros(m.ndof)
        du[j] = h
        fd = (m.compute_rhs(xdv, u + du) - m.compute_rhs(xdv, u - du)
              ).numpy() / (2 * h)
        np.testing.assert_allclose(K[:, j], fd, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("method", ["direct", "gmres"])
def test_solve_nonlinear_vs_oracle_and_jax(refs16, method):
    conn, X, fixed = refs16["mesh"]
    m = pt.NonlinearPoisson("quad4", X, conn, fixed, device=DEV)
    u, k = _solve(m, method)
    u_ref = refs16["oracle"]
    p = np.random.RandomState(123).rand(u.shape[0])
    assert abs((p @ u - p @ u_ref) / (p @ u)) < 1e-8
    uj, kj = refs16[method]
    assert k == kj
    assert np.abs(u - uj).max() <= 1e-10 * np.abs(uj).max()


def test_fused_gmres_matches_host_loop(refs16):
    conn, X, fixed = refs16["mesh"]
    m = pt.NonlinearPoisson("quad4", X, conn, fixed, device=DEV)
    u_host, k_host = _solve(m, "gmres")
    u, k, rn = m.solve_nonlinear_fused(method="gmres", xdv=XDV,
                                       verbose=False)
    assert np.abs(u.numpy() - u_host).max() < 1e-12
    assert k == k_host >= 4
    assert float(rn) < 1e-10 * 3.1
    st = m.last_solve_stats
    assert st["newton_iters"] == k and len(st["lin_iters"]) == k - 1


def test_fused_cg_raises(refs16):
    """Plain CG stalls on the nonsymmetric tangent; the stalled-solve
    guard freezes u and raises at the boundary."""
    conn, X, fixed = refs16["mesh"]
    m = pt.NonlinearPoisson("quad4", X, conn, fixed, device=DEV)
    with pytest.raises(RuntimeError, match="tangent solve failed"):
        m.solve_nonlinear_fused(method="cg", xdv=XDV, verbose=False)


def test_gmg_newton_matches_jax(refs17):
    conn, X, fixed = refs17["mesh"]
    m = pt.NonlinearPoisson("quad4", X, conn, fixed, device=DEV)
    m.attach_structured_grid(17, 17)
    u, k = _solve(m, "gmg")
    assert k == refs17["k"]
    assert np.abs(u - refs17["u"]).max() <= 1e-10 * np.abs(refs17["u"]).max()
    u0 = torch.zeros(m.ndof, dtype=torch.float64)
    res0 = m.residual(XDV, u0)
    li = m._gmg_tangent_solve_fn()(m._xdv(XDV), u0, res0, 1e-8)[1]
    assert abs(li - refs17["li"]) <= 1
    uf, kf, _rn = m.solve_nonlinear_fused(method="gmg", xdv=XDV,
                                          verbose=False)
    assert np.abs(uf.numpy() - u).max() <= 1e-10 * np.abs(u).max()
    assert kf >= 4


def test_gmg_first_tangent_solve_iterations_33():
    """V-cycle preconditioning keeps the Krylov count O(10) on the first
    Newton step (``test_nonlinear_poisson.py``'s bound, 30)."""
    conn, X, fixed = _mesh(33)
    m = pt.NonlinearPoisson("quad4", X, conn, fixed, device=DEV)
    m.attach_structured_grid(33, 33)
    u0 = torch.zeros(m.ndof, dtype=torch.float64)
    res0 = m.residual(XDV, u0)
    _du, li, lr, bnorm = m._gmg_tangent_solve_fn()(m._xdv(XDV), u0, res0,
                                                   1e-8)
    assert 0 < li <= 30
    assert float(lr) <= 1e-8 * float(bnorm) * 10


def test_uniform_fast_path_equivalence():
    """The scatter-free raster residual and tangent planes equal the
    generic einsum + assembly (1e-13), port against port and against the
    JAX package's fast path."""
    n = 17
    conn, X, fixed = _mesh(n)
    rng = np.random.RandomState(0)
    xdv = rng.rand(6)
    u = 0.3 * rng.standard_normal(n * n)
    m = pt.NonlinearPoisson("quad4", X, conn, fixed, device=DEV)
    m.attach_structured_grid(n, n)
    assert m._unif is not None
    xt, ut = m._xdv(xdv), torch.as_tensor(u)
    r_fast = m._uniform_residual(xt, ut).numpy()
    assert np.abs(r_fast - m.residual(xdv, u).numpy()).max() < 1e-13
    r64, rn = m._uniform_residual_f64(xt, ut)
    assert np.abs(r64.numpy() - r_fast).max() < 1e-13
    assert abs(float(rn) - np.linalg.norm(r_fast)) < 1e-13
    st0 = m._gmg_newton.static_levels[0].op
    cs, cr = m._uniform_tangent_coeffs(xt, ut.reshape(n, n))
    c_ref = st0.assemble(_tangent_elem(m.Xe, m.dN, m.N, m.wq, m.conn, xt,
                                       ut))
    assert float((cs + cr - c_ref).abs().max()) < 1e-13

    jm = fem.NonlinearPoisson("quad4", X, conn, fixed)
    jm.attach_structured_grid(n, n)
    xj, uj = jnp.asarray(xdv), jnp.asarray(u)
    assert np.abs(r_fast - np.asarray(jm._uniform_residual(xj, uj))
                  ).max() < 1e-13
    jcs, jcr = jm._uniform_tangent_coeffs(xj, uj.reshape(n, n))
    assert np.abs((cs + cr).numpy() - np.asarray(jcs + jcr)).max() < 1e-13
    j_ref = jm._gmg_newton.static_levels[0][0].assemble(j_tangent_elem(
        jm.Xe, jm.dN, jm.N, jm.wq, jm.conn, xj, uj))
    assert np.abs(c_ref.numpy() - np.asarray(j_ref)).max() < 1e-13


def test_f32_residual_has_a_float64_flux():
    """The float32 route's residual norm is the float64 residual of the
    float32 coefficient planes (numpy float64 stencil product), not the
    float32 ``flux - load`` difference."""
    n = 33
    conn, X, fixed = _mesh(n)
    m = pt.NonlinearPoisson("quad4", X, conn, fixed, dtype=torch.float32,
                            device=DEV)
    m.attach_structured_grid(n, n)
    rng = np.random.default_rng(2)
    u = torch.as_tensor(0.5 * rng.standard_normal(n * n),
                        dtype=torch.float32)
    xdv = m._xdv(XDV)
    cs, _ = m._uniform_tangent_coeffs(xdv, u.reshape(n, n), rank=False)
    assert cs.dtype == torch.float32
    r32, rn = m._uniform_residual_f64(xdv, u, cs)
    assert r32.dtype == torch.float32 and rn.dtype == torch.float64
    c = cs.numpy().astype(np.float64)[0, 0]
    up = np.pad(u.numpy().astype(np.float64).reshape(n, n), 1)
    flux = sum(c[dy, dx] * up[dy : dy + n, dx : dx + n]
               for dy in range(3) for dx in range(3))
    load = m._unif["load"].numpy()
    r = np.where(m.bc.mask.numpy(), 0.0, flux.reshape(-1) - load)
    assert abs(float(rn) - np.linalg.norm(r)) <= 1e-12 * np.linalg.norm(load)
    # the float32 difference is measurably off at this size
    r_f32 = m._uniform_residual(xdv, u, cs).numpy().astype(np.float64)
    assert np.abs(r_f32 - r).max() > 0


def test_shifted_raster_solves_its_own_problem():
    """A raster off the origin: the assembler's extents are X.max() -
    X.min(), so the gmg Newton (fast path) converges to the direct Newton
    solution of the same mesh (the JAX package assumes the origin and
    would scale the element matrices for extents 1.25 x 0.5)."""
    n = 17
    conn, X, fixed = _mesh(n)
    Xs = X + np.array([0.25, -0.5])
    m = pt.NonlinearPoisson("quad4", Xs, conn, fixed, device=DEV)
    u_dir, _k = _solve(m, "direct")
    m.attach_structured_grid(n, n)
    assert m._unif is not None
    assert m._gmg_newton.static_levels[0].Kq.shape == (4, 4, 4)
    uf, _k, _rn = m.solve_nonlinear_fused(method="gmg", xdv=XDV,
                                          verbose=False)
    # both stop at the Newton tolerance (1e-10 of the first residual)
    assert np.abs(uf.numpy() - u_dir).max() <= 1e-8 * np.abs(u_dir).max()
    # the same planes as an unshifted model: only the spacing matters
    m0 = pt.NonlinearPoisson("quad4", X, conn, fixed, device=DEV)
    m0.attach_structured_grid(n, n)
    assert torch.allclose(m._gmg_newton.static_levels[0].Kq,
                          m0._gmg_newton.static_levels[0].Kq,
                          rtol=0, atol=1e-14)


def test_non_raster_numbering_raises_at_attach():
    n = 9
    conn, X, fixed = _mesh(n)
    perm = np.random.default_rng(1).permutation(n * n)  # new -> old
    inv = np.argsort(perm)
    m = pt.NonlinearPoisson("quad4", X[perm], inv[conn], inv[fixed],
                            device=DEV)
    with pytest.raises(ValueError, match="raster"):
        m.attach_structured_grid(n, n)


def test_reattach_leaves_no_stale_solve_state():
    """Re-attaching with other GMG options: the next fused solve runs the
    new hierarchy, bit for bit a fresh model's."""
    n = 17
    conn, X, fixed = _mesh(n)
    m = pt.NonlinearPoisson("quad4", X, conn, fixed, device=DEV)
    m.attach_structured_grid(n, n)
    m.solve_nonlinear_fused(method="gmg", xdv=XDV, verbose=False)
    lin_a = m.last_solve_stats["lin_iters"]
    m.attach_structured_grid(n, n, nu_pre=1, nu_post=1, omega=0.5)
    u, k, _ = m.solve_nonlinear_fused(method="gmg", xdv=XDV, verbose=False)
    fresh = pt.NonlinearPoisson("quad4", X, conn, fixed, device=DEV)
    fresh.attach_structured_grid(n, n, nu_pre=1, nu_post=1, omega=0.5)
    u2, k2, _ = fresh.solve_nonlinear_fused(method="gmg", xdv=XDV,
                                            verbose=False)
    assert torch.equal(u, u2) and k == k2
    assert m.last_solve_stats["lin_iters"] == \
        fresh.last_solve_stats["lin_iters"] != lin_a


def test_fused_verbose_prints_the_residual_table(capsys):
    conn, X, fixed = _mesh(9)
    m = pt.NonlinearPoisson("quad4", X, conn, fixed, device=DEV)
    m.attach_structured_grid(9, 9)
    _u, k, _rn = m.solve_nonlinear_fused(method="gmg", xdv=XDV,
                                         verbose=True)
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("pyfem-tpu-fused") for line in out) == k
    assert sum("[gmg:" in line for line in out) == k - 1
    assert m.last_solve_stats["resnorms"][-1] < 1e-10 * \
        m.last_solve_stats["resnorms"][0]


def test_gmg_generic_branch_on_jittered_raster():
    """Raster numbering, non-uniform spacing: no raster tables, the
    tangent comes from the element einsum and ``Stencil2D.assemble`` —
    against the JAX package's gmg Newton on the same mesh (u within
    1e-10, the same Newton count) and fused equal to host."""
    n = 9
    conn, X, fixed = _mesh(n)
    h = 1.0 / (n - 1)
    rng = np.random.default_rng(3)
    inner = ((X > 0) & (X < X.max(axis=0))).all(axis=1)
    Xj = X.copy()
    Xj[inner] += 0.1 * h * rng.uniform(-1, 1, (int(inner.sum()), 2))
    jm = fem.NonlinearPoisson("quad4", Xj, conn, fixed)
    jm.attach_structured_grid(n, n)
    uj, kj = _solve(jm, "gmg")
    m = pt.NonlinearPoisson("quad4", Xj, conn, fixed, device=DEV)
    m.attach_structured_grid(n, n)
    assert m._unif is None
    u, k = _solve(m, "gmg")
    assert k == kj
    assert np.abs(u - uj).max() <= 1e-10 * np.abs(uj).max()
    uf, kf, _rn = m.solve_nonlinear_fused(method="gmg", xdv=XDV,
                                          verbose=False)
    assert np.abs(uf.numpy() - u).max() <= 1e-10 * np.abs(u).max()
