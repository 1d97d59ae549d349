"""PyTorch port, the 2D GMG-PCG slice end to end on CPU (float64).

Gates:
* ``restrict2d_il`` / ``prolong2d_il`` equal the JAX transfers (1e-14);
* ``smoothing_omegas`` equals the JAX factors;
* the ``__graft_entry__.entry`` configuration (65x33, p=3, rho=0.6,
  tip load, default GMGAssembler, and again with the bench's
  Chebyshev-node smoothing) solved at rtol 1e-11 takes the same
  PCG iteration count as the JAX package, with the solution within 1e-9
  relative;
* at 33x17 ``LinearElasticity.solve(method="gmg")`` gives the same
  compliance p^T u as the JAX package's ``solve(method="direct")``
  (1e-10 relative);
* the model's branches raise where the JAX package refuses (no
  attached grid) and run where it solves: ``pmg``, ``amg`` and gmg
  with nonzero Dirichlet values.

The JAX side runs its XLA path (``pallas_smooth=False``) under
``jax.jit``; the port runs K1/K2's plain versions (CPU tensors).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import multigrid as jmg
from pyfem_gpu_testflight_tpu.ops.dia import interleave_to_planar as j_i2p

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.ops.dia import (
    interleave_to_planar, planar_to_interleave,
)

import torch_threads  # noqa: F401  (one torch thread per worker)

# the port's entry points default to the CUDA card; these tests run on CPU
DEV = "cpu"


@pytest.mark.parametrize("shape", [(33, 65), (17, 33), (5, 9)])
def test_transfers_match_jax(shape):
    nyf, nxf = shape
    nyc, nxc = (nyf + 1) // 2, (nxf + 1) // 2
    rng = np.random.default_rng(nyf)
    f = rng.standard_normal((2, nyf, nxf))
    c = rng.standard_normal((2, nyc, nxc))
    r_ref = np.asarray(jmg.restrict2d_il(jnp.asarray(f), (nyc, nxc)))
    p_ref = np.asarray(jmg.prolong2d_il(jnp.asarray(c), (nyf, nxf)))
    r = tmg.restrict2d_il(torch.as_tensor(f), (nyc, nxc)).numpy()
    p = tmg.prolong2d_il(torch.as_tensor(c), (nyf, nxf)).numpy()
    assert np.abs(r - r_ref).max() <= 1e-14 * np.abs(r_ref).max()
    assert np.abs(p - p_ref).max() <= 1e-14 * np.abs(p_ref).max()


@pytest.mark.parametrize("nu", [1, 2, 3, 8, 24])
def test_smoothing_omegas_match_jax(nu):
    assert tmg.smoothing_omegas(nu, 2.3) == jmg.smoothing_omegas(nu, 2.3)


def test_interleave_roundtrip_matches_jax():
    u = np.arange(2 * 15, dtype=np.float64)
    got = interleave_to_planar(torch.as_tensor(u), 2).numpy()
    assert np.array_equal(got, np.asarray(j_i2p(jnp.asarray(u), 2)))
    back = planar_to_interleave(torch.as_tensor(got), 2).numpy()
    assert np.array_equal(back, u)


def _entry_solve_jax(nx, ny, rtol, omega):
    """__graft_entry__.entry()'s forward step, in float64."""
    c = fem.ProblemCreator(nnodes_x=nx, nnodes_y=ny, element_type="quad")
    conn, X, dof_fixed, nodal_force = c.create_linear_elasticity_problem()
    m = fem.LinearElasticity("quad4", X, conn, dof_fixed, None, nodal_force,
                             p=3.0, dtype=jnp.float64)
    Lx, Ly = float(X[:, 0].max()), float(X[:, 1].max())
    asm = jmg.GMGAssembler(nx, ny, Lx, Ly, "elasticity", p=3.0,
                           dtype=jnp.float64, omega=omega)

    @jax.jit
    def forward(rho, rhs):
        gmg, lv0 = asm.assemble(rho)
        b = jnp.where(lv0.mask, 0.0, j_i2p(rhs, 2).reshape(2, ny, nx))
        return jmg.pcg_gmg(gmg, lv0, b, rtol=rtol, maxiter=100)

    rho = jnp.full((m.nnodes,), 0.6)
    x, k, _ = forward(rho, m.compute_rhs())
    return np.asarray(x), int(k), (Lx, Ly), np.array(m.compute_rhs())


# 0.7: the default stationary damping; "cheby": the bench's
# Chebyshev-node factors, reversed in post-smoothing
@pytest.mark.parametrize("omega", [0.7, "cheby"])
def test_entry_config_matches_jax_f64(omega):
    nx, ny, rtol = 65, 33, 1e-11
    x_ref, k_ref, (Lx, Ly), rhs = _entry_solve_jax(nx, ny, rtol, omega)
    asm = tmg.GMGAssembler(nx, ny, Lx, Ly, "elasticity", p=3.0,
                           dtype=torch.float64, omega=omega, device=DEV)
    gmg, lv0 = asm.assemble(torch.full((nx * ny,), 0.6, dtype=torch.float64))
    b = torch.where(lv0.mask, 0.0, interleave_to_planar(
        torch.as_tensor(rhs), 2).reshape(2, ny, nx))
    x, k, rn = tmg.pcg_gmg(gmg, lv0, b, rtol=rtol, maxiter=100)
    assert k == k_ref
    assert float(rn) <= rtol * float(torch.linalg.norm(b))
    assert np.abs(x.numpy() - x_ref).max() <= 1e-9 * np.abs(x_ref).max()


def test_model_gmg_matches_jax_direct():
    nx, ny = 33, 17
    rng = np.random.default_rng(7)
    rho = rng.uniform(0.3, 1.0, nx * ny)
    c = fem.ProblemCreator(nx, ny)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    jm = fem.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0)
    u_ref = np.asarray(jm.solve(method="direct", rho=rho))
    c_ref = float(np.asarray(jm.compute_rhs()) @ u_ref)

    tm = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0,
                             dtype=torch.float64, device=DEV)
    tm.attach_structured_grid(nx, ny)
    u = tm.solve(method="gmg", rho=rho, rtol=1e-10)
    comp = float(tm.compute_rhs() @ u)
    assert abs(comp - c_ref) <= 1e-10 * abs(c_ref)
    assert tm.last_solve_stats["iters"] > 0
    assert np.abs(u.numpy() - u_ref).max() <= 1e-8 * np.abs(u_ref).max()


def test_unported_branches_raise():
    c = pt.ProblemCreator(9, 5)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m = pt.LinearElasticity("quad4", X, conn, fixed, None, force,
                            device=DEV)
    with pytest.raises(RuntimeError):
        m.solve(method="gmg")  # attach_structured_grid first
    # sharded_gmg is ported (tests/test_torch_sharded_gmg.py): it needs
    # attach_sharded_grid first, as the JAX package does
    with pytest.raises(RuntimeError, match="attach_sharded_grid"):
        m.solve(method="sharded_gmg")
    # amg is ported (tests/test_torch_amg.py): AMG-PCG on any mesh
    u_amg, u_d = m.solve(method="amg", rtol=1e-10), m.solve(method="direct")
    assert m.last_solve_stats["method"] == "amg"
    assert (u_amg - u_d).abs().max() <= 1e-8 * u_d.abs().max()
    # pmg is ported (tests/test_torch_pmg.py): attach_pmg and the solve run
    conn3, X3, fixed3, force3 = pt.ProblemCreator(
        5, 5, 5, element_type="brick20").create_linear_elasticity_problem()
    mq = pt.LinearElasticity("brick20", X3, conn3, fixed3, None, force3,
                             device=DEV)
    u_pmg = mq.attach_pmg(5, 5, 5).solve(method="pmg", rtol=1e-10)
    u_qd = mq.solve(method="direct")
    assert mq.last_solve_stats["method"] == "pmg"
    assert (u_pmg - u_qd).abs().max() <= 1e-8 * u_qd.abs().max()
    # cg and direct are ported (tests/test_torch_models_cg.py), gmres too
    # (tests/test_torch_gmres.py)
    u_cg, u_dir = m.solve(method="cg"), m.solve(method="direct")
    assert (u_cg - u_dir).abs().max() <= 1e-8 * u_dir.abs().max()
    u_gm = m.solve(method="gmres", rtol=1e-12)
    assert (u_gm - u_dir).abs().max() <= 1e-8 * u_dir.abs().max()
    with pytest.raises(ValueError, match="hex8"):
        m.attach_structured_grid(9, 5, 3)  # 3D gmg needs a hex8 model
    # compliance is ported (tests/test_torch_topo.py), complex-step
    # inputs too (tests/test_torch_complex_step.py): they take the einsum
    # route, whose real part is the real sensitivity
    rng = np.random.default_rng(0)
    rho = rng.uniform(0.3, 1.0, m.nnodes)
    phi, psi = rng.standard_normal((2, m.ndof))
    s = m.k_dv_sens(rho + 1e-30j * rng.uniform(size=m.nnodes), phi, psi)
    assert s.dtype == torch.complex128
    s_real = m.k_dv_sens(rho, phi, psi)
    assert (s.real - s_real).abs().max() <= 1e-12 * s_real.abs().max()
    # nonzero Dirichlet values: gmg lifts the rhs (tests/
    # test_torch_dirichlet_gmg.py holds every route); u and the lifted
    # b equal the JAX package's gmg solve's, u the direct solve's
    vals = np.ones(len(fixed))
    m2 = pt.LinearElasticity("quad4", X, conn, fixed, vals, force,
                             device=DEV).attach_structured_grid(9, 5)
    u2, b2 = m2._solve_system(None, m2.compute_rhs(), "gmg", rtol=1e-12)
    jm2 = fem.LinearElasticity("quad4", X, conn, fixed, vals, force)
    ju, jb = jm2.attach_structured_grid(9, 5)._solve_gmg(
        1.0, jm2.compute_rhs(), rtol=1e-12)
    u2d = m2.solve(method="direct")
    assert np.abs(b2.numpy() - np.asarray(jb)).max() <= 1e-12 * np.abs(
        np.asarray(jb)).max()
    for ref in (np.asarray(ju), u2d.numpy()):
        np.testing.assert_allclose(u2.numpy(), ref, rtol=1e-7, atol=1e-10)
    assert (u2[fixed] == torch.as_tensor(vals)).all()
