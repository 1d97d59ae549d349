"""PyTorch port: hand-derived sensitivities against ``torch.autograd``
and ``jax.grad`` on CPU (float64).

The port's ``k_dv_sens`` (the adjoint einsums of the reference's hand
derivations, pyfem.py:1219-1276, 1872-1920) against reverse-mode
``torch.autograd`` through the port's einsum element pipeline
(interpolation, RAMP, element stiffness, phi^T K psi) to 1e-11 relative
/ 1e-13 absolute, as tests/test_autodiff.py holds the JAX package; the
same autograd gradient against ``jax.grad`` of the JAX pipeline on the
same inputs; and the end-to-end compliance gradient (autograd through a
dense BC'd solve) against ``compliance_grad``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread per worker)
import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu.models.base import ramp as jramp
from pyfem_gpu_testflight_tpu.ops import geometry as jgeo
from pyfem_gpu_testflight_tpu.ops import stiffness as jstiff
import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch.models.base import ramp
from pyfem_gpu_testflight_tpu_torch.ops import geometry, stiffness

DEV = "cpu"


def _models(physics):
    if physics == "poisson":
        conn, X, fixed = pt.ProblemCreator(14, 11).create_poisson_problem()
        mk = lambda f, **kw: f.LinearPoisson("quad4", X, conn, fixed, p=4.0,
                                             **kw)
        seed = 0
    else:
        conn, X, fixed, force = pt.ProblemCreator(
            10, 8).create_linear_elasticity_problem()
        mk = lambda f, **kw: f.LinearElasticity("quad4", X, conn, fixed,
                                                None, force, p=4.0, **kw)
        seed = 1
    return mk(pt, device=DEV), mk(fem), np.random.RandomState(seed)


def _pt_inner(m, phi, psi):
    """rho -> phi^T K(rho) psi through the port's einsum pipeline."""
    def f(rho):
        rho_q = geometry.interp_to_quads(m.N, rho[m.conn])
        if m.ndof_per_node == 1:
            Ke = stiffness.poisson_stiffness(m.Xe, m.dN, m.wq,
                                             ramp(rho_q, m.p))
        else:
            Ke = stiffness.elasticity_stiffness(m.Xe, m.dN, m.wq,
                                                ramp(rho_q, m.p), m.mu,
                                                m.lam)
        return torch.einsum("ei,eij,ej->", phi[m.conn_dof], Ke,
                            psi[m.conn_dof])
    return f


def _jax_inner(j, phi, psi):
    def f(rho):
        rho_q = jgeo.interp_to_quads(j.N, jnp.take(rho, j.conn, axis=0))
        if j.ndof_per_node == 1:
            Ke = jstiff.poisson_stiffness(j.Xe, j.dN, j.wq,
                                          jramp(rho_q, j.p))
        else:
            Ke = jstiff.elasticity_stiffness(j.Xe, j.dN, j.wq,
                                             jramp(rho_q, j.p), j.mu, j.lam)
        phi_e = jnp.take(phi, j.conn_dof, axis=0)
        psi_e = jnp.take(psi, j.conn_dof, axis=0)
        return jnp.einsum("ei,eij,ej->", phi_e, Ke, psi_e)
    return f


@pytest.mark.parametrize("physics", ["poisson", "elasticity"])
def test_dv_sens_matches_autograd_and_jax_grad(physics):
    m, j, rng = _models(physics)
    phi = rng.rand(m.ndof)
    psi = rng.rand(m.ndof)
    rho = rng.rand(m.nnodes)
    rho_t = torch.tensor(rho, requires_grad=True)
    _pt_inner(m, torch.tensor(phi), torch.tensor(psi))(rho_t).backward()
    g_ad = rho_t.grad.numpy()
    g_hand = m.k_dv_sens(rho, phi, psi).numpy()
    np.testing.assert_allclose(g_hand, g_ad, rtol=1e-11, atol=1e-13)
    g_jax = np.asarray(jax.grad(_jax_inner(j, jnp.asarray(phi),
                                           jnp.asarray(psi)))(
        jnp.asarray(rho)))
    np.testing.assert_allclose(g_ad, g_jax, rtol=1e-11, atol=1e-13)


def test_end_to_end_compliance_grad_via_autograd():
    """autograd through assemble + dense solve equals the adjoint grad."""
    conn, X, fixed, force = pt.ProblemCreator(
        8, 6).create_linear_elasticity_problem()
    m = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0,
                            device=DEV)
    rho = 0.3 + 0.6 * np.random.RandomState(2).rand(m.nnodes)
    rhs = m.compute_rhs()
    mask = m.bc.mask
    n = m.ndof

    def compliance(rho):
        Ke = m.element_jacobian(rho)
        idx = (m.conn_dof[:, :, None] * n + m.conn_dof[:, None, :]).reshape(-1)
        K = torch.zeros(n * n, dtype=Ke.dtype).index_add(
            0, idx, Ke.reshape(-1)).reshape(n, n)
        free = ~mask
        K = torch.where(free[:, None] & free[None, :], K, 0.0)
        K = K + torch.diag(torch.where(mask, 1.0, 0.0).to(K.dtype))
        b = torch.where(mask, 0.0, rhs)
        return b @ torch.linalg.solve(K, b)

    rho_t = torch.tensor(rho, requires_grad=True)
    compliance(rho_t).backward()
    _, u = m.compliance(rho, solver="direct")
    g_adj = m.compliance_grad(rho, u).numpy()
    np.testing.assert_allclose(g_adj, rho_t.grad.numpy(), rtol=1e-9,
                               atol=1e-11)
