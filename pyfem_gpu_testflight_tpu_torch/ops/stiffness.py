"""Material constants and element stiffness, einsum path (plain PyTorch).

Port of ``lame_params``, ``poisson_stiffness``, ``mass_matrix``,
``elasticity_stiffness`` and the design-sensitivity inner products
``poisson_dv_inner`` / ``elasticity_dv_inner`` from
``pyfem_gpu_testflight_tpu/ops/stiffness.py`` (the reference's element
einsums, pyfem.py:1176-1186, 1219-1276, 1872-1920, 2016-2027).  This
is the models' ``kernel="einsum"`` route and, through a layout
transpose, the plain version the element kernels K7 and K8
(``ops.element_kernels``, ``ops.element_kernels3d``) are held against.

Elasticity is in Lamé form: for isotropic material B^T C B expands into
three Ngrad x Ngrad contractions (plane stress uses the effective
lambda), algebraically identical to the reference's Voigt/B-matrix
form (pyfem.py:1975-2027).
"""

from __future__ import annotations

import torch

from . import geometry

__all__ = ["lame_params", "poisson_stiffness", "mass_matrix",
           "elasticity_stiffness", "poisson_dv_inner",
           "elasticity_dv_inner"]


def lame_params(E, nu, ndims):
    """(mu, lam) for 3D isotropic or 2D plane stress.

    Plane stress uses the effective lambda = E nu / (1 - nu^2) so that
    2 mu e + lam tr(e) I reproduces the reference's plane-stress C0
    (pyfem.py:1746-1750); 3D matches pyfem.py:1752-1757.
    """
    mu = E / (2.0 * (1.0 + nu))
    if ndims == 2:
        lam = E * nu / (1.0 - nu**2)
    else:
        lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam


def poisson_stiffness(Xe, dN, wq, kappa_q):
    """Ke[e,n,m] = sum_q kappa_q w_q |J_q| grad(N_n) . grad(N_m).

    Args:
        Xe: (nelems, nn, ndims); dN: (nquads, nn, ndims); wq: (nquads,).
        kappa_q: (nelems, nquads) material at quadrature points.
    """
    detJ, Ngrad = geometry.shape_gradients(Xe, dN)
    c = kappa_q * (detJ * wq[None, :])
    return torch.einsum("eq,eqnl,eqml->enm", c, Ngrad, Ngrad)


def mass_matrix(Xe, dN, N, wq):
    """Consistent mass matrix Me[e,n,m] = sum_q w_q |J_q| N_n N_m."""
    detJ, _ = geometry.det_and_inv(geometry.jacobian(Xe, dN))
    return torch.einsum("eq,qn,qm->enm", detJ * wq[None, :], N, N)


def elasticity_stiffness(Xe, dN, wq, Cq, mu, lam):
    """Isotropic (plane-stress / 3D) element stiffness in Lamé form.

    Ke[(n,a),(m,b)] = sum_q c_q [ mu (delta_ab grad N_n . grad N_m
                                      + d_b N_n d_a N_m)
                                  + lam d_a N_n d_b N_m ]
    with c_q = Cq w_q |J_q| (Cq is the RAMP factor).

    Returns:
        (nelems, nn*ndims, nn*ndims) with interleaved dofs (node-major).
    """
    detJ, Ngrad = geometry.shape_gradients(Xe, dN)
    nelems, _nq, nn, nd = Ngrad.shape
    c = Cq * (detJ * wq[None, :])
    gg = torch.einsum("eq,eqnl,eqml->enm", c, Ngrad, Ngrad)  # grad.grad
    P = torch.einsum("eq,eqna,eqmb->enamb", c, Ngrad, Ngrad)
    eye = torch.eye(nd, dtype=P.dtype, device=P.device)
    Ke = (
        mu * (gg[:, :, None, :, None] * eye[None, None, :, None, :])
        + mu * P.permute(0, 1, 4, 3, 2)
        + lam * P
    )
    return Ke.reshape(nelems, nn * nd, nn * nd)


def poisson_dv_inner(Xe, dN, N, wq, dramp_q, phi_e, psi_e):
    """Per-(element, node) inner product for d(phi^T K psi)/d rho.

    Contracts phi/psi into gradients first instead of materializing the
    reference's 4-axis Ke_deriv (pyfem.py:1219-1276).

    Args:
        dramp_q: (nelems, nquads) RAMP derivative at quads.
        phi_e, psi_e: (nelems, nn) gathered vectors.

    Returns:
        inner: (nelems, nn); sum over conn for the nodal gradient.
    """
    detJ, Ngrad = geometry.shape_gradients(Xe, dN)
    gphi = torch.einsum("eqnl,en->eql", Ngrad, phi_e)
    gpsi = torch.einsum("eqnl,en->eql", Ngrad, psi_e)
    a = torch.einsum("eql,eql->eq", gphi, gpsi)
    w = dramp_q * (detJ * wq[None, :]) * a
    return torch.einsum("qo,eq->eo", N, w)


def elasticity_dv_inner(Xe, dN, N, wq, dramp_q, phi_e, psi_e, mu, lam):
    """Elasticity analogue of :func:`poisson_dv_inner`.

    phi_e/psi_e: (nelems, nn, ndims) gathered displacement-like vectors.
    Uses (B phi)^T C0 (B psi) = mu (grad phi : grad psi
    + grad phi : grad psi^T) + lam div(phi) div(psi).
    """
    detJ, Ngrad = geometry.shape_gradients(Xe, dN)
    # displacement gradient g[e,q,a,l] = d phi_a / d x_l
    gphi = torch.einsum("eqnl,ena->eqal", Ngrad, phi_e)
    gpsi = torch.einsum("eqnl,ena->eqal", Ngrad, psi_e)
    t1 = torch.einsum("eqal,eqal->eq", gphi, gpsi)
    t2 = torch.einsum("eqal,eqla->eq", gphi, gpsi)
    divphi = torch.diagonal(gphi, dim1=2, dim2=3).sum(-1)
    divpsi = torch.diagonal(gpsi, dim1=2, dim2=3).sum(-1)
    s = mu * (t1 + t2) + lam * divphi * divpsi
    w = dramp_q * (detJ * wq[None, :]) * s
    return torch.einsum("qo,eq->eo", N, w)
