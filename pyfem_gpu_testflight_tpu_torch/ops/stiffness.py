"""Material constants and element stiffness, einsum path (plain PyTorch).

Port of ``lame_params``, ``poisson_stiffness`` and
``elasticity_stiffness`` from ``pyfem_gpu_testflight_tpu/ops/stiffness.py``
(the reference's element einsums, pyfem.py:1176-1186, 2016-2027).  This
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

__all__ = ["lame_params", "poisson_stiffness", "elasticity_stiffness"]


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
