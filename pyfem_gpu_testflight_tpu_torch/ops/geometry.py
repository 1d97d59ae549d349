"""Batched isoparametric geometry (plain PyTorch).

Port of ``pyfem_gpu_testflight_tpu/ops/geometry.py``.  Every function is
shaped ``(nelems, ...)`` over the leading element axis, with closed-form
2x2 / 3x3 inverses (the reference's adjugate formulas, utils.py:244-260)
and any float dtype.
"""

from __future__ import annotations

import torch

__all__ = [
    "gather_to_elements",
    "jacobian",
    "det_and_inv",
    "shape_gradients",
    "interp_to_quads",
    "quad_weights_times_detj",
]


def gather_to_elements(data, conn):
    """``data_e[e, n, ...] = data[conn[e, n], ...]``.

    Args:
        data: (nnodes,) or (nnodes, k) nodal tensor.
        conn: (nelems, nnodes_per_elem) integer connectivity.
    """
    return data[conn]


def jacobian(Xe, dN):
    """Isoparametric Jacobian J[e,q,i,k] = dx_i/dxi_k.

    Args:
        Xe: (nelems, nnodes_per_elem, ndims) element nodal coordinates.
        dN: (nquads, nnodes_per_elem, ndims) local shape derivatives.

    Returns:
        J: (nelems, nquads, ndims, ndims).
    """
    # Centered on the element centroid: sum_n dN[q,n,k] == 0 makes this a
    # no-op analytically, but it removes the cancellation of near-equal
    # coordinates in float32 (element size << domain size).
    Xc = Xe - Xe.mean(dim=1, keepdim=True)
    return torch.einsum("qnk,eni->eqik", dN, Xc)


def det_and_inv(J):
    """Closed-form determinant and inverse of batched 2x2 / 3x3 matrices.

    Returns:
        (det, inv): (...,) and (..., d, d).
    """
    d = J.shape[-1]
    if d == 2:
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        inv = torch.stack(
            [
                torch.stack([J[..., 1, 1], -J[..., 0, 1]], dim=-1),
                torch.stack([-J[..., 1, 0], J[..., 0, 0]], dim=-1),
            ],
            dim=-2,
        ) / det[..., None, None]
        return det, inv
    if d == 3:
        a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
        p, q, r = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
        u, v, w = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
        c00 = q * w - r * v
        c01 = -(p * w - r * u)
        c02 = p * v - q * u
        det = a * c00 + b * c01 + c * c02
        adj = torch.stack(
            [
                torch.stack([c00, -(b * w - c * v), b * r - c * q], dim=-1),
                torch.stack([c01, a * w - c * u, -(a * r - c * p)], dim=-1),
                torch.stack([c02, -(a * v - b * u), a * q - b * p], dim=-1),
            ],
            dim=-2,
        )
        return det, adj / det[..., None, None]
    raise ValueError(f"det_and_inv supports 2x2/3x3 only, got {d}x{d}")


def shape_gradients(Xe, dN):
    """Physical-space shape gradients and |J| per quadrature point.

    Returns:
        (detJ, Ngrad): (nelems, nquads) and (nelems, nquads, nn, ndims)
        with Ngrad[e,q,n,i] = dN_n/dx_i.
    """
    detJ, invJ = det_and_inv(jacobian(Xe, dN))
    # dN/dx_i = sum_m dN/dxi_m * dxi_m/dx_i;  invJ[m, i] = dxi_m/dx_i
    return detJ, torch.einsum("qnm,eqmi->eqni", dN, invJ)


def interp_to_quads(N, data_e):
    """Element nodal data (nelems, nn[, k]) -> quadrature points
    (nelems, nquads[, k]) with shape values N (nquads, nn)."""
    if data_e.ndim == 2:
        return torch.einsum("qn,en->eq", N, data_e)
    return torch.einsum("qn,enk->eqk", N, data_e)


def quad_weights_times_detj(detJ, wq):
    """Integration measure w_q |J_q| per (element, quad)."""
    return detJ * wq[None, :]
