"""K7: batched quad4 element stiffness (elasticity and Poisson).

Port of ``pyfem_gpu_testflight_tpu/ops/pallas_stiffness.py`` — the
in-repo stand-in for the reference's external A2D element-kernel
library (pyfem.py:2180-2283) — with its signatures and element-minor
layouts:

    XeT: (8, nelems) rows n*2 + i      cq: (4, nelems)
    KeT: (ndpe*ndpe, nelems) rows r*ndpe + s = Ke[:, r, s]

(ndpe = 8 for plane-stress elasticity, 4 for Poisson).  A CPU tensor
takes the ``*_plain`` version (the einsum path of ``ops.stiffness``
through a layout transpose); a CUDA tensor launches
``csrc/stiffness_2d.cu`` (float32) or raises.  The TPU kernel's
(8, 128) element tiles and ghost-element padding have no counterpart:
the CUDA kernel masks its ragged last block.
"""

from __future__ import annotations

import torch

from ..elements import get_element
from . import _cuda, stiffness

__all__ = [
    "transpose_xe",
    "untranspose",
    "elasticity_stiffness_quad4",
    "elasticity_stiffness_quad4_plain",
    "poisson_stiffness_quad4",
    "poisson_stiffness_quad4_plain",
    "element_tables",
    "einsum_ket",
]


def transpose_xe(Xe):
    """(nelems, ...) -> (prod(...), nelems), the kernels' element-minor
    layout: Xe (nelems, nn, ndims) -> XeT rows n*ndims + dim (quad4:
    (8, nelems)), and likewise Ke (nelems, ndpe, ndpe) -> rows r*ndpe + s."""
    return Xe.reshape(Xe.shape[0], -1).t().contiguous()


def untranspose(AT, *tail):
    """Inverse of :func:`transpose_xe`: (prod(tail), nelems) ->
    contiguous (nelems, *tail)."""
    return AT.t().contiguous().reshape(AT.shape[1], *tail)


def element_tables(etype, like):
    """(dN, wq) of ``etype`` in ``like``'s dtype and device."""
    et = get_element(etype)
    kw = dict(dtype=like.dtype, device=like.device)
    return (torch.as_tensor(et.shape_grads, **kw),
            torch.as_tensor(et.quad_wts, **kw))


def einsum_ket(etype, XeT, cq, mu=None, lam=None):
    """The einsum path of ``ops.stiffness`` in the kernels' layout:
    elasticity (Lamé form) when ``mu`` is given, else Poisson.  The
    plain version of K7 and K8."""
    et = get_element(etype)
    dN, wq = element_tables(etype, XeT)
    Xe = untranspose(XeT, et.nnodes, et.ndims)
    Ke = (stiffness.poisson_stiffness(Xe, dN, wq, cq.t()) if mu is None else
          stiffness.elasticity_stiffness(Xe, dN, wq, cq.t(), mu, lam))
    return transpose_xe(Ke)


def elasticity_stiffness_quad4_plain(XeT, cq, mu, lam):
    """Plain PyTorch K7a (any device, any float dtype)."""
    return einsum_ket("quad4", XeT, cq, mu, lam)


def poisson_stiffness_quad4_plain(XeT, kq):
    """Plain PyTorch K7b (any device, any float dtype)."""
    return einsum_ket("quad4", XeT, kq)


def _check(XeT, cq, nrows_x, nq):
    if XeT.dim() != 2 or XeT.shape[0] != nrows_x:
        raise ValueError(f"XeT {tuple(XeT.shape)}: want ({nrows_x}, nelems)")
    if tuple(cq.shape) != (nq, XeT.shape[1]):
        raise ValueError(f"cq {tuple(cq.shape)}: want ({nq}, "
                         f"{XeT.shape[1]})")
    if cq.device != XeT.device or cq.dtype != XeT.dtype:
        raise ValueError(f"cq must be {XeT.dtype} on {XeT.device}")
    if XeT.shape[1] == 0:
        raise ValueError("no elements")


def _cuda_inputs(XeT, cq):
    if XeT.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {XeT.dtype}")
    if not (XeT.is_contiguous() and cq.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    if XeT.shape[1] >= 2**31:
        raise ValueError("more than 2^31 - 1 elements")


def elasticity_stiffness_quad4(XeT, cq, mu, lam):
    """Plane-stress quad4 element stiffness (K7a).

    Args:
        XeT: (8, nelems) transposed element coordinates (transpose_xe).
        cq: (4, nelems) material factor (RAMP of rho) at the quad points.
        mu/lam: Lamé parameters (plane-stress lambda).

    Returns:
        KeT: (64, nelems) with row r*8+s = Ke[:, r, s].
    """
    _check(XeT, cq, 8, 4)
    if XeT.device.type == "cpu":
        return elasticity_stiffness_quad4_plain(XeT, cq, mu, lam)
    if XeT.device.type != "cuda":
        raise ValueError(f"unsupported device {XeT.device}")
    _cuda_inputs(XeT, cq)
    E = XeT.shape[1]
    KeT = torch.empty((64, E), dtype=XeT.dtype, device=XeT.device)
    _cuda.launch("pyfem_elasticity_quad4", XeT.data_ptr(), cq.data_ptr(),
                 float(mu), float(lam), E, KeT.data_ptr(),
                 _cuda.stream_ptr(XeT))
    return KeT


def poisson_stiffness_quad4(XeT, kq):
    """quad4 Poisson element stiffness (K7b).

    Returns:
        KeT: (16, nelems) with row n*4+m = Ke[:, n, m].
    """
    _check(XeT, kq, 8, 4)
    if XeT.device.type == "cpu":
        return poisson_stiffness_quad4_plain(XeT, kq)
    if XeT.device.type != "cuda":
        raise ValueError(f"unsupported device {XeT.device}")
    _cuda_inputs(XeT, kq)
    E = XeT.shape[1]
    KeT = torch.empty((16, E), dtype=XeT.dtype, device=XeT.device)
    _cuda.launch("pyfem_poisson_quad4", XeT.data_ptr(), kq.data_ptr(), E,
                 KeT.data_ptr(), _cuda.stream_ptr(XeT))
    return KeT
