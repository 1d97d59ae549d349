"""K8: batched 3D element stiffness for hex8, tet10 and brick20.

Port of ``pyfem_gpu_testflight_tpu/ops/pallas_stiffness3d.py`` (the
reference's hex8-only A2D role, pyfem.py:2260-2264, extended to the
quadratic elements) with its signatures and element-minor layouts
(nn nodes, nq quadrature points per element):

    XeT: (3*nn, nelems) rows n*3 + i      cq: (nq, nelems)
    KeT: ((3*nn)^2 | nn^2, nelems) rows r*ndpe + s = Ke[:, r, s]

A CPU tensor takes the ``*_plain`` version (the einsum path of
``ops.stiffness`` through a layout transpose); a CUDA tensor launches
``csrc/stiffness_3d.cu`` (float32) or raises.  The kernel computes each
element's geometry once (a block takes a group of elements, with the
derivative table of :func:`element_table` in shared memory), splits the
upper triangle of Ke over threads by node pair (hex8 and tet10 Poisson:
a thread takes an element), mirrors it, and writes Ke element-major,
``(nelems, ndpe, ndpe)`` contiguous, the layout the matrix-free operator
reads: on the card ``KeT`` is the transposed view of that buffer, so
``KeT.t()`` is contiguous and reshaping it copies nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..elements import get_element
from . import _cuda
from .element_kernels import einsum_ket, transpose_xe

__all__ = [
    "element_table",
    "elasticity_stiffness_3d",
    "elasticity_stiffness_3d_plain",
    "elasticity_stiffness_hex8",
    "poisson_stiffness_3d",
    "poisson_stiffness_3d_plain",
    "poisson_stiffness_hex8",
    "ETYPES",
]

ETYPES = ("hex8", "tet10", "brick20")

_tables = {}  # (etype, device) -> (nq, 3nn+1) float32 table


def element_table(etype, device):
    """(nq, 3*nn + 1) float32: per quad point q the derivatives dN
    (column n*3 + k) and the weight w_q (last column) — the table the
    JAX kernel kept in SMEM for its quadratic elements, here the
    kernel's shared-memory copy (hex8 Poisson folds it into constants,
    as the JAX kernel did for hex8)."""
    key = (etype, torch.device(device))
    if key not in _tables:
        et = get_element(etype)
        nn, nq = et.nnodes, et.nquads
        tab = np.zeros((nq, 3 * nn + 1), dtype=np.float32)
        tab[:, : 3 * nn] = np.asarray(et.shape_grads).reshape(nq, 3 * nn)
        tab[:, 3 * nn] = np.asarray(et.quad_wts)
        _tables[key] = torch.as_tensor(tab, device=device)
    return _tables[key]


def _sizes(etype):
    if etype not in ETYPES:
        raise ValueError(f"etype must be one of {ETYPES}, got {etype!r}")
    et = get_element(etype)
    return et.nnodes, et.nquads


def elasticity_stiffness_3d_plain(XeT, cq, mu, lam, etype="hex8"):
    """Plain PyTorch K8, elasticity (any device, any float dtype)."""
    _sizes(etype)
    return einsum_ket(etype, XeT, cq, mu, lam)


def poisson_stiffness_3d_plain(XeT, kq, etype="hex8"):
    """Plain PyTorch K8, Poisson (any device, any float dtype)."""
    _sizes(etype)
    return einsum_ket(etype, XeT, kq)


def _launch(XeT, cq, mu, lam, etype, elastic):
    nn, nq = _sizes(etype)
    if XeT.dim() != 2 or XeT.shape[0] != 3 * nn:
        raise ValueError(f"XeT {tuple(XeT.shape)}: want ({3 * nn}, nelems)")
    E = XeT.shape[1]
    if tuple(cq.shape) != (nq, E):
        raise ValueError(f"cq {tuple(cq.shape)}: want ({nq}, {E})")
    if cq.device != XeT.device or cq.dtype != XeT.dtype:
        raise ValueError(f"cq must be {XeT.dtype} on {XeT.device}")
    if E == 0:
        raise ValueError("no elements")
    ndpe = 3 * nn if elastic else nn
    if XeT.device.type == "cpu":
        if elastic:
            return elasticity_stiffness_3d_plain(XeT, cq, mu, lam, etype)
        return poisson_stiffness_3d_plain(XeT, cq, etype)
    if XeT.device.type != "cuda":
        raise ValueError(f"unsupported device {XeT.device}")
    if XeT.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {XeT.dtype}")
    if not (XeT.is_contiguous() and cq.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    if ndpe * ndpe * E >= 2**63 or E >= 2**31:
        raise ValueError("too many elements")
    tab = element_table(etype, XeT.device)
    Ke = torch.empty((E, ndpe, ndpe), dtype=XeT.dtype, device=XeT.device)
    _cuda.launch("pyfem_stiffness_3d", XeT.data_ptr(), cq.data_ptr(),
                 tab.data_ptr(), float(mu), float(lam), int(elastic), nn, E,
                 Ke.data_ptr(), _cuda.stream_ptr(XeT))
    return Ke.view(E, ndpe * ndpe).t()


def elasticity_stiffness_3d(XeT, cq, mu, lam, etype="hex8"):
    """3D isotropic element stiffness for hex8 / tet10 / brick20 (K8).

    Args:
        XeT: (3*nn, nelems) transposed coordinates
            (``element_kernels.transpose_xe``).
        cq: (nq, nelems) RAMP material factor at quadrature points.
        mu/lam: 3D Lamé parameters.
        etype: "hex8" | "tet10" | "brick20".

    Returns:
        KeT: ((3*nn)^2, nelems) with row r*(3*nn) + s = Ke[:, r, s]; on
        the card the transposed view of a contiguous (nelems, 3*nn,
        3*nn) Ke.
    """
    return _launch(XeT, cq, mu, lam, etype, True)


def elasticity_stiffness_hex8(XeT, cq, mu, lam):
    """hex8 form of :func:`elasticity_stiffness_3d`: KeT (576, nelems)."""
    return elasticity_stiffness_3d(XeT, cq, mu, lam, etype="hex8")


def poisson_stiffness_3d(XeT, kq, etype="hex8"):
    """3D Poisson element stiffness for hex8 / tet10 / brick20 (K8).

    Returns:
        KeT: (nn*nn, nelems) with row n*nn+m = Ke[:, n, m]; on the card
        the transposed view of a contiguous (nelems, nn, nn) Ke.
    """
    return _launch(XeT, kq, 0.0, 0.0, etype, False)


def poisson_stiffness_hex8(XeT, kq):
    """hex8 Poisson element stiffness: KeT (64, nelems)."""
    return poisson_stiffness_3d(XeT, kq, etype="hex8")
