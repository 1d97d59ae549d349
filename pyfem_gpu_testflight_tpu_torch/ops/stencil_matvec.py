"""K9: the 2D stencil product y = A u on unpacked coefficient planes.

Port of ``stencil_matvec_2d`` from
``pyfem_gpu_testflight_tpu/ops/pallas_stencil.py``: the 9-point,
nd-component stencil operator with zero padding outside the grid, in
the layouts of ``ops.stencil`` — ``coeff (nd, nd, 3, 3, ny, nx)``,
``u (nd, ny, nx)`` — and in the dtype of ``u`` (float32 or float64).

The Helmholtz filter's structured path (``models.helmholtz``) runs it
in every Jacobi-PCG iteration, and it is the float64 fine operator of
the accuracy solve.  ``Stencil2D.matvec`` stays the plain reference
(K2's plain version and the coarse dense factor use it), so that no
kernel is ever held against a kernel.

A CPU tensor takes :func:`stencil_matvec_2d_plain`; a CUDA tensor
launches ``csrc/stencil_2d.cu`` or raises.
"""

from __future__ import annotations

import torch

from . import _cuda
from .stencil import Stencil2D

__all__ = ["stencil_matvec_2d", "stencil_matvec_2d_plain"]


def _check(coeff, u):
    if u.dim() != 3:
        raise ValueError(f"u must be (nd, ny, nx), got {tuple(u.shape)}")
    nd, ny, nx = u.shape
    if tuple(coeff.shape) != (nd, nd, 3, 3, ny, nx):
        raise ValueError(f"coeff {tuple(coeff.shape)} != "
                         f"{(nd, nd, 3, 3, ny, nx)}")
    if coeff.dtype != u.dtype or coeff.device != u.device:
        raise ValueError("coeff and u must share dtype and device")
    return nd, ny, nx


def stencil_matvec_2d_plain(coeff, u):
    """Plain PyTorch K9 (any device, any dtype): ``Stencil2D.matvec``."""
    nd, ny, nx = _check(coeff, u)
    return Stencil2D(nx, ny, nd).matvec(coeff, u)


def _stencil_matvec_2d_cuda(coeff, u):
    nd, ny, nx = _check(coeff, u)
    if nd not in (1, 2):
        raise ValueError(f"the CUDA kernel takes nd 1 or 2, got {nd}")
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA kernel takes float32 or float64, got "
                        f"{u.dtype}")
    if not (coeff.is_contiguous() and u.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    out = torch.empty_like(u)
    _cuda.launch("pyfem_stencil_2d", coeff.data_ptr(), u.data_ptr(),
                 out.data_ptr(), nd, ny, nx, int(u.dtype == torch.float64),
                 _cuda.stream_ptr(u))
    return out


def stencil_matvec_2d(coeff, u):
    """y = A u for a 9-point, nd-component stencil operator.

    Args:
        coeff: (nd, nd, 3, 3, ny, nx) coefficient planes
            (``Stencil2D.assemble`` layout), in u's dtype.
        u: (nd, ny, nx) field; neighbours outside the grid read as 0.

    Returns:
        (nd, ny, nx), equal to ``Stencil2D.matvec(coeff, u)`` up to the
        order of the nd*9 products in each sum.
    """
    if u.device.type == "cuda":
        return _stencil_matvec_2d_cuda(coeff, u)
    if u.device.type == "cpu":
        return stencil_matvec_2d_plain(coeff, u)
    raise ValueError(f"unsupported device {u.device}")
