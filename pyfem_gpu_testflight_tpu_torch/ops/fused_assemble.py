"""K1: uniform-geometry assembly of BC-eliminated stencil planes.

Port of ``pyfem_gpu_testflight_tpu/ops/pallas_assemble.py``
(``assembly_weights``, ``assemble_pack_2d``).  One pass turns a nodal
density grid into the BC-eliminated stencil coefficient planes plus the
inverse diagonal consumed by ``fused_smooth`` — fusing material
interpolation, RAMP, the unit-matrix weighted sums and
``Stencil2D.bc_eliminate``.  On a uniform grid every element has the
same geometry, so

    coeff[k][iy, ix] = rowm * colm * sum_{ay, ax, q}
        W[k, ay ax, q] * Cq[q][iy - ay, ix - ax]  +  diag-fix

with ``Cq = RAMP(N @ rho_nodes)`` and ``W`` the unit matrices folded
through the stencil plan (:func:`assembly_weights`).

Layout is logical: ``rho (ny, nx)``, free mask ``(nd, ny, nx)`` (1.0
free / 0.0 fixed), outputs ``coeff (nd*nd*9, ny, nx)`` and ``invd (nd,
ny, nx)``.  Inverse-diagonal convention: ``invd = rowm / diag``, i.e. 0
at fixed dofs (the JAX ``Level`` uses ``1 / diag``, 1 there; the two
agree on free dofs, and a V-cycle field is zero at fixed dofs either
way).  The TPU packing (halo rows, 128-lane padding) and the
half-symmetric 19-plane storage are not ported.

A CPU tensor takes :func:`assemble_pack_2d_plain`; a CUDA tensor
launches ``csrc/assemble_2d.cu`` or raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.base import ramp
from . import _cuda
from .stencil import _QUAD4_LOCAL

__all__ = ["assembly_weights", "assemble_pack_2d", "assemble_pack_2d_plain"]


def assembly_weights(plan, Kq, nd, nq):
    """Host: fold unit matrices through the stencil plan.

    Returns W (nd*nd*9, 4, nq) float64: W[k, ay*2+ax, q] is the weight
    of Cq[q] at element offset (ay, ax) in plane k.
    """
    Kq = np.asarray(Kq, np.float64)
    W = np.zeros((nd * nd * 9, 4, nq))
    for (ca, cb, dy, dx, ay, ax, r, s) in plan:
        k = (ca * nd + cb) * 9 + dy * 3 + dx
        W[k, ay * 2 + ax, :] += Kq[:, r, s]
    return W


def _check(rho, maskf, W, N, nd):
    ny, nx = rho.shape
    nk = nd * nd * 9
    if nd not in (1, 2):
        raise ValueError(f"nd must be 1 or 2, got {nd}")
    if tuple(maskf.shape) != (nd, ny, nx):
        raise ValueError(f"maskf {tuple(maskf.shape)} != {(nd, ny, nx)}")
    if tuple(W.shape) != (nk, 4, 4) or tuple(N.shape) != (4, 4):
        raise ValueError(f"W {tuple(W.shape)} / N {tuple(N.shape)}: "
                         f"want ({nk}, 4, 4) / (4, 4)")
    for name, t in (("rho", rho), ("maskf", maskf), ("W", W), ("N", N)):
        if t.device != rho.device or t.dtype != rho.dtype:
            raise ValueError(f"{name} must be {rho.dtype} on {rho.device}")


def assemble_pack_2d_plain(rho, maskf, W, N, *, nd, p, lp_dtype=None):
    """Plain PyTorch K1 (any device, any float dtype).

    Returns (coeff, invd[, coeff_lp]) — see the module docstring.
    """
    _check(rho, maskf, W, N, nd)
    ny, nx = rho.shape
    nq = N.shape[0]
    rho_e = [rho[ay : ay + ny - 1, ax : ax + nx - 1]
             for ay, ax in _QUAD4_LOCAL]
    Cq = []
    for q in range(nq):
        acc = N[q, 0] * rho_e[0]
        for n in range(1, 4):
            acc = acc + N[q, n] * rho_e[n]
        Cq.append(ramp(acc, p))
    # element (ey, ex) at padded (ey+1, ex+1): phantom elements read 0
    Cq = F.pad(torch.stack(Cq), (1, 1, 1, 1))
    S = torch.stack([
        Cq[:, 1 - ay : 1 - ay + ny, 1 - ax : 1 - ax + nx]
        for ay in range(2) for ax in range(2)
    ])  # (4, nq, ny, nx), index ay*2+ax
    acc = (W.reshape(-1, 4 * nq) @ S.reshape(4 * nq, -1)).reshape(
        nd, nd, 3, 3, ny, nx
    )
    mp = F.pad(maskf, (1, 1, 1, 1))
    colm = torch.stack([
        torch.stack([mp[:, dy : dy + ny, dx : dx + nx] for dx in range(3)], 1)
        for dy in range(3)
    ], 1)  # (nd, 3, 3, ny, nx)
    coeff = acc * maskf[:, None, None, None] * colm[None]
    for c in range(nd):
        coeff[c, c, 1, 1] += 1.0 - maskf[c]
    diag = torch.stack([coeff[c, c, 1, 1] for c in range(nd)])
    invd = maskf / torch.where(diag == 0.0, 1.0, diag)
    coeff = coeff.reshape(nd * nd * 9, ny, nx)
    if lp_dtype is None:
        return coeff, invd
    return coeff, invd, coeff.to(lp_dtype)


def _assemble_pack_2d_cuda(rho, maskf, W, N, *, nd, p, lp_dtype):
    _check(rho, maskf, W, N, nd)
    if rho.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {rho.dtype}")
    if lp_dtype not in (None, torch.bfloat16):
        raise TypeError(f"lp_dtype must be None or bfloat16, got {lp_dtype}")
    for t in (rho, maskf, W, N):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    ny, nx = rho.shape
    nk = nd * nd * 9
    coeff = torch.empty((nk, ny, nx), dtype=rho.dtype, device=rho.device)
    invd = torch.empty((nd, ny, nx), dtype=rho.dtype, device=rho.device)
    lp = (None if lp_dtype is None else
          torch.empty((nk, ny, nx), dtype=lp_dtype, device=rho.device))
    _cuda.launch(
        "pyfem_assemble_2d", rho.data_ptr(), maskf.data_ptr(), W.data_ptr(),
        N.data_ptr(), float(p), nd, ny, nx, coeff.data_ptr(),
        invd.data_ptr(), None if lp is None else lp.data_ptr(),
        _cuda.stream_ptr(rho),
    )
    return (coeff, invd) if lp is None else (coeff, invd, lp)


def assemble_pack_2d(rho, maskf, W, N, *, nd, p, lp_dtype=None):
    """Density grid -> BC-eliminated coefficient planes + inverse diagonal.

    Args:
        rho: (ny, nx) nodal density.
        maskf: (nd, ny, nx) free-dof mask (1.0 free / 0.0 fixed).
        W: (nd*nd*9, 4, 4) :func:`assembly_weights` in rho's dtype.
        N: (4, 4) quad4 shape values at the quad points.
        nd, p: dofs per node and RAMP penalization.
        lp_dtype: also emit a low-precision copy of the planes (the
            smoother's) in the same pass.

    Returns:
        (coeff (nd*nd*9, ny, nx), invd (nd, ny, nx)[, coeff_lp]).
    """
    if rho.device.type == "cuda":
        return _assemble_pack_2d_cuda(rho, maskf, W, N, nd=nd, p=p,
                                      lp_dtype=lp_dtype)
    if rho.device.type == "cpu":
        return assemble_pack_2d_plain(rho, maskf, W, N, nd=nd, p=p,
                                      lp_dtype=lp_dtype)
    raise ValueError(f"unsupported device {rho.device}")
