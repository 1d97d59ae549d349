"""Geometric multigrid for structured quad and hex grids (PyTorch port).

Port of the 2D and 3D (uniform and on-the-fly element paths) parts of
``pyfem_gpu_testflight_tpu/multigrid.py``:

* every level's operator is a BC-eliminated stencil assembled from the
  nodal density: 9-point planes by kernel K1 in 2D (all planes, or
  half-symmetric storage with ``sym=True``), 27-point planes by kernel
  K3 in 3D (``ops.fused_assemble``; half-symmetric storage, or all
  planes with ``sym=False``), on every level (the TPU's
  assembly-size thresholds are TPU tuning) — except on the 3D
  ``elem_path="otf"`` route, where every level but the coarsest stores
  no coefficients and kernel K6 rebuilds them from the density in each
  pass (``ops.otf3d``, :class:`OTFLevel`), and on the 2D
  ``elem_path="cuda" | "einsum"`` routes, where each level's planes are
  assembled from element matrices (kernel K7 or the einsum path) and
  BC-eliminated in PyTorch;
* smoothing is damped Jacobi with per-sweep Chebyshev-node factors:
  kernel K2 in 2D, which also supplies the residuals and the operator
  matvec; in 3D kernel K5 runs each smoothing call (sweeps + residual)
  and kernel K4 the operator matvec (``ops.fused_smooth``), or K6 all
  three on an OTF level; or, with ``smoother="chebyshev"``, the
  three-term Chebyshev recurrence, one residual pass of the same kernels
  (K2 at ``niter=0``, K4, K6) per degree plus elementwise torch;
* the design sensitivity d(phi^T K psi)/drho on the fine uniform grid
  is scatter-free (:func:`_dv_sens_uniform`, ``GMGAssembler.dv_sens``);
* prolongation is bi/trilinear interpolation in reshape/interleave
  form, restriction its exact transpose (FEM Galerkin convention), so
  the V-cycle is a symmetric preconditioner for CG; the strided-slice
  and convolution forms of the same pair are exported too and can be
  passed to :class:`GMG` as ``restrict_fn`` / ``prolong_fn``;
* the coarsest level is solved by an explicit dense inverse;
* coarse operators are rediscretized on coarse ProblemCreator grids,
  with nodal densities restricted by injection.

The PCG loops read the residual norm back to the host once per
iteration to decide whether to stop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .device import resolve_device
from .solvers import readbacks
from .ops import fused_assemble, fused_smooth, otf3d
from .ops.stencil import _HEX8_LOCAL, _QUAD4_LOCAL, Stencil2D, Stencil3D

__all__ = [
    "Level",
    "Level3D",
    "OTFLevel",
    "GMG",
    "GMGAssembler",
    "GMGAssembler3D",
    "prolong2d",
    "restrict2d",
    "prolong3d",
    "restrict3d",
    "prolong2d_conv",
    "restrict2d_conv",
    "prolong3d_conv",
    "restrict3d_conv",
    "prolong2d_il",
    "restrict2d_il",
    "prolong_axis_il",
    "restrict_axis_il",
    "prolong3d_il",
    "restrict3d_il",
    "smoothing_omegas",
    "build_elasticity_gmg",
    "build_poisson_gmg",
    "pcg",
    "pcg_gmg",
]


# ---------------------------------------------------------------------------
# Grid transfer operators (2D bilinear P and R = P^T)
# ---------------------------------------------------------------------------


def _deinterleave2(a, axis):
    """Split even/odd elements along axis (input padded to even length)."""
    n = a.shape[axis]
    if n % 2:
        pad = [0, 0] * a.ndim
        pad[2 * (a.ndim - 1 - axis) + 1] = 1
        a = F.pad(a, pad)
    shape = list(a.shape)
    shape[axis] //= 2
    shape.insert(axis + 1, 2)
    a = a.reshape(shape)
    return a.select(axis + 1, 0), a.select(axis + 1, 1)


def _interleave2(e, o, axis, out_len):
    """Interleave e/o along axis and trim to out_len."""
    st = torch.stack([e, o], dim=axis + 1)
    shape = list(e.shape)
    shape[axis] *= 2
    return st.reshape(shape).narrow(axis, 0, out_len)


def _shift_pad(a, axis, before):
    """Shift by one along axis, zero-filling (before=True shifts down)."""
    pad = [0, 0] * a.ndim
    n = a.shape[axis]
    if before:
        pad[2 * (a.ndim - 1 - axis)] = 1
        return F.pad(a, pad).narrow(axis, 0, n)
    pad[2 * (a.ndim - 1 - axis) + 1] = 1
    return F.pad(a, pad).narrow(axis, 1, n)


def restrict2d_il(f, coarse_shape):
    """Restriction R = P^T on (d, nyf, nxf) -> (d, nyc, nxc).

    FEM Galerkin convention: nested bilinear coarse basis functions are
    combinations of fine ones, so A_c = P^T A_f P with no extra scaling.
    """
    nyc, nxc = coarse_shape
    rows_e, rows_o = _deinterleave2(f, 1)      # even/odd rows
    F00, F01 = _deinterleave2(rows_e[:, :nyc], 2)
    F10, F11 = _deinterleave2(rows_o, 2)
    F00, F01 = F00[:, :, :nxc], F01[:, :, : nxc - 1]
    F10 = F10[:, : nyc - 1, :nxc]
    F11 = F11[:, : nyc - 1, : nxc - 1]
    c = F00
    c = c + 0.5 * (F.pad(F10, (0, 0, 1, 0)) + F.pad(F10, (0, 0, 0, 1)))
    c = c + 0.5 * (F.pad(F01, (1, 0)) + F.pad(F01, (0, 1)))
    q = F.pad(F11, (0, 1, 0, 1))
    c = c + 0.25 * (
        q
        + _shift_pad(q, 1, True)
        + _shift_pad(q, 2, True)
        + _shift_pad(_shift_pad(q, 1, True), 2, True)
    )
    return c


def prolong2d_il(c, fine_shape):
    """Bilinear prolongation (d, nyc, nxc) -> (d, 2nyc-1, 2nxc-1)."""
    nyf, nxf = fine_shape
    colavg = F.pad(0.5 * (c[:, :, :-1] + c[:, :, 1:]), (0, 1))
    ce = _interleave2(c, colavg, 2, nxf)       # even rows, full width
    rowavg = F.pad(0.5 * (ce[:, :-1] + ce[:, 1:]), (0, 0, 0, 1))
    return _interleave2(ce, rowavg, 1, nyf)


def _pad_axis(a, axis, before, after):
    """Zero-pad ``before``/``after`` entries along ``axis``."""
    pad = [0, 0] * a.ndim
    pad[2 * (a.ndim - 1 - axis)] = before
    pad[2 * (a.ndim - 1 - axis) + 1] = after
    return F.pad(a, pad)


def restrict_axis_il(f, axis, nc):
    """One separable tent-restriction step along ``axis``: n -> nc."""
    e, o = _deinterleave2(f, axis)
    o = o.narrow(axis, 0, nc - 1)
    return e.narrow(axis, 0, nc) + 0.5 * (
        _pad_axis(o, axis, 1, 0) + _pad_axis(o, axis, 0, 1)
    )


def prolong_axis_il(c, axis, nf):
    """One separable tent-prolongation step along ``axis``: nc -> nf."""
    n = c.shape[axis]
    avg = 0.5 * (c.narrow(axis, 0, n - 1) + c.narrow(axis, 1, n - 1))
    return _interleave2(c, _pad_axis(avg, axis, 0, 1), axis, nf)


def restrict3d_il(f, coarse_shape):
    """Trilinear restriction R = P^T on (d, nzf, nyf, nxf) -> (d, nzc,
    nyc, nxc): the tent step along each axis in turn (the JAX package
    sums the eight parity blocks at once; the same operator)."""
    for i, nc in enumerate(coarse_shape):
        f = restrict_axis_il(f, 1 + i, nc)
    return f


def prolong3d_il(c, fine_shape):
    """Trilinear prolongation (d, nzc, nyc, nxc) -> (d, nzf, nyf, nxf)."""
    for i, nf in enumerate(fine_shape):
        c = prolong_axis_il(c, 1 + i, nf)
    return c


def prolong2d(c, fine_shape):
    """Bilinear prolongation (d, nyc, nxc) -> (d, nyf, nxf) by strided
    slice assignment (the JAX ``prolong2d``); nyf = 2 nyc - 1, nxf =
    2 nxc - 1.  The same operator as :func:`prolong2d_il`."""
    nyf, nxf = fine_shape
    f = c.new_zeros((c.shape[0], nyf, nxf))
    f[:, 0::2, 0::2] = c
    f[:, 1::2, 0::2] = 0.5 * (c[:, :-1] + c[:, 1:])
    f[:, 0::2, 1::2] = 0.5 * (c[:, :, :-1] + c[:, :, 1:])
    f[:, 1::2, 1::2] = 0.25 * (c[:, :-1, :-1] + c[:, 1:, :-1]
                               + c[:, :-1, 1:] + c[:, 1:, 1:])
    return f


def restrict2d(f, coarse_shape):
    """Restriction R = prolong2d^T exactly, by strided slices (the JAX
    ``restrict2d``; FEM Galerkin convention, no 1/4 factor)."""
    c = f[:, 0::2, 0::2].clone()
    e = f[:, 1::2, 0::2]
    c[:, :-1] += 0.5 * e
    c[:, 1:] += 0.5 * e
    e = f[:, 0::2, 1::2]
    c[:, :, :-1] += 0.5 * e
    c[:, :, 1:] += 0.5 * e
    e = f[:, 1::2, 1::2]
    c[:, :-1, :-1] += 0.25 * e
    c[:, 1:, :-1] += 0.25 * e
    c[:, :-1, 1:] += 0.25 * e
    c[:, 1:, 1:] += 0.25 * e
    return c


def _avg(*terms):
    s = terms[0]
    for t in terms[1:]:
        s = s + t
    return s / len(terms)


def prolong3d(c, fine_shape):
    """Trilinear prolongation (d, nzc, nyc, nxc) -> (d, nzf, nyf, nxf) by
    strided slice assignment (the JAX ``prolong3d``): each of the 8
    parity cases is the average of the coarse nodes of its cell face,
    edge or centre.  The same operator as :func:`prolong3d_il`."""
    f = c.new_zeros((c.shape[0],) + tuple(fine_shape))
    lo, hi = slice(None, -1), slice(1, None)
    f[:, 0::2, 0::2, 0::2] = c
    f[:, 1::2, 0::2, 0::2] = _avg(c[:, lo], c[:, hi])
    f[:, 0::2, 1::2, 0::2] = _avg(c[:, :, lo], c[:, :, hi])
    f[:, 0::2, 0::2, 1::2] = _avg(c[:, :, :, lo], c[:, :, :, hi])
    f[:, 1::2, 1::2, 0::2] = _avg(c[:, lo, lo], c[:, hi, lo], c[:, lo, hi],
                                  c[:, hi, hi])
    f[:, 1::2, 0::2, 1::2] = _avg(c[:, lo, :, lo], c[:, hi, :, lo],
                                  c[:, lo, :, hi], c[:, hi, :, hi])
    f[:, 0::2, 1::2, 1::2] = _avg(c[:, :, lo, lo], c[:, :, hi, lo],
                                  c[:, :, lo, hi], c[:, :, hi, hi])
    f[:, 1::2, 1::2, 1::2] = _avg(
        c[:, lo, lo, lo], c[:, hi, lo, lo], c[:, lo, hi, lo],
        c[:, lo, lo, hi], c[:, hi, hi, lo], c[:, hi, lo, hi],
        c[:, lo, hi, hi], c[:, hi, hi, hi],
    )
    return f


def restrict3d(f, coarse_shape):
    """Restriction R = prolong3d^T exactly, by strided slices (the JAX
    ``restrict3d``; FEM Galerkin convention)."""
    lo, hi = slice(None, -1), slice(1, None)
    c = f[:, 0::2, 0::2, 0::2].clone()
    e = f[:, 1::2, 0::2, 0::2]
    c[:, lo] += 0.5 * e
    c[:, hi] += 0.5 * e
    e = f[:, 0::2, 1::2, 0::2]
    c[:, :, lo] += 0.5 * e
    c[:, :, hi] += 0.5 * e
    e = f[:, 0::2, 0::2, 1::2]
    c[:, :, :, lo] += 0.5 * e
    c[:, :, :, hi] += 0.5 * e
    e = f[:, 1::2, 1::2, 0::2]
    for sz in (lo, hi):
        for sy in (lo, hi):
            c[:, sz, sy] += 0.25 * e
    e = f[:, 1::2, 0::2, 1::2]
    for sz in (lo, hi):
        for sx in (lo, hi):
            c[:, sz, :, sx] += 0.25 * e
    e = f[:, 0::2, 1::2, 1::2]
    for sy in (lo, hi):
        for sx in (lo, hi):
            c[:, :, sy, sx] += 0.25 * e
    e = f[:, 1::2, 1::2, 1::2]
    for sz in (lo, hi):
        for sy in (lo, hi):
            for sx in (lo, hi):
                c[:, sz, sy, sx] += 0.125 * e
    return c


def _tent_kernel(ndim, like):
    """(1, 1, 3, ..., 3) tent weights [0.5, 1, 0.5]^(x ndim)."""
    t = torch.tensor([0.5, 1.0, 0.5], dtype=like.dtype, device=like.device)
    w = t
    for _ in range(ndim - 1):
        w = w[..., None] * t
    return w[None, None]


def restrict2d_conv(f, coarse_shape):
    """Restriction as one stride-2 convolution with the tent weights
    (the JAX ``restrict2d_conv``); the same operator as
    :func:`restrict2d`."""
    out = F.conv2d(f[:, None], _tent_kernel(2, f), stride=2, padding=1)
    return out.reshape((f.shape[0],) + tuple(coarse_shape))


def prolong2d_conv(c, fine_shape):
    """Prolongation as the transposed convolution (the JAX
    ``prolong2d_conv``); the same operator as :func:`prolong2d`."""
    out = F.conv_transpose2d(c[:, None], _tent_kernel(2, c), stride=2,
                             padding=1)
    return out.reshape((c.shape[0],) + tuple(fine_shape))


def restrict3d_conv(f, coarse_shape):
    """3D :func:`restrict2d_conv` (the JAX ``restrict3d_conv``)."""
    out = F.conv3d(f[:, None], _tent_kernel(3, f), stride=2, padding=1)
    return out.reshape((f.shape[0],) + tuple(coarse_shape))


def prolong3d_conv(c, fine_shape):
    """3D :func:`prolong2d_conv` (the JAX ``prolong3d_conv``)."""
    out = F.conv_transpose3d(c[:, None], _tent_kernel(3, c), stride=2,
                             padding=1)
    return out.reshape((c.shape[0],) + tuple(fine_shape))


# ---------------------------------------------------------------------------
# Levels and the V-cycle
# ---------------------------------------------------------------------------


class Level:
    """One grid level: K1's eliminated planes + BC mask + smoother data.

    Attributes:
        op: Stencil2D (plan + plain matvec).
        coeff: (nk, ny, nx) BC-eliminated stencil planes: all nd*nd*9,
            or the kept planes of ``fused_smooth.sym_planes_2d`` (K2
            reads either).
        coeff_lp: low-precision copy for the smoother, or None.
        inv_diag: (nd, ny, nx) inverse diagonal, 0 at fixed dofs.
        mask: (nd, ny, nx) bool, True at constrained dofs.
        shape: (ny, nx) node grid.
        nd: dofs per node.
    """

    def __init__(self, op: Stencil2D, coeff, inv_diag, mask, shape, nd,
                 coeff_lp=None):
        self.op = op
        self.coeff = coeff
        self.coeff_lp = coeff_lp
        self.inv_diag = inv_diag
        self.mask = mask
        self.shape = tuple(int(s) for s in shape)
        self.nd = int(nd)
        self.dense_inv = None  # explicit inverse (see dense_factor)

    @property
    def _coeff_smooth(self):
        """Preconditioner-internal coefficients (bf16 copy when set)."""
        return self.coeff if self.coeff_lp is None else self.coeff_lp

    def matvec(self, u):
        """A u on the full-precision planes (the PCG operator)."""
        return fused_smooth.fused_sweeps_2d(
            self.coeff, self.inv_diag, None, u, niter=0, want_resid=True,
            neg_resid=True,
        )

    def presmooth_resid(self, b, niter, omega):
        """Jacobi sweeps from x0 = 0 plus the residual: (x, b - A x)."""
        if niter == 0:
            return torch.zeros_like(b), b
        return fused_smooth.fused_sweeps_2d(
            self._coeff_smooth, self.inv_diag, b, None, niter=niter,
            want_resid=True, omega=omega,
        )

    def postsmooth(self, b, x0, niter, omega):
        """Jacobi sweeps from a given iterate."""
        if niter == 0:
            return x0
        return fused_smooth.fused_sweeps_2d(
            self._coeff_smooth, self.inv_diag, b, x0, niter=niter,
            omega=omega,
        )

    def resid(self, b, x):
        """b - A x on the smoother's coefficients, K2 at ``niter=0`` (the
        Chebyshev smoother's pass)."""
        return fused_smooth.fused_sweeps_2d(
            self._coeff_smooth, self.inv_diag, b, x, niter=0,
            want_resid=True,
        )

    def postsmooth_resid(self, b, x0, niter, omega):
        """Post-sweeps plus the residual: (x, b - A x).

        Runs on the full-precision coefficients (not the bf16 smoother
        copy): the trailing residual defines ``A z = b - r`` for the
        PCG matvec-by-recurrence (:func:`pcg_gmg`), so it must be the
        PCG operator.
        """
        out = fused_smooth.fused_sweeps_2d(
            self.coeff, self.inv_diag, b, x0, niter=niter,
            want_resid=True, omega=omega,
        )
        return (x0, out) if niter == 0 else out

    def dense_factor(self):
        """Explicit inverse of the (small) coarsest operator.

        Columns come from the plain stencil matvec over an identity
        batch, on the full planes (rebuilt from the kept ones under sym
        storage); the inverse is computed once per hierarchy assembly.  It
        is a preconditioner component, so the inverse's (bounded) loss
        of backward stability vs a Cholesky solve is immaterial.
        """
        ny, nx = self.shape
        n = ny * nx * self.nd
        eye = torch.eye(n, dtype=self.inv_diag.dtype,
                        device=self.inv_diag.device)
        c = fused_smooth.as_full_planes_2d(self.coeff, self.nd)
        A = self.op.matvec(c, eye.reshape(n, self.nd, ny, nx)).reshape(n, n)
        # row i of the batch is A e_i = column i of A; A is symmetric
        L = torch.linalg.cholesky(A.t())
        self.dense_inv = torch.cholesky_inverse(L)
        return self


class Level3D:
    """One 3D grid level: K3's planes + BC mask + smoother.

    Attributes:
        op: Stencil3D (plan + plain matvec).
        coeff: (nk, nz, ny, nx) BC-eliminated planes, the PCG operator:
            the kept planes of ``fused_smooth.sym_planes_3d`` or all
            nd*nd*27 (K4 and K5 read either storage).
        coeff_lp: low-precision copy for the smoother, or None.
        inv_diag: (nd, nz, ny, nx) inverse diagonal, 0 at fixed dofs.
        mask: (nd, nz, ny, nx) bool, True at constrained dofs.
        shape: (nz, ny, nx) node grid.
        nd: dofs per node.
    """

    def __init__(self, op: Stencil3D, coeff, inv_diag, mask, shape, nd,
                 coeff_lp=None):
        self.op = op
        self.coeff = coeff
        self.coeff_lp = coeff_lp
        self.inv_diag = inv_diag
        self.mask = mask
        self.shape = tuple(int(s) for s in shape)
        self.nd = int(nd)
        self.dense_inv = None  # explicit inverse (see dense_factor)

    @property
    def _coeff_smooth(self):
        """Preconditioner-internal coefficients (bf16 copy when set)."""
        return self.coeff if self.coeff_lp is None else self.coeff_lp

    def matvec(self, u):
        """A u on the full-precision planes (the PCG operator), K4."""
        return fused_smooth.fused_sweep_3d(self.coeff, x=u, mode="matvec",
                                           neg_resid=True)

    def can_fuse3d(self, niter, x0_zero, want_resid):
        """True when K5 covers the smoothing call: any ``niter >= 1``.

        The port's K5 runs one stencil pass per sweep, so it has neither
        the TPU kernel's z ghost-plane budget nor its VMEM guard.
        """
        return niter >= 1

    def presmooth_resid3d(self, b, niter, omega):
        """Sweeps from x0 = 0 plus the residual, one K5 call: (x, b - A x).

        Preconditioner-internal (bf16 copy when present; flexible PCG
        absorbs it).
        """
        return fused_smooth.fused_sweeps3d(
            self._coeff_smooth, self.inv_diag, b, None, niter=niter,
            want_resid=True, omega=omega,
        )

    def postsmooth3d(self, b, x0, niter, omega):
        """Sweeps from a given iterate, one K5 call."""
        return fused_smooth.fused_sweeps3d(
            self._coeff_smooth, self.inv_diag, b, x0, niter=niter,
            omega=omega,
        )

    def sweep3d(self, b, x, omega):
        """One sweep x + omega * invD * (b - A x), K4."""
        return fused_smooth.fused_sweep_3d(
            self._coeff_smooth, self.inv_diag, b, x, mode="sweep",
            omega=omega,
        )

    def resid3d(self, b, x):
        """b - A x on the smoother's coefficients, K4."""
        return fused_smooth.fused_sweep_3d(self._coeff_smooth, None, b, x,
                                           mode="resid")

    def dense_factor(self):
        """Explicit inverse of the (small) coarsest operator.

        Columns come from the plain stencil matvec over an identity
        batch, on the full planes (rebuilt from the kept ones under sym
        storage).
        """
        nz, ny, nx = self.shape
        n = nz * ny * nx * self.nd
        eye = torch.eye(n, dtype=self.inv_diag.dtype,
                        device=self.inv_diag.device)
        full = fused_smooth.as_full_planes_3d(self.coeff, self.nd)
        A = self.op.matvec(
            full, eye.reshape(n, self.nd, nz, ny, nx)
        ).reshape(n, n)
        # row i of the batch is A e_i = column i of A; A is symmetric
        L = torch.linalg.cholesky(A.t())
        self.dense_inv = torch.cholesky_inverse(L)
        return self


class OTFLevel:
    """One 3D grid level with no coefficients: K6 applies the operator.

    Holds the level's nodal density, free-dof mask and OTF weight tables
    (``ops.otf3d.otf_weights``); every matvec, sweep and residual
    rebuilds the stencil coefficients from the density inside kernel K6,
    so no coefficient volume is ever written or read.  Nothing is cached
    per assembly: each sweep pass recomputes the inverse diagonal from
    the density.  Exposes the surface ``GMG._cycle3d`` uses on
    :class:`Level3D`.  Precondition (K6's): every field handed in is
    zero at fixed dofs, which the V-cycle and PCG keep.

    Attributes:
        rho: (nz, ny, nx) nodal density of the level.
        maskf: (nd, nz, ny, nx) free-dof mask (1.0 free / 0.0 fixed).
        w3, wd: the OTF weight tables in the working dtype.
        mask: (nd, nz, ny, nx) bool, True at constrained dofs.
        smoother_bf16: the smoother's calls round K6's matmul operands
            to bf16 (the OTF analogue of the bf16 coefficient copy).
    """

    dense_inv = None  # never the coarsest level

    def __init__(self, rho, maskf, mask, w3, wd, shape, nd, p,
                 smoother_bf16=False):
        self.rho = rho
        self.maskf = maskf
        self.mask = mask
        self.w3 = w3
        self.wd = wd
        self.shape = tuple(int(s) for s in shape)
        self.nd = int(nd)
        self.p = float(p)
        self.smoother_bf16 = bool(smoother_bf16)
        self._inv_diag = None

    def _call(self, b, x, **kw):
        return otf3d.otf_apply_3d(self.rho, self.maskf, self.w3, self.wd, b,
                                  x, p=self.p, **kw)

    def matvec(self, u):
        """A u in float32 operands (the PCG operator), K6."""
        return self._call(None, u, niter=0, want_resid=True, neg_resid=True)

    def can_fuse3d(self, niter, x0_zero, want_resid):
        """True for any ``niter >= 1``: K6 runs one pass per sweep, so it
        has no z ghost-plane budget (the TPU's ``otf_budget_ok``)."""
        return niter >= 1

    def presmooth_resid3d(self, b, niter, omega):
        """Sweeps from x0 = 0 plus the residual: (x, b - A x), K6."""
        return self._call(b, None, niter=niter, want_resid=True, omega=omega,
                          mxu_bf16=self.smoother_bf16)

    def postsmooth3d(self, b, x0, niter, omega):
        """Sweeps from a given iterate, K6."""
        return self._call(b, x0, niter=niter, want_resid=False, omega=omega,
                          mxu_bf16=self.smoother_bf16)

    def sweep3d(self, b, x, omega):
        """One sweep x + omega * invD * (b - A x), K6."""
        return self.postsmooth3d(b, x, 1, omega)

    def resid3d(self, b, x):
        """b - A x on the float32 operator (as the JAX OTFLevel), K6."""
        return self._call(b, x, niter=0, want_resid=True)

    @property
    def inv_diag(self):
        """(nd, nz, ny, nx) inverse diagonal, 0 at fixed dofs, for the
        Chebyshev smoother: one float32 K6 sweep from x0 = 0 with omega
        1 on b = maskf, computed on first use."""
        if self._inv_diag is None:
            self._inv_diag = self._call(self.maskf, None, niter=1,
                                        want_resid=False, omega=1.0)
        return self._inv_diag


def smoothing_omegas(nu, lam_max=3.0, frac=8.0):
    """Per-sweep damping factors for product-form Chebyshev smoothing.

    Reciprocals of the ``nu`` Chebyshev nodes on
    ``[lam_max/frac, lam_max]``: the sweep product
    ``prod_k (I - omega_k D^-1 A)`` is the minimax degree-``nu``
    polynomial over that interval.  ``lam_max`` bounds the spectral
    radius of ``D^-1 A`` (overestimates are safe, underestimates
    diverge).
    """
    nu = int(nu)
    lo, hi = lam_max / frac, 1.02 * lam_max
    th, de = 0.5 * (hi + lo), 0.5 * (hi - lo)
    ks = np.arange(1, nu + 1)
    t = th + de * np.cos(np.pi * (2 * ks - 1) / (2 * nu))
    return tuple(float(w) for w in 1.0 / t)


class GMG:
    """V-cycle preconditioner over a list of Levels (fine -> coarse)."""

    def __init__(self, levels, nu_pre=2, nu_post=2, omega=0.7,
                 coarse_iters=24, restrict_fn=None, prolong_fn=None,
                 smoother="jacobi", cheb_lam=2.2, cheb_frac=8.0):
        """omega: a damping factor, a tuple of per-sweep factors, or
        ``"cheby"`` — per-sweep reciprocals of Chebyshev nodes on
        [cheb_lam/cheb_frac, cheb_lam].  Post-smoothing applies the
        factors in reverse so the V-cycle stays symmetric (each Jacobi
        sweep is self-adjoint in the D-inner product, so the adjoint of
        the pre-sweep product is the reversed product).

        smoother: ``"jacobi"`` (the damped sweeps above, fused in K2 /
        K5 / K6) or ``"chebyshev"``, the three-term Chebyshev recurrence
        of :meth:`_cheb_smooth` (``cheb_lam`` bounds the spectrum of
        D^-1 A; ``omega`` and ``cheb_frac`` are not used).

        restrict_fn, prolong_fn: grid transfers ``(field, shape) ->
        field``; default the interleave forms (:func:`restrict2d_il` /
        :func:`prolong2d_il`, 3D :func:`restrict3d_il` /
        :func:`prolong3d_il`).
        """
        self.levels = list(levels)
        self.nu_pre = int(nu_pre)
        self.nu_post = int(nu_post)
        if isinstance(omega, str) and omega != "cheby":
            raise ValueError(f"omega={omega!r}: want a float, a tuple or "
                             f"'cheby'")
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"smoother={smoother!r}: want 'jacobi' or "
                             f"'chebyshev'")
        self.omega = omega
        self.smoother = smoother
        self.coarse_iters = int(coarse_iters)
        self.cheb_lam = float(cheb_lam)
        self.cheb_frac = float(cheb_frac)
        self.dim = len(self.levels[0].shape)
        if self.dim == 2:
            default_r, default_p = restrict2d_il, prolong2d_il
        else:
            default_r, default_p = restrict3d_il, prolong3d_il
        self.restrict_fn = restrict_fn or default_r
        self.prolong_fn = prolong_fn or default_p

    def _omegas(self, niter, reverse=False):
        """Per-sweep damping tuple of length ``niter`` (reversed for
        post-smoothing: the adjoint ordering)."""
        if isinstance(self.omega, str):  # "cheby", checked at init
            seq = smoothing_omegas(niter, self.cheb_lam, self.cheb_frac)
        else:
            seq = fused_smooth._omega_seq(self.omega, niter)
        return seq[::-1] if reverse else seq

    def _resid(self, lv, b, x):
        """b - A x on the level's smoother operator: K2 at ``niter=0``
        (2D), K4 (3D) or K6 (an OTF level)."""
        return lv.resid3d(b, x) if self.dim == 3 else lv.resid(b, x)

    def _cheb_smooth(self, lv, x, b, degree):
        """Chebyshev smoothing for A x ~= b on D^-1 A over [cheb_lam/30,
        1.1 cheb_lam] (the JAX ``GMG._cheb_smooth``): one residual pass
        of the level's kernel per degree, the recurrence in elementwise
        torch.  ``x`` None starts from x0 = 0, whose residual is b
        itself (no pass).  The inverse diagonal is 0 at fixed dofs, so
        the JAX package's masking of the residual is implied."""
        hi = 1.1 * self.cheb_lam
        lo = self.cheb_lam / 30.0
        theta = 0.5 * (hi + lo)
        delta = 0.5 * (hi - lo)
        sigma = theta / delta
        invd = lv.inv_diag
        d = invd * (b if x is None else self._resid(lv, b, x)) / theta
        x = d if x is None else x + d
        rho_old = 1.0 / sigma
        for _ in range(int(degree) - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            d = (rho * rho_old * d
                 + (2.0 * rho / delta) * (invd * self._resid(lv, b, x)))
            x = x + d
            rho_old = rho
        return x

    def _coarse_solve(self, lv, b):
        if lv.dense_inv is not None:
            return (lv.dense_inv @ b.reshape(-1)).reshape(b.shape)
        if self.smoother == "chebyshev":
            return self._cheb_smooth(lv, None, b, self.coarse_iters)
        sweeps = (fused_smooth.fused_sweeps_2d if self.dim == 2
                  else fused_smooth.fused_sweeps3d)
        return sweeps(
            lv._coeff_smooth, lv.inv_diag, b, None, niter=self.coarse_iters,
            omega=self._omegas(self.coarse_iters),
        )

    def _coarse_correct(self, k, x, r):
        """x + P (V-cycle of the restricted residual), masked."""
        lv, coarse = self.levels[k], self.levels[k + 1]
        bc = self.restrict_fn(r, coarse.shape)
        bc = torch.where(coarse.mask, 0.0, bc)
        xc = self._cycle(k + 1, bc)
        corr = self.prolong_fn(xc, lv.shape)
        return x + torch.where(lv.mask, 0.0, corr)

    def _cycle(self, k, b):
        lv = self.levels[k]
        if k == len(self.levels) - 1:
            return self._coarse_solve(lv, b)
        if self.smoother == "chebyshev":
            x = self._cheb_smooth(lv, None, b, self.nu_pre)
            r = torch.where(lv.mask, 0.0, self._resid(lv, b, x))
            x = self._coarse_correct(k, x, r)
            return self._cheb_smooth(lv, x, b, self.nu_post)
        if self.dim == 3:
            return self._cycle3d(k, b)
        x, r = lv.presmooth_resid(b, self.nu_pre, self._omegas(self.nu_pre))
        x = self._coarse_correct(k, x, r)
        return lv.postsmooth(b, x, self.nu_post,
                             self._omegas(self.nu_post, reverse=True))

    def _cycle3d(self, k, b):
        lv = self.levels[k]
        oms = self._omegas(self.nu_pre)
        if lv.can_fuse3d(self.nu_pre, True, True):
            # all pre-sweeps + the residual in one K5 call
            x, r = lv.presmooth_resid3d(b, self.nu_pre, oms)
        else:
            # per-sweep K4 (K5 takes no nu = 0 call)
            x = torch.zeros_like(b)
            for om in oms:
                x = lv.sweep3d(b, x, om)
            r = lv.resid3d(b, x)
        x = self._coarse_correct(k, x, r)
        om_post = self._omegas(self.nu_post, reverse=True)
        if lv.can_fuse3d(self.nu_post, False, False):
            return lv.postsmooth3d(b, x, self.nu_post, om_post)
        for om in om_post:
            x = lv.sweep3d(b, x, om)
        return x

    def apply(self, r):
        """Preconditioner action z = M^-1 r (zero at constrained dofs)."""
        return self._cycle(0, torch.where(self.levels[0].mask, 0.0, r))

    @property
    def supports_apply_resid(self):
        """True when the fine level can supply A z with the V-cycle.

        2D Jacobi only, as in the JAX package: neither the 3D smoother
        nor the Chebyshev recurrence emits a trailing residual on the
        PCG operator, so :func:`pcg_gmg` takes :func:`pcg` with the
        level's matvec there.
        """
        return (len(self.levels) > 1 and self.dim == 2
                and self.smoother == "jacobi")

    def apply_resid(self, r):
        """One V-cycle returning (z, A z) with A z riding the postsmooth.

        The fine level's postsmooth emits its final residual ``b - A z``
        on the f32 coefficients, so the PCG matvec comes out as
        ``A z = b - r_out``.
        """
        lv = self.levels[0]
        b = torch.where(lv.mask, 0.0, r)
        x, rr = lv.presmooth_resid(b, self.nu_pre, self._omegas(self.nu_pre))
        x = self._coarse_correct(0, x, rr)
        z, rout = lv.postsmooth_resid(
            b, x, self.nu_post, self._omegas(self.nu_post, reverse=True)
        )
        return z, b - rout


# ---------------------------------------------------------------------------
# Hierarchy builder (rediscretized coarse operators)
# ---------------------------------------------------------------------------


def _grid_sizes(nx, ny, min_n=5):
    """Sequence of (nx, ny) halving the cell count per axis while 2|n-1."""
    sizes = [(nx, ny)]
    while True:
        nx2 = (nx - 1) // 2 + 1 if (nx - 1) % 2 == 0 else None
        ny2 = (ny - 1) // 2 + 1 if (ny - 1) % 2 == 0 else None
        if not nx2 or not ny2 or nx2 < min_n or ny2 < min_n:
            break
        nx, ny = nx2, ny2
        sizes.append((nx, ny))
    return sizes


def _grid_sizes_3d(nx, ny, nz, min_n=3):
    """Sequence of (nx, ny, nz) halving the cell count per axis while
    every axis has 2 | n-1 and stays >= min_n."""
    sizes = [(nx, ny, nz)]
    while True:
        nxt = []
        for n in (nx, ny, nz):
            nxt.append((n - 1) // 2 + 1 if (n - 1) % 2 == 0 else None)
        if any(v is None or v < min_n for v in nxt):
            break
        nx, ny, nz = nxt
        sizes.append((nx, ny, nz))
    return sizes


def _restrict_nodal(rho_grid):
    """Injection restriction of a nodal field (even entries per axis)."""
    return rho_grid[(slice(None, None, 2),) * rho_grid.ndim].contiguous()


def _dv_sens_uniform(Kq, N, p, offsets, rho_grid, phi, psi):
    """Nodal d(phi^T K(rho) psi)/drho on a uniform grid, scatter-free.

    Port of the JAX ``multigrid._dv_sens_uniform``.  With ``Ke = sum_q
    ramp(rho_q) Kq`` the gradient is

        dc[m] = sum_{e ni m} sum_q ramp'(rho_q[e]) N[q, m_e]
                                   (phi_e^T Kq psi_e)[e]

    where phi_e / psi_e are shifted slices of the (nd, *grid) component
    planes, the quadratic forms are one ``(nq*ndpe, ndpe) @ (ndpe,
    nelems)`` product, and the element -> node sum is one zero-padded
    plane add per local node — no gather, no scatter, no atomics.
    Written over the local-node offsets, so 2D and 3D share it.

    Args:
        Kq: (nq, ndpe, ndpe) unit element matrices (rows node*nd+comp,
            nodes in ``offsets`` order).
        N: (nq, nnodes_per_elem) shape values at quadrature points.
        p: RAMP penalization parameter.
        offsets: per-local-node grid offsets (``_QUAD4_LOCAL`` /
            ``_HEX8_LOCAL`` of ``ops.stencil``).
        rho_grid: nodal density, (ny, nx) or (nz, ny, nx).
        phi, psi: (nd, *grid) dof component planes.

    Returns:
        (*grid,) nodal gradient (flatten for the dof-vector form).
    """
    from .models.base import ramp_deriv

    nd = phi.shape[0]
    esh = tuple(s - 1 for s in rho_grid.shape)

    def sl(off, a):
        return a[tuple(slice(o, o + e) for o, e in zip(off, esh))]

    rho_e = [sl(off, rho_grid) for off in offsets]
    nq = N.shape[0]
    # term order of the JAX package's sum(): n = 1.. first, then n = 0
    rho_q = torch.stack([
        sum(N[q, n] * rho_e[n] for n in range(1, len(offsets)))
        + N[q, 0] * rho_e[0]
        for q in range(nq)
    ])
    w = ramp_deriv(rho_q, p)  # (nq,) + esh
    # element dof planes, row r = local_node * nd + comp
    P = torch.stack([sl(off, phi[a]) for off in offsets for a in range(nd)])
    Q = torch.stack([sl(off, psi[a]) for off in offsets for a in range(nd)])
    Pf = P.reshape(P.shape[0], -1)
    Qf = Q.reshape(Q.shape[0], -1)
    Kqa = Kq.to(phi.dtype)
    # s_q[e] = phi_e^T Kq psi_e for all q at once (one matrix product)
    Y = torch.einsum("qrs,se->qre", Kqa, Qf)
    s = torch.einsum("re,qre->qe", Pf, Y).reshape((nq,) + esh)
    ws = w * s
    out = None
    for n, off in enumerate(offsets):
        contrib = (sum(N[q, n] * ws[q] for q in range(1, nq))
                   + N[0, n] * ws[0])
        pad = []
        for o, g, e in reversed(list(zip(off, rho_grid.shape, esh))):
            pad += [o, g - e - o]
        padded = F.pad(contrib, pad)
        out = padded if out is None else out + padded
    return out


def _left_edge_mask(nx, ny, nd):
    """(nd, ny, nx) mask: all components of the x=0 node column."""
    mask = np.zeros((nd, ny, nx), dtype=bool)
    mask[:, :, 0] = True
    return mask


def _left_face_mask(nx, ny, nz, nd):
    """(nd, nz, ny, nx) mask: all components of the x=0 node face."""
    mask = np.zeros((nd, nz, ny, nx), dtype=bool)
    mask[:, :, :, 0] = True
    return mask


class StaticLevel(NamedTuple):
    """Per-level setup data of :class:`GMGAssembler` (2D) and
    :class:`GMGAssembler3D` (3D; shapes gain the z axis)."""

    op: object           # Stencil2D / Stencil3D
    mask: torch.Tensor   # (nd, [nz,] ny, nx) bool, True at fixed dofs
    maskf: torch.Tensor  # 1.0 free / 0.0 fixed, same shape (K1/K3 input)
    shape: tuple         # ([nz,] ny, nx)
    Kq: torch.Tensor     # (nq, ndpe, ndpe) unit element matrices
    W: torch.Tensor      # (nd*nd*9, 4, nq) K1 / (nd*nd*27, 8, nq) K3 weights
    otf: tuple = None    # 3D OTF level: (w3, wd) K6 tables, else None
    elem: tuple = None   # elem_path "einsum"/"cuda": (Xe, conn, XeT|None)


class GMGAssembler:
    """Static per-level data + the hierarchy assembly from a density.

    Setup (host, once): coarse ProblemCreator grids, BC masks, unit
    element matrices and K1 weights per level.  ``assemble(rho)`` then
    builds every level's operator on the device: with kernel K1 on the
    default ``elem_path="uniform"``, or from element matrices.

    Args:
        physics: "elasticity" (plane stress) or "poisson".
        device: where the hierarchy lives; None means the CUDA card
            (``device="cpu"`` runs the kernels' plain versions).
        elem_path: element-matrix route of ``assemble``:
            * "uniform" (default): uniform-geometry unit matrices folded
              into K1, which writes the eliminated planes directly;
            * "cuda": element matrices by kernel K7
              (``ops.element_kernels``; the JAX ``"pallas"`` route);
            * "einsum": element matrices by the einsum path
              (``ops.stiffness``), any dtype.
            On "cuda" and "einsum" each level's planes come from
            ``Stencil2D.assemble[_transposed]`` and are BC-eliminated
            with their inverse diagonal and optional bf16 copy, as the
            JAX ``Level.__init__`` does; K2 smooths them as on the
            uniform route.
        smoother: the V-cycle's smoother, ``"jacobi"`` or
            ``"chebyshev"`` (:class:`GMG`).
        sym: coefficient storage, the JAX package's ``pallas_sym``: all
            nd*nd*9 planes (False, the default in 2D, as in JAX) or the
            half-symmetric kept planes of ``fused_smooth.sym_planes_2d``
            (K1 writes them; K2 reads them in every mode).
    """

    _level_cls = Level
    _assemble_fn = staticmethod(fused_assemble.assemble_pack_2d)
    _offsets = _QUAD4_LOCAL  # local-node grid offsets (dv_sens, materials)
    _sym_planes = staticmethod(fused_smooth.sym_planes_2d)  # kept planes

    def __init__(self, nx, ny, Lx, Ly, physics="elasticity", E=10.0, nu=0.3,
                 p=0.0, dtype=torch.float32, device=None, nu_pre=2,
                 nu_post=2, omega=0.7, min_n=5, fine_mask=None,
                 coarse_dense=True, coarse_dense_max=4096,
                 smoother_dtype=None, cheb_lam=None, cheb_frac=8.0,
                 elem_path="uniform", sym=False, smoother="jacobi"):
        """fine_mask: optional (nd, ny, nx) bool Dirichlet mask; coarse
        masks are derived by injection (default: clamp the x=0 column,
        matching ProblemCreator's problem factories).

        omega: smoother damping — a float (stationary Jacobi), a tuple
        of per-sweep factors, or ``"cheby"`` for Chebyshev-node factors
        on [cheb_lam/cheb_frac, cheb_lam] (:func:`smoothing_omegas`).

        smoother_dtype: ``torch.bfloat16`` keeps a bf16 copy of each
        level's planes for the smoother (written by K1 in the same
        pass); the PCG operator stays full precision, and the solve
        then needs flexible PCG.
        """
        from .mesh import ProblemCreator

        if elem_path not in ("uniform", "einsum", "cuda"):
            raise ValueError(f"unknown elem_path {elem_path!r} (the JAX "
                             f"'pallas' route is 'cuda' here)")
        self.elem_path = elem_path
        self.sym = bool(sym)
        # spectral-radius bound of D^-1 A for Chebyshev-node smoothing
        # (power iteration on uniform grids: quad4 elasticity 2.20,
        # poisson 1.49; overestimates are safe)
        nd = self._setup("quad4", 2, physics, E, nu, p, dtype, device,
                         nu_pre, nu_post, omega, coarse_dense,
                         coarse_dense_max, smoother_dtype, cheb_lam,
                         cheb_frac, 2.3, smoother)
        self.sizes = _grid_sizes(nx, ny, min_n=min_n)
        self.static_levels = []
        cur_mask = None
        if fine_mask is not None:
            cur_mask = np.asarray(fine_mask).reshape(nd, ny, nx)
        for lnx, lny in self.sizes:
            creator = ProblemCreator(nnodes_x=lnx, nnodes_y=lny, Lx=Lx,
                                     Ly=Ly, element_type="quad")
            if cur_mask is not None:
                mask_np = cur_mask.copy()
                cur_mask = cur_mask[:, ::2, ::2]
            else:
                mask_np = _left_edge_mask(lnx, lny, nd)
            self._add_level(Stencil2D(lnx, lny, nd), creator, mask_np,
                            (lny, lnx), fused_assemble.assembly_weights)
            if elem_path != "uniform":
                self.static_levels[-1] = self.static_levels[-1]._replace(
                    elem=self._elem_data(creator, elem_path == "cuda"))

    def _setup(self, element, dim, physics, E, nu, p, dtype, device, nu_pre,
               nu_post, omega, coarse_dense, coarse_dense_max,
               smoother_dtype, cheb_lam, cheb_frac, cheb_lam_elasticity,
               smoother):
        """Options, material and element tables shared by 2D and 3D."""
        from .elements import get_element
        from .ops import stiffness

        if physics not in ("elasticity", "poisson"):
            raise ValueError(f"unknown physics {physics!r}")
        self.physics = physics
        self.p = float(p)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.nu_pre, self.nu_post, self.omega = nu_pre, nu_post, omega
        self.coarse_dense = bool(coarse_dense)
        self.coarse_dense_max = int(coarse_dense_max)
        self.smoother_dtype = smoother_dtype
        self.smoother = smoother
        if cheb_lam is None:
            cheb_lam = cheb_lam_elasticity if physics == "elasticity" else 1.6
        self.cheb_lam = float(cheb_lam)
        self.cheb_frac = float(cheb_frac)
        self.nd = dim if physics == "elasticity" else 1
        if physics == "elasticity":
            self.mu, self.lam = stiffness.lame_params(E, nu, dim)

        # element tables rounded to the working dtype (as the JAX
        # package's device copies are), then used in float64 on the host
        self._np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        et = get_element(element)
        self._N64 = et.shape_vals.astype(self._np_dtype).astype(np.float64)
        self._dN64 = et.shape_grads.astype(self._np_dtype).astype(np.float64)
        self._wq64 = et.quad_wts.astype(self._np_dtype).astype(np.float64)
        self.N = self._tensor(self._N64)
        return self.nd

    def _add_level(self, op, creator, mask_np, shape, weights_fn):
        # rounded to the working dtype before folding into W, as the
        # JAX package folds its device copy of Kq
        Kq = self.unit_matrices(creator.X[np.asarray(creator.conn[0])])
        Kq = Kq.astype(self._np_dtype).astype(np.float64)
        W = weights_fn(op.plan, Kq, self.nd, Kq.shape[0])
        self.static_levels.append(StaticLevel(
            op=op,
            mask=torch.as_tensor(mask_np, device=self.device),
            maskf=self._tensor((~mask_np).astype(np.float64)),
            shape=shape,
            Kq=self._tensor(Kq),
            W=self._tensor(W),
        ))

    def _elem_data(self, creator, transposed):
        """(Xe, conn, XeT or None) of a level's element-matrix route,
        gathered on the host as the JAX package does."""
        from .ops.element_kernels import transpose_xe

        Xe = self._tensor(creator.X[creator.conn])
        conn = torch.as_tensor(creator.conn, dtype=torch.int64,
                               device=self.device)
        return Xe, conn, transpose_xe(Xe) if transposed else None

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device).contiguous()

    def unit_matrices(self, Xe1):
        """(nquads, ndpe, ndpe) float64 per-quadrature unit matrices.

        Kq[q] = w_q |J_q| B_q^T C B_q of the level's (uniform) element,
        so ``sum_q Cq[e,q] Kq[q]`` reproduces the general assembly
        exactly on uniform grids.  The element tables are rounded to the
        working dtype first (without that, float32 tables drift ~1e-8
        from the reference's).  The 3x3 inverse is the JAX package's
        adjugate form, so both give the same float64 tables.
        """
        dN, wq = self._dN64, self._wq64
        Xe = np.asarray(Xe1, np.float64)
        Xc = Xe - Xe.mean(axis=0, keepdims=True)
        J = np.einsum("qnk,ni->qik", dN, Xc)  # (nq, d, d)
        if J.shape[-1] == 2:
            det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
            inv = np.empty_like(J)
            inv[:, 0, 0] = J[:, 1, 1]
            inv[:, 0, 1] = -J[:, 0, 1]
            inv[:, 1, 0] = -J[:, 1, 0]
            inv[:, 1, 1] = J[:, 0, 0]
            inv /= det[:, None, None]
        else:
            a, b, c = J[:, 0, 0], J[:, 0, 1], J[:, 0, 2]
            p_, q_, r_ = J[:, 1, 0], J[:, 1, 1], J[:, 1, 2]
            u, v, w = J[:, 2, 0], J[:, 2, 1], J[:, 2, 2]
            c00 = q_ * w - r_ * v
            c01 = -(p_ * w - r_ * u)
            c02 = p_ * v - q_ * u
            det = a * c00 + b * c01 + c * c02
            adj = np.stack(
                [
                    np.stack([c00, -(b * w - c * v), b * r_ - c * q_], -1),
                    np.stack([c01, a * w - c * u, -(a * r_ - c * p_)], -1),
                    np.stack([c02, -(a * v - b * u), a * q_ - b * p_], -1),
                ],
                axis=-2,
            )
            inv = adj / det[:, None, None]
        Ngrad = np.einsum("qnm,qmi->qni", dN, inv)  # (nq, nn, d)
        cq = wq * det
        nq, nn, d = Ngrad.shape
        if self.physics == "elasticity":
            gg = np.einsum("q,qnl,qml->qnm", cq, Ngrad, Ngrad)
            P = np.einsum("q,qna,qmb->qnamb", cq, Ngrad, Ngrad)
            eye = np.eye(d)
            return (
                self.mu
                * (gg[:, :, None, :, None] * eye[None, None, :, None, :])
                + self.mu * np.transpose(P, (0, 1, 4, 3, 2))
                + self.lam * P
            ).reshape(nq, nn * d, nn * d)
        return np.einsum("q,qnl,qml->qnm", cq, Ngrad, Ngrad)

    def material_planes(self, rho_grid):
        """RAMP material at quad points as (nquads, [nez,] ney, nex)
        planes (gather-free: the quad4 / hex8 nodal gather is four /
        eight shifted slices, one per local node of ``_offsets``)."""
        from .models.base import ramp

        esh = tuple(s - 1 for s in rho_grid.shape)
        rho_e = [rho_grid[tuple(slice(o, o + e) for o, e in zip(off, esh))]
                 for off in self._offsets]
        planes = []
        for q in range(self.N.shape[0]):
            acc = self.N[q, 0] * rho_e[0]
            for n in range(1, len(rho_e)):
                acc = acc + self.N[q, n] * rho_e[n]
            planes.append(acc)
        return ramp(torch.stack(planes), self.p)

    def dv_sens(self, rho_grid, phi, psi):
        """Scatter-free d(phi^T K psi)/drho on the fine grid (see
        :func:`_dv_sens_uniform`).

        rho_grid: (*grid); phi/psi: (nd, *grid).  Returns (*grid).
        """
        return _dv_sens_uniform(self.static_levels[0].Kq, self.N, self.p,
                                self._offsets, rho_grid, phi, psi)

    def _elem_matrices(self, Xe, conn, rho_flat):
        """(nelems, ndpe, ndpe) by the einsum path."""
        from .models.base import ramp
        from .ops import geometry, stiffness

        Cq = ramp(geometry.interp_to_quads(self.N, rho_flat[conn]), self.p)
        dN, wq = self._tensor(self._dN64), self._tensor(self._wq64)
        if self.physics == "elasticity":
            return stiffness.elasticity_stiffness(Xe, dN, wq, Cq, self.mu,
                                                  self.lam)
        return stiffness.poisson_stiffness(Xe, dN, wq, Cq)

    def _elem_level(self, st, rho_grid):
        """A level from element matrices (elem_path "cuda" in 2D,
        "einsum" in 2D and 3D): stencil assembly, Dirichlet elimination,
        inverse diagonal (0 at fixed dofs, K1's / K3's convention), the
        planes in the assembler's storage and the optional bf16 copy."""
        from .ops import element_kernels as ek

        Xe, conn, XeT = st.elem
        if self.elem_path == "cuda":
            Cq = self.material_planes(rho_grid)
            cqT = Cq.reshape(Cq.shape[0], -1)
            if self.physics == "elasticity":
                KeT = ek.elasticity_stiffness_quad4(XeT, cqT, self.mu,
                                                    self.lam)
            else:
                KeT = ek.poisson_stiffness_quad4(XeT, cqT)
            coeff = st.op.assemble_transposed(KeT)
        else:
            coeff = st.op.assemble(
                self._elem_matrices(Xe, conn, rho_grid.reshape(-1)))
        ce = st.op.bc_eliminate(coeff, st.mask)
        diag = st.op.diagonal(ce)
        invd = st.maskf / torch.where(diag == 0, 1.0, diag)
        ce = ce.reshape(-1, *st.shape)
        if self.sym:
            ce = ce[[k for (k, *_r) in self._sym_planes(self.nd)]]
        lp = None if self.smoother_dtype is None else ce.to(
            self.smoother_dtype)
        return self._level_cls(st.op, ce, invd, st.mask, st.shape, self.nd,
                               coeff_lp=lp)

    def _assemble_level(self, st, rho_grid):
        """One level's operator from its nodal density (K1 / K3, in the
        assembler's storage), or from element matrices on an
        ``elem_path`` that makes them ("cuda", "einsum")."""
        if st.elem is not None:
            return self._elem_level(st, rho_grid)
        outs = self._assemble_fn(
            rho_grid, st.maskf, st.W, self.N, nd=self.nd, p=self.p,
            lp_dtype=self.smoother_dtype, sym=self.sym,
        )
        return self._level_cls(
            st.op, outs[0], outs[1], st.mask, st.shape, self.nd,
            coeff_lp=outs[2] if len(outs) > 2 else None,
        )

    def assemble(self, rho):
        """Fine nodal rho -> (gmg, fine_level), every level through the
        assembly kernel (K1 in 2D, K3 in 3D) or, on a 3D OTF level, as
        the density K6 reads."""
        shape = self.static_levels[0].shape
        rho_grid = torch.as_tensor(rho, dtype=self.dtype,
                                   device=self.device).reshape(shape)
        rho_grid = rho_grid.contiguous()
        levels = []
        for st in self.static_levels:
            levels.append(self._assemble_level(st, rho_grid))
            rho_grid = _restrict_nodal(rho_grid)
        if self.coarse_dense and (
            int(np.prod(levels[-1].shape)) * self.nd <= self.coarse_dense_max
        ):
            levels[-1].dense_factor()
        gmg = GMG(levels, nu_pre=self.nu_pre, nu_post=self.nu_post,
                  omega=self.omega, smoother=self.smoother,
                  cheb_lam=self.cheb_lam, cheb_frac=self.cheb_frac)
        return gmg, levels[0]


class GMGAssembler3D(GMGAssembler):
    """3D (hex8) analogue of :class:`GMGAssembler`.

    ``elem_path="uniform"``: ``assemble(rho)`` builds every level with
    kernel K3; the V-cycle smooths with K5 and the PCG operator is K4.
    ``elem_path="otf"``: every level but the coarsest is an
    :class:`OTFLevel` (kernel K6 smooths and is the PCG operator, from
    the density alone); the coarsest is K3-assembled with its dense
    inverse.  ``elem_path="einsum"``: every level from einsum element
    matrices (``ops.stiffness``, any dtype) through
    ``Stencil3D.assemble``, eliminated, in the assembler's storage; K5
    smooths and K4 is the PCG operator, as on the uniform route.

    Args:
        physics: "elasticity" (3D isotropic, nd=3) or "poisson" (nd=1).
        elem_path: "uniform", "otf" or "einsum".
        sym: K3's coefficient storage, the JAX package's ``pallas_sym``:
            the half-symmetric kept planes (True, the default) or all
            nd*nd*27 planes.  A storage choice, not a tiling: K4 and K5
            read either.
    """

    _level_cls = Level3D
    _assemble_fn = staticmethod(fused_assemble.assemble_pack_3d)
    _offsets = _HEX8_LOCAL
    _sym_planes = staticmethod(fused_smooth.sym_planes_3d)

    def __init__(self, nx, ny, nz, Lx, Ly, Lz, physics="elasticity",
                 E=10.0, nu=0.3, p=0.0, dtype=torch.float32, device=None,
                 nu_pre=2, nu_post=2, omega=0.6, min_n=3, coarse_dense=True,
                 coarse_dense_max=4096, elem_path="uniform",
                 smoother_dtype=None, cheb_lam=None, cheb_frac=8.0,
                 fine_mask=None, sym=True, smoother="jacobi"):
        """fine_mask: optional (nd, nz, ny, nx) bool Dirichlet mask;
        coarse masks by injection (default: clamp the x=0 face, the
        create_*_problem factories' layout).

        omega: a float, a per-sweep tuple, or ``"cheby"`` (see
        :func:`smoothing_omegas`).  The JAX package's TPU knobs
        (``pallas_smooth``, ``pallas_tz`` and the rest) have no meaning
        here and are not taken (a ``TypeError``); ``pallas_sym`` is
        ``sym``.

        smoother: ``"jacobi"`` or ``"chebyshev"`` (:class:`GMG`).  The
        Chebyshev recurrence runs on OTF levels too (K6 residual passes;
        the JAX package builds assembled levels instead under it).
        """
        from .mesh import ProblemCreator

        if elem_path not in ("uniform", "otf", "einsum"):
            raise ValueError(f"unknown elem_path {elem_path!r}")
        self.elem_path = elem_path
        self.sym = bool(sym)
        # hex8 elasticity measured 2.96, poisson 1.49 (JAX package)
        nd = self._setup("hex8", 3, physics, E, nu, p, dtype, device,
                         nu_pre, nu_post, omega, coarse_dense,
                         coarse_dense_max, smoother_dtype, cheb_lam,
                         cheb_frac, 3.0, smoother)
        self.sizes = _grid_sizes_3d(nx, ny, nz, min_n=min_n)
        self.static_levels = []
        cur_mask = None
        if fine_mask is not None:
            cur_mask = np.asarray(fine_mask).reshape(nd, nz, ny, nx)
        for lnx, lny, lnz in self.sizes:
            creator = ProblemCreator(nnodes_x=lnx, nnodes_y=lny,
                                     nnodes_z=lnz, Lx=Lx, Ly=Ly, Lz=Lz,
                                     element_type="block")
            if cur_mask is not None:
                mask_np = cur_mask.copy()
                cur_mask = cur_mask[:, ::2, ::2, ::2]
            else:
                mask_np = _left_face_mask(lnx, lny, lnz, nd)
            self._add_level(Stencil3D(lnx, lny, lnz, nd), creator, mask_np,
                            (lnz, lny, lnx), fused_assemble.assembly_weights3d)
            if elem_path == "einsum":
                self.static_levels[-1] = self.static_levels[-1]._replace(
                    elem=self._elem_data(creator, False))
        if elem_path == "otf":  # every level but the coarsest
            for li, st in enumerate(self.static_levels[:-1]):
                self.static_levels[li] = st._replace(otf=self.otf_tables(st))

    def otf_tables(self, st):
        """(w3, wd) K6 tables of one level, folded in float64 from its
        unit matrices (as the JAX package folds its device copy of Kq)."""
        Kq = st.Kq.cpu().double().numpy()
        return tuple(self._tensor(t) for t in otf3d.otf_weights(
            st.op.plan, Kq, self.nd, Kq.shape[0]))

    def _assemble_level(self, st, rho_grid):
        if st.otf is None:
            return super()._assemble_level(st, rho_grid)
        return OTFLevel(rho_grid, st.maskf, st.mask, *st.otf, st.shape,
                        self.nd, self.p,
                        smoother_bf16=self.smoother_dtype is not None)


def build_elasticity_gmg(nx, ny, Lx, Ly, E=10.0, nu=0.3, p=0.0, rho=None,
                         dtype=torch.float32, nu_pre=2, nu_post=2, omega=0.7,
                         min_n=5, device=None):
    """GMG hierarchy for the left-edge-clamped plane-stress problem (the
    JAX ``build_elasticity_gmg``).

    Returns:
        (gmg, fine_level): use ``fine_level.matvec`` as the operator and
        ``gmg.apply`` as the preconditioner.
    """
    asm = GMGAssembler(nx, ny, Lx, Ly, "elasticity", E=E, nu=nu, p=p,
                       dtype=dtype, device=device, nu_pre=nu_pre,
                       nu_post=nu_post, omega=omega, min_n=min_n)
    if rho is None:
        rho = torch.ones(nx * ny, dtype=dtype, device=asm.device)
    return asm.assemble(rho)


def build_poisson_gmg(nx, ny, Lx, Ly, p=0.0, rho=None, dtype=torch.float32,
                      nu_pre=2, nu_post=2, omega=0.8, min_n=5, device=None):
    """GMG hierarchy for the left-edge-fixed Poisson problem (the JAX
    ``build_poisson_gmg``)."""
    asm = GMGAssembler(nx, ny, Lx, Ly, "poisson", p=p, dtype=dtype,
                       device=device, nu_pre=nu_pre, nu_post=nu_post,
                       omega=omega, min_n=min_n)
    if rho is None:
        rho = torch.ones(nx * ny, dtype=dtype, device=asm.device)
    return asm.assemble(rho)


# ---------------------------------------------------------------------------
# Krylov solvers
# ---------------------------------------------------------------------------


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _more(r, tol2):
    """r.r > tol2, read back to the host (counted in
    ``solvers.readbacks["pcg"]``)."""
    readbacks["pcg"] += 1
    return bool(_dot(r, r) > tol2)


def pcg(matvec, precond, b, rtol=1e-6, maxiter=500, x0=None,
        flexible=False):
    """Preconditioned CG with an arbitrary SPD preconditioner.

    flexible=True uses the Polak-Ribiere beta
    (z_new . (r_new - r_old) / rz_old), which tolerates a preconditioner
    that varies between applications — required when the V-cycle smooths
    on bfloat16 coefficients.

    Returns:
        (x, iterations, ||r||) with the residual norm a 0-d tensor.
    """
    tol2 = (rtol * torch.linalg.norm(b)) ** 2
    if x0 is None:
        # r = b - A*0: skip the setup matvec (a full coefficient read)
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    z = precond(r)
    pv = z
    rz = _dot(r, z)
    k = 0
    while k < maxiter and _more(r, tol2):  # one host sync
        Ap = matvec(pv)
        alpha = rz / _dot(pv, Ap)
        x = x + alpha * pv
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        if flexible:
            beta = _dot(r_new - r, z_new) / rz
        else:
            beta = _dot(r_new, z_new) / rz
        rz = _dot(r_new, z_new)
        pv = z_new + beta * pv
        r = r_new
        k += 1
    return x, k, torch.sqrt(_dot(r, r))


def pcg_gmg(gmg, lv0, b, rtol=1e-6, maxiter=500, x0=None, flexible=False):
    """PCG with the V-cycle preconditioner, the matvec riding the V-cycle.

    ``gmg.apply_resid`` returns ``A z`` alongside ``z`` (the trailing
    residual of the fine postsmooth), and ``A p`` is kept by the
    recurrence ``A p = A z + beta A p`` — no separate operator matvec
    per iteration.  Falls back to :func:`pcg` with ``lv0.matvec`` when
    ``gmg.supports_apply_resid`` is False (a one-level or a 3D
    hierarchy).  Same return contract.
    """
    if not gmg.supports_apply_resid:
        return pcg(lv0.matvec, gmg.apply, b, rtol=rtol, maxiter=maxiter,
                   x0=x0, flexible=flexible)
    tol2 = (rtol * torch.linalg.norm(b)) ** 2
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - lv0.matvec(x0)
    z, Ap = gmg.apply_resid(r)
    pv = z
    rz = _dot(r, z)
    k = 0
    while k < maxiter and _more(r, tol2):  # one host sync
        alpha = rz / _dot(pv, Ap)
        x = x + alpha * pv
        r_new = r - alpha * Ap
        z_new, Az_new = gmg.apply_resid(r_new)
        if flexible:
            beta = _dot(r_new - r, z_new) / rz
        else:
            beta = _dot(r_new, z_new) / rz
        rz = _dot(r_new, z_new)
        pv = z_new + beta * pv
        Ap = Az_new + beta * Ap
        r = r_new
        k += 1
    return x, k, torch.sqrt(_dot(r, r))
