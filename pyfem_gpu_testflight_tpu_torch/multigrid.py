"""Geometric multigrid for structured 2D quad grids (PyTorch port).

Port of the 2D part of ``pyfem_gpu_testflight_tpu/multigrid.py``:

* every level's operator is a BC-eliminated 9-point stencil assembled
  from the nodal density by kernel K1 (``ops.fused_assemble``) — on
  every level, the TPU's 8192-node assembly threshold being a TPU
  tuning;
* smoothing is damped Jacobi with per-sweep Chebyshev-node factors,
  run by kernel K2 (``ops.fused_smooth``), which also supplies the
  residuals and the operator matvec;
* prolongation is bilinear interpolation in reshape/interleave form,
  restriction its exact transpose (FEM Galerkin convention), so the
  V-cycle is a symmetric preconditioner for CG;
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

from .ops import fused_assemble, fused_smooth
from .ops.stencil import Stencil2D

__all__ = [
    "Level",
    "GMG",
    "GMGAssembler",
    "prolong2d_il",
    "restrict2d_il",
    "smoothing_omegas",
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


# ---------------------------------------------------------------------------
# Levels and the V-cycle
# ---------------------------------------------------------------------------


class Level:
    """One grid level: K1's eliminated planes + BC mask + smoother data.

    Attributes:
        op: Stencil2D (plan + plain matvec).
        coeff: (nd*nd*9, ny, nx) BC-eliminated stencil planes.
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
        batch; the inverse is computed once per hierarchy assembly.  It
        is a preconditioner component, so the inverse's (bounded) loss
        of backward stability vs a Cholesky solve is immaterial.
        """
        ny, nx = self.shape
        n = ny * nx * self.nd
        eye = torch.eye(n, dtype=self.inv_diag.dtype,
                        device=self.inv_diag.device)
        c = self.coeff.reshape(self.nd, self.nd, 3, 3, ny, nx)
        A = self.op.matvec(c, eye.reshape(n, self.nd, ny, nx)).reshape(n, n)
        # row i of the batch is A e_i = column i of A; A is symmetric
        L = torch.linalg.cholesky(A.t())
        self.dense_inv = torch.cholesky_inverse(L)
        return self


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
                 coarse_iters=24, cheb_lam=2.2, cheb_frac=8.0):
        """omega: a damping factor, a tuple of per-sweep factors, or
        ``"cheby"`` — per-sweep reciprocals of Chebyshev nodes on
        [cheb_lam/cheb_frac, cheb_lam].  Post-smoothing applies the
        factors in reverse so the V-cycle stays symmetric (each Jacobi
        sweep is self-adjoint in the D-inner product, so the adjoint of
        the pre-sweep product is the reversed product).
        """
        self.levels = list(levels)
        self.nu_pre = int(nu_pre)
        self.nu_post = int(nu_post)
        if isinstance(omega, str) and omega != "cheby":
            raise ValueError(f"omega={omega!r}: want a float, a tuple or "
                             f"'cheby'")
        self.omega = omega
        self.coarse_iters = int(coarse_iters)
        self.cheb_lam = float(cheb_lam)
        self.cheb_frac = float(cheb_frac)

    def _omegas(self, niter, reverse=False):
        """Per-sweep damping tuple of length ``niter`` (reversed for
        post-smoothing: the adjoint ordering)."""
        if isinstance(self.omega, str):  # "cheby", checked at init
            seq = smoothing_omegas(niter, self.cheb_lam, self.cheb_frac)
        else:
            seq = fused_smooth._omega_seq(self.omega, niter)
        return seq[::-1] if reverse else seq

    def _coarse_solve(self, lv, b):
        if lv.dense_inv is not None:
            return (lv.dense_inv @ b.reshape(-1)).reshape(b.shape)
        return fused_smooth.fused_sweeps_2d(
            lv._coeff_smooth, lv.inv_diag, b, None, niter=self.coarse_iters,
            omega=self._omegas(self.coarse_iters),
        )

    def _coarse_correct(self, k, x, r):
        """x + P (V-cycle of the restricted residual), masked."""
        lv, coarse = self.levels[k], self.levels[k + 1]
        bc = restrict2d_il(r, coarse.shape)
        bc = torch.where(coarse.mask, 0.0, bc)
        xc = self._cycle(k + 1, bc)
        corr = prolong2d_il(xc, lv.shape)
        return x + torch.where(lv.mask, 0.0, corr)

    def _cycle(self, k, b):
        lv = self.levels[k]
        if k == len(self.levels) - 1:
            return self._coarse_solve(lv, b)
        x, r = lv.presmooth_resid(b, self.nu_pre, self._omegas(self.nu_pre))
        x = self._coarse_correct(k, x, r)
        return lv.postsmooth(b, x, self.nu_post,
                             self._omegas(self.nu_post, reverse=True))

    def apply(self, r):
        """Preconditioner action z = M^-1 r (zero at constrained dofs)."""
        return self._cycle(0, torch.where(self.levels[0].mask, 0.0, r))

    @property
    def supports_apply_resid(self):
        """True when the fine level can supply A z with the V-cycle."""
        return len(self.levels) > 1

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


def _restrict_nodal(rho_grid):
    """Injection restriction of a nodal field (even entries per axis)."""
    return rho_grid[::2, ::2].contiguous()


def _left_edge_mask(nx, ny, nd):
    """(nd, ny, nx) mask: all components of the x=0 node column."""
    mask = np.zeros((nd, ny, nx), dtype=bool)
    mask[:, :, 0] = True
    return mask


class StaticLevel(NamedTuple):
    """Per-level setup data of :class:`GMGAssembler`."""

    op: Stencil2D
    mask: torch.Tensor   # (nd, ny, nx) bool, True at fixed dofs
    maskf: torch.Tensor  # (nd, ny, nx) 1.0 free / 0.0 fixed (K1 input)
    shape: tuple         # (ny, nx)
    Kq: torch.Tensor     # (nq, ndpe, ndpe) unit element matrices
    W: torch.Tensor      # (nd*nd*9, 4, nq) K1 weights


class GMGAssembler:
    """Static per-level data + the hierarchy assembly from a density.

    Setup (host, once): coarse ProblemCreator grids, BC masks, unit
    element matrices and K1 weights per level.  ``assemble(rho)`` then
    builds every level's operator on the device with kernel K1.

    Args:
        physics: "elasticity" (plane stress) or "poisson".
    """

    def __init__(self, nx, ny, Lx, Ly, physics="elasticity", E=10.0, nu=0.3,
                 p=0.0, dtype=torch.float32, device="cpu", nu_pre=2,
                 nu_post=2, omega=0.7, min_n=5, fine_mask=None,
                 coarse_dense=True, coarse_dense_max=4096,
                 smoother_dtype=None, cheb_lam=None, cheb_frac=8.0):
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
        from .elements import get_element
        from .mesh import ProblemCreator
        from .ops import stiffness

        if physics not in ("elasticity", "poisson"):
            raise ValueError(f"unknown physics {physics!r}")
        self.physics = physics
        self.p = float(p)
        self.dtype = dtype
        self.device = torch.device(device)
        self.nu_pre, self.nu_post, self.omega = nu_pre, nu_post, omega
        self.coarse_dense = bool(coarse_dense)
        self.coarse_dense_max = int(coarse_dense_max)
        self.smoother_dtype = smoother_dtype
        # spectral-radius bound of D^-1 A for Chebyshev-node smoothing
        # (power iteration on uniform grids: quad4 elasticity 2.20,
        # poisson 1.49; overestimates are safe)
        if cheb_lam is None:
            cheb_lam = 2.3 if physics == "elasticity" else 1.6
        self.cheb_lam = float(cheb_lam)
        self.cheb_frac = float(cheb_frac)
        nd = 2 if physics == "elasticity" else 1
        self.nd = nd
        if physics == "elasticity":
            self.mu, self.lam = stiffness.lame_params(E, nu, 2)

        # element tables rounded to the working dtype (as the JAX
        # package's device copies are), then used in float64 on the host
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        et = get_element("quad4")
        self._N64 = et.shape_vals.astype(np_dtype).astype(np.float64)
        self._dN64 = et.shape_grads.astype(np_dtype).astype(np.float64)
        self._wq64 = et.quad_wts.astype(np_dtype).astype(np.float64)
        self.N = self._tensor(self._N64)

        self.sizes = _grid_sizes(nx, ny, min_n=min_n)
        self.static_levels = []
        cur_mask = None
        if fine_mask is not None:
            cur_mask = np.asarray(fine_mask).reshape(nd, ny, nx)
        for lnx, lny in self.sizes:
            creator = ProblemCreator(nnodes_x=lnx, nnodes_y=lny, Lx=Lx,
                                     Ly=Ly, element_type="quad")
            op = Stencil2D(lnx, lny, nd)
            if cur_mask is not None:
                mask_np = cur_mask.copy()
                cur_mask = cur_mask[:, ::2, ::2]
            else:
                mask_np = _left_edge_mask(lnx, lny, nd)
            # rounded to the working dtype before folding into W, as the
            # JAX package folds its device copy of Kq
            Kq = self.unit_matrices(creator.X[np.asarray(creator.conn[0])])
            Kq = Kq.astype(np_dtype).astype(np.float64)
            W = fused_assemble.assembly_weights(op.plan, Kq, nd, Kq.shape[0])
            self.static_levels.append(StaticLevel(
                op=op,
                mask=torch.as_tensor(mask_np, device=self.device),
                maskf=self._tensor((~mask_np).astype(np.float64)),
                shape=(lny, lnx),
                Kq=self._tensor(Kq),
                W=self._tensor(W),
            ))

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device).contiguous()

    def unit_matrices(self, Xe1):
        """(nquads, ndpe, ndpe) float64 per-quadrature unit matrices.

        Kq[q] = w_q |J_q| B_q^T C B_q of the level's (uniform) element,
        so ``sum_q Cq[e,q] Kq[q]`` reproduces the general assembly
        exactly on uniform grids.  The element tables are rounded to the
        working dtype first (without that, float32 tables drift ~1e-8
        from the reference's).
        """
        dN, wq = self._dN64, self._wq64
        Xe = np.asarray(Xe1, np.float64)
        Xc = Xe - Xe.mean(axis=0, keepdims=True)
        J = np.einsum("qnk,ni->qik", dN, Xc)  # (nq, 2, 2)
        det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        inv = np.empty_like(J)
        inv[:, 0, 0] = J[:, 1, 1]
        inv[:, 0, 1] = -J[:, 0, 1]
        inv[:, 1, 0] = -J[:, 1, 0]
        inv[:, 1, 1] = J[:, 0, 0]
        inv /= det[:, None, None]
        Ngrad = np.einsum("qnm,qmi->qni", dN, inv)  # (nq, nn, 2)
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

    def assemble(self, rho):
        """Fine nodal rho -> (gmg, fine_level), every level through K1."""
        ny, nx = self.static_levels[0].shape
        rho_grid = torch.as_tensor(rho, dtype=self.dtype,
                                   device=self.device).reshape(ny, nx)
        rho_grid = rho_grid.contiguous()
        levels = []
        for st in self.static_levels:
            outs = fused_assemble.assemble_pack_2d(
                rho_grid, st.maskf, st.W, self.N, nd=self.nd, p=self.p,
                lp_dtype=self.smoother_dtype,
            )
            levels.append(Level(st.op, outs[0], outs[1], st.mask, st.shape,
                                self.nd,
                                coeff_lp=outs[2] if len(outs) > 2 else None))
            rho_grid = _restrict_nodal(rho_grid)
        if self.coarse_dense and (
            int(np.prod(levels[-1].shape)) * self.nd <= self.coarse_dense_max
        ):
            levels[-1].dense_factor()
        gmg = GMG(levels, nu_pre=self.nu_pre, nu_post=self.nu_post,
                  omega=self.omega, cheb_lam=self.cheb_lam,
                  cheb_frac=self.cheb_frac)
        return gmg, levels[0]


# ---------------------------------------------------------------------------
# Krylov solvers
# ---------------------------------------------------------------------------


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


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
    while k < maxiter and bool(_dot(r, r) > tol2):  # one host sync
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
    per iteration.  Falls back to :func:`pcg` for a one-level
    hierarchy.  Same return contract.
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
    while k < maxiter and bool(_dot(r, r) > tol2):  # one host sync
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
