"""Sharded geometric multigrid: node planes block-partitioned over ranks.

Port of ``pyfem_gpu_testflight_tpu/parallel/sharded_gmg.py``.  The
GMG-PCG solve of ``multigrid`` runs over a 1D mesh of ranks
(``parallel.sharding.Mesh``):

* every vector and coefficient plane of the fine levels is
  block-partitioned along the leading spatial axis (y in 2D, z in 3D);
* the 3^d stencil product needs one halo slab a side, exchanged with the
  neighbour ranks (:meth:`Mesh.halo`; ranks at the global ends receive
  zeros, matching the zero-padded global product);
* smoothing runs the port's kernels on each rank's block extended by a
  halo: in 2D kernel K2 (``ops.fused_smooth.fused_sweeps_2d``, full
  storage), one launch per smoothing call on a block extended by ``h``
  rows, ``h`` the call's stencil steps, exchanged once per call (the
  JAX ``pallas_smooth=True`` path, whose TPU kernel took 8 rows); in 3D
  kernel K4 (``fused_sweep_3d``, full storage) one pass at a time, a
  one-slab halo exchanged before each pass (as the JAX package runs
  it).  Rows of the extended block within the call's stencil steps of
  its edge are wrong and are cut off.  An
  optional ``smoother_dtype`` (bfloat16) copy of the planes feeds the
  smoother; the PCG operator stays full precision and PCG is flexible;
* grid transfers are the single-device interleave forms on the trailing
  axes and a one-slab halo form along the sharded axis;
* coarse levels below the sharded prefix are replicated: one
  ``all_gather`` of the coarsest sharded residual, then every rank runs
  the remaining V-cycle (``multigrid.GMG`` on its levels, the dense
  coarsest solve included);
* PCG is ``multigrid.pcg_gmg`` (2D) / ``multigrid.pcg`` (3D) on the
  local blocks with ``reduce=Mesh.all_reduce``: local dots + one
  ``all_reduce`` for the dots of a step; the stop test reads the
  all-reduced ``r.r``, so every rank stops at the same iteration.

Padding scheme (the JAX package's): a level with n real slabs is padded
to D*nl slabs (nl = m * 2^(S-1-l), m = ceil((n0-1+2^(S-1)) /
(D*2^(S-1))), at least the 2D call halo ``h``), so every sharded level's
local slab count halves exactly between levels.  Padded slabs carry zero
coefficients and a True Dirichlet mask; every vector is zero there, so
the iteration on the real grid is the unsharded one.

``local_assembly`` (default on the uniform element path) assembles every
sharded level on its rank: one rho halo slab per level, then the
assembler's kernel (K1 in 2D, K3 in 3D; plain XLA in the JAX package) on
the extended block cut to the grid's real slabs, so each local slab's
planes are the single-device ones bit for bit.  Off, every rank
assembles the global hierarchy (``GMGAssembler.assemble``) and keeps its
rows.  The replicated levels come from the same kernel, with the
smoother copy, as ``GMGAssembler.assemble`` makes them.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import multigrid
from ..multigrid import (
    GMG,
    GMGAssembler,
    GMGAssembler3D,
    _deinterleave2,
    _interleave2,
    _restrict_nodal,
    prolong2d_il,
    prolong3d_il,
    prolong_axis_il,
    restrict2d_il,
    restrict3d_il,
    restrict_axis_il,
)
from ..ops import fused_smooth
from ..ops.stencil import Stencil2D, Stencil3D
from ..solvers import cg_loop

__all__ = ["ShardedGMG2D", "ShardedGMG3D", "dryrun",
           "halo_stencil_matvec", "local_pcg"]


def _pad_lead(a, axis, before, after, value=0.0):
    """Constant-pad ``a`` along ``axis``."""
    pad = [0, 0] * a.ndim
    pad[2 * (a.ndim - 1 - axis)] = before
    pad[2 * (a.ndim - 1 - axis) + 1] = after
    return F.pad(a, pad, value=value)


def halo_stencil_matvec(coeff, u, mesh, nd, dim):
    """3^dim stencil product on a lead-axis-sharded local block.

    One halo slab a side along the sharded lead axis, zeros past the
    trailing axes: the global stencil product on this rank's rows.  2D:
    kernel K9 (``ops.stencil_matvec``; float32 and float64) on
    ``coeff (nd, nd, 3, 3, rows, nx)``; 3D: kernel K4 (matvec mode) on
    full-storage ``coeff (nd*nd*27, rows, ny, nx)`` in float32, its plain
    version in float64 (K4 has no float64 form).  ``rows`` is the local
    slab count, or that plus two when the caller keeps the coefficients
    extended by a zero slab a side (no copy per call).  ``u`` is (nd,
    rows, *trail).
    """
    nl = u.shape[1]
    rows = coeff.shape[-dim]
    if dim == 2:
        coeff = coeff.reshape((nd, nd, 3, 3) + tuple(coeff.shape[-2:]))
    else:
        coeff = coeff.reshape((nd * nd * 27,) + tuple(coeff.shape[-3:]))
    if rows == nl:
        coeff = _pad_lead(coeff, coeff.ndim - dim, 1, 1)
    elif rows != nl + 2:
        raise ValueError(f"coefficients have {rows} slabs for {nl} rows")
    y = multigrid._stencil_product(coeff, mesh.halo(u, 1, 1))
    return y.narrow(1, 1, nl)


def local_pcg(matvec, invd, b, mesh, rtol, maxiter):
    """Jacobi-PCG on lead-sharded local blocks (all-reduced dots).

    ``solvers.cg_loop`` with ``reduce=mesh.all_reduce``; ``matvec`` must
    be SPMD-correct on local blocks (e.g. :func:`halo_stencil_matvec`).

    Returns:
        (x, iters, resnorm), the last two 0-d tensors.
    """
    return cg_loop(matvec, b, inv_diag=invd, rtol=rtol, maxiter=maxiter,
                   reduce=mesh.all_reduce)


class _ShLevel(NamedTuple):
    """One sharded level on this rank.

    ``ck`` / ``ck_s``: full-storage eliminated planes (PCG operator /
    smoother copy) and ``dk``: the inverse diagonal (0 at fixed dofs),
    all on the rank's block extended by ``h`` slabs a side (2D: the
    neighbours' rows; 3D: zero slabs).  ``mask`` and ``invd`` are the
    local block's."""

    ck: torch.Tensor
    ck_s: torch.Tensor
    dk: torch.Tensor
    mask: torch.Tensor
    invd: torch.Tensor


class _Hierarchy(NamedTuple):
    levels: list        # _ShLevel per sharded level
    tail: GMG           # the replicated levels' V-cycle
    raw0: object        # uneliminated fine-level local planes, or None


class _ShardedGMGBase:
    """Dimension-generic sharded GMG-PCG over a 1D mesh of ranks."""

    dim: int  # spatial dimensions (2 or 3); sharded axis = leading one

    def __init__(self, mesh, asm, n_lead, n_sharded=None,
                 smoother_dtype=None, local_assembly=None):
        """smoother_dtype (e.g. bfloat16): low-precision copy of the planes
        for the smoother (flexible PCG absorbs it).
        local_assembly: assemble every sharded level on its rank (default
        on the uniform element path)."""
        if asm.smoother != "jacobi":
            raise ValueError("the sharded V-cycle smooths by damped Jacobi")
        if asm.nu_pre < 1 or asm.nu_post < 1:
            raise ValueError("the sharded V-cycle needs nu_pre, nu_post >= 1")
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.D = int(mesh.size)
        self.rank = int(mesh.rank)
        self.device = mesh.device
        self.asm = asm
        self.dtype = asm.dtype
        self.nd = asm.nd
        self.smoother_dtype = smoother_dtype
        # halo slabs of the kernels' extended blocks: a 2D call's stencil
        # steps (presmooth: nu_pre - 1 sweeps + the residual; the fine
        # postsmooth: nu_post sweeps + the residual); one for 3D passes
        self.h = max(asm.nu_pre, asm.nu_post + 1) if self.dim == 2 else 1
        nlev = len(asm.sizes)
        max_s = max(1, nlev - 1)  # keep >= 1 replicated (coarse) level
        S = max_s if n_sharded is None else max(1, min(int(n_sharded), max_s))
        self.S = S
        m = math.ceil(
            (n_lead - 1 + (1 << (S - 1))) / (self.D * (1 << (S - 1)))
        )
        m = max(m, self.h)  # a call's halo comes from one neighbour
        self.nl = [m * (1 << (S - 1 - l)) for l in range(S)]
        self.shapes = [tuple(st.shape) for st in asm.static_levels]
        if self.dim == 2:
            self._restrict_full, self._prolong_full = (restrict2d_il,
                                                       prolong2d_il)
        else:
            self._restrict_full, self._prolong_full = (restrict3d_il,
                                                       prolong3d_il)
        self.local_assembly = (
            asm.elem_path == "uniform" if local_assembly is None
            else bool(local_assembly)
        )
        self.last_stats = None

    # -- layout helpers ------------------------------------------------------

    def _local(self, a, l, value=0.0, axis=1):
        """Rank block of a global level-``l`` field (lead axis ``axis``),
        padded to D*nl slabs with ``value``."""
        a = _pad_lead(a, axis, 0, self.D * self.nl[l] - a.shape[axis],
                      value=value)
        return a.narrow(axis, self.rank * self.nl[l], self.nl[l])

    def _ext(self, v, g):
        """(nd, nl, *trail) -> the kernels' (nd, nl + 2h, *trail) block:
        ``g`` slabs a side from the neighbours, zeros beyond."""
        h = self.h
        if g == 0:
            return _pad_lead(v, 1, h, h)
        nl = v.shape[1]
        lo, hi = self.mesh.exchange(v.narrow(1, nl - g, g), v.narrow(1, 0, g))
        parts = [lo, v, hi]
        if g < h:
            z = v.new_zeros((v.shape[0], h - g) + tuple(v.shape[2:]))
            parts = [z, lo, v, hi, z]
        return torch.cat(parts, dim=1)

    def _crop(self, v, nl):
        return v.narrow(1, self.h, nl)

    def _level(self, ce, invd, mask):
        """A _ShLevel from local eliminated planes (nk, nl, *trail)."""
        if self.dim == 2:
            ck = self.mesh.halo(ce, 1, self.h)
            dk = self.mesh.halo(invd, 1, self.h)
        else:
            ck = _pad_lead(ce, 1, 1, 1)
            dk = _pad_lead(invd, 1, 1, 1)
        ck = ck.contiguous()
        ck_s = ck if self.smoother_dtype is None else ck.to(
            self.smoother_dtype)
        return _ShLevel(ck, ck_s, dk.contiguous(), mask,
                        dk.narrow(1, self.h, ce.shape[1]))

    def _omegas(self, n, reverse=False):
        """Per-sweep damping (``multigrid.GMG._omegas``)."""
        asm = self.asm
        if isinstance(asm.omega, str):  # "cheby"
            seq = multigrid.smoothing_omegas(n, asm.cheb_lam, asm.cheb_frac)
        else:
            seq = fused_smooth._omega_seq(asm.omega, n)
        return seq[::-1] if reverse else seq

    def _tail(self, levels):
        """The replicated levels' V-cycle."""
        asm = self.asm
        return GMG(levels, nu_pre=asm.nu_pre, nu_post=asm.nu_post,
                   omega=asm.omega, cheb_lam=asm.cheb_lam,
                   cheb_frac=asm.cheb_frac)

    # -- hierarchy assembly ----------------------------------------------------

    def _local_hierarchy(self, rho_loc, want_raw0=False):
        """Assemble every level's coefficients on the local block.

        Each sharded level: a one-slab rho halo, then the assembler's
        kernel (K1 in 2D, K3 in 3D, full storage) on the halo-extended
        block cut to the grid's real slabs — so no phantom element is
        assembled, and each local slab's stencil comes from the same
        elements, in the same order, as on one device — with the local
        slabs kept (padding slabs: zero planes, fixed); rho restricted
        block-locally (injection on even local slabs: every sharded
        level's local slab count is even).  Then one ``all_gather`` of
        the coarsest sharded rho, and every rank assembles the replicated
        levels with the same kernel.

        Args:
            rho_loc: (nl0, *trail) local nodal density block.
            want_raw0: also return the uneliminated fine-level local
                planes (the nonzero-Dirichlet rhs lift), by the plain
                uniform-geometry assembly.
        """
        asm, S, nd = self.asm, self.S, self.nd
        levels, raw0 = [], None
        for l in range(S):
            st, nl = asm.static_levels[l], self.nl[l]
            trail = tuple(self.shapes[l][1:])
            lo = self.rank * nl
            hi = min(lo + nl, self.shapes[l][0])   # real local slabs
            b0, b1 = max(lo - 1, 0), min(lo + nl + 1, self.shapes[l][0])
            rho_h = self.mesh.halo(rho_loc, 0, 1)  # slabs [lo-1, lo+nl+1)
            ce = rho_loc.new_zeros((nd * nd * 3 ** self.dim, nl) + trail)
            invd = rho_loc.new_zeros((nd, nl) + trail)
            if hi > lo:
                blk = rho_h[b0 - lo + 1: b1 - lo + 1].contiguous()
                c, d = asm._assemble_fn(
                    blk, st.maskf[:, b0:b1].contiguous(), st.W, asm.N,
                    nd=nd, p=asm.p, sym=False)[:2]
                ce[:, : hi - lo] = c[:, lo - b0: hi - b0]
                invd[:, : hi - lo] = d[:, lo - b0: hi - b0]
            if want_raw0 and l == 0:
                raw0 = (self._raw_planes(st, blk, lo - b0, hi - lo, nl)
                        if hi > lo else ce.new_zeros(
                            (nd, nd) + (3,) * self.dim + (nl,) + trail))
            levels.append(self._level(ce, invd,
                                      self._local(st.mask, l, value=True)))
            if l + 1 < S:
                rho_loc = _restrict_nodal(rho_loc)
        rho_g = self.mesh.all_gather(rho_loc, dim=0)[: self.shapes[S - 1][0]]
        tail = []
        for st in asm.static_levels[S:]:
            rho_g = _restrict_nodal(rho_g)
            tail.append(asm._assemble_level(st, rho_g))
        if asm.coarse_dense and (int(np.prod(tail[-1].shape)) * nd
                                 <= asm.coarse_dense_max):
            tail[-1].dense_factor()
        return _Hierarchy(levels, self._tail(tail), raw0)

    def _raw_planes(self, st, blk, first, n, nl):
        """The uneliminated planes of the block's slabs [first, first+n)
        as (nd, nd, 3, .., nl, *trail) local planes (zero on padding)."""
        trail = tuple(blk.shape[1:])
        if self.dim == 2:
            op = Stencil2D(trail[0], blk.shape[0], self.nd)
        else:
            op = Stencil3D(trail[1], trail[0], blk.shape[0], self.nd)
        c = op.assemble_uniform(self.asm.material_planes(blk),
                                st.Kq.cpu().numpy())
        lead = c.ndim - self.dim
        out = c.new_zeros(tuple(c.shape[:lead]) + (nl,) + trail)
        out.narrow(lead, 0, n).copy_(c.narrow(lead, first, n))
        return out

    def _global_hierarchy(self, rho):
        """Every rank assembles the global hierarchy (K1 / K3, full
        storage) and keeps its rows of the sharded levels."""
        gmg, _ = self.asm.assemble(rho)
        levels = []
        for l in range(self.S):
            lv = gmg.levels[l]
            levels.append(self._level(
                self._local(lv.coeff, l).contiguous(),
                self._local(lv.inv_diag, l).contiguous(),
                self._local(lv.mask, l, value=True)))
        return _Hierarchy(levels, self._tail(gmg.levels[self.S:]), None)

    # -- the local operators ---------------------------------------------------

    def _matvec(self, lv, u):
        """A u on the local block (full-precision planes)."""
        ue = self._ext(u, 1)
        if self.dim == 2:
            y = fused_smooth.fused_sweeps_2d(
                lv.ck, lv.dk, None, ue, niter=0, want_resid=True,
                neg_resid=True)
        else:
            y = fused_smooth.fused_sweep_3d(lv.ck, x=ue, mode="matvec",
                                            neg_resid=True)
        return self._crop(y, u.shape[1])

    def _sweep(self, planes, lv, bk, x, om):
        """One 3D damped-Jacobi pass on a one-slab halo (K4)."""
        y = fused_smooth.fused_sweep_3d(planes, lv.dk, bk, self._ext(x, 1),
                                        mode="sweep", omega=om)
        return self._crop(y, x.shape[1])

    def _resid(self, planes, bk, x):
        """3D b - A x on ``planes``, one-slab halo (K4)."""
        y = fused_smooth.fused_sweep_3d(planes, None, bk, self._ext(x, 1),
                                        mode="resid")
        return self._crop(y, x.shape[1])

    def _presmooth_resid(self, lv, b):
        """nu_pre sweeps from x0 = 0 and the residual, on the smoother's
        planes: (x, r, bk).  2D: one K2 launch; 3D: K4 passes."""
        oms, nl = self._omegas(self.asm.nu_pre), b.shape[1]
        if self.dim == 2:
            bk = self._ext(b, self.h)
            x, r = fused_smooth.fused_sweeps_2d(
                lv.ck_s, lv.dk, bk, None, niter=len(oms), want_resid=True,
                omega=oms)
            return self._crop(x, nl), self._crop(r, nl), bk
        bk = self._ext(b, 0)
        # the first sweep from x = 0 is elementwise
        x = oms[0] * lv.invd * b
        for om in oms[1:]:
            x = self._sweep(lv.ck_s, lv, bk, x, om)
        return x, self._resid(lv.ck_s, bk, x), bk

    def _postsmooth(self, lv, x, bk, want_resid=False):
        """nu_post sweeps from x; with ``want_resid`` on the full-precision
        planes with the trailing residual (``Level.postsmooth_resid``):
        (x, b - A x)."""
        oms = self._omegas(self.asm.nu_post, reverse=True)
        planes = lv.ck if want_resid else lv.ck_s
        if self.dim == 2:
            out = fused_smooth.fused_sweeps_2d(
                planes, lv.dk, bk, self._ext(x, self.h), niter=len(oms),
                want_resid=want_resid, omega=oms)
            crop = lambda v: self._crop(v, x.shape[1])
            return tuple(map(crop, out)) if want_resid else crop(out)
        for om in oms:
            x = self._sweep(planes, lv, bk, x, om)
        return (x, self._resid(planes, bk, x)) if want_resid else x

    def _restrict_loc(self, f):
        """Local fine -> local coarse: the single-device tent step on the
        trailing axes, c[j] = f[2j] + (f[2j-1] + f[2j+1]) / 2 on the
        one-slab-haloed lead axis (zeros at the global ends)."""
        for ax in range(2, f.ndim):
            f = restrict_axis_il(f, ax, (f.shape[ax] + 1) // 2)
        e, o = _deinterleave2(self.mesh.halo(f, 1, 1), 1)
        nl2 = f.shape[1] // 2
        return o[:, :nl2] + 0.5 * (e[:, :nl2] + e[:, 1: nl2 + 1])

    def _prolong_loc(self, c):
        """Local coarse -> local fine (right-haloed interleave form)."""
        _, hi = self.mesh.exchange(c[:, -1:], c[:, :1])
        ch = torch.cat([c, hi], dim=1)
        nl2 = c.shape[1]
        avg = 0.5 * (ch[:, :nl2] + ch[:, 1: nl2 + 1])
        f = _interleave2(c, avg, 1, 2 * nl2)
        for ax in range(2, f.ndim):
            f = prolong_axis_il(f, ax, 2 * f.shape[ax] - 1)
        return f

    def _vcycle(self, hier, b, want_az=False):
        """One V-cycle: (z, A z) with ``want_az`` (2D: A z rides the fine
        postsmooth, as ``GMG.apply_resid``), else (z, None)."""
        S, sh, tail = self.S, hier.levels, hier.tail
        bs, xs, bks = [b], [], []
        for l in range(S):
            x, r, bk = self._presmooth_resid(sh[l], bs[l])
            xs.append(x)
            bks.append(bk)
            if l + 1 < S:
                bs.append(torch.where(sh[l + 1].mask, 0.0,
                                      self._restrict_loc(r)))
                continue
            # the replicated tail: gather the coarsest sharded residual,
            # every rank runs the rest of the V-cycle
            n_last, last_shape = self.shapes[S - 1][0], self.shapes[S - 1]
            r_full = self.mesh.all_gather(r, dim=1)[:, :n_last]
            c0 = tail.levels[0]
            bc = torch.where(c0.mask, 0.0,
                             self._restrict_full(r_full, c0.shape))
            corr = self._local(
                self._prolong_full(tail._cycle(0, bc), last_shape), S - 1)
        az = None
        for l in reversed(range(S)):
            x = xs[l] + torch.where(sh[l].mask, 0.0, corr)
            if l == 0 and want_az:
                x, rout = self._postsmooth(sh[0], x, bks[0], want_resid=True)
                az = bs[0] - rout
            else:
                x = self._postsmooth(sh[l], x, bks[l])
            if l > 0:
                corr = self._prolong_loc(x)
        return x, az

    # -- the solve ------------------------------------------------------------

    def _local_solve(self, hier, b0, rtol, maxiter, x0=None):
        """PCG with the sharded V-cycle on the local blocks: in 2D
        ``multigrid.pcg_gmg`` (the matvec rides the V-cycle's fine
        postsmooth), in 3D ``multigrid.pcg`` with one K4 matvec an
        iteration; the dots all-reduced; flexible (Polak-Ribiere) with a
        low-precision smoother copy.

        Returns (x, iters, resnorm): the local block, an int and a 0-d
        tensor.
        """
        lv0 = hier.levels[0]
        mask0 = lv0.mask
        b = torch.where(mask0, 0.0, b0)
        if x0 is not None:
            x0 = torch.where(mask0, 0.0, x0)
        kw = dict(rtol=rtol, maxiter=maxiter, x0=x0,
                  flexible=self.smoother_dtype is not None,
                  reduce=self.mesh.all_reduce)

        def matvec(u):
            return self._matvec(lv0, u)

        def cycle(r, want_az):
            return self._vcycle(hier, torch.where(mask0, 0.0, r),
                                want_az=want_az)

        if self.dim == 2:
            gmg = SimpleNamespace(supports_apply_resid=True,
                                  apply_resid=lambda r: cycle(r, True))
            return multigrid.pcg_gmg(gmg, SimpleNamespace(matvec=matvec), b,
                                     **kw)
        return multigrid.pcg(matvec, lambda r: cycle(r, False)[0], b, **kw)

    def _as_local(self, v, value=0.0):
        """Global (nd, *grid) field -> this rank's padded fine block."""
        v = torch.as_tensor(v, device=self.device).to(self.dtype)
        return self._local(v.reshape((self.nd,) + self.shapes[0]), 0,
                           value=value)

    def hierarchy(self, rho_loc, want_raw0=False):
        """The sharded hierarchy from this rank's fine rho block."""
        if self.local_assembly:
            return self._local_hierarchy(rho_loc, want_raw0=want_raw0)
        if want_raw0:
            raise ValueError("nonzero Dirichlet values need "
                             "local_assembly=True (the global levels are "
                             "eliminated only)")
        rho = self.mesh.all_gather(rho_loc, dim=0)[: self.shapes[0][0]]
        return self._global_hierarchy(rho)

    def solve(self, rho, b_planar, rtol=1e-6, maxiter=200, vals=None,
              return_rhs=False):
        """Assemble + sharded GMG-PCG.

        Args:
            rho: fine nodal density (flattened or grid-shaped), the
                global field on every rank.
            b_planar: rhs as (nd, *grid) component planes (global).
            vals: optional (nd, *grid) Dirichlet values (nonzero BC
                data; applied via a rhs lift through the raw operator).
            return_rhs: also return the BC-applied rhs (compliance
                convention: fixed entries carry the values, free ones
                the lifted load).

        Returns:
            (x, iters, resnorm[, b]) with x as global (nd, *grid) planes
            on every rank (one ``all_gather``).
        """
        mesh, n0 = self.mesh, self.shapes[0][0]
        rho = torch.as_tensor(rho, device=self.device).to(self.dtype)
        rho_loc = self._local(rho.reshape(self.shapes[0]), 0, axis=0)
        b0 = self._as_local(b_planar)
        has_vals = vals is not None
        mesh.reset_counts()
        hier = self.hierarchy(rho_loc.contiguous(), want_raw0=has_vals)
        mask0 = hier.levels[0].mask
        if has_vals:
            v = self._as_local(vals)
            vz = torch.where(mask0, v, 0.0)
            b0 = torch.where(mask0, 0.0, b0 - halo_stencil_matvec(
                hier.raw0, vz, mesh, self.nd, self.dim))
            b_out = torch.where(mask0, v, b0)
        else:
            b_out = torch.where(mask0, 0.0, b0)
        n_asm = dict(mesh.counts)
        x, k, rn = self._local_solve(hier, b0, rtol, maxiter)
        if has_vals:
            x = torch.where(mask0, v, x)
        self.last_stats = {
            "iters": k, "collectives_assembly": n_asm,
            "collectives_solve": {c: n - n_asm[c]
                                  for c, n in mesh.counts.items()},
        }
        full = lambda v: mesh.all_gather(v, dim=1)[:, :n0].contiguous()
        if return_rhs:
            return full(x), k, rn, full(b_out)
        return full(x), k, rn


class ShardedGMG2D(_ShardedGMGBase):
    """2D quad4 GMG-PCG sharded along y (rows of the node grid)."""

    dim = 2

    def __init__(self, mesh, nx, ny, Lx, Ly, physics="elasticity",
                 E=10.0, nu=0.3, p=0.0, dtype=torch.float32, nu_pre=2,
                 nu_post=2, omega=0.7, min_n=5, n_sharded=None,
                 fine_mask=None, pallas_smooth=True, smoother_dtype=None,
                 local_assembly=None):
        """``pallas_smooth`` is the JAX package's switch to its kernel
        smoother; here smoothing always runs the kernels (K2), so it
        changes nothing."""
        asm = GMGAssembler(
            nx, ny, Lx, Ly, physics, E=E, nu=nu, p=p, dtype=dtype,
            device=mesh.device, nu_pre=nu_pre, nu_post=nu_post,
            omega=omega, min_n=min_n, fine_mask=fine_mask,
            smoother_dtype=smoother_dtype,
        )
        super().__init__(mesh, asm, int(ny), n_sharded,
                         smoother_dtype=smoother_dtype,
                         local_assembly=local_assembly)


class ShardedGMG3D(_ShardedGMGBase):
    """3D hex8 GMG-PCG sharded along z (slabs of the node grid)."""

    dim = 3

    def __init__(self, mesh, nx, ny, nz, Lx, Ly, Lz,
                 physics="elasticity", E=10.0, nu=0.3, p=0.0,
                 dtype=torch.float32, nu_pre=2, nu_post=2, omega=0.6,
                 min_n=3, n_sharded=None, fine_mask=None,
                 pallas_smooth=True, smoother_dtype=None,
                 local_assembly=None):
        """``pallas_smooth``: as in :class:`ShardedGMG2D` (K4 here)."""
        # full storage: the kernels run on the sharded blocks' planes
        asm = GMGAssembler3D(
            nx, ny, nz, Lx, Ly, Lz, physics, E=E, nu=nu, p=p, dtype=dtype,
            device=mesh.device, nu_pre=nu_pre, nu_post=nu_post,
            omega=omega, min_n=min_n, fine_mask=fine_mask, sym=False,
            smoother_dtype=smoother_dtype,
        )
        super().__init__(mesh, asm, int(nz), n_sharded,
                         smoother_dtype=smoother_dtype,
                         local_assembly=local_assembly)


def dryrun(mesh, dtype=torch.float32):
    """Small sharded solves for the multichip dry run (the JAX
    ``sharded_gmg.dryrun``'s eight checks after the element-sharded one):
    see :func:`parallel.dryrun.dryrun_multichip`."""
    from .dryrun import sharded_checks

    return sharded_checks(mesh, dtype)
