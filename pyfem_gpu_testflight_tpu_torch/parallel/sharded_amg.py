"""Sharded smoothed-aggregation AMG for unstructured (.inp) meshes.

Port of ``pyfem_gpu_testflight_tpu/parallel/sharded_amg.py``, the
multi-rank form of :func:`unstructured.amg_pcg` (the reference's pyamg
role, pyfem.py:2392-2400).  The RCM band reordering that bands every
level also makes it shardable: a contiguous block of rows couples only
to columns within the level's bandwidth ``bw``, so its product needs one
halo of ``bw`` entries a side from the neighbour ranks.

The JAX package stores each level as DIA; the port's levels are CSR on
kernel U1 (``unstructured``), so each rank holds its row block as CSR
with its columns renumbered into [lower halo | local | upper halo] and
empty rows for the halo positions — a square matrix of nl + 2 bw rows —
and runs U1 (``ops.spmv.csr_matvec``) on the halo-extended vector.

Sharding scheme (1D mesh of ranks, dof axis):

* every level but the coarsest with ``bw <= local rows`` and
  ``n >= min_sharded`` is block-partitioned: values, diagonal, smoothing
  and the product run per rank;
* inter-level transfers pass through a replicated coarse vector:
  restriction is a rank-local deterministic segment sum of the tentative
  rows into the aggregates plus one ``all_reduce`` (the smoothed
  prolongator's correction applies the level's own sharded product);
  prolongation gathers from the replicated coarse vector with local row
  indices, with no communication;
* smaller levels and the dense coarsest solve run replicated on every
  rank;
* the outer CG is ``solvers.cg_loop`` on the sharded fine level with
  the V-cycle as preconditioner and all-reduced dots, in blocks of
  ``solvers.CHECK_EVERY`` iterations as ``amg_pcg``.

The set-up stays on the host (``unstructured.AMGPreconditioner``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..assembly import SortedSegments
from ..device import resolve_device
from ..ops.spmv import csr_matvec
from ..unstructured import AMGPreconditioner, _device_csr, _torch_dtype
from ..solvers import cg_loop

__all__ = ["ShardedAMGPCG", "sharded_amg_pcg"]


class _LocalCSR(NamedTuple):
    """A rank's row block, square over [lower halo | rows | upper halo]."""

    indptr: torch.Tensor
    indices: torch.Tensor
    vals: torch.Tensor
    bw: int
    nl: int


def _local_csr(indptr, indices, vals, lo, nl, bw, device):
    """Rows [lo, lo + nl) of a host CSR pattern (rows past its end
    empty) with columns shifted by ``lo - bw``: a square CSR of
    ``nl + 2 bw`` rows whose halo rows are empty.  ``vals`` is the
    matrix's value tensor (any device); its slice is taken, not copied
    to the host."""
    n = indptr.shape[0] - 1
    first, hi = min(lo, n), min(lo + nl, n)
    start, stop = int(indptr[first]), int(indptr[hi])
    ip = np.asarray(indptr[first: hi + 1], np.int64) - start
    cols = np.asarray(indices[start:stop], np.int64) - (lo - bw)
    if cols.size and (cols.min() < 0 or cols.max() >= nl + 2 * bw):
        raise ValueError("a column lies outside the rows' bandwidth halo")
    full = np.concatenate([np.zeros(bw, np.int64), ip,
                           np.full(nl - (hi - first) + bw, ip[-1],
                                   np.int64)])
    as_i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)
    return _LocalCSR(as_i32(full), as_i32(cols),
                     vals[start:stop].to(device).contiguous(), bw, nl)


class ShardedAMGPCG:
    """Sharded AMG-preconditioned CG for a host-assembled CSR system.

    Every rank builds the same host set-up and keeps its row blocks of
    the sharded levels and the replicated levels on its device.

    Args:
        mesh: the ranks' mesh (``parallel.make_mesh``).
        K_csr: BC-applied symmetric host CSR matrix.
        nd, coords, dtype, nu, smoother, ...: see
            :class:`unstructured.AMGPreconditioner` (``dtype`` is the
            cycle's and the CG's).
        min_sharded: smallest level size kept sharded (smaller levels
            replicate).
    """

    def __init__(self, mesh, K_csr, nd=1, coords=None, dtype=torch.float32,
                 min_sharded=256, **amg_kw):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.D = int(mesh.size)
        self.rank = int(mesh.rank)
        self.device = resolve_device(mesh.device)
        self.dtype = _torch_dtype(dtype)
        self.amg = amg = AMGPreconditioner(K_csr, nd=nd, coords=coords,
                                           dtype=self.dtype,
                                           device=self.device, **amg_kw)
        nlev = len(amg.levels)
        self.plan = []
        for k, lv in enumerate(amg.levels):
            n = lv["n"]
            offs = np.asarray(amg.structure["levels"][k]["offsets"])
            bw = int(np.abs(offs).max()) if offs.size else 0
            nl = math.ceil(n / self.D)
            sharded = (bw <= nl and n >= int(min_sharded)
                       and k < nlev - 1)
            self.plan.append({"sharded": bool(sharded), "n": n, "nl": nl,
                              "bw": bw, "offsets": offs})
        self.fine_sharded = self.plan[0]["sharded"]
        # the CG operator: the permuted fine matrix in the CG's dtype
        pat = {}
        A0, _ = _device_csr(amg.A0, pat, "p", self.dtype, self.device)
        self._A0 = self._block(0, pat["p"][2], pat["p"][3], A0.vals)
        self._loc = {}
        for k, pl in enumerate(self.plan):
            if not pl["sharded"]:
                continue
            lv = amg.levels[k]
            sl = amg.structure["levels"][k]
            rows, m = self._rows(k), lv["m"]
            # the tentative rows of the block (zero on the padding rows)
            J = self._pad(lv["J_dof"][rows], k)
            self._loc[k] = {
                "op": self._block(k, sl["csr"][2], sl["csr"][3],
                                  lv["op"].vals),
                "inv_diag": self._pad(lv["inv_diag"][rows], k, 1.0),
                "J_dof": J,
                "Tv": self._pad(lv["Tv"][rows], k),
                "TT": SortedSegments(
                    J[:, None] * m + torch.arange(m, device=self.device),
                    lv["n_agg"] * m, device=self.device),
            }

    # -- layout ---------------------------------------------------------------

    def _rows(self, k):
        nl = self.plan[k]["nl"]
        return slice(self.rank * nl, (self.rank + 1) * nl)

    def _pad(self, a, k, value=0.0):
        """A local row block padded to nl rows (the last rank's tail)."""
        nl = self.plan[k]["nl"]
        if a.shape[0] == nl:
            return a.contiguous()
        pad = a.new_full((nl - a.shape[0],) + tuple(a.shape[1:]), value)
        return torch.cat([a, pad])

    def _block(self, k, indptr, indices, vals):
        pl = self.plan[k]
        return _local_csr(indptr, indices, vals, self.rank * pl["nl"],
                         pl["nl"], pl["bw"], self.device)

    def _slice_local(self, k, rep):
        """Replicated level-k vector -> this rank's padded block."""
        return self._pad(rep[self._rows(k)], k)

    def _gather_full(self, k, loc):
        """This level's local blocks -> the replicated real vector."""
        return self.mesh.all_gather(loc)[: self.plan[k]["n"]]

    # -- local pieces -----------------------------------------------------------

    def _spmv(self, A, u):
        """U1 on the halo-extended local vector, this rank's rows."""
        uh = u if A.bw == 0 else self.mesh.halo(u, 0, A.bw)
        return csr_matvec(A.indptr, A.indices, A.vals, uh).narrow(
            0, A.bw, A.nl)

    def _matvec_at(self, k, u):
        if self.plan[k]["sharded"]:
            return self._spmv(self._loc[k]["op"], u)
        return self.amg._matvec(k, u)

    def _inv_diag(self, k):
        if self.plan[k]["sharded"]:
            return self._loc[k]["inv_diag"]
        return self.amg.levels[k]["inv_diag"]

    def _smooth_at(self, k, x, b, x0_zero=False):
        """The level's smoother (``AMGPreconditioner._smooth``) on local
        or replicated vectors."""
        amg, lv = self.amg, self.amg.levels[k]
        inv_diag = self._inv_diag(k)
        if amg.smoother == "chebyshev":
            theta, steps = lv["cheb"]
            d = inv_diag * (b - self._matvec_at(k, x)) / theta
            x = x + d
            for c1, c2 in steps:
                r = inv_diag * (b - self._matvec_at(k, x))
                d = c1 * d + c2 * r
                x = x + d
            return x
        w, niter = lv["w_jac"], amg.nu
        if x0_zero and niter > 0:
            x = w * inv_diag * b
            niter -= 1
        for _ in range(niter):
            x = x + w * inv_diag * (b - self._matvec_at(k, x))
        return x

    def _restrict(self, k, r):
        """P^T r -> the replicated coarse vector."""
        lv = self.amg.levels[k]
        s = r - lv["w_sm"] * self._matvec_at(k, self._inv_diag(k) * r)
        if self.plan[k]["sharded"]:
            loc = self._loc[k]
            return self.mesh.all_reduce(loc["TT"].sum(loc["Tv"] * s[:, None]))
        return self.amg._TT(k, s)

    def _prolong(self, k, xc_rep):
        """P xc from a replicated coarse vector (the gather is local)."""
        lv = self.amg.levels[k]
        if self.plan[k]["sharded"]:
            loc = self._loc[k]
            Xc = xc_rep.reshape(lv["n_agg"], lv["m"])
            t = torch.sum(loc["Tv"] * Xc[loc["J_dof"]], dim=1)
        else:
            t = self.amg._T(k, xc_rep)
        return t - lv["w_sm"] * (self._inv_diag(k) * self._matvec_at(k, t))

    def _cycle(self, k, b):
        amg = self.amg
        if k == len(amg.levels) - 1:  # replicated coarsest
            return amg._cycle(k, b)
        x = self._smooth_at(k, torch.zeros_like(b), b, x0_zero=True)
        r = b - self._matvec_at(k, x)
        bc_rep = self._restrict(k, r)
        if self.plan[k + 1]["sharded"]:
            xc_loc = self._cycle(k + 1, self._slice_local(k + 1, bc_rep))
            xc_rep = self._gather_full(k + 1, xc_loc)
        else:
            xc_rep = self._cycle(k + 1, bc_rep)
        x = x + self._prolong(k, xc_rep)
        return self._smooth_at(k, x, b)

    def solve(self, b, rtol=1e-8, atol=0.0, maxiter=1000):
        """AMG-PCG in the original (unpermuted) dof ordering.

        Returns:
            (x, iters, resnorm): x replicated on every rank (one
            ``all_gather``), iters and resnorm 0-d tensors.
        """
        if not self.fine_sharded:
            raise ValueError("fine level not shardable (bandwidth > local "
                             "rows); use unstructured.amg_pcg")
        bp = torch.as_tensor(b, device=self.device).to(self.dtype)
        b_loc = self._slice_local(0, bp[self.amg.perm])
        x, k, rn = cg_loop(lambda u: self._spmv(self._A0, u), b_loc,
                           rtol=rtol, atol=atol, maxiter=int(maxiter),
                           precond=lambda r: self._cycle(0, r),
                           reduce=self.mesh.all_reduce)
        x = self._gather_full(0, x)
        return x[self.amg.iperm], k, rn


def sharded_amg_pcg(mesh, K_csr, b, nd=1, coords=None, dtype=None,
                    rtol=1e-8, atol=0.0, maxiter=1000, **amg_kw):
    """One-shot sharded AMG-PCG (multi-rank :func:`unstructured.amg_pcg`)."""
    if dtype is None:
        dtype = b.dtype if torch.is_tensor(b) else np.asarray(b).dtype
    solver = ShardedAMGPCG(mesh, K_csr, nd=nd, coords=coords,
                           dtype=dtype, **amg_kw)
    return solver.solve(b, rtol=rtol, atol=atol, maxiter=maxiter)
