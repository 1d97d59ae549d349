"""Sharded topology optimization with every iteration on the devices.

Port of ``pyfem_gpu_testflight_tpu/opt/topo_sharded.py``: the
multi-rank form of :class:`opt.topo_device.DeviceTopo`.  Every MMA
iteration runs on lead-axis block-partitioned grids over the solver's
mesh of ranks:

    filter fwd   — Jacobi-PCG on the (padded, sharded) Helmholtz
                   stencil: halo products on kernel K9 in 2D and K4 at
                   nd = 1 in 3D (``sharded_gmg.halo_stencil_matvec``),
                   all-reduced dots;
    assembly     — the per-rank GMG hierarchy assembly
                   (``ShardedGMG._local_hierarchy``);
    state solve  — the sharded V-cycle-PCG, warm-started from the
                   previous design's state;
    adjoint      — the block-local scatter-free sensitivity
                   (``multigrid._dv_sens_uniform`` on the halo-extended
                   block, phantom elements masked);
    filter bwd   — the transposed filter, the same halo PCG;
    MMA update   — ``device_update_body`` with all-reduced dual
                   reductions (the same update on every rank).

Host syncs happen at the drain points of ``DeviceTopo.optimize`` and in
the PCG stop tests.  Padded lead rows carry zero design and state
throughout and are cropped on the way out: the final design, and the
checkpoints (written by rank 0), are the real grid's, so either
package's ``DeviceTopo`` or sharded checkpoint resumes here
(``convert.load_topo_checkpoint``; a JAX sharded checkpoint's padding
is cropped).  The history's ``step`` is the design step on the real
rows, as the single-device loop records it.
"""

from __future__ import annotations

import torch

from .mma import device_update_body
from .topo_device import DeviceTopo

__all__ = ["ShardedDeviceTopo"]


class ShardedDeviceTopo(DeviceTopo):
    """MMA topology optimization over a mesh of ranks.

    Args:
        model: LinearElasticity/LinearPoisson with
            ``attach_sharded_grid`` already called (per-rank hierarchy
            assembly: the uniform element path).
        filtr: Helmholtz filter with ``attach_structured_grid`` already
            called (its stencil planes are sliced and padded here once;
            they do not depend on the design).
        Other args as :class:`DeviceTopo`.
    """

    def __init__(self, model, filtr, fixed_volume=0.4, x_init=0.95,
                 lb=1e-3, ub=1.0, rtol=1e-6, maxiter=200,
                 mma_options=None, rho_floor=None):
        from ..ops.dia import interleave_to_planar
        from ..parallel.sharded_gmg import _pad_lead

        sg = getattr(model, "_sgmg", None)
        if sg is None:
            raise ValueError("call model.attach_sharded_grid(...) first")
        if not sg.local_assembly:
            raise ValueError("the sharded DeviceTopo needs per-rank "
                             "assembly (the uniform element path)")
        if getattr(filtr, "_st", None) is None:
            raise ValueError("call filtr.attach_structured_grid(...) first")
        self.model, self.filtr, self.sg = model, filtr, sg
        self.mesh = mesh = sg.mesh
        self.fixed_volume = float(fixed_volume)
        self.dtype = model.dtype
        self.device = mesh.device
        self.history = []
        o = dict(mma_options or {})
        self._upd_kw = dict(
            asy_grow=float(o.get("asymptote_grow", 1.2)),
            asy_shrink=float(o.get("asymptote_shrink", 0.7)),
            albefa=float(o.get("albefa", 0.1)),
            move=float(o.get("move_limit", 0.2)),
        )
        self.asy_init = float(o.get("asymptote_init", 0.5))
        self.rho_floor = float(lb if rho_floor is None else rho_floor)
        self._rtol = float(rtol)
        self._maxiter = int(maxiter)
        self.x_init, self.lb, self.ub = x_init, float(lb), float(ub)
        self.mark = None

        dim, nd = sg.dim, sg.nd
        self._shape0 = shape0 = tuple(sg.shapes[0])
        self._n0 = n0 = shape0[0]
        self._nl0 = nl0 = sg.nl[0]
        self._dim, self._nd = dim, nd
        dev, dt = self.device, self.dtype
        # padded-lead-row marker of this rank's block (design pinned to
        # zero there)
        rows = torch.arange(nl0, device=dev) + mesh.rank * nl0
        self._xpad = (rows >= n0).reshape((nl0,) + (1,) * (dim - 1)).expand(
            (nl0,) + shape0[1:])
        # filter planes: this rank's rows, zero on the padding, extended
        # by a zero slab a side for the halo product
        lead = filtr._coeffK.ndim - dim
        planes = lambda c: _pad_lead(sg._local(c.to(dev), 0, axis=lead),
                                     lead, 1, 1).contiguous()
        self._fK = planes(filtr._coeffK)
        self._fR = planes(filtr._coeffR)
        self._finvd = sg._local(filtr._st_inv_diag.to(dev), 0, value=1.0)
        self._frtol, self._fmax = filtr.rtol, 10 * filtr.ndof
        # volume-gradient chain (design-independent): filter^T(dvol)
        dci = filtr._st_bwd(torch.full((model.nnodes,), 1.0 / model.nnodes,
                                       dtype=dt, device=filtr.device))
        self._dci = sg._local(dci.to(dev).reshape(shape0), 0, axis=0)
        self._b0 = sg._local(interleave_to_planar(
            model.compute_rhs().to(dev).to(dt), nd).reshape((nd,) + shape0),
            0)
        self._kq0 = sg.asm.static_levels[0].Kq

    # -- local pieces -----------------------------------------------------------

    def _fmatvec(self, coeff, u):
        from ..parallel.sharded_gmg import halo_stencil_matvec

        return halo_stencil_matvec(coeff, u, self.mesh, 1, self._dim)

    def _filter_solve(self, b):
        from ..parallel.sharded_gmg import local_pcg

        return local_pcg(lambda u: self._fmatvec(self._fK, u), self._finvd,
                         b, self.mesh, self._frtol, self._fmax)

    def _dv_sens_local(self, rho_loc, u_loc):
        """Block-local d(u^T K u)/drho with phantom elements masked."""
        from ..multigrid import _dv_sens_uniform

        mesh, nl0, dim = self.mesh, self._nl0, self._dim
        rho_h = mesh.halo(rho_loc, 0, 1)
        u_h = mesh.halo(u_loc, 1, 1)
        e_glob = (torch.arange(nl0 + 1, device=self.device)
                  + mesh.rank * nl0 - 1)
        ev = ((e_glob >= 0) & (e_glob < self._n0 - 1)).to(rho_h.dtype)
        asm = self.sg.asm
        out_h = _dv_sens_uniform(
            self._kq0, asm.N, asm.p, asm._offsets, rho_h, u_h, u_h,
            elem_valid=ev.reshape((1, nl0 + 1) + (1,) * (dim - 1)))
        return out_h[1: nl0 + 1]

    def _step(self, x, xold1, xold2, low, upp, u_prev, k, lb_v, ub_v):
        """One MMA iteration on every rank; the new state and its stats."""
        mesh, sg = self.mesh, self.sg
        mark = self.mark or (lambda _stage: None)
        xpad = self._xpad
        rho_raw, it_fwd, _ = self._filter_solve(
            self._fmatvec(self._fR, x[None]))
        rho_raw = rho_raw[0]
        mark("filter_fwd")
        rho = torch.clamp(rho_raw, min=self.rho_floor)
        hier = sg.hierarchy(rho)
        mark("assemble")
        mask0 = hier.levels[0].mask
        bz = torch.where(mask0, 0.0, self._b0)
        u, it, rn = sg._local_solve(hier, bz, self._rtol, self._maxiter,
                                    x0=torch.where(mask0, 0.0, u_prev))
        mark("state_pcg")
        sums = mesh.all_reduce(torch.stack([
            torch.dot(bz.reshape(-1), u.reshape(-1)),
            torch.dot(bz.reshape(-1), bz.reshape(-1)),
            torch.sum(rho_raw)]))
        obj, bnorm = sums[0], torch.sqrt(sums[1])
        dc = -self._dv_sens_local(rho, u)
        dc = torch.where(rho_raw > self.rho_floor, dc, 0.0)
        dc = torch.where(xpad, 0.0, dc)
        mark("sensitivity")
        z2, it_bwd, _ = self._filter_solve(dc[None])
        g = torch.where(xpad, 0.0, self._fmatvec(self._fR, z2)[0])
        mark("filter_bwd")
        con = self.fixed_volume - sums[2] / self.model.nnodes
        x_new, low_n, upp_n, _lam, _ = device_update_body(
            x, xold1, xold2, low, upp, g, self._dci, -con, lb_v, ub_v, k,
            mesh=mesh, **self._upd_kw)
        step = mesh.all_reduce(torch.max(torch.where(
            xpad, 0.0, torch.abs(x_new - x))), op="max")
        x_new = torch.where(xpad, 0.0, x_new)
        # convergence guard (DeviceTopo's): freeze the state on a stalled
        # solve; the drain then raises at this iteration
        bad = ~(rn <= 10.0 * self._rtol * bnorm)
        state = (torch.where(bad, x, x_new), torch.where(bad, xold1, x),
                 torch.where(bad, xold2, xold1),
                 torch.where(bad, low, low_n), torch.where(bad, upp, upp_n),
                 torch.where(bad, u_prev, u))
        step = torch.where(bad, 0.0, step)
        sdt = obj.dtype
        stats = torch.stack([
            obj, con.to(sdt), torch.full((), it, dtype=sdt,
                                         device=obj.device),
            rn.to(sdt), bnorm.to(sdt), step.to(sdt), it_fwd.to(sdt),
            it_bwd.to(sdt)])
        mark("mma_update")
        return state, stats

    # -- DeviceTopo hooks ---------------------------------------------------------

    def _init_state(self):
        kw = dict(dtype=self.dtype, device=self.device)
        shape = self._xpad.shape
        lb_v = torch.full(shape, self.lb, **kw)
        ub_v = torch.full(shape, self.ub, **kw)
        x = torch.minimum(torch.maximum(torch.full(shape, self.x_init, **kw),
                                        lb_v), ub_v)
        x = torch.where(self._xpad, 0.0, x)
        u_prev = torch.zeros((self._nd,) + tuple(shape), **kw)
        return x, lb_v, ub_v, u_prev

    def _gather(self, a, axis):
        """This rank's block -> the real grid's rows (every rank)."""
        return self.mesh.all_gather(a, dim=axis).narrow(axis, 0, self._n0)

    def save_checkpoint(self, path, state, k_next):
        """Rank 0 writes the real grid's state; every rank returns once
        the file is written (a resume on any rank may follow)."""
        super().save_checkpoint(path, state, k_next)
        self.mesh.all_reduce(torch.zeros(1, device=self.device))

    def _checkpoint_state(self, state):
        full = [self._gather(t, 1 if i == 5 else 0)
                for i, t in enumerate(state)]
        return full if self.mesh.rank == 0 else None

    def _load_state(self, resume, init):
        """A checkpoint of the real grid (or a JAX sharded one, padded:
        cropped here) as this rank's blocks; the padding rows take the
        initial state's values."""
        from ..convert import crop_topo_state, load_topo_checkpoint

        state, k0, history = load_topo_checkpoint(resume, self.dtype,
                                                  self.device)
        want = (self._n0,) + self._shape0[1:]
        out = []
        for i, t in enumerate(crop_topo_state(state, self._n0)):
            axis = 1 if i == 5 else 0
            if tuple(t.shape[axis:]) != want:
                raise ValueError(f"checkpoint {resume} holds a "
                                 f"{tuple(t.shape)} field; this problem's "
                                 f"real grid is {want}")
            out.append(self.sg._local(t, 0, axis=axis))
        x0, low0, upp0, u0 = init
        pad = self._xpad
        x, xo1, xo2, low, upp, u_prev = out
        return ((torch.where(pad, x0, x), torch.where(pad, x0, xo1),
                 torch.where(pad, x0, xo2), torch.where(pad, low0, low),
                 torch.where(pad, upp0, upp), u_prev), k0, history)

    def _finalize_x(self, x):
        """The real grid's flat nodal design (padding cropped)."""
        return self._gather(x, 0).reshape(-1)
