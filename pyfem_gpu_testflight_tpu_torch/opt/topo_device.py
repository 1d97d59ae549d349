"""Topology optimization with every iteration on the device.

Port of ``pyfem_gpu_testflight_tpu/opt/topo_device.py``.  The
reference's flagship workload is MMA iterations of Helmholtz-filtered
RAMP compliance minimization (examples/topology_optimization/topo.py:
176-189).  Each iteration here runs, over design tensors on the model's
device,

    filter fwd (stencil Jacobi-PCG: K9 in 2D, K4 in 3D)  ->  GMG
    hierarchy assembly (K1 / K3)  ->  warm-started V-cycle-PCG state
    solve (K2 / K5 smoothing, K4 the 3D PCG operator)  ->  structured
    sensitivity  ->  filter bwd (stencil PCG)  ->  MMA update

on a 2D quad4 or a 3D hex8 grid, with no design-sized host transfer.
The host reads back the state PCG's ``r.r`` once per PCG iteration
(``multigrid.pcg_gmg``) and the filter's convergence flag once per 16
of its iterations
(``solvers.cg_loop``); an iteration's stats are stacked into one tensor
and a batch of them is drained with one device-to-host copy every
``log_every`` iterations.  All reductions have a fixed order and no
kernel uses float atomics, so a run resumed from a checkpoint repeats
the uninterrupted run bit for bit.

Iterate-for-iterate equivalent to ``TopoProblem`` + ``MMA`` driving the
same solver.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .mma import device_update_body

__all__ = ["DeviceTopo"]

# stats rows drained per iteration: the JAX package's six, then the
# filter's forward and backward PCG iteration counts
_STATS = ("obj", "con", "cg_iters", "resnorm", "bnorm", "step",
          "filter_fwd_iters", "filter_bwd_iters")


class DeviceTopo:
    """MMA compliance topology optimization, iterations on the device.

    Args:
        model: LinearElasticity/LinearPoisson (quad4 or hex8) with
            ``attach_structured_grid`` already called (the GMG path
            assembles the state operator from rho).
        filtr: Helmholtz filter with ``attach_structured_grid`` already
            called (stencil PCG apply/apply_gradient).
        fixed_volume: volume-fraction bound (con = V - vol >= 0).
        rtol/maxiter: state-solve PCG controls.
        x_init, lb, ub: design initialization and bounds.
        mma_options: asymptote/move constants (see opt.mma.MMA).
        rho_floor: state-solve clamp of the filtered density (default
            ``lb``; see ``opt.topo.TopoProblem``).
    """

    def __init__(self, model, filtr, fixed_volume=0.4, x_init=0.95,
                 lb=1e-3, ub=1.0, rtol=1e-6, maxiter=200,
                 mma_options=None, rho_floor=None):
        if getattr(model, "_gmg_asm", None) is None:
            raise ValueError("call model.attach_structured_grid(...) first")
        if getattr(filtr, "_st", None) is None:
            raise ValueError("call filtr.attach_structured_grid(...) first")
        self.model = model
        self.filtr = filtr
        self.fixed_volume = float(fixed_volume)
        self.dtype = model.dtype
        self.device = model.device
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
        self._flexible = model._gmg_asm.smoother_dtype is not None
        self.x_init, self.lb, self.ub = x_init, float(lb), float(ub)
        # optional stage hook, called with each stage's name as it ends
        # (chip_smoke.py records a CUDA event there); None costs nothing
        self.mark = None

        nnodes = model.nnodes
        self._rhs_il = model.compute_rhs().to(self.dtype)
        # the volume-constraint gradient chain is design-independent:
        # dci = +filter^T(dvol) (see MMA.optimize's ci/dci signs)
        self._dci = filtr._st_bwd(torch.full(
            (nnodes,), 1.0 / nnodes, dtype=self.dtype, device=self.device))

    def _step(self, x, xold1, xold2, low, upp, u_prev, k, lb_v, ub_v):
        """One MMA iteration; returns the new state and its stats."""
        from .. import multigrid
        from ..ops.dia import interleave_to_planar, planar_to_interleave

        model, filtr = self.model, self.filtr
        mark = self.mark or (lambda _stage: None)
        nd = model.ndof_per_node
        shape = model._gmg_shape
        rho_raw = filtr._st_fwd(x)
        it_fwd = filtr.last_iters
        mark("filter_fwd")
        # filter-undershoot guard for the state solve (see
        # opt.topo.TopoProblem.rho_floor): clamp with an exact
        # chain-rule mask; the volume constraint keeps the raw field
        rho = torch.clamp(rho_raw, min=self.rho_floor)
        gmg, lv0 = model._gmg_asm.assemble(rho)
        mark("assemble")
        b = torch.where(lv0.mask, 0.0, interleave_to_planar(
            self._rhs_il, nd).reshape((nd,) + shape))
        # warm start from the previous design's state: the design moves
        # by <= the MMA move limit per iteration
        u, it, rn = multigrid.pcg_gmg(
            gmg, lv0, b, rtol=self._rtol, maxiter=self._maxiter,
            flexible=self._flexible,
            x0=torch.where(lv0.mask, 0.0, u_prev))
        mark("state_pcg")
        u_il = planar_to_interleave(u.reshape(-1), nd)
        b_il = planar_to_interleave(b.reshape(-1), nd)
        obj = torch.dot(b_il, u_il)
        dc = -model.k_dv_sens(rho, u_il, u_il)
        dc = torch.where(rho_raw > self.rho_floor, dc, 0.0)
        mark("sensitivity")
        g = filtr._st_bwd(dc)
        it_bwd = filtr.last_iters
        mark("filter_bwd")
        vol = torch.sum(rho_raw) / model.nnodes
        con = self.fixed_volume - vol
        x_new, low_n, upp_n, _lam, step = device_update_body(
            x, xold1, xold2, low, upp, g, self._dci, -con, lb_v, ub_v, k,
            **self._upd_kw)
        # convergence guard: a stalled state solve must not corrupt the
        # iterate before the host drains the stats (every log_every
        # iterations).  Freeze the whole optimizer state instead; the
        # drain's _check_converged (same slack) then raises at this
        # iteration.
        bnorm = torch.linalg.norm(b)
        bad = ~(rn <= 10.0 * self._rtol * bnorm)  # catches NaN too
        state = (torch.where(bad, x, x_new), torch.where(bad, xold1, x),
                 torch.where(bad, xold2, xold1), torch.where(bad, low, low_n),
                 torch.where(bad, upp, upp_n), torch.where(bad, u_prev, u))
        step = torch.where(bad, 0.0, step)
        sdt = obj.dtype  # model dtype: full history precision
        stats = torch.stack([
            obj, con.to(sdt), torch.full((), it, dtype=sdt,
                                         device=obj.device),
            rn.to(sdt), bnorm.to(sdt), step.to(sdt), it_fwd.to(sdt),
            it_bwd.to(sdt)])
        mark("mma_update")
        return state, stats

    def _init_state(self):
        """Initial (x, lb_v, ub_v, u_prev)."""
        n = self.model.nnodes
        kw = dict(dtype=self.dtype, device=self.device)
        lb_v = torch.full((n,), self.lb, **kw)
        ub_v = torch.full((n,), self.ub, **kw)
        x = torch.minimum(torch.maximum(torch.full((n,), self.x_init, **kw),
                                        lb_v), ub_v)
        u_prev = torch.zeros(
            (self.model.ndof_per_node,) + self.model._gmg_shape, **kw)
        return x, lb_v, ub_v, u_prev

    def save_checkpoint(self, path, state, k_next):
        """Write the optimizer state (device -> host, one npz).

        Captured at a drain point, the file reproduces the uninterrupted
        run exactly: the MMA update is deterministic in (x, xold1, xold2,
        low, upp, k) and the state PCG warm start in u_prev.  The keys
        are the JAX package's (``convert.load_topo_checkpoint`` reads
        either package's file).
        """
        state = self._checkpoint_state(state)
        if state is None:  # a rank that writes no file
            return
        x, xold1, xold2, low, upp, u_prev = (
            t.detach().cpu().numpy() for t in state)
        hist = self.history
        np.savez(
            path, x=x, xold1=xold1, xold2=xold2, low=low, upp=upp,
            u_prev=u_prev, k_next=np.asarray(int(k_next)),
            hist_iter=np.asarray([r["iter"] for r in hist], np.int64),
            hist_obj=np.asarray([r["obj"] for r in hist]),
            hist_con=np.asarray([r["con"] for r in hist]),
            hist_step=np.asarray([r["step"] for r in hist]),
            hist_cg=np.asarray([r["cg_iters"] for r in hist], np.int64),
        )

    def optimize(self, max_iterations=200, verbose=True, log_every=10,
                 callback=None, checkpoint_path=None, resume=None):
        """Run the loop; stats are drained every ``log_every`` iterations.

        Args:
            checkpoint_path: if set, write the optimizer state (npz) at
                every drain point.
            resume: path of a checkpoint (this package's or the JAX
                package's); continues the run bit for bit from the saved
                iteration.

        Returns:
            (x, rho): final raw and filtered densities (device tensors).
        """
        from ..models.base import _check_converged

        x, lb_v, ub_v, u_prev = self._init_state()
        xold1 = xold2 = x
        rng = ub_v - lb_v
        low = x - self.asy_init * rng
        upp = x + self.asy_init * rng
        k0 = 0
        if resume is not None:
            (x, xold1, xold2, low, upp, u_prev), k0, self.history = (
                self._load_state(resume, (x, low, upp, u_prev)))

        pending = []  # (iter, stats tensor)

        def drain():
            if not pending:
                return
            # ONE device -> host copy for the whole batch
            allstats = torch.stack([s for _, s in pending]).cpu().numpy()
            for (k, _), row in zip(pending, allstats):
                rec = dict(zip(_STATS, (float(v) for v in row)))
                _check_converged("gmg-pcg(topo)", rec["resnorm"],
                                 self._rtol * rec["bnorm"],
                                 int(rec["cg_iters"]))
                rec = {"iter": int(k), "obj": rec["obj"], "con": [rec["con"]],
                       "step": rec["step"], "cg_iters": int(rec["cg_iters"]),
                       "filter_iters": (int(rec["filter_fwd_iters"]),
                                        int(rec["filter_bwd_iters"]))}
                self.history.append(rec)
                if verbose:
                    print(f"[topo-dev] {rec['iter']:4d} "
                          f"obj {rec['obj']: .8e} con {rec['con'][0]: .3e} "
                          f"cg {rec['cg_iters']:3d} step {rec['step']:.3e}")
                if callback is not None:
                    callback(rec)
            pending.clear()

        t0 = time.time()
        self.batch_marks = [(0, 0.0)]  # (iters done, wall) at drains
        state = (x, xold1, xold2, low, upp, u_prev)
        for k in range(k0, max_iterations):
            state, stats = self._step(*state, k, lb_v, ub_v)
            pending.append((k, stats))
            if (k + 1) % log_every == 0 or k + 1 == max_iterations:
                drain()
                self.batch_marks.append((k + 1, time.time() - t0))
                if checkpoint_path is not None:
                    self.save_checkpoint(checkpoint_path, state, k + 1)
        if state[0].is_cuda:
            torch.cuda.synchronize(state[0].device)
        self.elapsed = time.time() - t0
        self.s_per_iter = self.elapsed / max(1, max_iterations - k0)
        # steady-state rate over the trailing half
        half = [(i, t) for (i, t) in self.batch_marks
                if i >= max_iterations // 2]
        if len(half) >= 2 and half[-1][0] > half[0][0]:
            (i0, w0), (i1, w1) = half[0], half[-1]
            self.steady_s_per_iter = (w1 - w0) / (i1 - i0)
        else:
            self.steady_s_per_iter = self.s_per_iter
        self.state = state
        x = self._finalize_x(state[0])
        return x, self.filtr.apply(x)

    # -- hooks (opt.topo_sharded.ShardedDeviceTopo overrides them) ------------

    def _load_state(self, resume, init):
        """The optimizer state of checkpoint ``resume``; ``init`` is this
        run's initial (x, low, upp, u_prev), whose shapes it must have."""
        from ..convert import crop_topo_state, load_topo_checkpoint

        x, u_prev = init[0], init[3]
        shapes = (tuple(x.shape), tuple(u_prev.shape))
        state, k0, history = load_topo_checkpoint(resume, self.dtype,
                                                  self.device)
        if state[0].dim() > 1:
            # a sharded run's grid-shaped design (a JAX one's padded)
            state = tuple(t.reshape(-1) if i < 5 else t for i, t in
                          enumerate(crop_topo_state(state, u_prev.shape[1])))
        got = (tuple(state[0].shape), tuple(state[5].shape))
        if got != shapes:
            raise ValueError(
                f"checkpoint {resume} holds x {got[0]} and u_prev {got[1]}; "
                f"this problem has {shapes[0]} and {shapes[1]}")
        return state, k0, history

    def _checkpoint_state(self, state):
        """The state as a checkpoint stores it (None: write no file)."""
        return state

    def _finalize_x(self, x):
        """The final design in the model's flat nodal layout."""
        return x
