"""Helmholtz-filtered RAMP compliance topology optimization.

Port of ``pyfem_gpu_testflight_tpu/opt/topo.py`` (the host loop with
the ParOpt contract); the model and filter calls run on their device.

Reference parity: ``TopoProblem`` + optimizer loop in
examples/topology_optimization/topo.py / topo_heat.py — filtered design
variables, compliance objective, volume-fraction constraint (ParOpt
convention con >= 0), design-history artifacts — plus checkpoint/resume
(absent from the reference; SURVEY.md §5).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mma import MMA, Problem

__all__ = ["TopoProblem", "optimize_topology"]


def _host(v):
    """A tensor (any device) or array-like as a float64 NumPy array."""
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64)


class TopoProblem(Problem):
    """Compliance minimization with a volume constraint.

    Args:
        model: LinearElasticity or LinearPoisson (anything exposing
            compliance / compliance_grad / volume / volume_grad).
        filtr: Helmholtz filter (apply / apply_gradient).
        fixed_volume: volume fraction bound (con = fixed_volume - vol >= 0).
        solver: linear solver for the state problem.
    """

    def __init__(
        self,
        model,
        filtr,
        fixed_volume,
        x_init=0.95,
        lb=1e-3,
        ub=1.0,
        solver="cg",
        save_history=False,
        save_history_every=10,
        prefix=".",
        rho_floor=None,
    ):
        super().__init__(model.nnodes, ncon=1)
        self.model = model
        self.filtr = filtr
        self.fixed_volume = float(fixed_volume)
        self.x_init = x_init
        self.lb = lb
        self.ub = ub
        # the Helmholtz filter undershoots near sharp 0/1 contrast
        # (measured rho down to -0.02 on converging designs); negative
        # RAMP stiffness makes K indefinite and kills PCG.  The *state
        # solve* uses max(rho, rho_floor) with an exact chain-rule mask
        # in the gradient; the volume constraint keeps the raw filtered
        # field (reference convention).
        self.rho_floor = float(lb if rho_floor is None else rho_floor)
        self.solver = solver
        self.save_history = save_history
        self.save_history_every = int(save_history_every)
        self.prefix = prefix
        self.counter = 0
        self.u = None
        self._memos = {}  # key -> (input, filter output) of the last call
        self.device = model.device  # where MMA runs its design update

    def getVarsAndBounds(self, x, lb, ub):
        x[:] = self.x_init
        lb[:] = self.lb
        ub[:] = self.ub

    def _memo(self, key, v, fn):
        """fn(v), reused while v is unchanged: the filter's solves are the
        costliest steps of an iteration on a general mesh, MMA evaluates
        the objective and its gradient at one design, and the volume
        gradient of a model is usually constant."""
        v = torch.as_tensor(v)
        last = self._memos.get(key)
        if last is not None and last[0].shape == v.shape and torch.equal(
                last[0], v.to(last[0].device)):
            return last[1]
        out = fn(v)
        self._memos[key] = (v.clone(), out)
        return out

    def evalObjCon(self, x):
        rho = self._memo("apply", x, self.filtr.apply)
        rho_c = torch.clamp(rho, min=self.rho_floor)
        if self.save_history and self.counter % self.save_history_every == 0:
            self._save_design(rho)
        self.counter += 1
        obj, self.u = self.model.compliance(rho_c, solver=self.solver)
        con = [self.fixed_volume - float(self.model.volume(rho))]
        return 0, float(obj), con

    def evalObjConGradient(self, x, g, A):
        rho = self._memo("apply", x, self.filtr.apply)
        rho_c = torch.clamp(rho, min=self.rho_floor)
        live = rho > self.rho_floor  # d rho_c / d rho (0 where clamped)
        g[:] = _host(
            self.filtr.apply_gradient(
                torch.where(live, self.model.compliance_grad(rho_c, self.u),
                            0.0)
            )
        )
        A[0][:] = -_host(self._memo("volume_grad",
                                    self.model.volume_grad(rho),
                                    self.filtr.apply_gradient))
        return 0

    def _save_design(self, rho):
        from ..io.vtk import to_vtk

        os.makedirs(self.prefix, exist_ok=True)
        to_vtk(
            self.model.conn_host,
            self.model.X_host,
            {"rho": _host(rho)},
            os.path.join(self.prefix, f"design_{self.counter:d}.vtk"),
        )


def optimize_topology(
    model,
    filtr,
    fixed_volume=0.4,
    max_iterations=200,
    prefix="results",
    checkpoint_every=10,
    resume=True,
    verbose=True,
    solver="cg",
    save_history=False,
):
    """Run MMA topology optimization with npz checkpoint/resume.

    Returns:
        (x, rho): optimized raw and filtered densities.
    """
    prob = TopoProblem(
        model, filtr, fixed_volume, solver=solver,
        save_history=save_history, prefix=prefix,
    )
    os.makedirs(prefix, exist_ok=True)
    ckpt_path = os.path.join(prefix, "checkpoint.npz")

    start_x = None
    if resume and os.path.exists(ckpt_path):
        data = np.load(ckpt_path)
        start_x = data["x"]
        if verbose:
            print(f"[topo] resuming from {ckpt_path} (iter {int(data['iter'])})")

    def callback(k, x, obj, con):
        if checkpoint_every and k % checkpoint_every == 0:
            np.savez(ckpt_path, x=_host(x), iter=k, obj=obj, con=con)

    if start_x is not None:
        x0 = start_x
        orig_get = prob.getVarsAndBounds

        def warm(x, lb, ub):
            orig_get(x, lb, ub)
            x[:] = x0

        prob.getVarsAndBounds = warm

    opt = MMA(
        prob,
        {
            "max_iterations": max_iterations,
            "verbose": verbose,
            "callback": callback,
        },
    )
    x = _host(opt.optimize())
    rho = _host(filtr.apply(x))
    np.savez(ckpt_path, x=x, iter=max_iterations, obj=opt.history[-1]["obj"],
             con=opt.history[-1]["con"])
    from ..io.vtk import to_vtk

    to_vtk(
        model.conn_host,
        model.X_host,
        {"x": x, "rho": rho},
        os.path.join(prefix, "result.vtk"),
    )
    return x, rho
