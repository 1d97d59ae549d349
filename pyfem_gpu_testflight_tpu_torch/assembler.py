"""Solver facade for reference-style scripts (PyTorch port).

Port of ``pyfem_gpu_testflight_tpu/assembler.py``.  Reference parity:
``Assembler`` (pyfem.py:2286-2423) — ``solve`` for linear statics,
``solve_nonlinear`` for Newton, and the matplotlib tri-contour ``plot``
helper.  The heavy lifting lives in the models; this class exists so
reference-style scripts port one-to-one.
"""

from __future__ import annotations

import numpy as np

from .models.base import _host

__all__ = ["Assembler"]


class Assembler:
    def __init__(self, model):
        self.model = model

    def solve(self, method="gmres", rtol=1e-8, rho=None):
        """Linear static solve (pyfem.py:2298-2317): any method of the
        model's ``solve`` (direct | cg | gmres, and gmg | pmg | amg after
        their set-up); ``rho`` is the nodal density (the model's default
        when None)."""
        kw = {} if rho is None else {"rho": rho}
        return self.model.solve(method=method, rtol=rtol, **kw)

    def solve_nonlinear(
        self, method="gmres", xdv=None, u0=None, tol=1e-10, atol=1e-12,
        max_iter=10,
    ):
        """Newton solve (pyfem.py:2319-2355)."""
        return self.model.solve_nonlinear(
            method=method, xdv=xdv, u0=u0, tol=tol, atol=atol,
            max_iter=max_iter,
        )

    def plot(self, u, ax, **kwargs):
        """2D tri-contour plot of a nodal scalar (pyfem.py:2357-2390)."""
        import matplotlib.tri as mtri

        model = self.model
        conn = np.asarray(model.conn_host)
        X = np.asarray(model.X_host)
        nn = model.nnodes_per_elem
        if nn == 4:
            tris = np.concatenate([conn[:, [0, 1, 2]], conn[:, [0, 2, 3]]])
        elif nn == 3:
            tris = conn
        else:
            raise ValueError("plot supports 2D tri/quad meshes only")
        tri_obj = mtri.Triangulation(X[:, 0], X[:, 1], tris)
        ax.set_aspect("equal")
        ax.tricontourf(tri_obj, _host(u), **kwargs)
