"""Shared model infrastructure (PyTorch port, slice 1).

Port of ``pyfem_gpu_testflight_tpu/models/base.py`` as far as the
structured GMG solve needs it: the constructor's mesh/BC state,
``attach_structured_grid`` in 2D, ``_solve_gmg`` and the ``"gmg"``
branch of ``_solve_system``.  Every other method or branch raises
``NotImplementedError`` naming the ROADMAP.md slice that ports it.

Reference parity: ModelBase (pyfem.py:634-931) and the RAMP material
helpers (pyfem.py:1278-1329, 1922-1973).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bcs import DirichletBC
from ..elements import get_element

__all__ = ["FEModel", "ramp", "ramp_deriv"]

# solve method -> the ROADMAP.md slice (queue 1) that ports it
_METHOD_SLICE = {
    "direct": "slice 1 item 4",
    "cg": "slice 1 item 4",
    "gmres": "slice 4",
    "pmg": "slice 5",
    "amg": "slice 6",
    "sharded_gmg": "slice 8",
}


def _not_ported(what, where):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, {where})"
    )


def _check_converged(method, resnorm, tol, iters=None, slack=10.0):
    """Raise on a stalled iterative solve (pyfem.py:1067, 2421-2422).

    The residual norm is checked directly (one host sync at the public
    solve boundary).  ``slack`` tolerates the last-iteration rounding
    between the loop's squared-norm test and this recheck.
    """
    rn = float(resnorm)
    t = float(tol)
    if not np.isfinite(rn) or rn > slack * max(t, 1e-300):
        it = "" if iters is None else f" after {int(iters)} iterations"
        raise RuntimeError(
            f"{method} failed to converge{it}: ||r|| = {rn:.3e} > "
            f"tolerance {t:.3e}"
        )


def ramp(rho_q, p):
    """RAMP penalization factor rho / (1 + p (1 - rho)) (pyfem.py:1300)."""
    return rho_q / (1.0 + p * (1.0 - rho_q))


def ramp_deriv(rho_q, p):
    """d RAMP / d rho = (1 + p) / (1 + p (1 - rho))^2 (pyfem.py:1325)."""
    return (1.0 + p) / (1.0 + p * (1.0 - rho_q)) ** 2


class FEModel:
    """Base class holding mesh/element/BC state for a physics model.

    ``dtype`` and ``device`` are explicit: torch defaults to float32,
    while the reference package runs with float64 enabled.
    """

    def __init__(
        self,
        etype,
        X,
        conn,
        dof_fixed=(),
        dof_fixed_vals=None,
        *,
        ndof_per_node: int,
        dtype=torch.float64,
        device="cpu",
    ):
        self.etype = get_element(etype)
        X_host = np.asarray(X, dtype=np.float64)
        conn_host = np.asarray(conn, dtype=np.int64)
        if X_host.shape[1] != self.etype.ndims:
            raise ValueError(
                f"mesh is {X_host.shape[1]}D but element {self.etype.name} "
                f"is {self.etype.ndims}D"
            )
        if conn_host.shape[1] != self.etype.nnodes:
            raise ValueError(
                f"conn has {conn_host.shape[1]} nodes per element, "
                f"{self.etype.name} has {self.etype.nnodes}"
            )

        self.dtype = dtype
        self.device = torch.device(device)
        self.ndof_per_node = int(ndof_per_node)
        self.nelems = int(conn_host.shape[0])
        self.nnodes = int(X_host.shape[0])
        self.ndims = int(X_host.shape[1])
        self.nnodes_per_elem = self.etype.nnodes
        self.nquads = self.etype.nquads
        self.ndof = self.nnodes * self.ndof_per_node
        self.X_host = X_host
        self.conn_host = conn_host

        # Constrain dofs of unreferenced grid nodes (e.g. brick20 meshes
        # skip super-cell centers, pyfem.py:683) so systems stay regular.
        used = np.zeros(self.nnodes, dtype=bool)
        used[conn_host.ravel()] = True
        unused = np.where(~used)[0]
        dof_fixed = np.asarray(dof_fixed, dtype=np.int64).ravel()
        if unused.size:
            extra = (
                self.ndof_per_node * unused[:, None]
                + np.arange(self.ndof_per_node)
            ).ravel()
            dof_fixed = np.concatenate([dof_fixed, extra])
            if dof_fixed_vals is not None:
                dof_fixed_vals = np.concatenate(
                    [np.asarray(dof_fixed_vals, dtype=float),
                     np.zeros(extra.size)]
                )
        self.bc = DirichletBC(dof_fixed, dof_fixed_vals, self.ndof,
                              device=self.device)

    # -- not ported in this slice -----------------------------------------

    def assemble_scipy(self, Ke, apply_bcs=False, enforce_symmetric_K=True,
                       rhs=None):
        _not_ported("FEModel.assemble_scipy", "slice 1 item 4")

    def matvec(self, Ke, u):
        _not_ported("FEModel.matvec", "slice 1 item 4")

    def diagonal(self, Ke):
        _not_ported("FEModel.diagonal", "slice 1 item 4")

    def attach_pmg(self, nnodes_x, nnodes_y, nnodes_z, **pmg_options):
        _not_ported("FEModel.attach_pmg", "slice 5")

    def attach_sharded_grid(self, mesh, nnodes_x, nnodes_y, nnodes_z=None,
                            **gmg_options):
        _not_ported("FEModel.attach_sharded_grid", "slice 8")

    # -- structured GMG ----------------------------------------------------

    def attach_structured_grid(self, nnodes_x, nnodes_y, nnodes_z=None,
                               **gmg_options):
        """Enable the geometric-multigrid fast path (structured quad4).

        Builds a GMG hierarchy (multigrid.GMGAssembler) using this
        model's physics, dtype, device and Dirichlet mask; afterwards
        ``solve(method="gmg")`` runs V-cycle-preconditioned CG.
        """
        from ..multigrid import GMGAssembler

        if nnodes_z is not None:
            _not_ported("3D attach_structured_grid", "slice 3")
        if self.etype.name != "quad4":
            raise ValueError("2D gmg requires quad4 grids")
        nd = self.ndof_per_node
        nx, ny = int(nnodes_x), int(nnodes_y)
        if nx * ny != self.nnodes:
            raise ValueError(f"{nx}x{ny} grid != {self.nnodes} nodes")
        # interleaved (node, comp) mask -> planar (comp, ny, nx)
        fine_mask = (
            self.bc.mask.cpu().numpy()
            .reshape(ny * nx, nd).T.reshape(nd, ny, nx)
        )
        physics = "elasticity" if nd == 2 else "poisson"
        kw = dict(p=self.p, dtype=self.dtype, device=self.device,
                  fine_mask=fine_mask)
        if physics == "elasticity":
            kw.update(E=self.E, nu=self.nu)
        kw.update(gmg_options)
        X = self.X_host
        self._gmg_asm = GMGAssembler(
            nx, ny, float(X[:, 0].max()), float(X[:, 1].max()), physics,
            **kw
        )
        self._gmg_shape = (ny, nx)
        return self

    def _solve_gmg(self, rho, rhs, rtol=1e-8, maxiter=400):
        from .. import multigrid
        from ..ops.dia import interleave_to_planar, planar_to_interleave

        if bool(self.bc.values.any()):
            # K1 levels are eliminated-only: the rhs lift needs the
            # un-eliminated operator (the JAX package refuses this on
            # its fused-kernel levels too)
            _not_ported("gmg with nonzero Dirichlet values",
                        "slice 1 item 6")
        shape = self._gmg_shape
        nd = self.ndof_per_node
        gmg, lv0 = self._gmg_asm.assemble(self._as_nodal(rho))
        rhs_g = interleave_to_planar(
            torch.as_tensor(rhs, dtype=self.dtype, device=self.device), nd
        ).reshape((nd,) + shape)
        vals_g = interleave_to_planar(
            self.bc.values.to(self.dtype), nd
        ).reshape((nd,) + shape)
        b = torch.where(lv0.mask, vals_g, rhs_g)
        x0 = torch.where(lv0.mask, vals_g, 0.0)
        x, k, rn = multigrid.pcg_gmg(gmg, lv0, b, rtol=rtol,
                                     maxiter=maxiter, x0=x0)
        _check_converged("gmg-pcg", rn, rtol * float(torch.linalg.norm(b)),
                         k)
        self.last_solve_stats = {
            "method": "gmg", "iters": int(k), "resnorm": float(rn),
        }
        return (planar_to_interleave(x.reshape(-1), nd),
                planar_to_interleave(b.reshape(-1), nd))

    def _solve_system(self, Ke, rhs, method="cg", rtol=1e-8, rho=None,
                      maxiter=None):
        """Apply BCs and solve K u = rhs.

        Returns:
            (u, b): solution and the BC-applied rhs (used by compliance).
        """
        if method in _METHOD_SLICE:
            _not_ported(f"method={method!r}", _METHOD_SLICE[method])
        if method != "gmg":
            raise ValueError(f"unknown solve method {method!r}")
        if getattr(self, "_gmg_asm", None) is None:
            raise RuntimeError(
                "call attach_structured_grid(nx, ny) before method='gmg'"
            )
        return self._solve_gmg(rho if rho is not None else 1.0, rhs,
                               rtol=rtol)

    def _as_nodal(self, rho):
        """Broadcast scalar density to a nodal field (pyfem.py:1015-1016)."""
        if rho is None:
            rho = 1.0
        if np.ndim(rho) == 0:
            return torch.full((self.nnodes,), float(rho), dtype=self.dtype,
                              device=self.device)
        return torch.as_tensor(rho, dtype=self.dtype, device=self.device)
