"""Helmholtz PDE filter: -r0^2 Delta rho + rho = x (natural Neumann BC).

Port of ``Helmholtz`` from ``pyfem_gpu_testflight_tpu/models/helmholtz.py``
(reference pyfem.py:2071-2177): K = r0^2 * stiffness + mass and R = mass
are built once at construction; ``apply(x) = K^-1 (R x)`` and
``apply_gradient(g) = R^T K^-1 g``.  K is SPD and mass-dominated at
typical filter radii, so Jacobi-PCG at ``rtol`` replaces the reference's
AMG hierarchy; ``solver="direct"`` factors K once on the host (scipy).

General meshes run the matrix-free operator through ``solvers.cg``.
``attach_structured_grid`` switches to stencil planes: in 2D every
product with K and R is kernel K9 (``ops.stencil_matvec``), in 3D
kernel K4 (``ops.fused_smooth.fused_sweep_3d``, matvec mode) on the 27
full-storage planes in float32 — the same product the JAX package runs
in plain XLA — and, K4 having no float64 form, the plain
``Stencil3D.matvec`` on a float64 filter.  Both routes solve with
``solvers.cg_loop``,
which reads its convergence flag back once per ``CHECK_EVERY``
iterations and masks the iterations past convergence, so iterates,
iteration count and residual equal a check on every iteration (the JAX
filter's ``lax.while_loop`` never syncs).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import assembly, solvers
from ..ops import stiffness
from .base import FEModel

__all__ = ["Helmholtz"]


def _filter_matrices(Xe, dN, N, wq, r0):
    """(K, R) element matrices: r0^2 * stiffness + mass, and mass."""
    Me = stiffness.mass_matrix(Xe, dN, N, wq)
    r0 = torch.as_tensor(r0, dtype=Me.dtype, device=Me.device)
    kq = torch.full(Me.shape[:1] + (N.shape[0],), 1.0, dtype=Me.dtype,
                    device=Me.device) * r0**2
    Ke = stiffness.poisson_stiffness(Xe, dN, wq, kq)
    return Ke + Me, Me


class Helmholtz(FEModel):
    """PDE density filter for topology optimization.

    Args:
        r0: filter radius.
        etype, X, conn: mesh (no Dirichlet dofs).
        solver: "cg" (Jacobi-PCG on the device) or "direct" (host scipy
            factorization, general meshes).
        rtol: relative tolerance of the PCG solves.
        device: None means the CUDA card; "cpu" runs the kernels' plain
            versions.
    """

    def __init__(self, r0, etype, X, conn, dtype=torch.float64, solver="cg",
                 rtol=1e-8, device=None):
        super().__init__(etype, X, conn, (), None, ndof_per_node=1,
                         dtype=dtype, device=device)
        if solver not in ("cg", "direct"):
            raise ValueError(f"solver must be 'cg' or 'direct', got "
                             f"{solver!r}")
        self.r0 = float(r0)
        self.solver = solver
        self.rtol = float(rtol)
        self.Ke, self.Re = _filter_matrices(self.Xe, self.dN, self.N,
                                            self.wq, self.r0)
        self._inv_diag = 1.0 / self.diagonal(self.Ke)
        self._lu = None  # host factorization for solver="direct"
        self._st = None
        self.last_iters = None  # PCG iterations of the last solve (tensor)

    # -- structured fast path ---------------------------------------------

    def attach_structured_grid(self, nnodes_x, nnodes_y, nnodes_z=None):
        """Stencil-operator path for structured quad/hex grids.

        ``apply``/``apply_gradient`` then run stencil products and
        Jacobi-PCG on (1, *grid) fields instead of the gather/scatter
        operator: kernel K9 in 2D; in 3D kernel K4 on (27, nz, ny, nx)
        full-storage planes in float32 and, by dtype, the plain
        ``Stencil3D.matvec`` in float64 (K4 takes float32 only).
        """
        from ..ops import fused_smooth
        from ..ops.stencil import Stencil2D, Stencil3D
        from ..ops.stencil_matvec import stencil_matvec_2d

        dims = ((nnodes_x, nnodes_y) if nnodes_z is None
                else (nnodes_x, nnodes_y, nnodes_z))
        dims = tuple(int(n) for n in dims)
        want = "quad4" if nnodes_z is None else "hex8"
        if self.etype.name != want:
            raise ValueError(f"{len(dims)}D structured filter requires "
                             f"{want} grids")
        if int(np.prod(dims)) != self.nnodes:
            raise ValueError(f"{'x'.join(map(str, dims))} grid != "
                             f"{self.nnodes} nodes")
        shape = dims[::-1]
        if nnodes_z is None:
            st = Stencil2D(*dims, 1)
            self._st_matvec = stencil_matvec_2d
            planes = lambda c: c.contiguous()
        else:
            st = Stencil3D(*dims, 1)
            k4 = (fused_smooth.fused_sweep_3d if self.dtype == torch.float32
                  else fused_smooth.fused_sweep_3d_plain)
            self._st_matvec = lambda c, u: k4(c, x=u, mode="matvec",
                                              neg_resid=True)
            # K4's full storage: plane (dz, dy, dx) at dz*9 + dy*3 + dx,
            # the row-major order of Stencil3D's (1, 1, 3, 3, 3) axes
            planes = lambda c: c.reshape((27,) + shape).contiguous()
        self._st = st
        self._st_shape = shape
        coeffK = st.assemble(self.Ke)
        diag = st.diagonal(coeffK)
        self._st_inv_diag = 1.0 / torch.where(diag == 0, 1.0, diag)
        self._coeffK = planes(coeffK)
        self._coeffR = planes(st.assemble(self.Re))
        return self

    def _st_solve_K(self, b_grid):
        x, k, _ = solvers.cg_loop(
            lambda u: self._st_matvec(self._coeffK, u), b_grid,
            inv_diag=self._st_inv_diag, rtol=self.rtol,
            maxiter=10 * self.ndof)
        self.last_iters = k
        return x

    def _st_fwd(self, x):
        """rho = K^-1 R x on the stencil planes (flat nodal in and out)."""
        b = self._st_matvec(self._coeffR, x.reshape((1,) + self._st_shape))
        return self._st_solve_K(b).reshape(-1)

    def _st_bwd(self, g):
        """R^T K^-1 g on the stencil planes (flat nodal in and out)."""
        z = self._st_solve_K(g.reshape((1,) + self._st_shape))
        return self._st_matvec(self._coeffR, z).reshape(-1)

    # -- core ops ------------------------------------------------------------

    def _solve_K(self, b):
        if self.solver == "direct":
            if self._lu is None:
                from scipy.sparse.linalg import factorized

                self._lu = factorized(self.assemble_scipy(self.Ke).tocsc())
            return torch.as_tensor(self._lu(b.detach().cpu().numpy()),
                                   dtype=self.dtype, device=self.device)
        data = (self.Ke, self.conn_dof, self.bc.mask, self.segments)
        res = solvers.cg(assembly.bc_elem_matvec, data, b,
                         inv_diag=self._inv_diag, rtol=self.rtol)
        self.last_iters = res.iters
        return res.x

    def _check_size(self, x):
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if tuple(x.shape) != (self.nnodes,):
            raise ValueError(
                f"Helmholtz expects a nodal field of shape "
                f"({self.nnodes},), got {tuple(x.shape)}"
            )
        return x

    def apply(self, x):
        """x -> rho = K^-1 R x."""
        x = self._check_size(x)
        if self._st is not None:
            return self._st_fwd(x)
        return self._solve_K(self.matvec(self.Re, x))

    def apply_gradient(self, gradrho):
        """d rho/d x transpose: g -> R^T K^-1 g (R is symmetric here)."""
        g = self._check_size(gradrho)
        if self._st is not None:
            return self._st_bwd(g)
        return self.matvec(self.Re, self._solve_K(g))

    def compute_rhs(self, x):
        return self.matvec(self.Re, torch.as_tensor(x, dtype=self.dtype,
                                                    device=self.device))

    def compute_jacobian(self):
        return self.assemble_scipy(self.Ke)
