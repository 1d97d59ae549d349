"""Linear elasticity: plane stress in 2D, isotropic in 3D (PyTorch port).

Port of ``LinearElasticity`` from
``pyfem_gpu_testflight_tpu/models/elasticity.py`` (reference
pyfem.py:1667-2068) as far as the structured GMG solve needs it: the
constructor, ``compute_rhs`` and ``solve(method="gmg")``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import stiffness
from .base import FEModel, _not_ported

__all__ = ["LinearElasticity"]


class LinearElasticity(FEModel):
    """Isotropic linear elasticity (plane stress on a 2D mesh, 3D on hex8).

    Args:
        nodal_force: dict {node: [fx, fy]} applied as the rhs
            (pyfem.py:1760-1768).
        E, nu: Young's modulus / Poisson ratio.
        p: RAMP penalization parameter.
        device: None means the CUDA card; "cpu" runs the kernels' plain
            versions.
    """

    def __init__(
        self,
        etype,
        X,
        conn,
        dof_fixed=(),
        dof_fixed_vals=None,
        nodal_force=None,
        E=10.0,
        nu=0.3,
        p=0.0,
        dtype=torch.float64,
        device=None,
    ):
        ndims = np.asarray(X).shape[1]
        super().__init__(
            etype, X, conn, dof_fixed, dof_fixed_vals,
            ndof_per_node=ndims, dtype=dtype, device=device,
        )
        self.E = float(E)
        self.nu = float(nu)
        self.p = float(p)
        self.mu, self.lam = stiffness.lame_params(self.E, self.nu, self.ndims)
        self.nodal_force = dict(nodal_force or {})
        self._rhs = None

    def element_jacobian(self, rho=1.0):
        _not_ported("LinearElasticity.element_jacobian", "slice 1 item 4")

    def compute_jacobian(self, rho=1.0):
        _not_ported("LinearElasticity.compute_jacobian", "slice 1 item 4")

    def compliance(self, rho, solver="cg"):
        _not_ported("LinearElasticity.compliance", "slice 1 item 4")

    def compliance_grad(self, rho, u):
        _not_ported("LinearElasticity.compliance_grad", "slice 1 item 4")

    def k_dv_sens(self, rho, phi, psi):
        _not_ported("LinearElasticity.k_dv_sens", "slice 1 item 4")

    def compute_rhs(self):
        """Nodal point forces scattered into the dof vector."""
        if self._rhs is None:
            rhs = np.zeros(self.ndof)
            for node, force in self.nodal_force.items():
                for a, f in enumerate(force):
                    rhs[self.ndof_per_node * int(node) + a] = f
            self._rhs = torch.as_tensor(rhs, dtype=self.dtype,
                                        device=self.device)
        return self._rhs

    def solve(self, method="cg", rho=1.0, rtol=1e-8, maxiter=None):
        """Static solve; this slice ports ``method="gmg"``."""
        u, _ = self._solve_system(None, self.compute_rhs(), method, rtol,
                                  rho=rho, maxiter=maxiter)
        return u
