"""Linear elasticity: plane stress in 2D, isotropic in 3D (PyTorch port).

Port of ``LinearElasticity`` from
``pyfem_gpu_testflight_tpu/models/elasticity.py`` (reference
pyfem.py:1667-2068): the constructor with its ``kernel`` option,
``element_jacobian`` (einsum path or the element kernels K7 / K8),
``compute_jacobian``, ``compute_rhs``, ``solve`` with ``method="cg"``,
``"gmres"``, ``"direct"``, ``"gmg"``, ``"pmg"`` or ``"amg"``, and the
optimization functionals ``compliance``, ``compliance_grad``, ``k_dv_sens``, ``volume`` and
``volume_grad`` (pyfem.py:1797-1920).  The stiffness is in Lamé form, algebraically
identical to the reference's B^T C0 B einsum (pyfem.py:2016-2027).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import assembly
from ..ops import geometry, stiffness
from .base import OWN_OPERATOR, FEModel, ramp, ramp_deriv

__all__ = ["LinearElasticity"]


class LinearElasticity(FEModel):
    """Isotropic linear elasticity (plane stress on a 2D mesh, 3D else).

    Args:
        nodal_force: dict {node: [fx, fy(, fz)]} applied as the rhs
            (pyfem.py:1760-1768).
        E, nu: Young's modulus / Poisson ratio.
        p: RAMP penalization parameter.
        kernel: "einsum" (the einsum path, any element and dtype) or
            "cuda": the hand-written element-stiffness kernels K7
            (quad4, ``ops.element_kernels``) and K8 (hex8, tet10,
            brick20, ``ops.element_kernels3d``), float32 only — the JAX
            package's ``kernel="pallas"``, the in-repo analogue of the
            reference's A2DWrapper native kernels (pyfem.py:2180).
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
        kernel="einsum",
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
        self._init_kernel(kernel)

    # -- assembly ----------------------------------------------------------

    def element_jacobian(self, rho=1.0):
        """Element stiffness matrices Ke (nelems, ndpe, ndpe)."""
        rho = self._as_nodal(rho)
        if self.kernel == "cuda" and not rho.is_complex():
            cqT = self._cq_transposed(rho)
            if self.ndims == 3:
                from ..ops import element_kernels3d as ek3

                KeT = ek3.elasticity_stiffness_3d(
                    self._XeT, cqT, self.mu, self.lam, etype=self.etype.name)
            else:
                from ..ops import element_kernels as ek

                KeT = ek.elasticity_stiffness_quad4(self._XeT, cqT, self.mu,
                                                    self.lam)
            return self._untranspose_ke(KeT)
        Xe, dN, N, wq = self._tables(rho.dtype)
        rho_q = geometry.interp_to_quads(N, rho[self.conn])
        return stiffness.elasticity_stiffness(Xe, dN, wq, ramp(rho_q, self.p),
                                              self.mu, self.lam)

    def compute_jacobian(self, rho=1.0):
        """Assembled host scipy CSR global matrix (the direct path)."""
        return self.assemble_scipy(self.element_jacobian(rho))

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

    # -- solves --------------------------------------------------------------

    def solve(self, method="cg", rho=1.0, rtol=1e-8, maxiter=None):
        """Static solve: ``"cg"`` (Jacobi-PCG on the matrix-free
        operator), ``"gmres"`` (Jacobi-GMRES on it), ``"direct"`` (host
        scipy), ``"gmg"``, ``"pmg"`` or ``"amg"`` (AMG-PCG, unstructured
        meshes)."""
        Ke = (None if method in OWN_OPERATOR
              else self.element_jacobian(rho))
        u, _ = self._solve_system(Ke, self.compute_rhs(), method, rtol,
                                  rho=rho, maxiter=maxiter)
        return u

    # -- optimization functionals -------------------------------------------

    def compliance(self, rho, solver="cg"):
        """Compliance c = <rhs_bc, u> and state u (pyfem.py:1797-1834)."""
        rho = self._as_nodal(rho)
        Ke = (None if solver in OWN_OPERATOR
              else self.element_jacobian(rho))
        u, b = self._solve_system(Ke, self.compute_rhs(), solver, rho=rho)
        b = b.to(u.dtype)
        return torch.dot(b, u), u

    def compliance_grad(self, rho, u):
        """Self-adjoint compliance gradient (pyfem.py:1836-1848)."""
        return -self.k_dv_sens(rho, u, u)

    def k_dv_sens(self, rho, phi, psi):
        """d(phi^T K psi)/d rho, nodal (pyfem.py:1872-1920): the
        structured route on an attached uniform grid, else the einsum
        route with a deterministic element -> node segment sum."""
        rho, phi, psi = self._dv_sens_inputs(rho, phi, psi)
        if self._use_structured_sens(rho, phi, psi):
            return self._k_dv_sens_structured(rho, phi, psi)
        rho_q, phi_e, psi_e = self._gather_dv(rho, phi, psi)
        Xe, dN, N, wq = self._tables(rho.dtype)
        inner = stiffness.elasticity_dv_inner(
            Xe, dN, N, wq, ramp_deriv(rho_q, self.p), phi_e, psi_e, self.mu,
            self.lam)
        return assembly.segment_sum(inner, self.node_segments, self.nnodes)
