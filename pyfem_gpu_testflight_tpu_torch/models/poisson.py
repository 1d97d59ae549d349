"""Linear Poisson model: -k Delta u = g with Dirichlet BCs (PyTorch port).

Port of ``LinearPoisson`` from ``pyfem_gpu_testflight_tpu/models/poisson.py``
(reference pyfem.py:934-1329): the constructor with its ``kernel``
option, ``compute_rhs`` (source term ``gfunc``), ``element_jacobian``
(einsum path or the element kernels K7 / K8), ``compute_jacobian``,
``solve`` with ``method="cg"``, ``"gmres"``, ``"direct"`` or ``"gmg"``,
and the optimization functionals ``compliance``, ``compliance_grad`` (with its
adjoint solve for the unweighted objective), ``k_dv_sens``, ``volume``
and ``volume_grad`` (pyfem.py:1032-1276).
"""

from __future__ import annotations

import torch

from .. import assembly
from ..ops import geometry, stiffness
from .base import OWN_OPERATOR, FEModel, ramp, ramp_deriv

__all__ = ["LinearPoisson"]


class LinearPoisson(FEModel):
    """Linear (optionally RAMP-penalized) Poisson problem.

    Args:
        etype: element type name or ElementType.
        X, conn: mesh arrays.
        dof_fixed, dof_fixed_vals: Dirichlet data (vals None => zeros).
        gfunc: source term callback, called with the quadrature-point
            coordinates as a torch tensor (nelems, nquads, ndims) and
            returning values broadcastable to (nelems, nquads)
            (pyfem.py:1126-1128).
        kappa0: nominal conductivity (kept for API parity; like the
            reference, the stiffness uses the RAMP factor only).
        p: RAMP penalization parameter.
        kernel: "einsum" (any element and dtype) or "cuda": kernels K7
            (quad4) / K8 (hex8, tet10, brick20), float32 only — the JAX
            package's ``kernel="pallas"`` (the A2DWrapper role,
            pyfem.py:2180).
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
        gfunc=None,
        kappa0=1.0,
        p=0.0,
        dtype=torch.float64,
        device=None,
        kernel="einsum",
    ):
        super().__init__(
            etype, X, conn, dof_fixed, dof_fixed_vals, ndof_per_node=1,
            dtype=dtype, device=device,
        )
        self.gfunc = gfunc
        self.kappa0 = kappa0
        self.p = float(p)
        self._rhs = None
        self._init_kernel(kernel)

    # -- assembly ----------------------------------------------------------

    def element_jacobian(self, rho=1.0):
        """Element stiffness matrices Ke (nelems, nn, nn)."""
        rho = self._as_nodal(rho)
        if self.kernel == "cuda" and not rho.is_complex():
            cqT = self._cq_transposed(rho)
            if self.ndims == 3:
                from ..ops import element_kernels3d as ek3

                KeT = ek3.poisson_stiffness_3d(self._XeT, cqT,
                                               etype=self.etype.name)
            else:
                from ..ops import element_kernels as ek

                KeT = ek.poisson_stiffness_quad4(self._XeT, cqT)
            return self._untranspose_ke(KeT)
        Xe, dN, N, wq = self._tables(rho.dtype)
        rho_q = geometry.interp_to_quads(N, rho[self.conn])
        return stiffness.poisson_stiffness(Xe, dN, wq, ramp(rho_q, self.p))

    def compute_jacobian(self, rho=1.0):
        """Assembled host scipy CSR global matrix (the direct path)."""
        return self.assemble_scipy(self.element_jacobian(rho))

    def compute_rhs(self):
        """Global load vector: rhs[n] = sum_e sum_q w|J| g(Xq) N_n."""
        if self._rhs is None:
            detJ, _ = geometry.det_and_inv(geometry.jacobian(self.Xe,
                                                             self.dN))
            Xq = geometry.interp_to_quads(self.N, self.Xe)
            g = (self.gfunc(Xq) if self.gfunc is not None
                 else torch.zeros_like(detJ))
            g = torch.broadcast_to(
                torch.as_tensor(g, dtype=self.dtype, device=self.device),
                detJ.shape)
            fe = torch.einsum("eq,qn->en", detJ * self.wq[None, :] * g,
                              self.N)
            self._rhs = assembly.assemble_vector(fe, self.conn_dof,
                                                 self.ndof, self.segments)
        return self._rhs

    # -- solves --------------------------------------------------------------

    def solve(self, method="cg", rho=1.0, rtol=1e-8, maxiter=None):
        """Static solve with Dirichlet BCs: ``"cg"``, ``"gmres"``,
        ``"direct"``, ``"gmg"`` or ``"pmg"``."""
        Ke = (None if method in OWN_OPERATOR
              else self.element_jacobian(rho))
        u, _ = self._solve_system(Ke, self.compute_rhs(), method, rtol,
                                  rho=rho, maxiter=maxiter)
        return u

    # -- optimization functionals -------------------------------------------

    def compliance(self, rho, solver="cg", weighted=True):
        """Thermal compliance c = <rhs_bc, u> (or mean(u)) and state u
        (pyfem.py:1032-1073)."""
        rho = self._as_nodal(rho)
        Ke = (None if solver in OWN_OPERATOR
              else self.element_jacobian(rho))
        u, b = self._solve_system(Ke, self.compute_rhs(), solver, rho=rho)
        if weighted:
            return torch.dot(b.to(u.dtype), u), u
        return torch.sum(u) / u.shape[0], u

    def compliance_grad(self, rho, u, weighted=True, solver="cg"):
        """Adjoint gradient of compliance w.r.t. nodal rho (pyfem.py:1075).

        The unweighted objective's adjoint solve uses the caller's
        solver (the reference hardcodes spsolve, pyfem.py:1098).
        """
        rho = self._as_nodal(rho)
        if weighted:
            psi = u  # self-adjoint
        else:
            Ke = (None if solver in OWN_OPERATOR
                  else self.element_jacobian(rho))
            rhs = torch.ones(self.ndof, dtype=self.dtype, device=self.device)
            psi, _ = self._solve_system(Ke, rhs, solver, rho=rho)
            psi = psi / self.ndof
        return -self.k_dv_sens(rho, psi, u)

    def k_dv_sens(self, rho, phi, psi):
        """d(phi^T K psi)/d rho, nodal (pyfem.py:1240-1276)."""
        rho, phi, psi = self._dv_sens_inputs(rho, phi, psi)
        if self._use_structured_sens(rho, phi, psi):
            return self._k_dv_sens_structured(rho, phi, psi)
        rho_q, phi_e, psi_e = self._gather_dv(rho, phi, psi)
        Xe, dN, N, wq = self._tables(rho.dtype)
        inner = stiffness.poisson_dv_inner(
            Xe, dN, N, wq, ramp_deriv(rho_q, self.p), phi_e, psi_e)
        return assembly.segment_sum(inner, self.node_segments, self.nnodes)
