"""Drop-in compatibility layer with the reference ``pyfem`` API
(PyTorch port).

Port of ``pyfem_gpu_testflight_tpu/compat.py``.  Reference users write
(pyfem.py public surface):

    import pyfem
    creator = pyfem.ProblemCreator(nnodes_x=32, nnodes_y=32)
    conn, X, dof_fixed = creator.create_poisson_problem()
    quadrature = pyfem.QuadratureBilinear2D()
    basis = pyfem.BasisBilinear2D(quadrature)
    model = pyfem.LinearPoisson(X, conn, dof_fixed, None, quadrature,
                                basis, gfunc)
    u = pyfem.Assembler(model).solve(method="direct")

This module reproduces that surface 1:1 (class names, constructor
argument orders, quadrature/basis objects, ``_compute_K_dv_sens``-style
private hooks used by the reference's tests) on top of this package's
models.  Each model also takes the package's ``device`` keyword (None:
the CUDA card; ``"cpu"`` runs the kernels' plain versions).  Use it via
``import pyfem_gpu_testflight_tpu_torch.compat as pyfem``.
"""

from __future__ import annotations

import numpy as np
import torch

from .assembler import Assembler
from .elements import get_element
from .io.inp import InpParser
from .io.vtk import to_vtk
from .mesh import ProblemCreator
from .models import elasticity as _elasticity
from .models import helmholtz as _helmholtz
from .models import nonlinear_poisson as _nonlinear
from .models import poisson as _poisson
from .models.base import _host
from .utils.profile import (
    time_this,
    timer_off,
    timer_on,
    timer_set_threshold,
    timer_to_stdout,
)

__all__ = [
    "Assembler",
    "BasisBase",
    "BasisBilinear2D",
    "BasisBlock3D",
    "BasisBrick20Nodes",
    "BasisTetrahedron10node",
    "BasisTriangle2D",
    "Helmholtz",
    "InpParser",
    "LinearElasticity",
    "LinearPoisson",
    "NonlinearPoisson2D",
    "ProblemCreator",
    "QuadratureBase",
    "QuadratureBilinear2D",
    "QuadratureBlock3D",
    "QuadratureBrick333Point",
    "QuadratureTetrahedron5Point",
    "QuadratureTriangle2D",
    "time_this",
    "timer_off",
    "timer_on",
    "timer_set_threshold",
    "timer_to_stdout",
    "to_vtk",
]


class QuadratureBase:
    """Quadrature view over an element's static tables."""

    element_name: str = None

    def __init__(self):
        self._etype = get_element(self.element_name)
        self.pts = self._etype.quad_pts
        self.weights = self._etype.quad_wts
        self.nquads = self._etype.nquads

    def get_nquads(self):
        return self.nquads

    def get_pt(self, idx=None):
        return self.pts if idx is None else self.pts[idx]

    def get_weight(self, idx=None):
        return self.weights if idx is None else self.weights[idx]


class QuadratureTriangle2D(QuadratureBase):
    element_name = "tri3"


class QuadratureBilinear2D(QuadratureBase):
    element_name = "quad4"


class QuadratureBlock3D(QuadratureBase):
    element_name = "hex8"


class QuadratureTetrahedron5Point(QuadratureBase):
    element_name = "tet10"


class QuadratureBrick333Point(QuadratureBase):
    element_name = "brick20"


class BasisBase:
    """Basis view over an element's static tables."""

    element_name: str = None

    def __init__(self, quadrature: QuadratureBase):
        self.quadrature = quadrature
        self._etype = get_element(self.element_name)
        if quadrature.element_name != self.element_name:
            raise ValueError("quadrature/basis element mismatch")
        self.ndims = self._etype.ndims
        self.nnodes_per_elem = self._etype.nnodes
        self.N = self._etype.shape_vals
        self.Nderiv = self._etype.shape_grads

    def eval_shape_fun(self):
        return self.N

    def eval_shape_fun_deriv(self):
        return self.Nderiv


class BasisTriangle2D(BasisBase):
    element_name = "tri3"


class BasisBilinear2D(BasisBase):
    element_name = "quad4"


class BasisBlock3D(BasisBase):
    element_name = "hex8"


class BasisTetrahedron10node(BasisBase):
    element_name = "tet10"


class BasisBrick20Nodes(BasisBase):
    element_name = "brick20"


def _etype_of(basis):
    return basis.element_name


class _CompatMixin:
    """Reference-style hooks shared by the compat models."""

    def apply_dirichlet_bcs(self, K, rhs, enforce_symmetric_K=True):
        return self.bc.apply_scipy(K, _host(rhs), enforce_symmetric_K)

    def _compute_K_dv_sens(self, rho, phi, psi):
        """d(phi^T K psi)/drho as a host NumPy array."""
        return _host(self.k_dv_sens(rho, phi, psi))


class LinearPoisson(_CompatMixin, _poisson.LinearPoisson):
    def __init__(self, X, conn, dof_fixed, dof_fixed_vals, quadrature,
                 basis, gfunc, kappa0=1.0, p=0.0, device=None):
        super().__init__(
            _etype_of(basis), X, conn, dof_fixed, dof_fixed_vals,
            gfunc=gfunc, kappa0=kappa0, p=p, device=device,
        )


class NonlinearPoisson2D(_CompatMixin, _nonlinear.NonlinearPoisson):
    def __init__(self, X, conn, dof_fixed, dof_fixed_vals, quadrature,
                 basis, device=None):
        super().__init__(_etype_of(basis), X, conn, dof_fixed,
                         dof_fixed_vals, device=device)


class LinearElasticity(_CompatMixin, _elasticity.LinearElasticity):
    def __init__(self, X, conn, dof_fixed, dof_fixed_vals, nodal_force,
                 quadrature, basis, E=10.0, nu=0.3, p=0.0, device=None):
        super().__init__(
            _etype_of(basis), X, conn, dof_fixed, dof_fixed_vals,
            nodal_force=nodal_force, E=E, nu=nu, p=p, device=device,
        )


class Helmholtz(_CompatMixin, _helmholtz.Helmholtz):
    def __init__(self, r0, X, conn, quadrature, basis, device=None):
        super().__init__(r0, _etype_of(basis), X, conn, device=device)


# ---------------------------------------------------------------------------
# utils.py surface (reference utils.py:154-298): out-argument style
# element/geometry helpers on NumPy arrays
# ---------------------------------------------------------------------------


def scatter_node_to_elem(conn, data, data_e):
    """data_e[...] = data[conn] (utils.py:155-168)."""
    data_e[...] = np.asarray(data)[np.asarray(conn)]


def compute_jtrans(Xe, Nderiv, Jq):
    """Jq[e,q,i,k] = dx_i/dxi_k (utils.py:172-185)."""
    Jq[...] = np.einsum("qnk,eni->eqik", np.asarray(Nderiv), np.asarray(Xe))


def compute_jdet(Jq, detJq):
    """detJq = det(Jq) (utils.py:189-200)."""
    detJq[...] = np.linalg.det(np.asarray(Jq))


def compute_elem_interp(N, data_e, data_q):
    """Interpolate nodal element data to quads (utils.py:204-221)."""
    N = np.asarray(N)
    data_e = np.asarray(data_e)
    if data_e.ndim == 2:
        data_q[...] = np.einsum("qn,en->eq", N, data_e)
    else:
        data_q[...] = np.einsum("qn,enk->eqk", N, data_e)


def compute_basis_grad(Jq, detJq, Nderiv, invJq, Ngrad):
    """Physical shape gradients + Jacobian inverse (utils.py:225-264),
    the inverse by the package's closed form on a CPU tensor."""
    from .ops import geometry as _geo

    _det, inv = _geo.det_and_inv(torch.as_tensor(np.asarray(Jq)))
    invJq[...] = inv.numpy()
    Ngrad[...] = np.einsum("qnm,eqmi->eqni", np.asarray(Nderiv), invJq)


def create_dof(nnodes, nelems, nnodes_per_elem, ndof_per_node, conn):
    """(dof, dof_each_node, conn_dof) with interleaved components
    (utils.py:268-298)."""
    from .assembly import make_conn_dof

    nodes = np.arange(nnodes)
    if ndof_per_node == 1:
        return nodes, nodes, np.asarray(conn)
    dof = np.arange(nnodes * ndof_per_node)
    dof_each_node = dof.reshape(nnodes, ndof_per_node)
    conn_dof = make_conn_dof(np.asarray(conn), ndof_per_node)
    return dof, dof_each_node, conn_dof


__all__ += [
    "compute_basis_grad",
    "compute_elem_interp",
    "compute_jdet",
    "compute_jtrans",
    "create_dof",
    "scatter_node_to_elem",
]
