"""Dirichlet boundary conditions as a mask algebra (PyTorch port).

Port of ``DirichletBC`` from ``pyfem_gpu_testflight_tpu/bcs.py``.  The
constrained operator is

    A_bc(u) = where(fixed, u, A(where(fixed, 0, u)))

which is exactly the symmetric-eliminated system

    [Krr 0; 0 I] [ur; u0] = [fr - Krb u0; u0]

when paired with ``constrain_rhs``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DirichletBC"]


class DirichletBC:
    """Container for fixed dofs and their values.

    Args:
        dof_fixed: indices of constrained dofs.
        dof_fixed_vals: values at constrained dofs, or None for zero.
        ndof_total: total number of dofs.
        device: where ``mask`` and ``values`` live.
    """

    def __init__(self, dof_fixed, dof_fixed_vals, ndof_total: int,
                 device="cpu"):
        self.ndof_total = int(ndof_total)
        self.fixed = np.unique(np.asarray(dof_fixed, dtype=np.int64))
        mask = np.zeros(ndof_total, dtype=bool)
        mask[self.fixed] = True
        self.mask = torch.as_tensor(mask, device=device)
        vals = np.zeros(ndof_total)
        if dof_fixed_vals is not None:
            # order corresponds to the user's dof_fixed list (pre-unique)
            vals[np.asarray(dof_fixed, dtype=np.int64)] = np.asarray(
                dof_fixed_vals
            )
        self.values = torch.as_tensor(vals, device=device)
        self._has_vals = dof_fixed_vals is not None

    @property
    def nfixed(self) -> int:
        return int(self.fixed.shape[0])

    def constrain_rhs(self, rhs, apply_fn):
        """rhs -> [fr - Krb u0; u0] using one unconstrained matvec."""
        vals = self.values.to(rhs.dtype)
        lift = apply_fn(torch.where(self.mask, vals, 0.0))
        return torch.where(self.mask, vals, rhs - lift)

    def zero_fixed(self, u):
        return torch.where(self.mask, 0.0, u)

    def apply_scipy(self, K, rhs, enforce_symmetric_K=True):
        """Reference-equivalent BC application on a scipy CSR matrix.

        Mirrors pyfem.py:780-835 (row zeroing, optional column zeroing,
        unit diagonal, rhs lift).
        """
        rhs = np.array(rhs)
        free = np.setdiff1d(np.arange(self.ndof_total), self.fixed)
        Krb = K[free][:, self.fixed]
        diag = np.asarray(K.diagonal()).copy()
        K = K.tolil()
        K[self.fixed, :] = 0.0
        if enforce_symmetric_K:
            K[:, self.fixed] = 0.0
        K = K.tocsr()
        diag[self.fixed] = 1.0
        K.setdiag(diag)
        K.eliminate_zeros()
        vals = self.values.cpu().numpy()[self.fixed]
        rhs[self.fixed] = vals if self._has_vals else 0.0
        if self._has_vals and enforce_symmetric_K:
            rhs[free] -= Krb.dot(vals)
        return K, rhs
