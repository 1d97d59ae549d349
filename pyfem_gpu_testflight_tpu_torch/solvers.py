"""Linear solvers (PyTorch port of ``pyfem_gpu_testflight_tpu/solvers.py``).

* ``cg``: Jacobi-preconditioned conjugate gradients, the replacement for
  the reference's preconditioned ``scipy cg`` (pyfem.py:2402-2423).  It
  keeps the JAX ``lax.while_loop``'s stopping rule — iterate while
  ``r.r > max(rtol*||b||, atol)^2`` and ``k < maxiter`` — and its count.
  The loop runs on the device in blocks of ``CHECK_EVERY`` iterations
  and reads the convergence flag back to the host once per block; the
  iterations of a block past convergence are masked (``torch.where``
  keeps x, r, p and r.z; ``k`` counts active iterations only), so x,
  iters and resnorm equal those of a check after every iteration bit
  for bit.
* ``direct_solve``: host scipy SuperLU, the float64 oracle (reference
  solver="direct", pyfem.py:2414).

``gmres`` and ``newton`` belong to ROADMAP.md queue 1, slice 4.

Operator convention: ``(apply_fn, data)`` with ``apply_fn(data, x)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["cg", "cg_loop", "direct_solve", "CGResult", "readbacks"]

# host read-backs of the convergence flag made by cg_loop (one per block)
readbacks = {"cg": 0}
# iterations between those read-backs (1 = the JAX loop's per-iteration test)
CHECK_EVERY = 16


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor
    resnorm: torch.Tensor


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def cg_loop(matvec, b, inv_diag=None, rtol=1e-8, atol=0.0, maxiter=1000,
            x0=None):
    """Jacobi-PCG; returns (x, iters, resnorm) as device tensors."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if inv_diag is None:
        inv_diag = torch.ones_like(b)
    normb = torch.linalg.norm(b)
    tol2 = torch.clamp(rtol * normb, min=atol) ** 2

    x = x0
    r = b - matvec(x0)
    z = inv_diag * r
    p = z
    rz = _dot(r, z)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    done = False
    while not done:
        for _ in range(CHECK_EVERY):
            active = (_dot(r, r) > tol2) & (k < maxiter)
            Ap = matvec(p)
            alpha = rz / _dot(p, Ap)
            x = torch.where(active, x + alpha * p, x)
            r = torch.where(active, r - alpha * Ap, r)
            z = inv_diag * r
            rz_new = _dot(r, z)
            p = torch.where(active, z + (rz_new / rz) * p, p)
            rz = torch.where(active, rz_new, rz)
            k = k + active.long()
        readbacks["cg"] += 1
        done = not bool((_dot(r, r) > tol2) & (k < maxiter))
    return x, k, torch.sqrt(_dot(r, r))


def cg(
    apply_fn: Callable,
    data,
    b,
    *,
    inv_diag=None,
    x0=None,
    rtol=1e-8,
    atol=0.0,
    maxiter=None,
):
    """Preconditioned conjugate gradients.

    Args:
        apply_fn: ``apply_fn(data, x) -> A x``.
        data: operator data (element matrices, dof maps, masks, ...).
        b: right-hand side.
        inv_diag: inverse-diagonal (Jacobi) preconditioner; identity if
            None.
        rtol/atol: stop when ||r|| <= max(rtol*||b||, atol).
        maxiter: default 10 * ndof.

    Returns:
        CGResult(x, iters, resnorm).
    """
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    x, k, rn = cg_loop(lambda u: apply_fn(data, u), b, inv_diag=inv_diag,
                       rtol=rtol, atol=atol, maxiter=int(maxiter), x0=x0)
    return CGResult(x, k, rn)


def direct_solve(K_csr, rhs):
    """Host sparse direct solve (SuperLU), the float64 oracle path."""
    from scipy.sparse.linalg import spsolve

    return spsolve(K_csr.tocsr(), np.asarray(rhs))
